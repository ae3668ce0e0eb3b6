// Fused elementwise chain for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::fused_elementwise (kernel body
// _chain_kernel), the single-launch form of the `fused_elementwise` nodes
// that repro.core.passes.fusion builds (ResNet-18's residual add + relu).
//
// out[i] = stage_{n-1}(... stage_0(x[i]) ...) for i < n over a flat index:
// the Pallas kernel views the tensor as (rows, 128) blocks; here each thread
// takes elements of a grid-stride loop and the tail needs no padding.  A
// stage is an activation (codes 0-5 of activation.cuh: none, relu, silu,
// gelu (tanh), tanh, sigmoid) or a binary op (6 add, 7 mul, 8 sub, 9 div)
// whose right operand is the next of up to 4 same-shape extras.  Codes are
// packed 4 bits per stage, stage 0 lowest, up to 8 stages.  Each stage is
// computed in f32 and rounded to the working dtype after it, as separate
// ops of that dtype would round.
//
// What bounds it on the card: bytes.  A chain with E extras reads (1 + E)
// and writes 1 element per element, a handful of flops each; at ResNet-18's
// residual shapes (1 x C x H x W, 0.1-0.8 MB in f32) one launch moves
// under 2.4 MB, under a microsecond at 3.35 TB/s, so launch latency
// dominates.  Loads are coalesced 4-byte (f32) or 2-byte (bf16) accesses
// with no vector widening; a later change can widen them to 16 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_torch::activate;
using repro_torch::from_float;
using repro_torch::to_float;

constexpr int THREADS = 256;
constexpr int MAX_STAGES = 8;
constexpr int MAX_EXTRAS = 4;

template <typename T>
struct Extras {
  const T* p[MAX_EXTRAS];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_chain(const T* __restrict__ x, Extras<T> extras, T* __restrict__ out,
            long long n, int n_stages, unsigned int code) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += step) {
    float v = to_float(x[i]);
    int e = 0;
    for (int s = 0; s < n_stages; ++s) {
      const int op = (code >> (4 * s)) & 0xF;
      if (op >= 6) {
        const float r = to_float(extras.p[e++][i]);
        switch (op) {
          case 6: v = v + r; break;
          case 7: v = v * r; break;
          case 8: v = v - r; break;
          default: v = v / r; break;
        }
      } else {
        v = activate(v, op);
      }
      v = to_float(from_float<T>(v));   // round to the working dtype
    }
    out[i] = from_float<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* const* ep, void* out, long long n,
           int n_stages, unsigned int code, cudaStream_t s) {
  Extras<T> extras;
  for (int k = 0; k < MAX_EXTRAS; ++k) extras.p[k] = static_cast<const T*>(ep[k]);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;   // 32 resident waves of 132 SMs
  fused_chain<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), extras, static_cast<T*>(out), n, n_stages, code);
  return (int)cudaGetLastError();
}

}  // namespace

// extras e0..e3 may be null past the chain's binary stages; dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int fused_elementwise(const void* x, const void* e0, const void* e1,
                                 const void* e2, const void* e3, void* out,
                                 long long n, int n_stages, unsigned int code,
                                 int dtype, void* stream) {
  if (n <= 0 || n_stages < 0 || n_stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  int binary = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int op = (code >> (4 * s)) & 0xF;
    if (op > 9) return (int)cudaErrorInvalidValue;
    binary += op >= 6;
  }
  const void* ep[MAX_EXTRAS] = {e0, e1, e2, e3};
  for (int k = 0; k < binary; ++k)
    if (k >= MAX_EXTRAS || ep[k] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, ep, out, n, n_stages, code, s);
  if (dtype == 1) return launch<bf16>(x, ep, out, n, n_stages, code, s);
  return (int)cudaErrorInvalidValue;
}
