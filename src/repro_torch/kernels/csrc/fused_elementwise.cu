// Fused elementwise chain for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::fused_elementwise (kernel body
// _chain_kernel), the single-launch form of the `fused_elementwise` nodes
// that repro.core.passes.fusion builds (ResNet-18's residual add + relu).
//
// out[i] = stage_{n-1}(... stage_0(x[i]) ...) over a flat index.  A stage is
// an activation (codes 0-5 of activation.cuh: none, relu, silu, gelu (tanh),
// tanh, sigmoid) or a binary op (6 add, 7 mul, 8 sub, 9 div) whose right
// operand is the next of up to 4 same-shape extras.  Codes are packed 4 bits
// per stage, stage 0 lowest, up to 8 stages.  Each stage is computed in f32
// and rounded to the working dtype after it, as separate ops of that dtype
// round.  Binary stages go through __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, which nvcc never contracts: a mul followed by an add rounds
// twice, as two PyTorch ops do, not once as an FMA would.
//
// What bounds it on the card: bytes.  Per element a chain with E extras
// reads 1 + E values and writes 1, with a few flops and no reuse, so
// neither TMA (which stages tiles for reuse in shared memory) nor the tensor
// cores buy anything; what matters is how many bytes are in flight.
//  * Large tensors: HBM's 3.35 TB/s.  By Little's law an SM must keep
//    3.35 TB/s / 132 x ~0.7 us ~ 18-25 KB of loads in flight.  Every access
//    is 16 bytes (float4 for f32, 8 x bf16 through uint4 for bf16), and each
//    thread issues the loads of x and of every extra for `unroll` vectors
//    before it runs the chain on any of them; the grid is SMs x resident
//    blocks, each block streaming an equal, contiguous share.
//  * ResNet-18's batch-1 residual shapes (25,088-200,704 elements, 0.3-2.4
//    MB): 0.09-0.72 us of bytes, below a launch's own device floor, so the
//    time there is latency and block count.  The grid spreads the vectors
//    over every SM (one block each, an equal share, blocks narrowed to the
//    share) instead of leaving most SMs idle.
// The host picks the geometry (kernels/fused.py::geometry): the vector
// width, `unroll`, threads, blocks and the scalar head, up to the first
// 16-byte boundary, that x, the extras and out share.  The head and the
// tail past the last whole vector run the scalar body in the same launch;
// where the pointers are not equally aligned the whole launch takes the
// scalar body (vector width 1).  Nothing is padded or copied.
//
// The code is decoded once per thread, into registers.  add -> relu, the
// only chain the fusion pass builds on ResNet-18, has its own instance;
// every other chain runs the generic body.
//
// CUDA C++, not Triton: the port builds every kernel with nvcc into ctypes
// libraries; one streaming pass in 16-byte vectors reaches the same
// bandwidth a Triton kernel would, without a second toolchain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_torch::activate;
using repro_torch::from_float;
using repro_torch::to_float;

constexpr int MAX_STAGES = 8;
constexpr int MAX_EXTRAS = 4;
constexpr int MAX_THREADS = 256;
constexpr int MAX_UNROLL = 4;
constexpr int VEC_BYTES = 16;
constexpr unsigned ADD_RELU = 6u | (1u << 4);   // stage 0 add, stage 1 relu

template <typename T>
struct Args {
  const T* x;
  const T* e[MAX_EXTRAS];
  T* out;
  long long head, nvec, tail;   // scalar head, whole vectors, scalar tail
  long long share;              // nvec / blocks: every block's vectors ...
  int rem;                      // ... and one more for the first nvec % blocks
  int unroll, n_stages;
  unsigned code;
};

// W elements as loaded: the element itself (W = 1) or one 16-byte word
template <typename T, int W>
using Raw = typename std::conditional<W == 1, T, uint4>::type;

template <typename T, int W>
__device__ __forceinline__ Raw<T, W> load(const T* p) {
  if constexpr (W == 1) return *p;
  else return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// element k of a loaded pack, as f32 (k is a constant after unrolling)
template <typename T, int W>
__device__ __forceinline__ float elem(const Raw<T, W>& r, int k) {
  if constexpr (W == 1) {
    return to_float(r);
  } else if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word(r, k));
  } else {   // bf16: the high half of an f32 word
    const unsigned w = word(r, k / 2);
    return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    *p = from_float<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16;
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// The packed code, decoded once per thread.  Both arrays are indexed only
// by fully unrolled loops, so they live in registers.
struct Chain {
  int n;
  int op[MAX_STAGES];
  int extra[MAX_STAGES];   // which extra a binary stage reads

  __device__ __forceinline__ Chain(int n_stages, unsigned code) : n(n_stages) {
    int e = 0;
#pragma unroll
    for (int s = 0; s < MAX_STAGES; ++s) {
      op[s] = (code >> (4 * s)) & 0xF;
      extra[s] = e;
      e += s < n_stages && op[s] >= 6;
    }
  }
};

// One element through the chain: x and its E extras as f32.
template <typename T, int E, bool ADD_RELU_ONLY>
__device__ __forceinline__ float apply(const Chain& c, float v, const float (&r)[E > 0 ? E : 1]) {
  if constexpr (ADD_RELU_ONLY) {
    return activate(round_to<T>(__fadd_rn(v, r[0])), 1);   // relu is exact
  } else {
#pragma unroll
    for (int s = 0; s < MAX_STAGES; ++s) {
      if (s >= c.n) break;
      const int op = c.op[s];
      if (op >= 6) {
        float b = r[0];
#pragma unroll
        for (int k = 1; k < E; ++k)
          if (c.extra[s] == k) b = r[k];
        switch (op) {
          case 6: v = __fadd_rn(v, b); break;
          case 7: v = __fmul_rn(v, b); break;
          case 8: v = __fsub_rn(v, b); break;
          default: v = __fdiv_rn(v, b); break;
        }
      } else {
        v = activate(v, op);
      }
      v = round_to<T>(v);
    }
    return v;
  }
}

template <typename T, int E, bool ADD_RELU_ONLY>
__device__ __forceinline__ void scalar(const Args<T>& a, const Chain& c, long long i) {
  float r[E > 0 ? E : 1];
#pragma unroll
  for (int k = 0; k < E; ++k) r[k] = to_float(a.e[k][i]);
  a.out[i] = from_float<T>(apply<T, E, ADD_RELU_ONLY>(c, to_float(a.x[i]), r));
}

// W: elements per access (16 bytes' worth, or 1 for the scalar body); E:
// the chain's extras.  Block b owns an equal share of the vectors, one more
// for the first nvec % blocks blocks (no division on the device), and walks
// it in chunks of blockDim x unroll.  A generic chain loads one vector at a
// time: its body is long enough to keep ptxas busy for seconds per
// instance when unrolled further, and it is not on the main path.
template <typename T, int W, int E, bool ADD_RELU_ONLY>
__global__ void __launch_bounds__(MAX_THREADS) fused_chain(const Args<T> a) {
  constexpr int UNROLL_BOUND = ADD_RELU_ONLY ? MAX_UNROLL : 1;
  const Chain c(a.n_stages, a.code);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < a.head) scalar<T, E, ADD_RELU_ONLY>(a, c, g);
  if (g < a.tail) scalar<T, E, ADD_RELU_ONLY>(a, c, a.head + a.nvec * W + g);

  const T* x = a.x + a.head;
  const T* e[E > 0 ? E : 1];
#pragma unroll
  for (int k = 0; k < E; ++k) e[k] = a.e[k] + a.head;
  T* out = a.out + a.head;
  const int unroll = a.unroll < UNROLL_BOUND ? a.unroll : UNROLL_BOUND;
  const long long b = blockIdx.x;
  const long long lo = b * a.share + (b < a.rem ? b : a.rem);
  const long long hi = lo + a.share + (b < a.rem);
  const long long step = (long long)blockDim.x * unroll;
  for (long long base = lo + threadIdx.x; base < hi; base += step) {
    Raw<T, W> xr[UNROLL_BOUND];
    Raw<T, W> er[E > 0 ? E : 1][UNROLL_BOUND];
    // every load of the chunk first, so they are in flight together
#pragma unroll
    for (int j = 0; j < UNROLL_BOUND; ++j) {
      const long long v = base + (long long)j * blockDim.x;
      if (j < unroll && v < hi) {
        xr[j] = load<T, W>(x + v * W);
#pragma unroll
        for (int k = 0; k < E; ++k) er[k][j] = load<T, W>(e[k] + v * W);
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL_BOUND; ++j) {
      const long long v = base + (long long)j * blockDim.x;
      if (j < unroll && v < hi) {
        float o[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float r[E > 0 ? E : 1];
#pragma unroll
          for (int k = 0; k < E; ++k) r[k] = elem<T, W>(er[k][j], w);
          o[w] = apply<T, E, ADD_RELU_ONLY>(c, elem<T, W>(xr[j], w), r);
        }
        store<T, W>(out + v * W, o);
      }
    }
  }
}

template <typename T, int W>
int launch(const Args<T>& a, int n_extras, int threads, int blocks, cudaStream_t s) {
  const dim3 grid(blocks), block(threads);
  if (a.n_stages == 2 && a.code == ADD_RELU) {
    fused_chain<T, W, 1, true><<<grid, block, 0, s>>>(a);
  } else {
    switch (n_extras) {
      case 0: fused_chain<T, W, 0, false><<<grid, block, 0, s>>>(a); break;
      case 1: fused_chain<T, W, 1, false><<<grid, block, 0, s>>>(a); break;
      case 2: fused_chain<T, W, 2, false><<<grid, block, 0, s>>>(a); break;
      case 3: fused_chain<T, W, 3, false><<<grid, block, 0, s>>>(a); break;
      default: fused_chain<T, W, 4, false><<<grid, block, 0, s>>>(a); break;
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* x, const void* const* ep, void* out, long long n,
                 int n_stages, unsigned code, int n_extras, int vec, int unroll,
                 int threads, int blocks, int head, cudaStream_t s) {
  constexpr int V = VEC_BYTES / sizeof(T);
  if ((vec != 1 && vec != V) || head < 0 || head >= vec || head > n)
    return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.x = static_cast<const T*>(x);
  for (int k = 0; k < MAX_EXTRAS; ++k) a.e[k] = static_cast<const T*>(ep[k]);
  a.out = static_cast<T*>(out);
  a.head = head;
  a.nvec = (n - head) / vec;
  a.tail = n - head - a.nvec * vec;
  a.share = a.nvec / blocks;
  a.rem = (int)(a.nvec % blocks);
  a.unroll = unroll;
  a.n_stages = n_stages;
  a.code = code;
  if (vec == 1 || a.nvec == 0) return launch<T, 1>(a, n_extras, threads, blocks, s);
  // the vector body needs x, every extra and out 16-byte aligned past the head
  const T* ptrs[2 + MAX_EXTRAS] = {a.x, a.out, a.e[0], a.e[1], a.e[2], a.e[3]};
  for (int k = 0; k < 2 + n_extras; ++k)
    if (reinterpret_cast<size_t>(ptrs[k] + head) % VEC_BYTES)
      return (int)cudaErrorMisalignedAddress;
  return launch<T, V>(a, n_extras, threads, blocks, s);
}

__global__ void empty_kernel() {}

}  // namespace

// extras e0..e3 may be null past the chain's binary stages; dtype: 0 =
// float32, 1 = bfloat16.  The geometry (kernels/fused.py::geometry): vec =
// elements per access (16 bytes' worth, or 1 for the scalar body), unroll =
// vectors a thread loads before computing (1..4), threads (a multiple of 32
// up to 256) and blocks, head = scalar elements before the first 16-byte
// boundary (< vec).  Returns the launch's cudaError_t.
extern "C" int fused_elementwise(const void* x, const void* e0, const void* e1,
                                 const void* e2, const void* e3, void* out,
                                 long long n, int n_stages, unsigned int code,
                                 int dtype, int vec, int unroll, int threads,
                                 int blocks, int head, void* stream) {
  if (n <= 0 || n_stages < 0 || n_stages > MAX_STAGES || unroll < 1 ||
      unroll > MAX_UNROLL || threads < 32 || threads > MAX_THREADS || threads % 32 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  int binary = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int op = (code >> (4 * s)) & 0xF;
    if (op > 9) return (int)cudaErrorInvalidValue;
    binary += op >= 6;
  }
  const void* ep[MAX_EXTRAS] = {e0, e1, e2, e3};
  if (binary > MAX_EXTRAS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < binary; ++k)
    if (ep[k] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(x, ep, out, n, n_stages, code, binary, vec, unroll,
                               threads, blocks, head, s);
  if (dtype == 1)
    return launch_dtype<bf16>(x, ep, out, n, n_stages, code, binary, vec, unroll,
                              threads, blocks, head, s);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel at the same geometry: the device floor of one launch,
// which no kernel of that geometry can go under (timed by chip_smoke.py).
extern "C" int fused_elementwise_floor(int threads, int blocks, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
