// Keyed token draw for Hopper (sm_90a).
//
// Replaces: the draw of src/repro/kernels/sampling.py::_sample_row (its
// `derive_key`, `jax.random.categorical` and the greedy `argmax`), which the
// JAX step programs fuse behind their logits.  It has no Pallas kernel: XLA
// fuses it.  Here one launch replaces the ~170 elementwise launches the
// same arithmetic takes in PyTorch ops, inside the captured step programs.
//
// Per row r of x (rows, V) f32, the masked, temperature-scaled logits:
//   key   = fold_in(fold_in(PRNGKey(seed), rid), token_index), keys[r] =
//           [seed, rid, token_index]: jax.random's threefry2x32 bit for bit
//           (PRNGKey(s) = [0, s], fold_in(k, d) = threefry(k, (0, d)));
//   bits  = y0 ^ y1 of threefry(key, (0, i)) for element i (jax's
//           partitionable random_bits at 32 bits);
//   u     = max(tiny, (float(bits >> 9 | 0x3F800000) - 1) * (1 - tiny) + tiny)
//           (random._uniform on [tiny, 1)), written to `uniforms` when given;
//   g     = -log(-log(u)) (random._gumbel, mode "low");
//   out[r] = temps[r] > 0 ? argmax(g + x[r]) : argmax(logits[r]), the first
//           index on ties and NaN above everything, as jnp.argmax.
// The float steps go through __fsub_rn / __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA, and logf (no fast-math flags): the uniforms
// equal the plain version's bit for bit, and the draw PyTorch's ops on the
// card.  Every row is drawn, greedy ones too, as the reference's `where`
// draws them and throws the draw away.
//
// What bounds it on the card: operations.  Per element it reads 4 bytes of
// x and 2-4 of the logits, and runs threefry's 20 rounds (an add, a rotate
// and a xor each) and 6 key injections on the integer pipes: ~75 integer
// instructions against 6 bytes at bf16, i.e. ~2.5x more time in the
// integer pipes than in HBM at the card's rates.  So the design is about
// keeping every SM busy: the vocabulary of each row is split over
// `splits` CTAs (kernels/sampling.py::draw_splits; at 8 rows, one CTA a row
// would leave 124 of 132 SMs idle).  Each CTA reduces its share to two
// (value, index) partials, the sampled and the greedy one, and the CTA
// that arrives last on the row's counter (ptx::arrive_last) reduces the
// row's partials and writes the token: one launch, capturable in a CUDA
// graph, the same token every run (an argmax with index tie-breaks is
// exact in any order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float F32_TINY = 1.17549435e-38f;   // np.finfo(np.float32).tiny
// maxval - minval of the uniform, rounded to f32 (1.0f)
constexpr float UNIFORM_SCALE = 1.0f - F32_TINY;

struct Words {
  uint32_t a, b;
};

// Threefry-2x32, 20 rounds (jax/_src/prng.py::_threefry2x32_lowering)
__device__ __forceinline__ Words threefry(uint32_t k0, uint32_t k1, uint32_t x0,
                                          uint32_t x1) {
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, ROT[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// (v, i) beats (bv, bi) under jnp.argmax's order: NaN above everything,
// then the larger value, then the lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// the block's argmax of each thread's two (value, index) pairs; the
// result is valid in thread 0
__device__ __forceinline__ void block_argmax(float (&v)[2], int (&i)[2]) {
  __shared__ float sv[2][WARPS];
  __shared__ int si[2][WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    warp_argmax(v[p], i[p]);
    if (lane == 0) {
      sv[p][warp] = v[p];
      si[p][warp] = i[p];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      v[p] = lane < WARPS ? sv[p][lane] : -INFINITY;
      i[p] = lane < WARPS ? si[p][lane] : INT_MAX;
      warp_argmax(v[p], i[p]);
    }
  }
}

template <typename L>
__global__ void __launch_bounds__(THREADS)
draw_kernel(const float* __restrict__ x, const L* __restrict__ logits,
            const float* __restrict__ temps, const int* __restrict__ keys,
            int* __restrict__ out, float* __restrict__ uniforms,
            float4* __restrict__ ws, int* __restrict__ counters, int v, int splits) {
  __shared__ uint32_t key[2];
  __shared__ int flag;
  const int split = blockIdx.x, row = blockIdx.y;
  if (threadIdx.x == 0) {
    const int* k = keys + 3 * row;
    const Words a = threefry(0u, static_cast<uint32_t>(k[0]), 0u,
                             static_cast<uint32_t>(k[1]));
    const Words b = threefry(a.a, a.b, 0u, static_cast<uint32_t>(k[2]));
    key[0] = b.a;
    key[1] = b.b;
  }
  __syncthreads();
  const uint32_t k0 = key[0], k1 = key[1];
  const int chunk = (v + splits - 1) / splits;
  const int lo = split * chunk, hi = min(v, lo + chunk);
  const float* xr = x + static_cast<size_t>(row) * v;
  const L* lr = logits + static_cast<size_t>(row) * v;
  float* ur = uniforms ? uniforms + static_cast<size_t>(row) * v : nullptr;
  // [0]: the sampled lane's argmax(g + x), [1]: the greedy argmax(logits)
  float best[2] = {-INFINITY, -INFINITY};
  int idx[2] = {INT_MAX, INT_MAX};
  for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
    const Words h = threefry(k0, k1, 0u, static_cast<uint32_t>(i));
    const uint32_t bits = h.a ^ h.b;
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    const float u = fmaxf(F32_TINY, __fadd_rn(__fmul_rn(f, UNIFORM_SCALE), F32_TINY));
    if (ur) ur[i] = u;
    const float s = __fadd_rn(-logf(-logf(u)), xr[i]);
    if (better(s, i, best[0], idx[0])) {
      best[0] = s;
      idx[0] = i;
    }
    const float l = to_f(lr[i]);
    if (better(l, i, best[1], idx[1])) {
      best[1] = l;
      idx[1] = i;
    }
  }
  block_argmax(best, idx);
  float4* part = ws + static_cast<size_t>(row) * splits;
  if (threadIdx.x == 0)
    part[split] = make_float4(best[0], __int_as_float(idx[0]), best[1],
                              __int_as_float(idx[1]));
  if (!ptx::arrive_last(counters + row, splits, &flag)) return;

  // the last CTA of the row: the argmax of the row's partials
  best[0] = best[1] = -INFINITY;
  idx[0] = idx[1] = INT_MAX;
  for (int s = threadIdx.x; s < splits; s += THREADS) {
    const float4 p = __ldcg(part + s);
    if (better(p.x, __float_as_int(p.y), best[0], idx[0])) {
      best[0] = p.x;
      idx[0] = __float_as_int(p.y);
    }
    if (better(p.z, __float_as_int(p.w), best[1], idx[1])) {
      best[1] = p.z;
      idx[1] = __float_as_int(p.w);
    }
  }
  __syncthreads();                   // block_argmax's shared memory is reused
  block_argmax(best, idx);
  if (threadIdx.x == 0) out[row] = temps[row] > 0.f ? idx[0] : idx[1];
}

}  // namespace

// x (rows, v) f32, logits (rows, v) of `dtype` (0 = float32, 1 =
// bfloat16), temps (rows,) f32, keys (rows, 3) int32 -> out (rows,) int32.
// uniforms: null, or (rows, v) f32 to receive each element's uniform.  ws:
// rows x splits float4 of scratch; counters: rows zeroed int32 arrival
// counters, left zeroed.  Returns the launch's cudaError_t.
extern "C" int sample_draw(const void* x, const void* logits, const void* temps,
                           const void* keys, void* out, void* uniforms, void* ws,
                           void* counters, int rows, int v, int splits, int dtype,
                           void* stream) {
  if (rows < 1 || rows > 65535 || v < 1 || splits < 1 || splits > v)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(temps);
  const int* kf = static_cast<const int*>(keys);
  int* of = static_cast<int*>(out);
  float* uf = static_cast<float*>(uniforms);
  float4* wf = static_cast<float4*>(ws);
  int* cf = static_cast<int*>(counters);
  if (dtype == 0)
    draw_kernel<float><<<grid, THREADS, 0, s>>>(
        xf, static_cast<const float*>(logits), tf, kf, of, uf, wf, cf, v, splits);
  else if (dtype == 1)
    draw_kernel<bf16><<<grid, THREADS, 0, s>>>(
        xf, static_cast<const bf16*>(logits), tf, kf, of, uf, wf, cf, v, splits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
