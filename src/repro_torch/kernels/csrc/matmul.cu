// Tiled GEMM with a fused bias + activation epilogue for Hopper (sm_90a).
//
// Replaces: repro/kernels/matmul.py::matmul_padded (kernel body
// _matmul_kernel), reached through repro.kernels.ops.matmul and the
// `pallas_matmul` lane of repro.kernels.dispatch.
//
// out (M, N) = act(x (M, K) @ w (K, N) + bias (N)), row-major, with an f32
// accumulator and the bias and activation applied in f32 before the one
// rounding to the output dtype — the Pallas kernel's epilogue.  Ragged
// edges are masked inside the kernel (out-of-range A/B elements load as
// zero, out-of-range outputs are not stored), so the wrapper pads nothing.
// Activations: 0 none, 1 relu, 2 silu, 3 gelu (tanh approximation, as
// jax.nn.gelu), 4 tanh, 5 sigmoid.
//
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments (mma.sync
// underneath) with f32 accumulation; f32 runs a plain CUDA-core tile so that
// it stays exact f32 (the tensor cores would round f32 inputs to TF32).
//
// What bounds it on the card: at the serving shapes M is small — 8 decode
// slots, or a chunk of 256 prompt rows — and K x N is a whole weight matrix
// (2048 x 151936 for lm_head), so the weight bytes bound it: at M = 8 the
// product does 2 * M = 16 flops per bf16 weight element (8 per byte), far
// below the ~295 flops per byte where the tensor cores would be the limit;
// at M = 256 it is 256 flops per byte, near the crossover.
//
// What the design does about it: every weight element is read from device
// memory once per CTA row of the output (one CTA row covers all of M <= 16,
// and 64 rows otherwise), with 16-byte loads contiguous along N; small M
// picks a 16 x 128 tile so the MMA does not spend 8x the work on zero rows.
// This first version stages one K-step at a time without overlapping the
// next tile's loads (no cp.async / TMA pipeline and no wgmma); those are for
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int THREADS = 128;

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return x / (1.f + expf(-x));
    case 3: {
      const float c = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case 4: return tanhf(x);
    case 5: return 1.f / (1.f + expf(-x));
    default: return x;
  }
}

// ---------------------------------------------------------------- bf16 WMMA
template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
          const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N,
          int K, int act) {
  static_assert(WM * WN * 32 == THREADS, "one warp per warp tile");
  constexpr int WTM = BM / WM, WTN = BN / WN;    // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 16;    // fragments per warp
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);    // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool kvec = (K % 8) == 0, nvec = (N % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M) {
        if (kvec && gk + 8 <= K) {
          val = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
        } else {
          bf16* e = reinterpret_cast<bf16*>(&val);
          for (int i = 0; i < 8; ++i)
            if (gk + i < K) e[i] = x[(size_t)gm * K + gk + i];
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDA + cc) = val;
    }
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gk < K) {
        if (nvec && gn + 8 <= N) {
          val = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
        } else {
          bf16* e = reinterpret_cast<bf16*>(&val);
          for (int i = 0; i < 8; ++i)
            if (gn + i < N) e[i] = w[(size_t)gk * N + gn + i];
        }
      }
      *reinterpret_cast<uint4*>(Bs + r * LDB + cc) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * WTM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * LDB + wn * WTN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, cn = e % BN;
    const int gm = m0 + r, gn = n0 + cn;
    if (gm >= M || gn >= N) continue;
    float v = Cs[r * LDC + cn];
    if (bias != nullptr) v += __bfloat162float(bias[gn]);
    out[(size_t)gm * N + gn] = __float2bfloat16(activate(v, act));
  }
}

// ----------------------------------------------------------- f32 CUDA cores
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ bias, float* __restrict__ out, int M, int N,
         int K, int act) {
  __shared__ float As[F_BK][F_BM + 4];   // A tile, k-major
  __shared__ float Bs[F_BK][F_BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int e = tid; e < F_BM * F_BK; e += F_THREADS) {
      const int r = e / F_BK, kk = e % F_BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
      const int kk = e / F_BN, cn = e % F_BN;
      const int gk = k0 + kk, gn = n0 + cn;
      Bs[kk][cn] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      out[(size_t)gm * N + gn] = activate(v, act);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bias may be null.  Returns the launch's
// cudaError_t.
extern "C" int matmul_fused(const void* x, const void* w, const void* bias,
                            void* out, int M, int N, int K, int act, int dtype,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < 0 || act > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const bf16* bb = static_cast<const bf16*>(bias);
    bf16* ob = static_cast<bf16*>(out);
    if (M <= 16) {
      dim3 grid((N + 127) / 128, (M + 15) / 16);
      gemm_bf16<16, 128, 32, 1, 4><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, N, K, act);
    } else {
      dim3 grid((N + 127) / 128, (M + 63) / 64);
      gemm_bf16<64, 128, 32, 2, 2><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, N, K, act);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    gemm_f32<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, act);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
