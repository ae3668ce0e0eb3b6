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
// Activations: the codes of activation.cuh.
//
// What bounds it on the card: bytes.  At the serving shapes M is small — 8
// decode slots, or a chunk of 256 prompt rows — and K x N is a whole weight
// matrix (2048 x 151936 for lm_head): at M = 8 the product does 8 flops per
// weight byte, at M = 256 256 per byte, both below the ~295 flops per byte
// where the tensor cores would become the limit.  So the kernel has to
// keep every SM streaming weights: enough CTAs, and enough bytes in flight
// in each.
//
// What the design does about it:
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulators,
//     operands by ldmatrix, double-buffered across k16 steps; ptx.cuh) on a
//     tile of BM x 128 outputs: BM = 16 for M <= 16 (no MMA work spent on
//     8x the zero rows), four warps; 64 otherwise, eight warps; 128 rows and
//     eight warps where that grid alone fills the card (lm_head at M >= 256,
//     whose weight tiles it reads half as often);
//   * the x and w tiles of BK = 64 k-steps stream through a ring of STAGES
//     (3 or 4) slots in shared memory by 16-byte cp.async copies from
//     per-thread addresses computed once, so the next STAGES - 1 steps'
//     weights (16 KB each) are in flight while one step multiplies; rows
//     are padded to an odd number of 16-byte units, so each ldmatrix phase
//     hits distinct banks; the grid runs the m-tiles of a weight tile
//     together, so the weights come from device memory once;
//   * split-K where the tile grid does not fill the card: the wrapper
//     (kernels/matmul.py::gemm_geometry) cuts K into S splits of whole
//     k-steps, as many as keep the grid within two CTAs per SM (S = 16 for
//     the decode step's wq at M = 8: 256 CTAs instead of 16).  Each CTA
//     writes its f32 partial tile to a workspace and the CTA that arrives
//     last on the tile's counter (ptx::arrive_last) sums the S partials in
//     split order, then adds the bias, applies the activation and rounds
//     once — never per partial, since the activation is nonlinear.  One
//     launch, no float atomics, no host sync;
//   * f32 runs a CUDA-core tile that stays exact f32 (the tensor cores
//     would round f32 inputs to TF32), with the same split-K epilogue.
// wgmma and TMA are not used.  The decode step's shapes (M = 8) are
// bytes-bound and stream near the card's rate on this design; at M = 256
// the tiles run well below the mma.sync rate, held back by the x and w
// tiles each CTA re-reads from L2 (PERF.md) — larger tiles shared across
// a cluster (TMA multicast) and wgmma are the way past that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activation.cuh"
#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_torch::activate;
using repro_torch::from_float;
using repro_torch::to_float;

// The bf16 tiles this library is built with, (BM, BN, BK, STAGES, WM, WN):
// WM x WN warps of 32 threads, each owning a (BM / WM) x (BN / WN) block
// of outputs.
// kernels/matmul.py::GEMM_TILES mirrors the first four numbers.
#define BF16_TILES(X)      \
  X(16, 128, 64, 4, 1, 4)  \
  X(64, 128, 64, 4, 2, 4)  \
  X(128, 128, 64, 3, 2, 4)
// The f32 CUDA-core tile (BM, BN, BK); kernels/matmul.py::GEMM_TILE_F32.
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

// Dynamic shared memory of a bf16 tile: the ring of STAGES x (A, B) slots,
// which the f32 output tile reuses after the K loop.
__host__ __device__ constexpr int bf16_smem(int bm, int bn, int bk, int stages) {
  return stages * (bm * (bk + 8) + bk * (bn + 8)) * 2 > bm * (bn + 4) * 4
             ? stages * (bm * (bk + 8) + bk * (bn + 8)) * 2
             : bm * (bn + 4) * 4;
}

// ------------------------------------------------------------ epilogue
// Store 4 consecutive outputs (16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 u;
  u.x = ptx::pack_bf16(v[0], v[1]);
  u.y = ptx::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// The CTA's f32 tile Cs (BM x BN, row stride ldc, in shared memory) to
// out: bias, activation, one rounding.  With split > 1, Cs is split s's
// partial: it goes to the workspace (S, M, N) first, and only the CTA that
// arrives last on counters[tile] finishes, from the S partials summed in
// split order.  Threads walk the tile in quads of 4 columns.
template <typename T, int BM, int BN, int NT>
__device__ void finish(const float* Cs, int ldc, const T* __restrict__ bias,
                       T* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ counters, int M, int N, int m0, int n0,
                       int act, int split, int s, int tile) {
  __shared__ int flag;
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  const bool vec = (N % 4) == 0;           // whole quads, aligned rows
  const size_t mn = (size_t)M * N;
  if (split > 1) {
    float* part = ws + (size_t)s * mn;
    for (int e = threadIdx.x; e < rows * (BN / 4); e += NT) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      if (c >= cols) continue;
      const float* src = Cs + r * ldc + c;
      float* dst = part + (size_t)(m0 + r) * N + n0 + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
      } else {
        for (int i = 0; i < 4 && c + i < cols; ++i) dst[i] = src[i];
      }
    }
    if (!ptx::arrive_last(counters + tile, split, &flag)) return;
  }
  // QPT quads per thread per pass and TB splits per batch: 16 partial
  // loads in flight per thread (the 16-row tile holds 2 quads a thread at
  // M = 8 and batches more splits: 32 loads, as it has registers to spare)
  constexpr int QPT = BM <= 16 ? 2 : 4;
  constexpr int TB = BM <= 16 ? 16 : 4;
  const int quads = rows * (BN / 4);
  for (int e0 = threadIdx.x; e0 < quads; e0 += NT * QPT) {
    float v[QPT][4];
#pragma unroll
    for (int qi = 0; qi < QPT; ++qi) v[qi][0] = v[qi][1] = v[qi][2] = v[qi][3] = 0.f;
    if (split > 1 && vec) {
      // split order, so the same bits every run
      for (int t0 = 0; t0 < split; t0 += TB) {
        float4 p[TB][QPT];
#pragma unroll
        for (int t = 0; t < TB; ++t)
#pragma unroll
          for (int qi = 0; qi < QPT; ++qi) {
            const int e = e0 + qi * NT, r = e / (BN / 4), c = (e % (BN / 4)) * 4;
            if (t0 + t < split && e < quads && c < cols)
              p[t][qi] = __ldcg(reinterpret_cast<const float4*>(
                  ws + (t0 + t) * mn + (size_t)(m0 + r) * N + n0 + c));
          }
#pragma unroll
        for (int t = 0; t < TB; ++t)
#pragma unroll
          for (int qi = 0; qi < QPT; ++qi)
            if (t0 + t < split) {
              v[qi][0] += p[t][qi].x; v[qi][1] += p[t][qi].y;
              v[qi][2] += p[t][qi].z; v[qi][3] += p[t][qi].w;
            }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QPT; ++qi) {
      const int e = e0 + qi * NT, r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      if (e >= quads || c >= cols) continue;
      const size_t o = (size_t)(m0 + r) * N + n0 + c;
      const int nc = min(4, cols - c);
      if (split == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[qi][i] = Cs[r * ldc + c + i];
      } else if (!vec) {
        for (int t = 0; t < split; ++t)
          for (int i = 0; i < nc; ++i) v[qi][i] += __ldcg(ws + t * mn + o + i);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = v[qi][i];
        if (bias != nullptr && i < nc) a += to_float(bias[n0 + c + i]);
        v[qi][i] = activate(a, act);
      }
      if (vec) {
        store4(out + o, v[qi]);
      } else {
        for (int i = 0; i < nc; ++i) out[o + i] = from_float<T>(v[qi][i]);
      }
    }
  }
}

// ---------------------------------------------------- bf16 tensor cores
template <int BM, int BN, int BK, int STAGES, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
          const bf16* __restrict__ bias, bf16* __restrict__ out,
          float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
          int act, int split, int steps_per_split) {
  constexpr int NT = WM * WN * 32;               // one warp per warp tile
  constexpr int WTM = BM / WM, WTN = BN / WN;    // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 8;     // m16 rows, n8 columns per warp
  static_assert(FN % 2 == 0, "B fragments come in pairs of n8 tiles");
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int A_ELEMS = BM * LDA, STAGE = A_ELEMS + BK * LDB;
  // 16-byte pieces: a thread copies A_IT of the x tile and B_IT of the w
  // tile per k-step, rows A_DR / B_DR apart, at a fixed column
  constexpr int A_CPR = BK / 8, B_CPR = BN / 8;  // pieces per row
  static_assert((BM * A_CPR) % NT == 0 && (BK * B_CPR) % NT == 0 && NT % B_CPR == 0,
                "every thread copies whole rows' worth of pieces");
  constexpr int A_IT = BM * A_CPR / NT, B_IT = BK * B_CPR / NT;
  constexpr int A_DR = NT / A_CPR, B_DR = NT / B_CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);    // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int kt0 = s * steps_per_split;
  const int nst = min(steps_per_split, (K + BK - 1) / BK - kt0);
  const bool vec = (K % 8) == 0 && (N % 8) == 0;
  // this thread's pieces: x rows ar + i * A_DR at column ac of the k-step,
  // w rows br + i * B_DR of the k-step at column n0 + bc
  const int ar = tid / A_CPR, ac = (tid % A_CPR) * 8;
  const int br = tid / B_CPR, bc = (tid % B_CPR) * 8;
  const bf16* xa = x + (size_t)(m0 + ar) * K + ac;
  const bf16* wb = w + (size_t)br * N + n0 + bc;
  const bool bcol = n0 + bc < N;

  // k-step i of this split into ring slot i % STAGES; 16-byte cp.async
  // where rows are 16-byte aligned (zero-filled past M / K / N without
  // reading), element loads otherwise
  auto issue = [&](int i) {
    bf16* As = ring + (i % STAGES) * STAGE;
    bf16* Bs = As + A_ELEMS;
    const int k0 = (kt0 + i) * BK;
    if (vec) {
#pragma unroll
      for (int it = 0; it < A_IT; ++it) {
        const bool ok = m0 + ar + it * A_DR < M && k0 + ac < K;
        ptx::cp_async16(ptx::smem_u32(As + (ar + it * A_DR) * LDA + ac),
                        ok ? xa + (size_t)it * A_DR * K + k0 : x, ok);
      }
#pragma unroll
      for (int it = 0; it < B_IT; ++it) {
        const bool ok = bcol && k0 + br + it * B_DR < K;
        ptx::cp_async16(ptx::smem_u32(Bs + (br + it * B_DR) * LDB + bc),
                        ok ? wb + (size_t)(k0 + it * B_DR) * N : w, ok);
      }
      return;
    }
    for (int c = tid; c < BM * A_CPR; c += NT) {
      const int r = c / A_CPR, cc = (c % A_CPR) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      for (int e = 0; e < 8; ++e)
        As[r * LDA + cc + e] =
            gm < M && gk + e < K ? x[(size_t)gm * K + gk + e] : __float2bfloat16(0.f);
    }
    for (int c = tid; c < BK * B_CPR; c += NT) {
      const int r = c / B_CPR, cc = (c % B_CPR) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      for (int e = 0; e < 8; ++e)
        Bs[r * LDB + cc + e] =
            gk < K && gn + e < N ? w[(size_t)gk * N + gn + e] : __float2bfloat16(0.f);
    }
  };

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix lane addresses: A (x rows, k contiguous) plain, B (w rows
  // along k, n contiguous) transposed — the V operand of mma_attention.cuh
  const int lrow = lane % 8 + ((lane / 8) & 1) * 8, lcol = (lane / 16) * 8;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) issue(i);
    ptx::cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    ptx::cp_async_wait<STAGES - 2>();            // step i landed
    __syncthreads();                             // ... and step i - 1 consumed
    if (i + STAGES - 1 < nst) issue(i + STAGES - 1);
    ptx::cp_async_commit();
    const bf16* As = ring + (i % STAGES) * STAGE;
    const bf16* Bs = As + A_ELEMS;
    const uint32_t a_addr = ptx::smem_u32(As + (wm * WTM + lrow) * LDA + lcol);
    const uint32_t b_addr = ptx::smem_u32(Bs + lrow * LDB + wn * WTN + lcol);
    // operand fragments double-buffered across the k16 steps: step kk + 1's
    // ldmatrix loads are issued before step kk's mma
    uint32_t a[2][FM][4], b[2][FN / 2][4];
    auto load_frags = [&](int buf, int kk) {
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
        ptx::ldsm_x4(a[buf][fm], a_addr + (uint32_t)((fm * 16 * LDA + kk) * 2));
#pragma unroll
      for (int fn = 0; fn < FN / 2; ++fn)
        ptx::ldsm_x4_trans(b[buf][fn], b_addr + (uint32_t)((kk * LDB + fn * 16) * 2));
    };
    load_frags(0, 0);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks + 1 < BK / 16) load_frags((ks + 1) % 2, (ks + 1) * 16);
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN / 2; ++fn) {
          ptx::mma16816(acc[fm][2 * fn], a[ks % 2][fm], b[ks % 2][fn][0], b[ks % 2][fn][1]);
          ptx::mma16816(acc[fm][2 * fn + 1], a[ks % 2][fm], b[ks % 2][fn][2],
                        b[ks % 2][fn][3]);
        }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // accumulators -> the f32 tile: rows lane / 4 and lane / 4 + 8 of each
  // m16 block, columns 2 * (lane % 4) and + 1 of each n8 block
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      const int r = wm * WTM + fm * 16 + lane / 4, c = wn * WTN + fn * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(Cs + r * LDC + c) = make_float2(acc[fm][fn][0], acc[fm][fn][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * LDC + c) =
          make_float2(acc[fm][fn][2], acc[fm][fn][3]);
    }
  __syncthreads();
  finish<bf16, BM, BN, NT>(Cs, LDC, bias, out, ws, counters, M, N, m0, n0, act, split,
                           s, blockIdx.y * gridDim.x + blockIdx.x);
}

// ----------------------------------------------------------- f32 CUDA cores
__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ bias, float* __restrict__ out,
         float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
         int act, int split, int steps_per_split) {
  constexpr int LDC = F_BN + 4;
  __shared__ __align__(16) float smem[F_BM * LDC];   // A/B tiles, then the C tile
  float (*As)[F_BM + 4] = reinterpret_cast<float (*)[F_BM + 4]>(smem);   // k-major
  float (*Bs)[F_BN + 4] = reinterpret_cast<float (*)[F_BN + 4]>(smem + F_BK * (F_BM + 4));
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN, s = blockIdx.z;
  const int k_end = min(K, (s + 1) * steps_per_split * F_BK);
  float acc[4][4] = {};
  for (int k0 = s * steps_per_split * F_BK; k0 < k_end; k0 += F_BK) {
    for (int e = tid; e < F_BM * F_BK; e += F_THREADS) {
      const int r = e / F_BK, kk = e % F_BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < k_end) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
      const int kk = e / F_BN, cn = e % F_BN;
      const int gk = k0 + kk, gn = n0 + cn;
      Bs[kk][cn] = (gk < k_end && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) smem[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();
  finish<float, F_BM, F_BN, F_THREADS>(smem, LDC, bias, out, ws, counters, M, N, m0,
                                       n0, act, split, s, blockIdx.y * gridDim.x + blockIdx.x);
}

template <int BM, int BN, int BK, int STAGES, int WM, int WN>
cudaError_t launch_bf16(const void* x, const void* w, const void* bias, void* out,
                        float* ws, int* counters, int M, int N, int K, int act,
                        int split, int sps, cudaStream_t s) {
  constexpr int smem = bf16_smem(BM, BN, BK, STAGES);
  const cudaError_t err =
      ptx::allow_smem<gemm_bf16<BM, BN, BK, STAGES, WM, WN>>(smem);
  if (err != cudaSuccess) return err;
  // m-tiles fastest: the CTAs that share a weight tile run together, so
  // the weights come from device memory once and from L2 for the others
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, split);
  gemm_bf16<BM, BN, BK, STAGES, WM, WN><<<grid, WM * WN * 32, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), ws, counters, M, N, K,
      act, split, sps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bias may be null.  (bm, bn, bk, stages,
// split): the geometry of kernels/matmul.py::gemm_geometry — one of the
// tiles this library is built with, and S splits of whole k-steps with
// none empty.  With split > 1, `ws` holds split x M x N f32 partials and
// `counters` one zeroed int per output tile (left zeroed at the end).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a geometry
// the library cannot run).
extern "C" int matmul_fused(const void* x, const void* w, const void* bias,
                            void* out, int M, int N, int K, int act, int dtype,
                            int bm, int bn, int bk, int stages, int split,
                            void* ws, void* counters, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < 0 || act > 5 || bk <= 0 || split < 1)
    return (int)cudaErrorInvalidValue;
  const int nk = (K + bk - 1) / bk;
  const int sps = (nk + split - 1) / split;
  if (split > nk || (split - 1) * sps >= nk || split > 65535 || N / 64 >= 65535 ||
      (split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 1) {
#define LAUNCH(BM, BN, BK, ST, WM, WN)                                             \
    if (bm == BM && bn == BN && bk == BK && stages == ST)                          \
      return (int)launch_bf16<BM, BN, BK, ST, WM, WN>(x, w, bias, out, wsf, cnt, M, \
                                                      N, K, act, split, sps, s);
    BF16_TILES(LAUNCH)
#undef LAUNCH
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && bm == F_BM && bn == F_BN && bk == F_BK && stages == 1) {
    dim3 grid((M + F_BM - 1) / F_BM, (N + F_BN - 1) / F_BN, split);
    gemm_f32<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), wsf, cnt, M, N, K,
        act, split, sps);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
