// NHWC convolution as an implicit GEMM on Hopper's tensor cores (sm_90a),
// with a fused bias + activation epilogue.
//
// Replaces: src/repro/kernels/conv2d.py::conv2d_direct (kernel body
// _conv_kernel), reached through repro.kernels.ops.conv2d and the
// `pallas_conv2d` backend of repro.core.engine.
//
// out (N, OH, OW, Cout) = act(conv(x (N, H, W, Cin), w (Kh·Kw·Cin, Cout)) +
// bias (Cout)), x NHWC and w the HWIO weights viewed as a matrix, with an
// f32 accumulator and the bias (f32) and activation applied in f32 before
// the one rounding to the output dtype — the Pallas kernel's epilogue.
// Activations: the codes of activation.cuh.  As a GEMM: M = N·OH·OW output
// pixels flattened row-major, N = Cout, K = Kh·Kw·Cin in the order of the
// HWIO weight's rows (tap-major, channels contiguous).  SAME padding stays
// in the kernel: a tap that falls outside the image loads zeros (at
// TensorFlow's offsets, pad_top = pad_h / 2, the odd row below), so no
// padded copy and no im2col matrix is written.
//
// What bounds it on the card: at batch 1, neither rate.  ResNet-18 is
// about 1.8 G multiply-adds per image (0.054 ms of FP32 at 67 TFLOP/s) and
// 45 MB of f32 weights (0.013 ms at 3.35 TB/s), spread over 20 launches
// whose late stages have 49-196 output pixels: the time goes to filling
// the card and hiding the latency of the loads.
//
// What the design does about it:
//   * tensor cores: bf16 runs mma.sync m16n8k16 with f32 accumulators (the
//     products are exact, only the summation order differs from an f32
//     reference); f32 runs 3xTF32 on mma.sync m16n8k8 — each operand split
//     into hi = tf32(a) and lo = tf32(a - hi) as it leaves shared memory,
//     lo·hi + hi·lo + hi·hi summed per k8 step and added to the f32
//     accumulator with a rounded add — because one TF32 product (10
//     explicit mantissa bits) misses the f32 tolerance by ~6x at K = 4,608
//     while the split stays within a few f32 ulps (ptx.cuh).  wgmma
//     is not used: its tiles are 64 rows, and at batch 1 the late stages
//     have M = 49-196, so most of such a tile would be padding;
//   * a tile of BM x BN outputs per CTA (four warps), its BM rows the
//     `rows` pixels of `row_block` whole output rows — a contiguous range
//     of M — padded to a multiple of 16 (BM in 16..128); K walks in steps
//     of BK = 32 through a STAGES-slot cp.async ring, A (the step's
//     gathered pixel x channel slab) and B (the weight slab), so the next
//     two steps land while one computes.  Where Cin is a multiple of BK a
//     step stays inside one tap and every row is one 16-byte copy per
//     piece, zero-filled (src-size 0) where the tap is padding; otherwise
//     (the stem, Cin = 3) a step walks the flattened (tap, channel) index
//     element by element, zero past K, so K is padded to the mma depth;
//   * split-K where the tile grid leaves SMs idle (kernels/conv2d.py::
//     geometry picks S from the shape alone): each split writes its f32
//     partial tile, and the CTA that arrives last on the tile's counter
//     (ptx::arrive_last) sums the S partials in split order, then adds the
//     bias, applies the activation and rounds once — one launch, no float
//     atomics, the same bits every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activation.cuh"
#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_torch::activate;
using repro_torch::from_float;

constexpr int THREADS = 128;   // four warps
constexpr int BK = 32;         // K per pipeline step
constexpr int STAGES = 3;      // cp.async ring slots
// The (BM, BN) tiles this library is built with;
// kernels/conv2d.py::CONV_TILES mirrors them.  Warps: WN = min(4, BN / 16)
// across N, 4 / WN across M, so every warp owns whole 16-row x 16-column
// fragment pairs.
#define CONV_TILES(X) \
  X(64, 16) X(128, 16) X(32, 32) X(64, 32) X(128, 32) X(16, 64) X(32, 64) \
  X(64, 64) X(128, 64) X(16, 128) X(32, 128) X(64, 128)

struct ConvArgs {
  int n, h, w, cin, cout, kh, kw, stride, pad_top, pad_left, oh, ow;
  int m, k;        // GEMM extents: N·OH·OW, Kh·Kw·Cin
  int rows;        // output pixels per tile (<= BM)
  int nk, sps;     // k-steps of BK; k-steps per split
  int split, act;
};

// Row strides in shared memory: A rows of BK + 4 f32 / + 8 bf16 and B rows
// of BN + 8 elements, so the fragment loads of a warp hit distinct banks
// (f32: lane (g, t) reads word 4g + t of A, 8t + g of B; bf16: ldmatrix
// rows 80 or 16 + 32j bytes apart); every row stays 16-byte aligned.
template <typename T> __host__ __device__ constexpr int lda() {
  return BK + (sizeof(T) == 4 ? 4 : 8);
}
template <int BN> __host__ __device__ constexpr int ldb() { return BN + 8; }

// Dynamic shared memory of an instance: the ring, which the f32 output tile
// (BM x BN + 4) reuses after the K loop; kernels/conv2d.py::tile_smem_bytes.
template <typename T, int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * (BM * lda<T>() + BK * ldb<BN>()) * (int)sizeof(T) > BM * (BN + 4) * 4
             ? STAGES * (BM * lda<T>() + BK * ldb<BN>()) * (int)sizeof(T)
             : BM * (BN + 4) * 4;
}

// one element global -> shared, zero where !ok: f32 by cp.async, bf16 (no
// 2-byte cp.async) by a load and a store, visible after the ring's barrier
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool ok) {
  ptx::cp_async4(ptx::smem_u32(dst), src, ok);
}
__device__ __forceinline__ void copy_elem(bf16* dst, const bf16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// The pixel of tile row r: (image row base, first input row, first input
// column); rows past the tile's pixels get an input row no tap reaches.
__device__ __forceinline__ void pixel(const ConvArgs& a, int m0, int rows, int r,
                                      int& pix0, int& ih0, int& iw0) {
  const int m = m0 + r;
  if (r >= rows || m >= a.m) {
    pix0 = 0; ih0 = -(1 << 28); iw0 = 0;
    return;
  }
  const int plane = a.oh * a.ow, img = m / plane, rem = m - img * plane;
  const int oh = rem / a.ow, ow = rem - oh * a.ow;
  pix0 = img * a.h * a.w;
  ih0 = oh * a.stride - a.pad_top;
  iw0 = ow * a.stride - a.pad_left;
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ counters, ConvArgs a) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int WN = BN / 16 < 4 ? BN / 16 : 4, WM = 4 / WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;      // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 8;       // m16 rows, n8 columns per warp
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "whole 16 x 16 fragment pairs");
  constexpr int EPC = 16 / sizeof(T);              // elements per 16-byte piece
  constexpr int LDA = lda<T>(), LDB = ldb<BN>(), LDC = BN + 4;
  constexpr int A_ELEMS = BM * LDA, STAGE = A_ELEMS + BK * LDB;
  // 16-byte pieces: A rows arow + i * A_DR at piece column acol, B rows
  // brow + i * B_DR at column bcol; past BM / BK a thread copies nothing
  constexpr int A_CPR = BK / EPC, B_CPR = BN / EPC;
  constexpr int A_DR = THREADS / A_CPR, B_DR = THREADS / B_CPR;
  constexpr int A_IT = (BM + A_DR - 1) / A_DR, B_IT = (BK + B_DR - 1) / B_DR;
  // element gathers: A row tid % BM at columns kk0 + j * (THREADS / BM);
  // B column tid % BN at rows kr0 + j * (THREADS / BN)
  constexpr int GA_STR = THREADS / BM, GA_N = BK / GA_STR;
  constexpr int GB_STR = THREADS / BN, GB_N = BK / GB_STR;
  static_assert(THREADS % A_CPR == 0 && THREADS % B_CPR == 0 && THREADS % BM == 0 &&
                THREADS % BN == 0, "fixed piece columns per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag;
  T* ring = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);      // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * a.rows, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int kt0 = s * a.sps, nst = min(a.sps, a.nk - kt0);
  const int rows = min(a.rows, a.m - m0);          // this tile's pixels
  const bool avec = a.cin % BK == 0;               // a k-step inside one tap
  const bool bvec = a.cout % EPC == 0;             // whole pieces of w's rows

  const int arow = tid / A_CPR, acol = (tid % A_CPR) * EPC;
  const int brow = tid / B_CPR, bcol = (tid % B_CPR) * EPC;
  int a_pix[A_IT], a_ih[A_IT], a_iw[A_IT];
  if (avec) {
#pragma unroll
    for (int i = 0; i < A_IT; ++i) pixel(a, m0, rows, arow + i * A_DR, a_pix[i], a_ih[i], a_iw[i]);
  } else {
    pixel(a, m0, rows, tid % BM, a_pix[0], a_ih[0], a_iw[0]);
  }

  // k-step j (of this split) into ring slot j % STAGES
  auto issue = [&](int j) {
    T* As = ring + (j % STAGES) * STAGE;
    T* Bs = As + A_ELEMS;
    const int k0 = (kt0 + j) * BK;
    if (avec) {
      const int tap = k0 / a.cin, c0 = k0 - tap * a.cin;
      const int dh = tap / a.kw, dw = tap - dh * a.kw;
#pragma unroll
      for (int i = 0; i < A_IT; ++i) {
        const int r = arow + i * A_DR;
        if (A_IT * A_DR > BM && r >= BM) continue;
        const int ih = a_ih[i] + dh, iw = a_iw[i] + dw;
        const bool ok = (unsigned)ih < (unsigned)a.h && (unsigned)iw < (unsigned)a.w;
        const T* src = ok ? x + (size_t)(a_pix[i] + ih * a.w + iw) * a.cin + c0 + acol : x;
        ptx::cp_async16(ptx::smem_u32(As + r * LDA + acol), src, ok);
      }
    } else {
      // the flattened (tap, channel) index k = k0 + kk, walked incrementally
      const int r = tid % BM, kk0 = tid / BM;
      int k = k0 + kk0, tap = k / a.cin, c = k - tap * a.cin;
      int dh = tap / a.kw, dw = tap - dh * a.kw;
#pragma unroll
      for (int e = 0; e < GA_N; ++e) {
        const int ih = a_ih[0] + dh, iw = a_iw[0] + dw;
        const bool ok = k < a.k && (unsigned)ih < (unsigned)a.h && (unsigned)iw < (unsigned)a.w;
        copy_elem(As + r * LDA + kk0 + e * GA_STR,
                  ok ? x + (size_t)(a_pix[0] + ih * a.w + iw) * a.cin + c : x, ok);
        k += GA_STR;
        c += GA_STR;
        while (c >= a.cin) {
          c -= a.cin;
          if (++dw == a.kw) { dw = 0; ++dh; }
        }
      }
    }
    if (bvec) {
#pragma unroll
      for (int i = 0; i < B_IT; ++i) {
        const int r = brow + i * B_DR;
        if (B_IT * B_DR > BK && r >= BK) continue;
        const bool ok = k0 + r < a.k && n0 + bcol < a.cout;
        ptx::cp_async16(ptx::smem_u32(Bs + r * LDB + bcol),
                        ok ? w + (size_t)(k0 + r) * a.cout + n0 + bcol : w, ok);
      }
    } else {
      const int cc = tid % BN, kr0 = tid / BN;
#pragma unroll
      for (int e = 0; e < GB_N; ++e) {
        const int r = kr0 + e * GB_STR;
        const bool ok = k0 + r < a.k && n0 + cc < a.cout;
        copy_elem(Bs + r * LDB + cc, ok ? w + (size_t)(k0 + r) * a.cout + n0 + cc : w, ok);
      }
    }
  };

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) issue(i);
    ptx::cp_async_commit();
  }
  const int g = lane / 4, t = lane % 4;                       // f32 fragments
  const int lrow = lane % 8 + ((lane / 8) & 1) * 8, lcol = (lane / 16) * 8;  // ldmatrix
  for (int i = 0; i < nst; ++i) {
    ptx::cp_async_wait<STAGES - 2>();            // step i landed
    __syncthreads();                             // ... and step i - 1 consumed
    if (i + STAGES - 1 < nst) issue(i + STAGES - 1);
    ptx::cp_async_commit();
    const T* As = ring + (i % STAGES) * STAGE;
    const T* Bs = As + A_ELEMS;
    if constexpr (F32) {
      // 3xTF32 over four k8 steps: B's fragments split once per step, each
      // A fragment split as it is loaded.  A k8 step's three products go
      // into a zeroed fragment, added to the accumulator by a rounded f32
      // add: the tensor cores' own accumulation does not round to nearest,
      // and over K / 8 steps into one running sum its error would grow past
      // an f32 sum's (PERF.md)
      const float* ab = reinterpret_cast<const float*>(As) + (wm * WTM + g) * LDA + t;
      const float* bb = reinterpret_cast<const float*>(Bs) + t * LDB + wn * WTN + g;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t bh[FN][2], bl[FN][2];
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) {
          ptx::split_tf32(bb[ks * 8 * LDB + fn * 8], bh[fn][0], bl[fn][0]);
          ptx::split_tf32(bb[(ks * 8 + 4) * LDB + fn * 8], bh[fn][1], bl[fn][1]);
        }
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          const float* ap = ab + fm * 16 * LDA + ks * 8;
          uint32_t ah[4], al[4];
          ptx::split_tf32(ap[0], ah[0], al[0]);
          ptx::split_tf32(ap[8 * LDA], ah[1], al[1]);
          ptx::split_tf32(ap[4], ah[2], al[2]);
          ptx::split_tf32(ap[8 * LDA + 4], ah[3], al[3]);
#pragma unroll
          for (int fn = 0; fn < FN; ++fn) {
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            ptx::mma1688_tf32(p, al, bh[fn][0], bh[fn][1]);
            ptx::mma1688_tf32(p, ah, bl[fn][0], bl[fn][1]);
            ptx::mma1688_tf32(p, ah, bh[fn][0], bh[fn][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[fm][fn][e] += p[e];
          }
        }
      }
    } else {
      // bf16 over two k16 steps: A plain and B transposed by ldmatrix, as
      // in matmul.cu
      const uint32_t a_addr = ptx::smem_u32(As + (wm * WTM + lrow) * LDA + lcol);
      const uint32_t b_addr = ptx::smem_u32(Bs + lrow * LDB + wn * WTN + lcol);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t b[FN / 2][4];
#pragma unroll
        for (int fn = 0; fn < FN / 2; ++fn)
          ptx::ldsm_x4_trans(b[fn], b_addr + (uint32_t)((ks * 16 * LDB + fn * 16) * 2));
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          uint32_t af[4];
          ptx::ldsm_x4(af, a_addr + (uint32_t)((fm * 16 * LDA + ks * 16) * 2));
#pragma unroll
          for (int fn = 0; fn < FN / 2; ++fn) {
            ptx::mma16816(acc[fm][2 * fn], af, b[fn][0], b[fn][1]);
            ptx::mma16816(acc[fm][2 * fn + 1], af, b[fn][2], b[fn][3]);
          }
        }
      }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // accumulators -> the f32 tile: rows g and g + 8 of each m16 block,
  // columns 2t and 2t + 1 of each n8 block
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      const int r = wm * WTM + fm * 16 + g, c = wn * WTN + fn * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * LDC + c) = make_float2(acc[fm][fn][0], acc[fm][fn][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * LDC + c) =
          make_float2(acc[fm][fn][2], acc[fm][fn][3]);
    }
  __syncthreads();

  // epilogue: with split > 1 this CTA's partial goes to the workspace
  // (S, M, Cout) first, and only the CTA that arrives last on the tile's
  // counter finishes, from the S partials summed in split order
  const int cols = min(BN, a.cout - n0);
  const size_t mn = (size_t)a.m * a.cout;
  if (a.split > 1) {
    float* part = ws + (size_t)s * mn;
    for (int e = tid; e < rows * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (c < cols) part[(size_t)(m0 + r) * a.cout + n0 + c] = Cs[r * LDC + c];
    }
    if (!ptx::arrive_last(counters + blockIdx.y * gridDim.x + blockIdx.x, a.split, &flag))
      return;
  }
  constexpr int SB = 8;                          // partial loads in flight
  for (int e = tid; e < rows * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    if (c >= cols) continue;
    const size_t o = (size_t)(m0 + r) * a.cout + n0 + c;
    float v = 0.f;
    if (a.split == 1) {
      v = Cs[r * LDC + c];
    } else {
      for (int t0 = 0; t0 < a.split; t0 += SB) {
        float p[SB];
#pragma unroll
        for (int i = 0; i < SB; ++i)
          if (t0 + i < a.split) p[i] = __ldcg(ws + (size_t)(t0 + i) * mn + o);
#pragma unroll
        for (int i = 0; i < SB; ++i)
          if (t0 + i < a.split) v += p[i];
      }
    }
    if (bias != nullptr) v += bias[n0 + c];
    out[o] = from_float<T>(activate(v, a.act));
  }
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   float* ws, int* counters, const ConvArgs& a, cudaStream_t s) {
  constexpr int smem = smem_bytes<T, BM, BN>();
  const cudaError_t err = ptx::allow_smem<conv2d_kernel<T, BM, BN>>(smem);
  if (err != cudaSuccess) return err;
  // m-tiles fastest: the CTAs that share a weight slab run together
  dim3 grid((a.m + a.rows - 1) / a.rows, (a.cout + BN - 1) / BN, a.split);
  conv2d_kernel<T, BM, BN><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(out), ws,
      counters, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int bm, int bn, const void* x, const void* w, const float* bias,
                        void* out, float* ws, int* counters, const ConvArgs& a,
                        cudaStream_t s) {
#define LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return launch<T, BM, BN>(x, w, bias, out, ws, counters, a, s);
  CONV_TILES(LAUNCH)
#undef LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// The geometry (bm, bn, rows, split) is kernels/conv2d.py::geometry's: a
// tile this library is built with, `rows` <= bm pixels per tile, and S
// splits of whole k-steps with none empty.  dtype: 0 = float32,
// 1 = bfloat16; bias (f32) may be null.  With split > 1, `ws` holds split x
// M x Cout f32 partials and `counters` one zeroed int per output tile (left
// zeroed at the end).  x and w must be 16-byte aligned.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a geometry the library
// cannot run).
extern "C" int conv2d_direct(const void* x, const void* w, const void* bias, void* out,
                             int n, int h, int wd, int cin, int cout, int kh, int kw,
                             int stride, int pad_top, int pad_left, int oh, int ow,
                             int bm, int bn, int rows, int split, int act, int dtype,
                             void* ws, void* counters, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      oh <= 0 || ow <= 0 || stride <= 0 || rows <= 0 || rows > bm || split < 1 ||
      act < 0 || act > 5)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.n = n; a.h = h; a.w = wd; a.cin = cin; a.cout = cout; a.kh = kh; a.kw = kw;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left; a.oh = oh; a.ow = ow;
  a.m = n * oh * ow;
  a.k = kh * kw * cin;
  a.rows = rows;
  a.nk = (a.k + BK - 1) / BK;
  a.sps = (a.nk + split - 1) / split;
  a.split = split;
  a.act = act;
  if (split > a.nk || (split - 1) * a.sps >= a.nk || split > 65535 ||
      (cout + bn - 1) / bn > 65535 || (split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tile<float>(bm, bn, x, w, b, out, wsf, cnt, a, s);
  if (dtype == 1) return (int)launch_tile<bf16>(bm, bn, x, w, b, out, wsf, cnt, a, s);
  return (int)cudaErrorInvalidValue;
}
