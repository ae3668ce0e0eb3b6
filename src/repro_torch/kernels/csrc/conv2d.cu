// Direct NHWC convolution with a fused bias + activation epilogue for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/conv2d.py::conv2d_direct (kernel body
// _conv_kernel), reached through repro.kernels.ops.conv2d and the
// `pallas_conv2d` backend of repro.core.engine.
//
// out (N, OH, OW, Cout) = act(conv(x (N, H, W, Cin), w (Kh·Kw·Cin, Cout)) +
// bias (Cout)), x NHWC and w the HWIO weights viewed as a matrix, with an
// f32 accumulator and the bias (f32) and activation applied in f32 before
// the one rounding to the output dtype — the Pallas kernel's epilogue.
// Activations: the codes of activation.cuh.  f32 and bf16 inputs; bf16 is
// widened to f32 on its way into shared memory, so the products are exact
// and only the summation order differs from an f32 reference.
//
// The TPU kernel keeps the whole padded image in VMEM and is handed a
// padded copy.  Here SAME padding is done in the kernel: the halo loads are
// masked at TensorFlow's offsets (pad_top = pad_h / 2, the odd row below),
// so no padded copy is written.  A block owns `row_block` whole output rows
// of one image and a `BN`-wide slice of the output channels (grid x: Cout
// tiles, grid y: image x row block).  It walks the input channels in chunks
// of `bc`; for each chunk it stages in shared memory the input halo its rows
// read ((row_block-1)·stride + Kh rows × (OW-1)·stride + Kw columns × bc,
// channel-major so that neighbouring output pixels read neighbouring words)
// and the Kh·Kw·bc × BN weight slice, then every thread accumulates its
// TM pixels × TN channels register tile over the chunk's taps.  The weight
// matrix cannot stay whole in shared memory (3·3·512 × 64 × 4 B = 1.2 MB
// for ResNet-18's last stage), hence the chunked K loop.  Thread (tr, tc)
// owns pixels tr + i·ROWS and channels tc + j·COLS: a warp reads one or a
// few broadcast halo words and consecutive weight words, and stores
// consecutive channels.
//
// What bounds it on the card: at batch 1 in f32, operations.  ResNet-18 is
// about 1.8 G multiply-adds (3.6 GFLOP) per image against 67 TFLOP/s of
// FP32 on the CUDA cores, about 0.054 ms, while its bytes (weights 45 MB,
// activations a few MB) take about 0.015 ms at 3.35 TB/s.  This first
// version runs on the CUDA cores with no cp.async / TMA overlap of the next
// chunk's loads, and every multiply-add reads shared memory
// ((TM + TN) loads per TM·TN FMAs), so it stays well below that rate;
// tensor cores (TF32 or bf16 wgmma) and a pipelined K loop are for a later
// change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_torch::activate;
using repro_torch::from_float;
using repro_torch::to_float;

constexpr int THREADS = 256;
constexpr int TN = 4;

struct ConvArgs {
  int n, h, w, cin, cout, kh, kw, stride, pad_top, pad_left, oh, ow;
  int row_block, n_row_blocks, bc, hr, wc, act;
};

template <typename T, int BN, int TM>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ out, ConvArgs a) {
  constexpr int COLS = BN / TN;          // threads across the channel tile
  constexpr int ROWS = THREADS / COLS;   // threads across the pixels
  extern __shared__ float smem[];
  float* xs = smem;                                  // [bc][hr][wc]
  float* ws = smem + a.bc * a.hr * a.wc;             // [Kh·Kw][bc][BN]

  const int tid = threadIdx.x, tc = tid % COLS, tr = tid / COLS;
  const int c0 = blockIdx.x * BN;
  const int img = blockIdx.y / a.n_row_blocks;
  const int oh0 = (blockIdx.y % a.n_row_blocks) * a.row_block;
  const int m_tile = a.row_block * a.ow;
  const int ih0 = oh0 * a.stride - a.pad_top;
  const int iw0 = -a.pad_left;
  const int taps = a.kh * a.kw;

  // each pixel's offset into one channel plane of the halo (tap 0);
  // pixels past the tile read offset 0 and are not stored
  int poff[TM];
  bool pvalid[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = tr + i * ROWS;
    const int r = p / a.ow, q = p % a.ow;
    pvalid[i] = p < m_tile && oh0 + r < a.oh;
    poff[i] = pvalid[i] ? r * a.stride * a.wc + q * a.stride : 0;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int plane = a.hr * a.wc;
  for (int cs = 0; cs < a.cin; cs += a.bc) {
    const int nc = min(a.bc, a.cin - cs);
    // input halo, zero outside the image (the SAME padding)
    for (int e = tid; e < nc * plane; e += THREADS) {
      const int c = e % nc, rest = e / nc;
      const int q = rest % a.wc, r = rest / a.wc;
      const int ih = ih0 + r, iw = iw0 + q;
      float v = 0.f;
      if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w)
        v = to_float(x[(((size_t)img * a.h + ih) * a.w + iw) * a.cin + cs + c]);
      xs[c * plane + r * a.wc + q] = v;
    }
    // weight slice: rows (tap, cs + c) of the (Kh·Kw·Cin, Cout) matrix
    for (int e = tid; e < taps * nc * BN; e += THREADS) {
      const int j = e % BN, rest = e / BN;
      const int c = rest % nc, t = rest / nc;
      const int co = c0 + j;
      ws[e] = co < a.cout ? to_float(w[((size_t)t * a.cin + cs + c) * a.cout + co]) : 0.f;
    }
    __syncthreads();
    for (int dh = 0; dh < a.kh; ++dh) {
      for (int dw = 0; dw < a.kw; ++dw) {
        const float* xt = xs + dh * a.wc + dw;
        const float* wt = ws + (dh * a.kw + dw) * nc * BN + tc;
        for (int c = 0; c < nc; ++c) {
          float wv[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) wv[j] = wt[c * BN + j * COLS];
          const float* xc = xt + c * plane;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xv = xc[poff[i]];
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (!pvalid[i]) continue;
    const int p = tr + i * ROWS;
    const int oh = oh0 + p / a.ow, q = p % a.ow;
    T* o = out + (((size_t)img * a.oh + oh) * a.ow + q) * a.cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = c0 + tc + j * COLS;
      if (co >= a.cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[co];
      o[co] = from_float<T>(activate(v, a.act));
    }
  }
}

template <typename T, int BN, int TM>
int launch(const void* x, const void* w, const float* bias, void* out,
           const ConvArgs& a, int smem, cudaStream_t s) {
  auto kernel = conv2d_kernel<T, BN, TM>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a.cout + BN - 1) / BN, a.n * a.n_row_blocks);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(w), bias,
                                     static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_tm(int tm, const void* x, const void* w, const float* bias,
              void* out, const ConvArgs& a, int smem, cudaStream_t s) {
  switch (tm) {
    case 2: return launch<T, BN, 2>(x, w, bias, out, a, smem, s);
    case 4: return launch<T, BN, 4>(x, w, bias, out, a, smem, s);
    case 8: return launch<T, BN, 8>(x, w, bias, out, a, smem, s);
    case 16: return launch<T, BN, 16>(x, w, bias, out, a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_bn(int bn, int tm, const void* x, const void* w, const float* bias,
              void* out, const ConvArgs& a, int smem, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_tm<T, 16>(tm, x, w, bias, out, a, smem, s);
    case 32: return launch_tm<T, 32>(tm, x, w, bias, out, a, smem, s);
    case 64: return launch_tm<T, 64>(tm, x, w, bias, out, a, smem, s);
    case 128: return launch_tm<T, 128>(tm, x, w, bias, out, a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch geometry (tm, bc, smem_bytes) is computed by the Python
// wrapper (kernels/conv2d.py::geometry) and validated there against the
// chip's limits.  dtype: 0 = float32, 1 = bfloat16; bias (f32) may be null.
// Returns the launch's cudaError_t.
extern "C" int conv2d_direct(const void* x, const void* w, const void* bias,
                             void* out, int n, int h, int wd, int cin, int cout,
                             int kh, int kw, int stride, int pad_top,
                             int pad_left, int oh, int ow, int row_block, int bn,
                             int tm, int bc, int smem_bytes, int act, int dtype,
                             void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || oh <= 0 || ow <= 0 || stride <= 0 ||
      row_block <= 0 || bc <= 0 || act < 0 || act > 5)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.n = n; a.h = h; a.w = wd; a.cin = cin; a.cout = cout; a.kh = kh; a.kw = kw;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.oh = oh; a.ow = ow; a.row_block = row_block;
  a.n_row_blocks = (oh + row_block - 1) / row_block;
  a.bc = bc; a.hr = (row_block - 1) * stride + kh; a.wc = (ow - 1) * stride + kw;
  a.act = act;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bn<float>(bn, tm, x, w, b, out, a, smem_bytes, s);
  if (dtype == 1) return launch_bn<bf16>(bn, tm, x, w, b, out, a, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
