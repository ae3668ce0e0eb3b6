// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_decode_padded (kernel body
// _decode_kernel), reached through repro.kernels.ops.attention_decode.
//
// One new token per sequence: q (B, H, D) against the first lengths[b] rows
// of each sequence's dense caches k, v (B, S, Hkv, D) -> (B, H, D).  Online
// softmax with f32 max / denominator / accumulator; Q·Kᵀ and P·V accumulate
// in f32 and the probabilities are rounded to the value dtype before P·V,
// as in the Pallas kernel.  Rows past the length are never read; a length
// of 0 gives zeros (lengths are taken within [0, S]).
//
// What bounds it on the card: bytes.  Each sequence reads its K and V rows
// once (2 * length * D * 2 bytes per KV head in bf16) and does ~4 * G * D
// flops per key row — about 2 flops per byte at G = 2, far below the ~295
// flops per byte where the H100's tensor cores would become the limit.  A
// call's few MB stream at the card's rate only if most SMs have rows in
// flight at once.
//
// What the design does about it: the split-KV body of split_decode.cuh,
// which paged decode runs, with dense row addressing (split::DenseRows: key
// t is row t of the sequence's slab, no table to read).  The grid is
// (sequence, KV head, split): split s takes key positions [s * kps,
// (s + 1) * kps), where the wrapper (kernels/attention.py::
// dense_decode_splits) picks kps and the split count from S alone — never
// from `lengths`, which would cost a device-to-host sync and break a CUDA
// graph capture.  At S = 1024 that is 8 splits of 128 keys: 8 x 8 x 8 = 512
// CTAs at 8 sequences x 8 KV heads, where one CTA per (sequence, KV head)
// gave 64 of the 132 SMs work.  Splits past a sequence's length exit at
// once; each split streams its rows in chunks through a two-stage cp.async
// ring, and the CTA that finishes a (sequence, KV head) last combines the
// partials in split order in the same launch (the same bits every run).
#include "split_decode.cuh"

namespace {

template <typename T, int MAXG, int DMAX>
__global__ void __launch_bounds__(split::THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ counters, int s, int n_heads, int hkv, int d,
                    int kps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int len = min(max(lengths[b], 0), s);
  const split::DenseRows rows{(size_t)b * s * hkv * d, hkv, d, h};
  split::decode_split<T, MAXG, DMAX>(smem, q, k, v, rows, out, ws, counters, b, h, sp,
                                     gridDim.z, kps, len, n_heads, n_heads / hkv, d,
                                     scale, (size_t)b * hkv + h);
}

template <typename T, int MAXG, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, void* ws, void* counters, int batch, int s, int n_heads,
                   int hkv, int d, int kps, int nsplit, float scale,
                   cudaStream_t stream) {
  const size_t smem = split::layout<T>(MAXG, DMAX).bytes;
  const cudaError_t err = ptx::allow_smem<dense_decode_kernel<T, MAXG, DMAX>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch, hkv, nsplit);
  dense_decode_kernel<T, MAXG, DMAX><<<grid, split::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), s, n_heads, hkv, d, kps, scale);
  return cudaGetLastError();
}

// the instance whose MAXG (1, 2, 4, 8 or 16) is the smallest >= g, and
// whose head-dim bound (64, 128 or 256) is the smallest >= d
template <typename T, int DMAX>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* ws, void* counters,
                     int batch, int s, int n_heads, int hkv, int d, int kps, int nsplit,
                     float scale, cudaStream_t st) {
#define ARGS q, k, v, lengths, out, ws, counters, batch, s, n_heads, hkv, d, kps, \
             nsplit, scale, st
  if (g <= 1) return launch<T, 1, DMAX>(ARGS);
  if (g <= 2) return launch<T, 2, DMAX>(ARGS);
  if (g <= 4) return launch<T, 4, DMAX>(ARGS);
  if (g <= 8) return launch<T, 8, DMAX>(ARGS);
  return launch<T, 16, DMAX>(ARGS);
#undef ARGS
}

template <typename T>
cudaError_t launch_d(int g, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* ws, void* counters,
                     int batch, int s, int n_heads, int hkv, int d, int kps, int nsplit,
                     float scale, cudaStream_t st) {
#define ARGS g, q, k, v, lengths, out, ws, counters, batch, s, n_heads, hkv, d, kps, \
             nsplit, scale, st
  switch (ptx::dmax_of(d)) {
    case 64: return launch_g<T, 64>(ARGS);
    case 128: return launch_g<T, 128>(ARGS);
    default: return launch_g<T, 256>(ARGS);
  }
#undef ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kps: keys per split; nsplit:
// ceil(s / kps).  With nsplit > 1, `ws` holds batch x hkv x
// split::unit_floats(nsplit, G, d) f32 and `counters` batch x hkv zeroed
// ints (left zeroed at the end).  Returns the launch's cudaError_t.
extern "C" int dense_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, int batch,
                                      int s, int n_heads, int hkv, int d, int kps,
                                      int nsplit, float scale, int dtype, void* ws,
                                      void* counters, void* stream) {
  if (batch < 1 || s < 1 || hkv < 1 || hkv > 65535 || n_heads % hkv ||
      n_heads / hkv > 16 || d > split::MAX_D || d % 8 || kps < 1 ||
      nsplit != (s + kps - 1) / kps || nsplit > 65535 ||
      (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = n_heads / hkv;
  if (dtype == 0)
    return (int)launch_d<float>(g, q, k, v, lengths, out, ws, counters, batch, s,
                                n_heads, hkv, d, kps, nsplit, scale, st);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(g, q, k, v, lengths, out, ws, counters, batch,
                                        s, n_heads, hkv, d, kps, nsplit, scale, st);
  return (int)cudaErrorInvalidValue;
}
