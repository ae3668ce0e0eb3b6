// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_decode_padded (kernel body
// _decode_kernel), reached through repro.kernels.ops.attention_decode.
//
// One new token per sequence: q (B, H, D) against the first lengths[b] rows
// of each sequence's dense caches k, v (B, S, Hkv, D) -> (B, H, D).  Online
// softmax with f32 max / denominator / accumulator; Q·Kᵀ and P·V accumulate
// in f32 and the probabilities are rounded to the value dtype before P·V,
// as in the Pallas kernel.  Blocks past the length are never read; a
// length of 0 gives zeros (lengths past S are taken as S).
//
// What bounds it on the card: bytes.  Each sequence reads its K and V rows
// once (2 * length * D * 2 bytes per KV head in bf16) and does ~4 * G * D
// flops per key row — about 2 flops per byte at G = 2, far below the ~295
// flops per byte where the H100's tensor cores would become the limit.
//
// What the design does about it: one launch with the KV head in the grid,
// (sequence, KV head), where the Pallas wrapper launches one kernel per KV
// head from a Python loop; each K/V row is read from device memory once and
// shared by the G query heads of its group, with 16-byte loads contiguous
// across threads, and nothing but the output is written.  It is the paged
// decode kernel's CTA (paged_attention.cuh) with dense addressing, and
// shares its limits: no overlap of the next block's load with the current
// block's math, and B x Hkv CTAs (64 of the 132 SMs at 8 sequences x 8 KV
// heads); splitting a long context across CTAs is left for a later change.
#include "paged_attention.cuh"

namespace {

constexpr int DECODE_MAXNQ = 16;   // G = H / Hkv query heads per CTA

template <typename T>
__global__ void __launch_bounds__(paged::THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int s, int n_heads, int hkv, int d,
                    int block_kv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = n_heads / hkv;
  paged::Tile<T, DECODE_MAXNQ> tile;
  tile.init(smem, g, d, block_kv, g, scale);
  tile.load_q(q, b, n_heads, h);
  const int len = min(max(lengths[b], 0), s);
  if (len > 0) {
    const paged::DenseKV kv{(size_t)b * s * hkv * d, block_kv, hkv, d, h};
    tile.attend(k, v, kv, (len - 1) / block_kv + 1, 0, g, len - 1, len - 1);
  }
  tile.store(out, b, n_heads, h);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int batch, int s, int n_heads,
                   int hkv, int d, int block_kv, float scale, cudaStream_t stream) {
  const int g = n_heads / hkv;
  const size_t smem = paged::layout<T>(g, block_kv, d).bytes;
  cudaError_t err = paged::set_smem(dense_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch, hkv);
  dense_decode_kernel<T><<<grid, paged::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), s, n_heads, hkv, d,
      block_kv, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int dense_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, int batch,
                                      int s, int n_heads, int hkv, int d,
                                      int block_kv, float scale, int dtype,
                                      void* stream) {
  if (batch < 1 || hkv < 1 || n_heads % hkv || n_heads / hkv > DECODE_MAXNQ ||
      block_kv < 1 || d > paged::MAX_D || d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, lengths, out, batch, s, n_heads, hkv, d,
                              block_kv, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, lengths, out, batch, s, n_heads, hkv,
                                      d, block_kv, scale, st);
  return (int)cudaErrorInvalidValue;
}
