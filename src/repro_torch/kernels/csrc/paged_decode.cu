// Paged decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_decode_paged (kernel body
// _paged_decode_kernel), reached through repro.kernels.ops.attention_decode_paged.
//
// Computes, for every slot b and KV head h, the attention of the slot's one
// new token — its G = H / Hkv query heads of KV head h — over the first
// lengths[b] rows of the slot's KV, read from the shared block pool through
// block_tables[b, :].  Online softmax with f32 max / denominator /
// accumulator; Q·Kᵀ and P·V accumulate in f32 and the probabilities are
// rounded to the value dtype before P·V, as in the Pallas kernel.  Blocks
// past the length are never read; a length of 0 gives zeros.  Inactive
// serving slots carry all-null tables and length 1: they read the sink
// block 0 and their output is discarded by the caller.
//
// What bounds it on the card: bytes.  Each slot reads its K and V rows once
// (2 * length * D * 2 bytes per KV head in bf16) and does ~4 * G * D flops
// per key row — about 2 flops per byte at G = 2, far below the ~295 flops
// per byte where the H100's tensor cores would become the limit.
//
// What the design does about it: the grid is (slot, KV head), so each KV
// row is read from device memory exactly once and shared by the G query
// heads of its group (GQA is never expanded); the K and V rows of a block
// arrive with 16-byte loads, contiguous across threads, and nothing but the
// output is written.  This first version walks a slot's blocks inside one
// CTA without overlapping the next block's load with the current block's
// math, and at 8 slots x 8 KV heads it fills 64 of the 132 SMs; splitting a
// long context across CTAs with a combine step is left for a later change.
#include "paged_attention.cuh"

namespace {

constexpr int DECODE_MAXNQ = 16;   // G = H / Hkv query heads per CTA

template <typename T>
__global__ void __launch_bounds__(paged::THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int n_heads, int hkv, int d, int bs, int nbt, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = n_heads / hkv;
  paged::Tile<T, DECODE_MAXNQ> tile;
  tile.init(smem, g, d, bs, g, scale);
  tile.load_q(q, b, n_heads, h);
  const int len = lengths[b];
  if (len > 0) {
    const int nblk = min(nbt, (len - 1) / bs + 1);
    const paged::PagedKV kv{tables + (size_t)b * nbt, bs, hkv, d, h};
    tile.attend(k_pool, v_pool, kv, nblk, 0, g, len - 1, len - 1);
  }
  tile.store(out, b, n_heads, h);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* lengths, const void* tables, void* out, int batch,
                   int n_heads, int hkv, int d, int bs, int nbt, float scale,
                   cudaStream_t stream) {
  const int g = n_heads / hkv;
  const size_t smem = paged::layout<T>(g, bs, d).bytes;
  cudaError_t err = paged::set_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch, hkv);
  paged_decode_kernel<T><<<grid, paged::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<T*>(out), n_heads, hkv, d, bs,
      nbt, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* lengths,
                                      const void* tables, void* out, int batch,
                                      int n_heads, int hkv, int d, int bs, int nbt,
                                      float scale, int dtype, void* stream) {
  if (n_heads % hkv || n_heads / hkv > DECODE_MAXNQ || d > paged::MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pool, v_pool, lengths, tables, out, batch,
                              n_heads, hkv, d, bs, nbt, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, lengths, tables, out,
                                      batch, n_heads, hkv, d, bs, nbt, scale, s);
  return (int)cudaErrorInvalidValue;
}
