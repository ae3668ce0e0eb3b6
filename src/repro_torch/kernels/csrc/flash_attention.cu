// Dense flash attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_attention_padded (kernel body
// _flash_kernel), reached through repro.kernels.ops.attention.
//
// q (B, Sq, H, D) against k, v (B, Skv, Hkv, D) -> (B, Sq, H, D); query head
// h reads KV head h / (H / Hkv), and K/V are never repeated per query head.
// Q·Kᵀ accumulates in f32 and is scaled; the causal mask is aligned at the
// top left, as the Pallas kernel's is (query row i sees keys 0..i, whatever
// Skv), and KV blocks wholly above a tile's diagonal are never loaded.
// Online softmax with f32 max / denominator / accumulator; the
// probabilities are rounded to V's dtype before P·V, which accumulates in
// f32; a row that sees no key comes out as zeros.  Unlike the Pallas
// wrapper, which pads Sq and Skv to its blocks (and for a non-causal call
// with a ragged Skv falls back to the XLA oracle), this kernel masks the
// ragged edges itself and reads no padded copy.
//
// What bounds it on the card: at the serving shapes (D = 128, Sq up to 700)
// a causal call does 2 * D flops per (query head, visible key) for each of
// Q·Kᵀ and P·V on inputs it could read once: hundreds of flops per byte,
// so at the card's peak rates the tensor cores' 989 TFLOP/s would bound a
// long prefill and the bytes a short one (a decode row sees a single key
// under the top-left mask).  This first version does the products on the
// CUDA cores in f32 (one thread per score, one per output column), which
// bounds it far above either: ~67 TFLOP/s, with two shared-memory reads
// per FMA.
//
// What the design does about it: it reuses the online-softmax tile of the
// paged kernels (paged_attention.cuh) with dense addressing.  The grid is
// (query tile, KV head, batch): a tile of block_q rows x G query heads
// (at most 32 vectors) shares every K/V block it stages, so each K/V row is
// read from device memory once per query tile rather than once per query
// head; rows are staged with 16-byte loads, shared-memory K rows are padded
// so the score threads never conflict on a bank, and the causal walk stops
// at the tile's last row.  Moving Q·Kᵀ and P·V onto the tensor cores (mma /
// wgmma on bf16 tiles) is the work of a later change.
#include "paged_attention.cuh"

namespace {

constexpr int FLASH_MAXNQ = 32;   // query vectors (rows x G) per CTA

template <typename T>
__global__ void __launch_bounds__(paged::THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int skv, int n_heads, int hkv, int d, int block_q,
                       int block_kv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = n_heads / hkv;
  const int r0 = blockIdx.x * block_q;
  const int rows = min(block_q, sq - r0);
  const size_t qoff = (size_t)b * sq * n_heads * d;
  paged::Tile<T, FLASH_MAXNQ> tile;
  tile.init(smem, rows * g, d, block_kv, g, scale);
  tile.load_q(q + qoff, r0, n_heads, h);
  if (skv > 0) {
    // causal: row r0 + i sees keys 0..r0 + i; otherwise every row sees all
    const int kmax = causal ? min(r0 + rows - 1, skv - 1) : skv - 1;
    const int qpos_a = causal ? r0 : kmax;
    const paged::DenseKV kv{(size_t)b * skv * hkv * d, block_kv, hkv, d, h};
    tile.attend(k, v, kv, kmax / block_kv + 1, 0, rows * g, qpos_a, kmax);
  }
  tile.store(out + qoff, r0, n_heads, h);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int sq, int skv, int n_heads, int hkv, int d,
                   int block_q, int block_kv, int causal, float scale,
                   cudaStream_t stream) {
  const int g = n_heads / hkv;
  const size_t smem = paged::layout<T>(block_q * g, block_kv, d).bytes;
  cudaError_t err = paged::set_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + block_q - 1) / block_q, hkv, batch);
  flash_attention_kernel<T><<<grid, paged::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, n_heads, hkv, d, block_q, block_kv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int sq, int skv, int n_heads,
                               int hkv, int d, int block_q, int block_kv,
                               int causal, float scale, int dtype, void* stream) {
  if (batch < 1 || sq < 1 || skv < 0 || hkv < 1 || n_heads % hkv ||
      block_q < 1 || block_kv < 1 || block_q * (n_heads / hkv) > FLASH_MAXNQ ||
      d > paged::MAX_D || d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, batch, sq, skv, n_heads, hkv, d,
                              block_q, block_kv, causal, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, batch, sq, skv, n_heads, hkv,
                                      d, block_q, block_kv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
