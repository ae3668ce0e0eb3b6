// Segment-packed paged prefill attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_prefill_paged (kernel body
// _paged_prefill_kernel), reached through repro.kernels.ops.attention_prefill_packed.
//
// The query buffer q (C, H, D) is one prompt chunk packed with contiguous
// segments from up to S requests: segment s occupies rows
// [row_offset, row_offset + seg_len) of the chunk (seg_info[s]) and its first
// row sits at absolute position kv_start of its own request, whose KV blocks
// seg_tables[s, :] names (the chunk's own K/V rows are already committed to
// the pool).  Chunk row r of segment s attends causally to key positions
// kpos <= kv_start + r - row_offset of its OWN request; co-packed segments
// never see each other.  Online softmax with f32 statistics, f32 Q·Kᵀ and
// P·V accumulation and probabilities rounded to the value dtype before P·V,
// as in the Pallas kernel.  Rows past the packed fill attend to nothing and
// come out as zeros (finite: their K/V feed the sink block in later layers).
//
// Design (option 2 of the port plan): the grid is (query tile, KV head).
// Instead of walking every (segment, block) pair and masking foreign
// segments to NEG_INF as the TPU grid does, a CTA finds the segments that
// intersect its tile and walks, for each, only the blocks its rows can see:
// 0 .. (largest row position) / block_size.  Each row is visited by exactly
// one segment pass, so the result equals the Pallas kernel's (whose foreign
// blocks are annihilated by alpha = exp(NEG_INF - m) = 0) up to f32
// summation order.
//
// What bounds it on the card: a tile of nq query vectors does 4 * D flops
// per (vector, key) pair on the K/V rows it stages, i.e. nq flops per byte
// of bf16 KV it reads (32 at the serving tile).  That is below the tensor
// cores' ~295 flops per byte, so at the card's peak rates the bytes bound
// it; but this first version does the products on the CUDA cores in f32
// (one thread per score, one per output column), whose ~67 TFLOP/s put the
// crossover near 20 flops per byte, so in practice the arithmetic bounds
// it.  The f32 products keep the f32 path exact and the kernel simple;
// moving Q·Kᵀ and P·V onto the tensor cores (mma / wgmma on bf16 tiles) is
// the work of a later change.  What it does about the bound today: tiles of
// up to 32 query vectors share each staged K/V block, shared-memory rows are
// padded so the score threads never conflict on a bank, and blocks above a
// tile's diagonal are never loaded.
#include "paged_attention.cuh"

namespace {

constexpr int PREFILL_MAXNQ = 32;   // query vectors (rows x G) per CTA

template <typename T>
__global__ void __launch_bounds__(paged::THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ seg_tables,
                     const int* __restrict__ seg_info, T* __restrict__ out, int c,
                     int n_heads, int hkv, int d, int bs, int nbt, int ns,
                     int block_q, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int g = n_heads / hkv;
  const int r0 = blockIdx.x * block_q;
  const int rows = min(block_q, c - r0);
  paged::Tile<T, PREFILL_MAXNQ> tile;
  tile.init(smem, rows * g, d, bs, g, scale);
  tile.load_q(q, r0, n_heads, h);
  for (int s = 0; s < ns; ++s) {
    const int q0 = seg_info[3 * s], qn = seg_info[3 * s + 1];
    const int kv0 = seg_info[3 * s + 2];
    const int ra = max(r0, q0), rb = min(r0 + rows, q0 + qn);
    if (qn <= 0 || ra >= rb) continue;     // idle segment or not in this tile
    const int qpos_a = kv0 + ra - q0;
    const int nblk = min(nbt, (kv0 + rb - 1 - q0) / bs + 1);
    const paged::PagedKV kv{seg_tables + (size_t)s * nbt, bs, hkv, d, h};
    tile.attend(k_pool, v_pool, kv, nblk, (ra - r0) * g, (rb - r0) * g, qpos_a,
                qpos_a + rb - 1 - ra);
  }
  tile.store(out, r0, n_heads, h);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* seg_tables, const void* seg_info, void* out, int c,
                   int n_heads, int hkv, int d, int bs, int nbt, int ns, int block_q,
                   float scale, cudaStream_t stream) {
  const int g = n_heads / hkv;
  const size_t smem = paged::layout<T>(block_q * g, bs, d).bytes;
  cudaError_t err = paged::set_smem(paged_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((c + block_q - 1) / block_q, hkv);
  paged_prefill_kernel<T><<<grid, paged::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(seg_tables),
      static_cast<const int*>(seg_info), static_cast<T*>(out), c, n_heads, hkv, d,
      bs, nbt, ns, block_q, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* seg_tables,
                                       const void* seg_info, void* out, int c,
                                       int n_heads, int hkv, int d, int bs, int nbt,
                                       int ns, int block_q, float scale, int dtype,
                                       void* stream) {
  if (n_heads % hkv || block_q < 1 || block_q * (n_heads / hkv) > PREFILL_MAXNQ ||
      d > paged::MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pool, v_pool, seg_tables, seg_info, out, c,
                              n_heads, hkv, d, bs, nbt, ns, block_q, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, seg_tables, seg_info, out,
                                      c, n_heads, hkv, d, bs, nbt, ns, block_q,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
