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
// Design: the grid is (query tile, KV head).  Instead of walking every
// (segment, block) pair and masking foreign segments to NEG_INF as the TPU
// grid does, a CTA finds the segments that intersect its tile and walks,
// for each, only the keys its rows can see: 0 .. (largest row position).
// Each row is active in exactly one segment pass — the rows of the other
// segments, and rows past the fill, are inactive in it and their softmax
// state does not move — so the result equals the Pallas kernel's (whose
// foreign blocks are annihilated by alpha = exp(NEG_INF - m) = 0) up to f32
// summation order.
//
// What bounds it on the card: a tile of nq query vectors does 4 * D flops
// per (vector, key) pair on the K/V rows it stages, i.e. nq flops per byte
// of bf16 KV it reads (32 at the serving tile), below the tensor cores'
// ~295 flops per byte: at the card's peak rates the bytes bound it.
//
// What the design does about it: tiles of up to 32 query vectors share
// each staged K/V row.  The bf16 instance runs the tensor-core tile of
// mma_attention.cuh (Q·Kᵀ and P·V on mma.sync m16n8k16, the online softmax
// in registers), which gathers KV tiles of PREFILL_BLOCK_KV keys row by row
// through the segment's block table into a two-stage cp.async ring — a
// tile is a multiple of 16 keys whatever the pool's block_size, and the
// next tile loads while this one computes; keys past a pass's last visible
// position are never read.  The f32 instance keeps the CUDA-core tile of
// paged_attention.cuh, one pool block per step (f32 products, exact to the
// f32 tolerance), chosen by dtype alone.
#include "mma_attention.cuh"

namespace {

constexpr int F32_MAXNQ = 32;          // query vectors (rows x G) per f32 CTA
constexpr int PREFILL_BLOCK_KV = 64;   // keys per staged tile of the bf16 instance

// Segment s's pass over this tile: rows [ra, rb) of the chunk (empty when
// the segment is idle or misses the tile), the first row's key position,
// and the pass's last visible key.
struct Pass {
  int ra, rb, qpos_a, kmax;
};

__device__ inline Pass segment_pass(const int* __restrict__ seg_info, int s, int r0,
                                    int rows, int bs, int nbt) {
  const int q0 = seg_info[3 * s], qn = seg_info[3 * s + 1];
  const int kv0 = seg_info[3 * s + 2];
  Pass p;
  p.ra = max(r0, q0);
  p.rb = qn > 0 ? min(r0 + rows, q0 + qn) : p.ra;
  p.qpos_a = kv0 + p.ra - q0;
  p.kmax = min(p.qpos_a + p.rb - 1 - p.ra, nbt * bs - 1);
  return p;
}

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
  paged::Tile<T, F32_MAXNQ> tile;
  tile.init(smem, rows * g, d, bs, g, scale);
  tile.load_q(q, r0, n_heads, h);
  for (int s = 0; s < ns; ++s) {
    const Pass p = segment_pass(seg_info, s, r0, rows, bs, nbt);
    if (p.ra >= p.rb || p.kmax < 0) continue;
    const paged::PagedKV kv{seg_tables + (size_t)s * nbt, bs, hkv, d, h};
    tile.attend(k_pool, v_pool, kv, p.kmax / bs + 1, (p.ra - r0) * g,
                (p.rb - r0) * g, p.qpos_a, p.kmax);
  }
  tile.store(out, r0, n_heads, h);
}

template <int DMAX>
__global__ void __launch_bounds__(mma::THREADS)
paged_prefill_mma_kernel(const mma::bf16* __restrict__ q,
                         const mma::bf16* __restrict__ k_pool,
                         const mma::bf16* __restrict__ v_pool,
                         const int* __restrict__ seg_tables,
                         const int* __restrict__ seg_info, mma::bf16* __restrict__ out,
                         int c, int n_heads, int hkv, int d, int bs, int nbt, int ns,
                         int block_q, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int g = n_heads / hkv;
  // a segment's last rows see the most keys: start the last tiles first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * block_q;
  const int rows = min(block_q, c - r0);
  mma::Tile<DMAX, mma::step_keys(PREFILL_BLOCK_KV) / 16> tile;
  tile.init(smem, rows * g, d, PREFILL_BLOCK_KV, g, scale);
  tile.load_q(q, r0, n_heads, h);
  for (int s = 0; s < ns; ++s) {
    const Pass p = segment_pass(seg_info, s, r0, rows, bs, nbt);
    if (p.ra >= p.rb || p.kmax < 0) continue;
    const paged::PagedKV kv{seg_tables + (size_t)s * nbt, bs, hkv, d, h};
    tile.attend(k_pool, v_pool, kv, (p.ra - r0) * g, (p.rb - r0) * g, p.qpos_a,
                p.kmax);
  }
  tile.store(out, r0, n_heads, h);
}

// Launch the bf16 instance <DMAX>; its shared-memory attribute allows its
// largest layout (MAX_NQ vectors, KV tiles of PREFILL_BLOCK_KV keys).
template <int DMAX>
cudaError_t launch_mma(dim3 grid, size_t smem, cudaStream_t s, const mma::bf16* q,
                       const mma::bf16* k_pool, const mma::bf16* v_pool,
                       const int* seg_tables, const int* seg_info, mma::bf16* out,
                       int c, int n_heads, int hkv, int d, int bs, int nbt, int ns,
                       int block_q, float scale) {
  const cudaError_t err = mma::allow_smem<paged_prefill_mma_kernel<DMAX>>(
      mma::layout(mma::MAX_NQ, PREFILL_BLOCK_KV, DMAX).bytes);
  if (err != cudaSuccess) return err;
  paged_prefill_mma_kernel<DMAX><<<grid, mma::THREADS, smem, s>>>(
      q, k_pool, v_pool, seg_tables, seg_info, out, c, n_heads, hkv, d, bs, nbt, ns,
      block_q, scale);
  return cudaGetLastError();
}

typedef cudaError_t (*MmaLaunch)(dim3, size_t, cudaStream_t, const mma::bf16*,
                                 const mma::bf16*, const mma::bf16*, const int*,
                                 const int*, mma::bf16*, int, int, int, int, int, int,
                                 int, int, float);

}  // namespace

// dtype: 0 = float32 (CUDA-core tile), 1 = bfloat16 (tensor-core tile).
// Returns the launch's cudaError_t.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* seg_tables,
                                       const void* seg_info, void* out, int c,
                                       int n_heads, int hkv, int d, int bs, int nbt,
                                       int ns, int block_q, float scale, int dtype,
                                       void* stream) {
  if (hkv < 1 || n_heads % hkv || block_q < 1 || bs < 1 || d > paged::MAX_D || d % 8)
    return (int)cudaErrorInvalidValue;
  const int g = n_heads / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + block_q - 1) / block_q, hkv);
  const int* tables = static_cast<const int*>(seg_tables);
  const int* info = static_cast<const int*>(seg_info);
  if (dtype == 0) {
    if (block_q * g > F32_MAXNQ) return (int)cudaErrorInvalidValue;
    const size_t smem = paged::layout<float>(block_q * g, bs, d).bytes;
    cudaError_t err = paged::set_smem(paged_prefill_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_prefill_kernel<float><<<grid, paged::THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), tables, info, static_cast<float*>(out), c,
        n_heads, hkv, d, bs, nbt, ns, block_q, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || block_q * g > mma::MAX_NQ) return (int)cudaErrorInvalidValue;
  const size_t smem = mma::layout(block_q * g, PREFILL_BLOCK_KV, d).bytes;
  const MmaLaunch launch = d <= 64 ? launch_mma<64> : d <= 128 ? launch_mma<128>
                                                              : launch_mma<256>;
  return (int)launch(grid, smem, s, static_cast<const mma::bf16*>(q),
                     static_cast<const mma::bf16*>(k_pool),
                     static_cast<const mma::bf16*>(v_pool), tables, info,
                     static_cast<mma::bf16*>(out), c, n_heads, hkv, d, bs, nbt, ns,
                     block_q, scale);
}
