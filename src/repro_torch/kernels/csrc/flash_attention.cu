// Dense flash attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_attention_padded (kernel body
// _flash_kernel), reached through repro.kernels.ops.attention.
//
// q (B, Sq, H, D) against k, v (B, Skv, Hkv, D) -> (B, Sq, H, D); query head
// h reads KV head h / (H / Hkv), and K/V are never repeated per query head.
// Q·Kᵀ accumulates in f32 and is scaled; the causal mask is aligned at the
// top left, as the Pallas kernel's is (query row i sees keys 0..i, whatever
// Skv), and KV tiles wholly above a query tile's diagonal are never loaded.
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
// so at the card's peak rates the tensor cores' 989 TFLOP/s bound a long
// prefill and the bytes a short one (a decode row sees a single key under
// the top-left mask, so that call is bound by its launch).
//
// What the design does about it: the grid is (query tile, KV head, batch);
// a tile of block_q rows x G query heads (at most 32 vectors) shares every
// K/V tile it stages, so each K/V row is read from device memory once per
// query tile rather than once per query head, and the causal walk stops at
// the tile's last row.  The bf16 instance runs the tensor-core tile of
// mma_attention.cuh: Q·Kᵀ and P·V on mma.sync m16n8k16 with Q's fragments
// in registers, the online softmax in registers, and K/V tiles of block_kv
// keys (16, 32, 64 or 128; one instance per tile width and head-dim bound)
// in a two-stage cp.async ring, so the next tile loads while this one
// computes; the last query tiles, which see the most keys, start first.  The f32 instance keeps the CUDA-core
// tile of paged_attention.cuh (f32 products, exact to the f32 tolerance),
// chosen by dtype alone.
#include "mma_attention.cuh"

namespace {

constexpr int F32_MAXNQ = 32;            // query vectors (rows x G) per f32 CTA

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
  paged::Tile<T, F32_MAXNQ> tile;
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

template <int DMAX, int NCH>
__global__ void __launch_bounds__(mma::THREADS)
flash_mma_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                 const mma::bf16* __restrict__ v, mma::bf16* __restrict__ out,
                 int sq, int skv, int n_heads, int hkv, int d, int block_q,
                 int block_kv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = n_heads / hkv;
  // the last query tiles see the most keys under the causal mask: start them first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * block_q;
  const int rows = min(block_q, sq - r0);
  const size_t qoff = (size_t)b * sq * n_heads * d;
  mma::Tile<DMAX, NCH> tile;
  tile.init(smem, rows * g, d, block_kv, g, scale);
  tile.load_q(q + qoff, r0, n_heads, h);
  if (skv > 0) {
    const int kmax = causal ? min(r0 + rows - 1, skv - 1) : skv - 1;
    const int qpos_a = causal ? r0 : kmax;
    const paged::DenseKV kv{(size_t)b * skv * hkv * d, block_kv, hkv, d, h};
    tile.attend(k, v, kv, 0, rows * g, qpos_a, kmax);
  }
  tile.store(out + qoff, r0, n_heads, h);
}

// Launch the bf16 instance <DMAX, NCH>.  Its largest layout (MAX_NQ
// vectors, KV tiles of 32 * NCH keys) is what its shared-memory attribute
// allows.
template <int DMAX, int NCH>
cudaError_t launch_mma(dim3 grid, size_t smem, cudaStream_t s, const mma::bf16* q,
                       const mma::bf16* k, const mma::bf16* v, mma::bf16* out,
                       int sq, int skv, int n_heads, int hkv, int d, int block_q,
                       int block_kv, int causal, float scale) {
  const cudaError_t err = mma::allow_smem<flash_mma_kernel<DMAX, NCH>>(
      mma::layout(mma::MAX_NQ, 32 * NCH, DMAX).bytes);
  if (err != cudaSuccess) return err;
  flash_mma_kernel<DMAX, NCH><<<grid, mma::THREADS, smem, s>>>(
      q, k, v, out, sq, skv, n_heads, hkv, d, block_q, block_kv, causal, scale);
  return cudaGetLastError();
}

typedef cudaError_t (*MmaLaunch)(dim3, size_t, cudaStream_t, const mma::bf16*,
                                 const mma::bf16*, const mma::bf16*, mma::bf16*, int,
                                 int, int, int, int, int, int, int, float);

template <int NCH>
MmaLaunch pick(int d) {
  return d <= 64 ? launch_mma<64, NCH>
                 : d <= 128 ? launch_mma<128, NCH> : launch_mma<256, NCH>;
}

}  // namespace

// dtype: 0 = float32 (CUDA-core tile), 1 = bfloat16 (tensor-core tile).
// Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int sq, int skv, int n_heads,
                               int hkv, int d, int block_q, int block_kv,
                               int causal, float scale, int dtype, void* stream) {
  if (batch < 1 || sq < 1 || skv < 0 || hkv < 1 || n_heads % hkv ||
      block_q < 1 || block_kv < 1 || d > paged::MAX_D || d % 8)
    return (int)cudaErrorInvalidValue;
  const int g = n_heads / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((sq + block_q - 1) / block_q, hkv, batch);
  if (dtype == 0) {
    if (block_q * g > F32_MAXNQ) return (int)cudaErrorInvalidValue;
    const size_t smem = paged::layout<float>(block_q * g, block_kv, d).bytes;
    cudaError_t err = paged::set_smem(flash_attention_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_kernel<float><<<grid, paged::THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, skv, n_heads,
        hkv, d, block_q, block_kv, causal, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || block_q * g > mma::MAX_NQ ||
      (block_kv != 16 && block_kv != 32 && block_kv != 64 && block_kv != 128))
    return (int)cudaErrorInvalidValue;
  const size_t smem = mma::layout(block_q * g, block_kv, d).bytes;
  const int nch = mma::step_keys(block_kv) / 16;
  const MmaLaunch launch = nch == 1 ? pick<1>(d) : nch == 2 ? pick<2>(d) : pick<4>(d);
  return (int)launch(grid, smem, s, static_cast<const mma::bf16*>(q),
                     static_cast<const mma::bf16*>(k), static_cast<const mma::bf16*>(v),
                     static_cast<mma::bf16*>(out), sq, skv, n_heads, hkv, d, block_q,
                     block_kv, causal, scale);
}
