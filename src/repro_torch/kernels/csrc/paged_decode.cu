// Paged decode attention for Hopper (sm_90a).
//
// Replaces: repro/kernels/attention.py::flash_decode_paged (kernel body
// _paged_decode_kernel), reached through repro.kernels.ops.attention_decode_paged.
//
// Computes, for every slot b and KV head h, the attention of the slot's one
// new token — its G = H / Hkv query heads of KV head h — over the first
// lengths[b] rows of the slot's KV, read from the shared block pool through
// block_tables[b, :].  f32 max / denominator / accumulator; Q·Kᵀ and P·V
// accumulate in f32 and the probabilities are rounded to the value dtype
// before P·V, as in the Pallas kernel.  Blocks past the length are never
// read; a length of 0 gives zeros.  Inactive serving slots carry all-null
// tables and length 1: they read the sink block 0 and their output is
// discarded by the caller.
//
// What bounds it on the card: bytes.  Each slot reads its K and V rows once
// (2 * length * D * 2 bytes per KV head in bf16) and does ~4 * G * D flops
// per key row — about 2 flops per byte at G = 2, far below the ~295 flops
// per byte where the H100's tensor cores would become the limit.  A decode
// step's few MB can only stream at the card's rate if most SMs have a
// chunk of rows in flight at once.
//
// What the design does about it: split-KV (flash-decoding), the body of
// split_decode.cuh.  The grid is (slot, KV head, split): split s takes key
// positions [s * kps, (s + 1) * kps), where the wrapper
// (kernels/attention.py::decode_splits) picks kps and the split count from
// the table width and the block size alone — never from `lengths`, which
// would cost a device-to-host sync per step.  At the serving shape (64-block
// tables of 16 rows, kps 128) that is 8 x 8 x 8 = 512 CTAs instead of 64;
// splits past a slot's length exit at once.  Each split streams its rows in
// chunks of up to 64 through a two-stage cp.async ring, and the CTA that
// finishes a (slot, KV head) last combines the splits' partials in split
// order in the same launch, through self-resetting counters.
#include "split_decode.cuh"

namespace {

template <typename T, int MAXG, int DMAX>
__global__ void __launch_bounds__(split::THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int n_heads, int hkv, int d, int bs, int nbt, int kps,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int len = min(lengths[b], nbt * bs);
  const split::PagedRows rows{tables + (size_t)b * nbt, bs, hkv, d, h};
  split::decode_split<T, MAXG, DMAX>(smem, q, k_pool, v_pool, rows, out, ws, counters,
                                     b, h, s, gridDim.z, kps, len, n_heads,
                                     n_heads / hkv, d, scale, (size_t)b * hkv + h);
}

template <typename T, int MAXG, int DMAX>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* lengths, const void* tables, void* out, void* ws,
                   void* counters, int batch, int n_heads, int hkv, int d, int bs,
                   int nbt, int kps, int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = split::layout<T>(MAXG, DMAX).bytes;
  const cudaError_t err = ptx::allow_smem<paged_decode_kernel<T, MAXG, DMAX>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch, hkv, nsplit);
  paged_decode_kernel<T, MAXG, DMAX><<<grid, split::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), n_heads, hkv, d, bs, nbt, kps, scale);
  return cudaGetLastError();
}

// the instance whose MAXG (1, 2, 4, 8 or 16) is the smallest >= g, and
// whose head-dim bound (64, 128 or 256) is the smallest >= d
template <typename T, int DMAX>
cudaError_t launch_g(int g, const void* q, const void* k_pool, const void* v_pool,
                     const void* lengths, const void* tables, void* out, void* ws,
                     void* counters, int batch, int n_heads, int hkv, int d, int bs,
                     int nbt, int kps, int nsplit, float scale, cudaStream_t s) {
#define ARGS q, k_pool, v_pool, lengths, tables, out, ws, counters, batch, n_heads, \
             hkv, d, bs, nbt, kps, nsplit, scale, s
  if (g <= 1) return launch<T, 1, DMAX>(ARGS);
  if (g <= 2) return launch<T, 2, DMAX>(ARGS);
  if (g <= 4) return launch<T, 4, DMAX>(ARGS);
  if (g <= 8) return launch<T, 8, DMAX>(ARGS);
  return launch<T, 16, DMAX>(ARGS);
#undef ARGS
}

template <typename T>
cudaError_t launch_d(int g, const void* q, const void* k_pool, const void* v_pool,
                     const void* lengths, const void* tables, void* out, void* ws,
                     void* counters, int batch, int n_heads, int hkv, int d, int bs,
                     int nbt, int kps, int nsplit, float scale, cudaStream_t s) {
#define ARGS g, q, k_pool, v_pool, lengths, tables, out, ws, counters, batch, n_heads, \
             hkv, d, bs, nbt, kps, nsplit, scale, s
  switch (ptx::dmax_of(d)) {
    case 64: return launch_g<T, 64>(ARGS);
    case 128: return launch_g<T, 128>(ARGS);
    default: return launch_g<T, 256>(ARGS);
  }
#undef ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kps: keys per split, a multiple of bs;
// nsplit: ceil(nbt * bs / kps).  With nsplit > 1, `ws` holds batch x hkv x
// split::unit_floats(nsplit, G, d) f32 and `counters` batch x hkv zeroed
// ints (left zeroed at the end).  Returns the launch's cudaError_t.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* lengths,
                                      const void* tables, void* out, int batch,
                                      int n_heads, int hkv, int d, int bs, int nbt,
                                      int kps, int nsplit, float scale, int dtype,
                                      void* ws, void* counters, void* stream) {
  if (hkv < 1 || n_heads % hkv || n_heads / hkv > 16 || d > split::MAX_D || d % 8 ||
      bs < 1 || nbt < 1 || kps < bs || kps % bs || nsplit != (nbt * bs + kps - 1) / kps ||
      nsplit > 65535 || (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = n_heads / hkv;
  if (dtype == 0)
    return (int)launch_d<float>(g, q, k_pool, v_pool, lengths, tables, out, ws,
                                counters, batch, n_heads, hkv, d, bs, nbt, kps,
                                nsplit, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(g, q, k_pool, v_pool, lengths, tables, out,
                                        ws, counters, batch, n_heads, hkv, d, bs, nbt,
                                        kps, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}
