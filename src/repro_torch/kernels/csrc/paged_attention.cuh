// Shared body of the two paged attention kernels (paged_decode.cu and
// paged_prefill.cu): an online-softmax pass of a tile of query vectors over
// the KV blocks one block table names.
//
// A CTA owns one KV head `h` and a tile of query rows; each row carries the
// G = H / Hkv query heads of that KV head, so the tile holds nq = rows * G
// query vectors (vector v = local_row * G + g).  A row at absolute position
// `qpos` of its request attends to key positions 0..qpos, which live in
// logical blocks 0..qpos / block_size of its block table.  For each such
// block the CTA stages the block's K and V rows for head h in shared memory
// (16-byte loads from the (num_blocks, block_size, Hkv, D) pool), computes
// the scores in f32, updates the running max / denominator per vector and
// rescales the f32 accumulators, exactly the sequence of the Pallas kernels'
// grid steps — including the rounding of the probabilities to the value
// dtype before P·V.
//
// Thread layout (128 threads): scores are one thread per (vector, key);
// the softmax update is one thread per vector; the P·V accumulate is one
// thread per head-dim column (two columns for D up to 256), with the
// accumulators of every vector of the tile in that thread's registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float NEG_INF = -1e30f;   // the Pallas kernels' NEG_INF
constexpr int THREADS = 128;
constexpr int MAX_D = 2 * THREADS;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K rows are padded by one 32-bit word so that the 16 keys of a score warp
// fall in distinct shared-memory banks.
template <typename T> __host__ __device__ constexpr int kpad() {
  return 4 / (int)sizeof(T);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Shared-memory carve-up, identical on host (launch size) and device.
struct Layout {
  size_t q, k, v, s, m, l, a, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int nq, int bs, int d) {
  Layout L;
  size_t off = 0;
  L.q = off; off = align16(off + (size_t)nq * (d + 1) * sizeof(float));
  L.k = off; off = align16(off + (size_t)bs * (d + kpad<T>()) * sizeof(T));
  L.v = off; off = align16(off + (size_t)bs * d * sizeof(T));
  L.s = off; off = align16(off + (size_t)nq * bs * sizeof(float));
  L.m = off; off = align16(off + (size_t)nq * sizeof(float));
  L.l = off; off = align16(off + (size_t)nq * sizeof(float));
  L.a = off; off = align16(off + (size_t)nq * sizeof(float));
  L.bytes = off;
  return L;
}

template <typename T, int MAXNQ>
struct Tile {
  float* qs;   // (nq, d + 1) query vectors in f32
  T* ks;       // (bs, d + kpad) staged K rows
  T* vs;       // (bs, d) staged V rows
  float* sc;   // (nq, bs) scores, then rounded probabilities
  float* m;    // (nq) running max
  float* l;    // (nq) running denominator
  float* a;    // (nq) this block's rescale factor
  float acc[MAXNQ][2];   // this thread's accumulator columns
  int nq, d, bs, g;
  float scale;

  __device__ void init(unsigned char* smem, int nq_, int d_, int bs_, int g_,
                       float scale_) {
    const Layout L = layout<T>(nq_, bs_, d_);
    qs = reinterpret_cast<float*>(smem + L.q);
    ks = reinterpret_cast<T*>(smem + L.k);
    vs = reinterpret_cast<T*>(smem + L.v);
    sc = reinterpret_cast<float*>(smem + L.s);
    m = reinterpret_cast<float*>(smem + L.m);
    l = reinterpret_cast<float*>(smem + L.l);
    a = reinterpret_cast<float*>(smem + L.a);
    nq = nq_; d = d_; bs = bs_; g = g_; scale = scale_;
#pragma unroll
    for (int v = 0; v < MAXNQ; ++v) { acc[v][0] = 0.f; acc[v][1] = 0.f; }
    for (int v = threadIdx.x; v < nq; v += THREADS) { m[v] = NEG_INF; l[v] = 0.f; }
  }

  // Stage the tile's query vectors: rows [r0, r0 + nq / g) of q (rows, H, D),
  // heads [h * g, h * g + g).
  __device__ void load_q(const T* __restrict__ q, int r0, int n_heads, int h) {
    for (int i = threadIdx.x; i < nq * d; i += THREADS) {
      const int v = i / d, e = i % d;
      const int row = r0 + v / g, head = h * g + v % g;
      qs[v * (d + 1) + e] = to_f<T>(q[((size_t)row * n_heads + head) * d + e]);
    }
  }

  // One pass of vectors [va, vb) over logical blocks [0, nblk) of `table`;
  // vector va's row sits at absolute position qpos_a, each later row one
  // further.  Every thread of the CTA must call this with the same arguments.
  __device__ void attend(const T* __restrict__ kp, const T* __restrict__ vp,
                         const int* __restrict__ table, int nblk, int hkv, int h,
                         int va, int vb, int qpos_a) {
    const int tid = threadIdx.x;
    const int kstride = d + kpad<T>();
    constexpr int EPC = 16 / (int)sizeof(T);     // elements per 16-byte chunk
    const int cpr = d / EPC;                     // chunks per row
    const int nv = vb - va;
    for (int j = 0; j < nblk; ++j) {
      const size_t phys = (size_t)table[j];
      __syncthreads();                           // previous block consumed
      for (int c = tid; c < bs * cpr; c += THREADS) {
        const int t = c / cpr, cc = c % cpr;
        const size_t goff = ((phys * bs + t) * hkv + h) * (size_t)d;
        const uint4 kv = reinterpret_cast<const uint4*>(kp + goff)[cc];
        const uint4 vv = reinterpret_cast<const uint4*>(vp + goff)[cc];
        const T* kel = reinterpret_cast<const T*>(&kv);
#pragma unroll
        for (int e = 0; e < EPC; ++e) ks[t * kstride + cc * EPC + e] = kel[e];
        reinterpret_cast<uint4*>(vs + (size_t)t * d)[cc] = vv;
      }
      __syncthreads();
      const int kbase = j * bs;
      for (int i = tid; i < nv * bs; i += THREADS) {
        const int vi = i / bs, t = i % bs;
        const int v = va + vi;
        float s = NEG_INF;
        if (kbase + t <= qpos_a + vi / g) {
          const float* qrow = qs + v * (d + 1);
          const T* krow = ks + t * kstride;
          float dot = 0.f;
          for (int e = 0; e < d; ++e) dot = fmaf(qrow[e], to_f<T>(krow[e]), dot);
          s = dot * scale;
        }
        sc[v * bs + t] = s;
      }
      __syncthreads();
      for (int v = va + tid; v < vb; v += THREADS) {
        float* row = sc + v * bs;
        const float m_prev = m[v];
        float m_cur = NEG_INF;
        for (int t = 0; t < bs; ++t) m_cur = fmaxf(m_cur, row[t]);
        const float m_new = fmaxf(m_prev, m_cur);
        float sum = 0.f;
        for (int t = 0; t < bs; ++t) {
          const float p = expf(row[t] - m_new);
          sum += p;
          row[t] = to_f<T>(from_f<T>(p));        // p rounded to the value dtype
        }
        const float alpha = expf(m_prev - m_new);
        l[v] = l[v] * alpha + sum;
        m[v] = m_new;
        a[v] = alpha;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tid + c * THREADS;
        if (col >= d) continue;
#pragma unroll
        for (int v = 0; v < MAXNQ; ++v) {
          if (v < va || v >= vb) continue;
          // keys past the row's position carry p == 0; skip them so stale
          // rows of a partly written block are never read
          const int nt = min(bs, qpos_a + (v - va) / g - kbase + 1);
          float acc_v = acc[v][c] * a[v];
          const float* prow = sc + v * bs;
          for (int t = 0; t < nt; ++t)
            acc_v = fmaf(prow[t], to_f<T>(vs[(size_t)t * d + col]), acc_v);
          acc[v][c] = acc_v;
        }
      }
    }
  }

  // out[row, h * g + gi, :] = acc / l (l == 0 -> 1, i.e. zeros for rows
  // that attended to nothing), for the tile's first `nq` vectors.
  __device__ void store(T* __restrict__ out, int r0, int n_heads, int h) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = threadIdx.x + c * THREADS;
      if (col >= d) continue;
#pragma unroll
      for (int v = 0; v < MAXNQ; ++v) {
        if (v >= nq) continue;
        const float lv = l[v] == 0.f ? 1.f : l[v];
        const int row = r0 + v / g, head = h * g + v % g;
        out[((size_t)row * n_heads + head) * d + col] = from_f<T>(acc[v][c] / lv);
      }
    }
  }
};

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
