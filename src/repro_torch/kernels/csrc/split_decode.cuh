// Split-KV decode body (flash-decoding) for Hopper (sm_90a): the G query
// vectors of one new token that share KV head h, over one split — a fixed
// range of key positions — of their sequence's KV rows, on the CUDA cores.
// paged_decode.cu runs it over the paged pool, dense_decode.cu over dense
// caches: the row addressing (`Rows`: block(t), the block that holds key t,
// and offset(block, t), the element offset of its row for head h —
// PagedRows and DenseRows below) is a template parameter.
//
// One CTA per (sequence, KV head, split).  Split s covers key positions
// [s * kps, (s + 1) * kps) and stops at the sequence's length; a split
// that starts at or past the length reads nothing and leaves an empty
// partial (m = NEG_INF, l = 0).  Within a split, chunks of C keys (C rows
// of K and of V, 32 KB in bf16 at D = 128: four 16-row pool blocks)
// stream through a two-stage cp.async ring, gathered row by row through
// the addressing policy, so chunk j + 1 is in flight while chunk j
// computes; keys past the split or the length are zero-filled without
// reading device memory.  Each K and V row is read once for all G query
// vectors of its group: GQA is never expanded.
//
// Per chunk, the Pallas kernel's arithmetic (attention.py
// _paged_decode_kernel): scores Q·Kᵀ in f32 (lane groups split a row's
// 16-byte pieces and reduce by shuffles), scaled after the dot; an online
// softmax in f32, one warp per query vector; the probabilities rounded to
// the value dtype before P·V; P·V accumulated in f32, one thread per
// head-dim column (two for D up to 256).  Query vectors past G in the
// instance's MAXG, and dims past D in its head-dim bound DMAX (64, 128,
// 256), are zeros and never stored.  Everything that shapes the loops is a
// template parameter, so a chunk is straight-line code: the split's block
// ids are read one chunk ahead of the copies that need them.
//
// Combine: with one split the CTA writes acc / l itself.  Otherwise each
// CTA writes its (m, l, acc) partial in f32 to the workspace, and the CTA
// that arrives last on the (sequence, KV head) counter (ptx::arrive_last)
// sums the partials in split order, each scaled by exp(m_s - m) and empty
// ones skipped, divides by the combined l once (0 -> zeros) and rounds
// once.  No float atomics: the same inputs give the same bits every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_attention.cuh"
#include "ptx.cuh"

namespace split {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 2 * THREADS;
constexpr int MAX_CHUNK = 64;        // keys per staged chunk
constexpr int STAGE_BYTES = 32768;   // K + V rows of one chunk, at most
constexpr float NEG_INF = paged::NEG_INF;

// Keys per staged chunk of an instance of head-dim bound `dmax` and
// `item`-byte elements: kernels/attention.py::split_chunk_keys.
__host__ __device__ constexpr int chunk_keys(int dmax, int item) {
  return STAGE_BYTES / (2 * dmax * item) < MAX_CHUNK ? STAGE_BYTES / (2 * dmax * item)
                                                     : MAX_CHUNK;
}

struct Layout {
  size_t q, k, v, s, m, l, a, flag, bytes;
};

// Shared-memory carve-up of an instance of MAXG query vectors and head-dim
// bound DMAX, identical on host (launch size) and device:
// kernels/attention.py::split_decode_smem_bytes.
template <typename T>
__host__ __device__ inline Layout layout(int maxg, int dmax) {
  const int c = chunk_keys(dmax, sizeof(T));
  Layout L;
  size_t off = 0;
  L.q = off; off = paged::align16(off + (size_t)maxg * dmax * sizeof(float));
  L.k = off; off = paged::align16(off + (size_t)2 * c * dmax * sizeof(T));
  L.v = off; off = paged::align16(off + (size_t)2 * c * dmax * sizeof(T));
  L.s = off; off = paged::align16(off + (size_t)maxg * c * sizeof(float));
  L.m = off; off = paged::align16(off + (size_t)maxg * sizeof(float));
  L.l = off; off = paged::align16(off + (size_t)maxg * sizeof(float));
  L.a = off; off = paged::align16(off + (size_t)maxg * sizeof(float));
  L.flag = off; off = paged::align16(off + sizeof(int));
  L.bytes = off;
  return L;
}

// f32 floats of one (sequence, KV head)'s workspace: nsplit partials of
// g x (d accumulators, then m and l).
__host__ __device__ inline size_t unit_floats(int nsplit, int g, int d) {
  return (size_t)nsplit * g * (d + 2);
}

// Rows of one sequence in a (num_blocks, bs, Hkv, D) pool, KV head h: the
// block of key t (one block-table read) apart from the row's offset in
// it, so a chunk's table reads can be issued a chunk ahead of its copies.
struct PagedRows {
  const int* table;
  int bs, hkv, d, h;
  __device__ int block(int t) const { return __ldg(table + t / bs); }
  __device__ size_t offset(int blk, int t) const {
    return (((size_t)blk * bs + t % bs) * hkv + h) * (size_t)d;
  }
};

// Rows of one sequence in a dense (B, S, Hkv, D) cache, KV head h: key t
// is row t of the sequence's slab, so there is no block to look up.
struct DenseRows {
  size_t base;                     // b * S * Hkv * D, the sequence's slab
  int hkv, d, h;
  __device__ int block(int) const { return 0; }
  __device__ size_t offset(int, int t) const {
    return base + ((size_t)t * hkv + h) * (size_t)d;
  }
};

template <typename T> struct Vec16;   // one 16-byte piece of a row, in f32
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};

// One CTA's work: sequence b of length len, KV head h, split s of nsplit
// (kps keys each); q (B, H, D), out (B, H, D); `unit` = b * Hkv + h
// indexes the workspace and the counters.  Every thread calls it.
//
// Row geometry at compile time (DMAX, the head-dim bound): a row is CPR
// 16-byte pieces; a key's score is LPK lanes' work, two pieces each (l
// and l + LPK: the lanes of a pass read whole 128-byte lines), reduced
// by log2(LPK) shuffles, KPP keys per warp pass.
template <typename T, int MAXG, int DMAX, typename Rows>
__device__ void decode_split(unsigned char* smem, const T* __restrict__ q,
                             const T* __restrict__ kp, const T* __restrict__ vp,
                             const Rows& rows, T* __restrict__ out,
                             float* __restrict__ ws, int* __restrict__ counters,
                             int b, int h, int s, int nsplit, int kps, int len,
                             int n_heads, int g, int d, float scale, size_t unit) {
  using paged::from_f;
  using paged::to_f;
  constexpr int EPC = Vec16<T>::N;           // elements per 16-byte piece
  constexpr int CPR = DMAX / EPC;            // pieces per row
  constexpr int LPK = CPR / 2;               // lanes per key
  constexpr int KPP = 32 / LPK;              // keys per warp pass
  constexpr int C = chunk_keys(DMAX, sizeof(T));
  constexpr int PASSES = C / (WARPS * KPP);
  constexpr int PIECES = C * CPR / THREADS;  // K (and V) pieces a thread copies
  constexpr bool Q_IN_REGS = MAXG <= 4;
  static_assert(LPK <= 32 && PASSES * WARPS * KPP == C && PIECES * THREADS == C * CPR,
                "whole passes and whole pieces");
  const Layout L = layout<T>(MAXG, DMAX);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* sc = reinterpret_cast<float*>(smem + L.s);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  float* as = reinterpret_cast<float*>(smem + L.a);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k_lo = s * kps, k_hi = min(len, k_lo + kps);
  const int nch = k_hi > k_lo ? (k_hi - k_lo + C - 1) / C : 0;

  // chunk j (keys k_lo + j * C ...) into ring slot j % 2.  A thread's
  // PIECES pieces of K (and of V) are rows tid / CPR + p * (THREADS / CPR)
  // at piece tid % CPR; their blocks were read a chunk earlier (`blk`), and
  // pieces past d, or rows past the split or the length, are zero-filled
  // without reading device memory.
  const int prow = tid / CPR, pcol = tid % CPR;
  const bool pdim = pcol * EPC < d;
  int blk[PIECES];
  auto read_blocks = [&](int j) {
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const int t = k_lo + j * C + prow + p * (THREADS / CPR);
      blk[p] = t < k_hi ? rows.block(t) : 0;
    }
  };
  auto issue = [&](int j) {
    T* kst = ks + (size_t)(j & 1) * C * DMAX;
    T* vst = vs + (size_t)(j & 1) * C * DMAX;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const int r = prow + p * (THREADS / CPR), t = k_lo + j * C + r;
      const bool ok = pdim && t < k_hi;
      const size_t off = ok ? rows.offset(blk[p], t) + (size_t)pcol * EPC : 0;
      const int e = r * DMAX + pcol * EPC;
      ptx::cp_async16(ptx::smem_u32(kst + e), kp + off, ok);
      ptx::cp_async16(ptx::smem_u32(vst + e), vp + off, ok);
    }
  };

  if (nch > 0) {                             // in flight while q is staged
    read_blocks(0);
    issue(0);
    if (nch > 1) read_blocks(1);
  }
  ptx::cp_async_commit();
  const T* qrow = q + ((size_t)b * n_heads + (size_t)h * g) * d;
  for (int i = tid; i < MAXG * DMAX && nch > 0; i += THREADS) {
    const int gi = i / DMAX, e = i % DMAX;
    qs[i] = gi < g && e < d ? to_f<T>(qrow[gi * d + e]) : 0.f;
  }
  for (int i = tid; i < MAXG; i += THREADS) { ms[i] = NEG_INF; ls[i] = 0.f; as[i] = 0.f; }
  float acc[MAXG][2];
#pragma unroll
  for (int i = 0; i < MAXG; ++i) acc[i][0] = acc[i][1] = 0.f;
  const int l = lane % LPK;                  // this lane's pieces: l, l + LPK
  float qr[Q_IN_REGS ? MAXG : 1][2][EPC];    // q's pieces, when few enough
  bool q_ready = false;

  for (int j = 0; j < nch; ++j) {
    ptx::cp_async_wait<0>();                 // chunk j landed
    __syncthreads();                         // ... and chunk j - 1 consumed
    if (j + 1 < nch) issue(j + 1);
    ptx::cp_async_commit();
    if (j + 2 < nch) read_blocks(j + 2);     // used by the next issue
    if constexpr (Q_IN_REGS) {
      if (!q_ready) {
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < EPC; ++e) qr[gi][p][e] = qs[gi * DMAX + (l + p * LPK) * EPC + e];
        q_ready = true;
      }
    }
    const int t0 = k_lo + j * C, nt = min(C, k_hi - t0);
    const T* kc = ks + (size_t)(j & 1) * C * DMAX;
    const T* vc = vs + (size_t)(j & 1) * C * DMAX;

    // scores
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int t = (pass * WARPS + warp) * KPP + lane / LPK;
      float kf[2][EPC];
#pragma unroll
      for (int p = 0; p < 2; ++p) Vec16<T>::load(kc + t * DMAX + (l + p * LPK) * EPC, kf[p]);
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          if constexpr (Q_IN_REGS) {
            dot0 = fmaf(qr[gi][0][e], kf[0][e], dot0);
            dot1 = fmaf(qr[gi][1][e], kf[1][e], dot1);
          } else {
            dot0 = fmaf(qs[gi * DMAX + l * EPC + e], kf[0][e], dot0);
            dot1 = fmaf(qs[gi * DMAX + (l + LPK) * EPC + e], kf[1][e], dot1);
          }
        }
        float dot = dot0 + dot1;
#pragma unroll
        for (int off = LPK / 2; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (l == 0 && t < nt) sc[gi * C + t] = dot * scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query vector
    for (int gi = warp; gi < g; gi += WARPS) {
      float* row = sc + gi * C;
      float mx = NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[gi], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(row[t] - m_new);
        sum += p;
        row[t] = to_f<T>(from_f<T>(p));      // p rounded to the value dtype
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = m_new;
        as[gi] = alpha;
      }
    }
    __syncthreads();

    // P·V into this thread's columns
#pragma unroll
    for (int c = 0; c < (DMAX > THREADS ? 2 : 1); ++c) {
      const int col = tid + c * THREADS;
      if (col >= d) continue;
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
        if (gi < g) acc[gi][c] *= as[gi];
#pragma unroll 8
      for (int t = 0; t < nt; ++t) {
        const float v = to_f<T>(vc[t * DMAX + col]);
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi)
          if (gi < g) acc[gi][c] = fmaf(sc[gi * C + t], v, acc[gi][c]);
      }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();                           // the last softmax's m, l

  T* orow = out + ((size_t)b * n_heads + (size_t)h * g) * d;
  if (nsplit == 1) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = tid + c * THREADS;
      if (col >= d) continue;
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
        if (gi < g) {
          const float l = ls[gi] == 0.f ? 1.f : ls[gi];
          orow[gi * d + col] = from_f<T>(acc[gi][c] / l);
        }
    }
    return;
  }

  float* base = ws + unit * unit_floats(nsplit, g, d);
  const size_t pstride = (size_t)g * (d + 2);
  float* part = base + (size_t)s * pstride;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = tid + c * THREADS;
    if (col >= d || nch == 0) continue;     // an empty split's acc is never read
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi)
      if (gi < g) part[gi * d + col] = acc[gi][c];
  }
  for (int gi = tid; gi < g; gi += THREADS) {
    part[g * d + 2 * gi] = ms[gi];
    part[g * d + 2 * gi + 1] = ls[gi];
  }
  if (!ptx::arrive_last(counters + unit, nsplit, flag)) return;

  // the last CTA: combine the partials in split order, the loads of SB
  // splits in flight at a time (of all of them, in one batch, for up to
  // SB splits)
  constexpr int SB = 8;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = tid + c * THREADS;
    if (col >= d) continue;
    for (int gi = 0; gi < g; ++gi) {
      const float* ml = base + g * d + 2 * gi;
      const float* ac = base + gi * d + col;
      float2 v[SB];
      float a[SB];
      float m = NEG_INF, l = 0.f, o = 0.f;
      if (nsplit <= SB) {
#pragma unroll
        for (int t = 0; t < SB; ++t)
          if (t < nsplit) {
            v[t] = __ldcg(reinterpret_cast<const float2*>(ml + t * pstride));
            a[t] = __ldcg(ac + t * pstride);
          }
#pragma unroll
        for (int t = 0; t < SB; ++t)
          if (t < nsplit && v[t].y > 0.f) m = fmaxf(m, v[t].x);
#pragma unroll
        for (int t = 0; t < SB; ++t)
          if (t < nsplit && v[t].y > 0.f) {  // an empty split weighs 0
            const float wt = expf(v[t].x - m);
            l = fmaf(v[t].y, wt, l);
            o = fmaf(a[t], wt, o);
          }
      } else {
        for (int t0 = 0; t0 < nsplit; t0 += SB) {
#pragma unroll
          for (int i = 0; i < SB; ++i)
            if (t0 + i < nsplit)
              v[i] = __ldcg(reinterpret_cast<const float2*>(ml + (t0 + i) * pstride));
#pragma unroll
          for (int i = 0; i < SB; ++i)
            if (t0 + i < nsplit && v[i].y > 0.f) m = fmaxf(m, v[i].x);
        }
        for (int t0 = 0; t0 < nsplit; t0 += SB) {
#pragma unroll
          for (int i = 0; i < SB; ++i)
            if (t0 + i < nsplit) {
              v[i] = __ldcg(reinterpret_cast<const float2*>(ml + (t0 + i) * pstride));
              a[i] = __ldcg(ac + (t0 + i) * pstride);
            }
#pragma unroll
          for (int i = 0; i < SB; ++i)
            if (t0 + i < nsplit && v[i].y > 0.f) {
              const float wt = expf(v[i].x - m);
              l = fmaf(v[i].y, wt, l);
              o = fmaf(a[i], wt, o);
            }
        }
      }
      orow[gi * d + col] = from_f<T>(o / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace split
