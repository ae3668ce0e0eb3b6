// Tensor-core tile of the bf16 flash-attention and paged-prefill kernels
// (flash_attention.cu, paged_prefill.cu) for Hopper (sm_90a): an
// online-softmax pass of up to MAX_NQ query vectors over the KV rows of one
// KV head, with Q·Kᵀ and P·V on `mma.sync.m16n8k16` (bf16 in, f32
// accumulate), in the FlashAttention-2 arrangement.
//
// Vectors and warps.  As in paged_attention.cuh, the tile holds nq = rows x
// G query vectors (vector v = local_row * G + g), so the G query heads of a
// KV head share every staged K/V row.  Each warp owns 16 vectors: QWARPS
// query warps x KSPLIT KV warps (2 x 2: 128 threads, 32 vectors).  KV warp
// kh takes the kh-th half of each staged KV tile (a tile of 16 keys is KV
// warp 0's alone) as one step, and keeps its own (m, l, acc); the two
// states merge through shared memory before the store.
//
// Per step of NCH 16-key chunks (NCH = 1, 2 or 4 for tiles of 16-32, 64,
// 128 keys), a warp
//   * computes S = Q·Kᵀ (16 x 16·NCH, f32) with Q's A fragments held in
//     registers for the whole walk (loaded once by ldmatrix; re-read from
//     shared memory per k-step at DMAX = 256, whose 128 accumulators leave
//     no room) and K's B fragments by ldmatrix, all of a k-step's issued
//     before its mma;
//   * scales S in f32 after the dot (never folding the scale into a bf16 Q,
//     which would round Q·scale) and masks per element to -inf (key <= the
//     row's limit; an inactive row, outside the current segment pass or
//     past the tile, sees no key), so exp(-inf - m) = 0 even for a row that
//     has seen no key yet: such a row keeps (m, l, acc) = (NEG_INF, 0, 0) —
//     no exp(0) = 1 garbage — and comes out as zeros;
//   * updates the running max with quad shuffles; p = exp(s - m_new) in f32
//     feeds the denominator, alpha = exp(m_prev - m_new) rescales it and the
//     accumulators, and p rounded to bf16 is the A operand of P·V straight
//     from the score registers — the Pallas kernels' order
//     (attention.py:68-80, :272-285);
//   * accumulates P·V into 16 x DMAX f32 registers, V's B fragments by
//     ldmatrix.trans.
// Everything in a step is straight-line code: the head-dim bound DMAX (64,
// 128, 256) and NCH are template parameters, dims past D are zeros in
// shared memory, and the mask is a select, not a branch.
//
// Staging.  K/V tiles of `bkv` keys (16, 32, 64 or 128) go through a
// two-stage ring in shared memory by cp.async.cg (16 bytes), so tile j + 1
// loads while tile j computes.  Rows are DMAX + 8 elements long, an odd
// number of 16-byte units, which puts the 8 rows of every ldmatrix phase in
// distinct banks.  Key t's address comes from the KV addressing policy
// (`key(t)` of PagedKV / DenseKV): a paged tile gathers row by row through
// the block table, so a tile is 16-key aligned whatever the pool's
// block_size.  Keys past the visible limit, and dims past D, are
// zero-filled by cp.async without reading device memory.  TMA is not used:
// a block-table gather of 16-row pages is not a tensor-map box.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_attention.cuh"
#include "ptx.cuh"

namespace mma {

constexpr int QWARPS = 2;             // query warps, 16 vectors each
constexpr int KSPLIT = 2;             // KV warps per query warp (merged in store)
constexpr int THREADS = 32 * QWARPS * KSPLIT;
constexpr int MAX_NQ = 16 * QWARPS;    // query vectors per CTA
constexpr int STAGES = 2;
constexpr float NEG_INF = paged::NEG_INF;

typedef __nv_bfloat16 bf16;

using ptx::allow_smem;
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::dmax_of;
using ptx::ldsm_x4;
using ptx::ldsm_x4_trans;
using ptx::mma16816;
using ptx::pack_bf16;
using ptx::smem_u32;

// Keys per warp step of the instance that runs KV tiles of bkv keys (16,
// 32, 64 or 128): each of the KSPLIT KV warps takes one step of a tile
// (a tile of 16 keys is KV warp 0's alone).
__host__ __device__ constexpr int step_keys(int bkv) { return bkv <= 32 ? 16 : bkv / KSPLIT; }
// shared-memory row stride in elements: DMAX + 8, an odd number of 16-byte
// units, so the 8 rows of every ldmatrix phase fall in distinct banks
__host__ __device__ constexpr int ld(int dmax) { return dmax + 8; }

struct Layout {
  size_t q, kv, bytes;
};

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

// Shared-memory carve-up, identical on host (launch size) and device: the
// query rows, then the K/V ring, which the KV warps' merge reuses at the end.
__host__ __device__ inline Layout layout(int nq, int bkv, int d) {
  const int dmax = dmax_of(d);
  const size_t row = (size_t)ld(dmax) * sizeof(bf16);
  const size_t ring = (size_t)STAGES * 2 * bkv * row;
  const size_t merge = (size_t)QWARPS * (dmax / 8 * 4 + 4) * 32 * sizeof(float);
  Layout L;
  L.q = 0;
  L.kv = round16(round16(nq) * row);
  L.bytes = L.kv + round16(ring > merge ? ring : merge);
  return L;
}

// DMAX: the head-dim bound (64, 128 or 256); any D <= DMAX that is a
// multiple of 8 runs on it, its dims past D zero-filled in shared memory.
// NCH: 16-key chunks per warp step (step_keys(bkv) / 16).
template <int DMAX, int NCH>
struct Tile {
  static constexpr int NT = DMAX / 8;      // 8-column n-tiles of a 16 x D row block
  static constexpr int KS = DMAX / 16;     // 16-wide k-steps over the head dim
  static constexpr int LD = ld(DMAX);
  static constexpr int CPR = DMAX / 8;     // 16-byte chunks per staged row
  static constexpr bool Q_IN_REGS = DMAX <= 128;
  static_assert(THREADS % CPR == 0, "a thread copies one column of chunks");

  bf16* qs;          // (round16(nq), LD) query vectors
  bf16* ks;          // (STAGES, bkv, LD) staged K rows
  bf16* vs;          // (STAGES, bkv, LD) staged V rows
  float* mrg;        // the KV warps' merge (aliases the ring)
  uint32_t qf[Q_IN_REGS ? KS : 1][4];   // Q's A fragments
  float o[NT][4];    // accumulators: rows lane/4 and lane/4 + 8
  float m[2], l[2];  // running max / this thread's share of the denominator
  int nq, d, bkv, group, qw, kh, lane;
  bool q_ready;      // Q's fragments are in registers
  float scale;

  __device__ void init(unsigned char* smem, int nq_, int d_, int bkv_, int group_,
                       float scale_) {
    const Layout L = layout(nq_, bkv_, d_);
    qs = reinterpret_cast<bf16*>(smem + L.q);
    ks = reinterpret_cast<bf16*>(smem + L.kv);
    vs = ks + (size_t)STAGES * bkv_ * LD;
    mrg = reinterpret_cast<float*>(smem + L.kv);
    nq = nq_; d = d_; bkv = bkv_; group = group_; scale = scale_;
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    qw = warp % QWARPS;
    kh = warp / QWARPS;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
    q_ready = false;
  }

  __device__ bool has_rows() const { return 16 * qw < nq; }

  // A fragments of Q for k-step `s`: 16 vectors of this warp x 16 dims
  __device__ void load_qf(uint32_t (&a)[4], int s) const {
    const int row = 16 * qw + lane % 8 + ((lane / 8) & 1) * 8;
    ldsm_x4(a, smem_u32(qs + row * LD + s * 16 + (lane / 16) * 8));
  }

  // Start staging the tile's query vectors: rows [r0, r0 + nq / G) of q
  // (rows, H, D), heads [h * G, h * G + G); rows of the last 16 past nq and
  // dims past D are zeros.  The copies land with the first KV tile.
  __device__ void load_q(const bf16* __restrict__ q, int r0, int n_heads, int h) {
    const int full = d / 8;
    for (int i = threadIdx.x; i < (int)round16(nq) * CPR; i += THREADS) {
      const int v = i / CPR, c = i % CPR;
      const bool ok = v < nq && c < full;
      const bf16* src = ok ? q + ((size_t)(r0 + v / group) * n_heads + h * group +
                                  v % group) * d + c * 8 : q;
      cp_async16(smem_u32(qs + v * LD + c * 8), src, ok);
    }
    cp_async_commit();
  }

  // Q's A fragments into registers, once the staged queries are visible.
  __device__ void load_frags() {
    if constexpr (Q_IN_REGS) {
      if (has_rows()) {
#pragma unroll
        for (int s = 0; s < KS; ++s) load_qf(qf[s], s);
      }
    }
    q_ready = true;
  }

  // Issue the cp.async copies of stage j (keys j * bkv ...) into its ring
  // slot: keys past kmax, and dims past D, are zero-filled.
  template <typename KV>
  __device__ void issue(const bf16* __restrict__ kp, const bf16* __restrict__ vp,
                        const KV& kv, int j, int kmax) {
    const int kbase = j * bkv;
    const int c = threadIdx.x % CPR;
    const bool col = c < d / 8;
    bf16* kst = ks + (size_t)(j % STAGES) * bkv * LD + c * 8;
    bf16* vst = vs + (size_t)(j % STAGES) * bkv * LD + c * 8;
    for (int t = threadIdx.x / CPR; t < bkv; t += THREADS / CPR) {
      const bool ok = col && kbase + t <= kmax;
      const size_t off = ok ? kv.key(kbase + t) + c * 8 : 0;
      cp_async16(smem_u32(kst + t * LD), kp + off, ok);
      cp_async16(smem_u32(vst + t * LD), vp + off, ok);
    }
  }

  // One warp step over the NCH 16-key chunks staged at kc / vc, first key
  // k0: one online-softmax update.
  __device__ void step(const bf16* kc, const bf16* vc, int k0, const int (&lim)[2]) {
    float s[2 * NCH][4];                 // 8-key n-tiles of S
#pragma unroll
    for (int n = 0; n < 2 * NCH; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    const int krow = lane % 8 + (lane / 16) * 8, kcol = ((lane / 8) & 1) * 8;
    const uint32_t kaddr = smem_u32(kc + krow * LD + kcol);
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t kb[NCH][4];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        ldsm_x4(kb[c], kaddr + (uint32_t)((c * 16 * LD + st * 16) * sizeof(bf16)));
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[st][i];
      } else {
        load_qf(a, st);
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        mma16816(s[2 * c], a, kb[c][0], kb[c][1]);
        mma16816(s[2 * c + 1], a, kb[c][2], kb[c][3]);
      }
    }
    // scale, then mask to -inf: exp(-inf - m) is exactly 0 for a masked key
    // even in a row that has seen no key yet
    const int t0 = k0 + 2 * (lane % 4);
    float mx[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
    for (int n = 0; n < 2 * NCH; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool vis = t0 + n * 8 + (i & 1) <= lim[i >> 1];
        s[n][i] = vis ? s[n][i] * scale : __int_as_float(0xff800000);  // -inf
        mx[i >> 1][i & 1] = fmaxf(mx[i >> 1][i & 1], s[n][i]);
      }
    float alpha[2], sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = fmaxf(mx[r][0], mx[r][1]);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float m_new = fmaxf(m[r], v);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2 * NCH; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        sum[i >> 1][i & 1] += s[n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    // P (rounded to bf16) as the A operand: the score fragments' layout
    uint32_t pa[NCH][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
    }
    const int vrow = lane % 8 + ((lane / 8) & 1) * 8, vcol = (lane / 16) * 8;
    const uint32_t vaddr = smem_u32(vc + vrow * LD + vcol);
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t vb[NCH][4];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        ldsm_x4_trans(vb[c], vaddr + (uint32_t)((c * 16 * LD + st * 16) * sizeof(bf16)));
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        mma16816(o[2 * st], pa[c], vb[c][0], vb[c][1]);
        mma16816(o[2 * st + 1], pa[c], vb[c][2], vb[c][3]);
      }
    }
  }

  // One pass of vectors [va, vb) over keys 0..kmax (kmax >= 0) of `kv`;
  // vector va's row sees key positions 0..qpos_a, each later row one
  // further, and no row sees past kmax.  Every thread of the CTA must call
  // this with the same arguments.
  template <typename KV>
  __device__ void attend(const bf16* __restrict__ kp, const bf16* __restrict__ vp,
                         const KV& kv, int va, int vb, int qpos_a, int kmax) {
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = 16 * qw + lane / 4 + 8 * r;
      lim[r] = v >= va && v < vb ? min(qpos_a + (v - va) / group, kmax) : -1;
    }
    int wlim = max(lim[0], lim[1]);      // the warp's furthest visible key
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      wlim = max(wlim, __shfl_xor_sync(0xffffffffu, wlim, off));
    // KV warp kh takes keys [kh * NCH * 16, (kh + 1) * NCH * 16) of each
    // tile (a 16-key tile has one step, for KV warp 0)
    const int koff = kh * NCH * 16;
    const int nst = kmax / bkv + 1;
    issue(kp, vp, kv, 0, kmax);
    cp_async_commit();
    for (int j = 0; j < nst; ++j) {
      if (j + 1 < nst) issue(kp, vp, kv, j + 1, kmax);
      cp_async_commit();
      cp_async_wait<1>();                // stage j (and the queries) landed
      __syncthreads();
      if (!q_ready) load_frags();
      const int k0 = j * bkv + koff;
      if (koff < bkv && k0 <= wlim) {
        const size_t row = (size_t)(j % STAGES) * bkv * LD + (size_t)koff * LD;
        step(ks + row, vs + row, k0, lim);
      }
      __syncthreads();                   // stage j consumed
    }
  }

  // out[row, h * G + gi, :] = acc / l (l == 0 -> 1, i.e. zeros for vectors
  // that attended to nothing), for the tile's first `nq` vectors.
  __device__ void store(bf16* __restrict__ out, int r0, int n_heads, int h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    cp_async_wait<0>();                  // the queries' copies, if no pass ran
    // KV warp 1 hands its (acc, m, l) to KV warp 0 of the same query warp
    float* slot = mrg + (size_t)qw * (NT * 4 + 4) * 32;
    __syncthreads();                     // the ring is free
    if (kh == 1 && has_rows()) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) slot[(n * 4 + i) * 32 + lane] = o[n][i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        slot[(NT * 4 + r) * 32 + lane] = m[r];
        slot[(NT * 4 + 2 + r) * 32 + lane] = l[r];
      }
    }
    __syncthreads();
    if (kh != 0 || !has_rows()) return;
    float w0[2], w1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = slot[(NT * 4 + r) * 32 + lane];
      const float l1 = slot[(NT * 4 + 2 + r) * 32 + lane];
      const float mm = fmaxf(m[r], m1);
      w0[r] = expf(m[r] - mm);
      w1[r] = expf(m1 - mm);
      l[r] = l[r] * w0[r] + l1 * w1[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[n][i] = o[n][i] * w0[i >> 1] + slot[(n * 4 + i) * 32 + lane] * w1[i >> 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = 16 * qw + lane / 4 + 8 * r;
      if (v >= nq) continue;
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      bf16* row = out + ((size_t)(r0 + v / group) * n_heads + h * group + v % group) * d;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * (lane % 4);
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
    }
  }
};

}  // namespace mma
