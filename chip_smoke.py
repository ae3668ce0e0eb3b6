#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py [--profile] [--skip-serve]

Phases, each of which must pass (any failure raises and exits nonzero):

  1. environment: the card's name and power limit, torch/CUDA versions, the
     sm_90 check, and the build of every CUDA kernel from the sources in
     this checkout (one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes in bf16 and at the JAX tests' small shapes in
     f32, with kernel / plain / library times and the roofline bound;
  3. qwen3-1.7b at full width (random weights from seed 0) served through
     `ContinuousEngine` with a plan that sends attention and the four
     role-tagged matmuls through the kernels: 16 requests, chunked and
     packed prefill and decode-only steps; every request must finish, the
     pool must drain, every kernel must have launched on this path, and the
     first tokens must match the same engine on the torch lanes wherever the
     reference's top-2 margin exceeds the stated tolerance;
  4. one JSON line `{"kernels": [...]}` with each kernel's launches, error
     and times;
  5. the last line `{"ok": true, "device": {...}}`.

It imports nothing of JAX or of the JAX package.  Without a GPU it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
# tensor-core rate; the bound of a call is the larger of bytes / HBM_BPS
# and flops / BF16_FLOPS, with each input read once and each output
# written once.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
L2_BYTES = 50 * 2**20
DEVICE = "cuda"
PREFILL_BLOCK_Q = 16     # rows per prefill CTA: 16 rows x G=2 heads fill a tile


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(torch, fns, iters=20, warmup=2):
    """Mean ms of one call, cycling through `fns` (closures over distinct
    copies of the inputs, so the 50 MB L2 holds none of them from one call
    to the next, as in a serving step that walks every layer's weights)."""
    for i in range(warmup * len(fns)):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = max(iters, len(fns))
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def copies_for(nbytes):
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def bound(nbytes, flops):
    t_bytes, t_flops = nbytes / HBM_BPS, flops / BF16_FLOPS
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


class Check:
    """Accumulates one kernel's comparisons and timings."""

    def __init__(self, name, source, replaces, fn):
        self.name, self.source, self.replaces, self.fn = name, source, replaces, fn
        self.err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = 0.0
        self.bound_parts = [0.0, 0.0]
        self.shapes = []

    def compare(self, label, got, want, tol, why):
        torch = sys.modules["torch"]
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= tol
        log(f"  {self.name} {label}: max_abs_err {err:.3e} tol {tol:.1e} "
            f"({why}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{self.name} {label}: error {err} > tol {tol}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{self.name} {label}: non-finite output")
        return err

    def timed(self, label, kernel_fns, plain_fns, library_fns, nbytes, flops):
        torch = sys.modules["torch"]
        k = time_ms(torch, kernel_fns)
        p = time_ms(torch, plain_fns)
        lib = time_ms(torch, library_fns) if library_fns else None
        b, by = bound(nbytes, flops)
        self.ms += k
        self.plain_ms += p
        self.library_ms = None if lib is None or self.library_ms is None \
            else self.library_ms + lib
        self.bound_parts[0] += nbytes / HBM_BPS * 1e3
        self.bound_parts[1] += flops / BF16_FLOPS * 1e3
        self.bound_ms += b
        self.shapes.append(label)
        log(f"  {self.name} {label}: kernel_ms {k:.4f} plain_ms {p:.4f} "
            f"library_ms {'n/a' if lib is None else f'{lib:.4f}'} "
            f"bound_ms {b:.4f} ({by}; {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")

    def record(self, launches):
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": launches,
            "max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
            "bound_ms": self.bound_ms,
            "bound_by": ("bytes" if self.bound_parts[0] >= self.bound_parts[1]
                         else "operations"),
            "library_ms": self.library_ms,
            "shapes": self.shapes,
        }


# -------------------------------------------------------------- phase 1
def phase_environment(torch):
    from repro_torch.kernels import build
    from repro_torch.platform import require_sm90

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"compute capability {require_sm90()} (sm_90a kernels)")
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{n} {s:.1f} s" for n, s in seconds.items()))
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return smi


# -------------------------------------------------------------- phase 2
# The bf16 tolerances.  The plain attention versions are the JAX gather
# lanes: Q·Kᵀ rounded to bf16 before the f32 scale and softmax, where the
# kernels (like the Pallas kernels) keep Q·Kᵀ in f32.  With unit-variance q
# and k (qk-norm output) at D = 128 the unscaled Q·Kᵀ reaches ~|40|, whose
# bf16 rounding (2^-9 relative) moves a scaled logit by up to ~0.02, the
# probabilities by ~2% relative, and so an output of unit-scale V by a few
# 1e-2; 6e-2 bounds that.  Against an f32-math reference on the same bf16
# inputs only the kernels' own roundings remain (p to bf16, 2^-9 relative,
# and the bf16 output), so 2e-2 holds there.  The GEMM's plain version has
# the kernel's arithmetic (f32 accumulate, one rounding): the two differ
# by summation order, i.e. at most about one bf16 ulp of the output,
# 2^-7 relative: tolerance 1e-2 x max(1, max |ref|).  In f32 everything is
# the same algorithm up to summation order: 2e-5 (the JAX tests' own
# tolerance) for attention, 1e-5 x max(1, max |ref|) for the GEMM.
ATT_TOL_PLAIN_BF16 = 6e-2
ATT_TOL_F32MATH_BF16 = 2e-2
ATT_TOL_F32 = 2e-5
MM_RTOL_BF16 = 1e-2
MM_RTOL_F32 = 1e-5


def _gather_kv(torch, k_pool, v_pool, tables):
    """(B, Hkv, nbt*bs, D) contiguous K/V of each table row."""
    b, nbt = tables.shape
    bs, hkv, d = k_pool.shape[1:]
    k = k_pool[tables.long()].reshape(b, nbt * bs, hkv, d).transpose(1, 2)
    v = v_pool[tables.long()].reshape(b, nbt * bs, hkv, d).transpose(1, 2)
    return k.contiguous(), v.contiguous()


def check_decode(torch, chk):
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    F = torch.nn.functional
    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(1)
    # qwen3-1.7b heads, 8 slots, block_size 16, 64-block tables over the
    # serving pool (8 x 64 + 1 blocks); slot 4 is an inactive slot (all-null
    # table, length 1, as the serving path passes it)
    b, h, hkv, d, bs, nbt = 8, 16, 8, 128, 16, 64
    nb = b * nbt + 1
    lengths = torch.tensor([1, 16, 17, 1000, 1, 250, 513, 1024],
                           dtype=torch.int32, device=dev)
    perm = torch.randperm(nb - 1, generator=g, device=dev)[: b * nbt] + 1
    tables = perm.reshape(b, nbt).to(torch.int32)
    tables[4] = 0
    real = [i for i in range(b) if i != 4]
    q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    out = KA.paged_decode_attention(q, kp, vp, lengths, tables)
    want = R.paged_decode_attention_ref(q, kp, vp, lengths, tables)
    chk.err = max(chk.err, chk.compare(
        "bf16 vs plain (real slots)", out[real], want[real],
        ATT_TOL_PLAIN_BF16, "f32 vs bf16 Q·Kᵀ rounding"))
    exact = R.paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                         lengths, tables)
    chk.compare("bf16 vs f32-math reference", out[real], exact[real],
                ATT_TOL_F32MATH_BF16, "p and output rounded to bf16")

    n_copy = copies_for(2 * kp.numel() * 2)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(n_copy - 1)]
    kfns = [lambda kq=kq, vq=vq: KA.paged_decode_attention(q, kq, vq, lengths, tables)
            for kq, vq in pools]
    pfns = [lambda kq=kq, vq=vq: R.paged_decode_attention_ref(q, kq, vq, lengths, tables)
            for kq, vq in pools]
    kk, vv = _gather_kv(torch, kp, vp, tables)
    pos = torch.arange(nbt * bs, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    libs = [lambda: F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask,
                                                   enable_gqa=True)]
    rows = int(lengths.sum())
    nbytes = 2 * q.numel() * 2 + 2 * rows * hkv * d * 2 + (tables.numel() + b) * 4
    flops = 4 * rows * h * d
    chk.timed(f"B={b} H={h} Hkv={hkv} D={d} bs={bs} nbt={nbt} bf16 "
              "(library: SDPA over pre-gathered K/V, gather excluded)",
              kfns, pfns, libs, nbytes, flops)

    # f32 at tests/test_serving_runtime.py's shapes (first row), then other
    # head geometries: G = 1 / 8 / 4, D = 64 / 128 / 256, block 8 / 32 / 16
    for b, h, hkv, d, bs, nbt, lens in [(3, 4, 2, 16, 8, 4, (5, 19, 32)),
                                        (2, 8, 8, 64, 8, 5, (40, 1)),
                                        (2, 32, 4, 128, 32, 3, (70, 96)),
                                        (2, 16, 4, 256, 16, 4, (33, 64))]:
        nb = b * nbt + 1
        q = torch.randn((b, h, d), generator=g, device=dev)
        kp = torch.randn((nb, bs, hkv, d), generator=g, device=dev)
        vp = torch.randn((nb, bs, hkv, d), generator=g, device=dev)
        tables = (torch.randperm(nb - 1, generator=g, device=dev)[: b * nbt] + 1
                  ).reshape(b, nbt).to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        chk.compare(f"f32 H={h} Hkv={hkv} D={d} bs={bs} vs plain",
                    KA.paged_decode_attention(q, kp, vp, lengths, tables),
                    R.paged_decode_attention_ref(q, kp, vp, lengths, tables),
                    ATT_TOL_F32, "same algorithm, f32 summation order")


def _prefill_case(torch, g, c, h, hkv, d, bs, nbt, nb, segs, dtype):
    """Random inputs for one packed chunk: segs = [(seg_len, kv_start)],
    packed from row 0; disjoint per-segment tables."""
    dev = DEVICE
    ns = len(segs)
    q = torch.randn((1, c, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(dtype)
    perm = torch.randperm(nb - 1, generator=g, device=dev)[: ns * nbt] + 1
    tables = perm.reshape(ns, nbt).to(torch.int32)
    info, q0 = [], 0
    for i, (n, kv0) in enumerate(segs):
        info.append((q0, n, kv0))
        if n == 0:
            tables[i] = 0
        q0 += n
    info = torch.tensor(info, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, info


def _real_rows(info):
    return [r for q0, n, _ in info.tolist() for r in range(q0, q0 + n)]


def check_prefill(torch, chk, block_q):
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ref as R

    F = torch.nn.functional
    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(2)
    # chunk 256 of qwen3-1.7b heads: a fresh segment, a resumed one
    # (kv_start 544 > 0), a mid-prompt continuation, an idle segment, and
    # 6 padding rows past the fill
    c, h, hkv, d, bs, nbt = 256, 16, 8, 128, 16, 64
    nb = 8 * nbt + 1
    segs = [(120, 0), (100, 544), (30, 16), (0, 0)]
    q, kp, vp, tables, info = _prefill_case(torch, g, c, h, hkv, d, bs, nbt, nb,
                                            segs, torch.bfloat16)
    real = _real_rows(info)
    out = KA.paged_prefill_attention(q, kp, vp, tables, info, block_q=block_q)
    want = R.packed_prefill_attention_ref(q, kp, vp, tables, info)
    chk.err = max(chk.err, chk.compare(
        "bf16 vs plain (real rows)", out[0, real], want[0, real],
        ATT_TOL_PLAIN_BF16, "f32 vs bf16 Q·Kᵀ rounding"))
    exact = R.packed_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                           tables, info)
    chk.compare("bf16 vs f32-math reference", out[0, real], exact[0, real],
                ATT_TOL_F32MATH_BF16, "p and output rounded to bf16")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("prefill kernel: padding rows not finite")

    n_copy = copies_for(2 * kp.numel() * 2)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(n_copy - 1)]
    kfns = [lambda kq=kq, vq=vq: KA.paged_prefill_attention(
        q, kq, vq, tables, info, block_q=block_q) for kq, vq in pools]
    pfns = [lambda kq=kq, vq=vq: R.packed_prefill_attention_ref(
        q, kq, vq, tables, info) for kq, vq in pools]
    # library: one SDPA call over the segments batched and padded, with
    # their K/V already gathered contiguous (the gather is not timed)
    live = [(i, q0, n, kv0) for i, (q0, n, kv0) in enumerate(info.tolist()) if n]
    lq = max(n for _, _, n, _ in live)
    lk = max(kv0 + n for _, _, n, kv0 in live)
    qb = torch.zeros((len(live), h, lq, d), dtype=q.dtype, device=dev)
    mask = torch.zeros((len(live), 1, lq, lk), dtype=torch.bool, device=dev)
    kk, vv = _gather_kv(torch, kp, vp, tables[[i for i, *_ in live]])
    kk, vv = kk[:, :, :lk].contiguous(), vv[:, :, :lk].contiguous()
    rows_keys = 0
    for j, (_, q0, n, kv0) in enumerate(live):
        qb[j, :, :n] = q[0, q0:q0 + n].transpose(0, 1)
        qpos = kv0 + torch.arange(n, device=dev)
        mask[j, 0, :n] = torch.arange(lk, device=dev)[None, :] <= qpos[:, None]
        mask[j, 0, n:, 0] = True
        rows_keys += sum(kv0 + r + 1 for r in range(n))
    libs = [lambda: F.scaled_dot_product_attention(qb, kk, vv, attn_mask=mask,
                                                   enable_gqa=True)]
    kv_rows = sum(kv0 + n for _, _, n, kv0 in live)
    nbytes = 2 * q.numel() * 2 + 2 * kv_rows * hkv * d * 2 + tables.numel() * 4
    flops = 4 * rows_keys * h * d
    chk.timed(f"C={c} S=4 (fill {len(real)}, kv_start 544 resumed, 1 idle) "
              f"H={h} Hkv={hkv} D={d} block_q={block_q} bf16 (library: SDPA "
              "over pre-gathered, padded K/V, gather excluded)",
              kfns, pfns, libs, nbytes, flops)

    # f32 at the four cases of tests/test_packed_prefill.py
    h, hkv, d, bs, nbt, nb = 4, 2, 16, 8, 6, 32
    for seg_lens, kv_starts, bq in [((5, 9), (7, 0), None),
                                    ((3, 4, 2), (0, 11, 5), 4),
                                    ((6, 1, 8, 3), (2, 0, 9, 0), 8),
                                    ((11,), (13,), 4)]:
        c = sum(seg_lens) + 2
        q, kp, vp, tables, info = _prefill_case(
            torch, g, c, h, hkv, d, bs, nbt, nb, list(zip(seg_lens, kv_starts)),
            torch.float32)
        real = _real_rows(info)
        chk.compare(f"f32 segs {seg_lens} vs plain",
                    KA.paged_prefill_attention(q, kp, vp, tables, info,
                                               block_q=bq)[0, real],
                    R.packed_prefill_attention_ref(q, kp, vp, tables, info)[0, real],
                    ATT_TOL_F32, "same algorithm, f32 summation order")
    # other head geometries (D = 256 in f32 takes > 48 KB of shared memory)
    for h, hkv, d, bs in [(8, 8, 64, 8), (32, 4, 128, 32), (16, 4, 256, 16)]:
        segs = [(7, 0), (12, 13), (0, 0)]
        q, kp, vp, tables, info = _prefill_case(torch, g, 21, h, hkv, d, bs, 4,
                                                16, segs, torch.float32)
        real = _real_rows(info)
        chk.compare(f"f32 H={h} Hkv={hkv} D={d} bs={bs} vs plain",
                    KA.paged_prefill_attention(q, kp, vp, tables, info)[0, real],
                    R.packed_prefill_attention_ref(q, kp, vp, tables, info)[0, real],
                    ATT_TOL_F32, "same algorithm, f32 summation order")


def check_matmul(torch, chk, cfg):
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ref as R

    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(3)
    d, hd = cfg.d_model, cfg.hd
    roles = [("qkv_proj", d, cfg.n_heads * hd, None),
             ("qkv_proj(k,v)", d, cfg.n_kv_heads * hd, None),
             ("mlp_up", d, cfg.d_ff, "silu"),
             ("mlp_down", cfg.d_ff, d, None),
             ("lm_head", d, cfg.vocab, None)]
    for m in (8, 256):
        for role, k, n, act in roles:
            x = (torch.randn((m, k), generator=g, device=dev)).to(torch.bfloat16)
            w = (torch.randn((k, n), generator=g, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            out = KM.matmul_fused(x, w, None, act)
            want = R.matmul_ref(x, w, None, act)
            tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
            chk.err = max(chk.err, chk.compare(
                f"{role} M={m} K={k} N={n} act={act} bf16 vs plain", out, want,
                tol, "f32 summation order, one bf16 rounding"))
            ws = [w] + [w.clone() for _ in range(copies_for(w.numel() * 2) - 1)]
            kfns = [lambda wq=wq: KM.matmul_fused(x, wq, None, act) for wq in ws]
            pfns = [lambda wq=wq: R.matmul_ref(x, wq, None, act) for wq in ws]
            if act == "silu":
                lfns = [lambda wq=wq: torch.nn.functional.silu(torch.matmul(x, wq))
                        for wq in ws]
            else:
                lfns = [lambda wq=wq: torch.matmul(x, wq) for wq in ws]
            nbytes = 2 * (m * k + k * n + m * n)
            chk.timed(f"{role} M={m} K={k} N={n} act={act} bf16 "
                      "(library: torch.matmul + activation)",
                      kfns, pfns, lfns, nbytes, 2 * m * n * k)
    # f32 at small ragged and aligned shapes (the JAX kernel tests' scale)
    for (m, k, n) in ((37, 70, 53), (64, 128, 256)):
        for act in (None, "silu", "gelu"):
            x = torch.randn((m, k), generator=g, device=dev)
            w = torch.randn((k, n), generator=g, device=dev)
            b = torch.randn((n,), generator=g, device=dev)
            out = KM.matmul_fused(x, w, b, act)
            want = R.matmul_ref(x, w, b, act)
            tol = MM_RTOL_F32 * max(1.0, want.abs().max().item())
            chk.compare(f"f32 M={m} K={k} N={n} act={act} bias vs plain",
                        out, want, tol, "f32 summation order")
    # bf16 edges the serving shapes never reach: K and N not multiples of 8
    # (element-wise tile loads), bias, and M between the two tile heights
    for (m, k, n) in ((37, 70, 53), (20, 2048, 1000)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
             ).to(torch.bfloat16)
        b = torch.randn((n,), generator=g, device=dev).to(torch.bfloat16)
        want = R.matmul_ref(x, w, b, "gelu")
        tol = MM_RTOL_BF16 * max(1.0, want.float().abs().max().item())
        chk.compare(f"bf16 M={m} K={k} N={n} act=gelu bias vs plain",
                    KM.matmul_fused(x, w, b, "gelu"), want, tol,
                    "f32 summation order, one bf16 rounding")


# -------------------------------------------------------------- phase 3
# First-token agreement between the kernel lanes and the torch lanes: each
# lane rounds differently at every layer (f32 vs bf16 Q·Kᵀ, the gate's
# activation fused before or after the bf16 rounding), so the bf16 logits
# of the two engines differ by a few bf16 ulps of logits of magnitude ~4
# (ulp 2^-5).  Tokens must agree wherever the reference's top-2 margin
# exceeds FIRST_TOKEN_MARGIN.
FIRST_TOKEN_MARGIN = 0.25
PROMPT_LENS = [32, 700, 64, 512, 96, 384, 128, 256, 48, 640, 160, 448, 200,
               600, 80, 320]


def _spy_first_logits(eng):
    """Record each request's first-token logits (the prefill lane's row)."""
    store = {}
    orig = eng.adapter.dispatch

    def dispatch(params, dec_rids, lengths, last_tok, chunks, *rest):
        out = orig(params, dec_rids, lengths, last_tok, chunks, *rest)
        for i, (req, start, n) in enumerate(chunks):
            if start + n == req.prompt_len:
                store[req.rid] = eng.adapter.last_seg_logits[i].float().cpu()
        return out

    eng.adapter.dispatch = dispatch
    return store


def phase_serve(torch, cfg, block_q, profile=False):
    import numpy as np

    from repro_torch.core.plan import InferencePlan, OpChoice
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels.dispatch import MATMUL_ROLES
    from repro_torch.models import DecoderLM
    from repro_torch.serve.router import PlanRouter
    from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig

    model = DecoderLM(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = model.serving_params(model.init(gen), DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}; {n_params / 1e9:.3f} G params "
        f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB) "
        f"initialised in {time.perf_counter() - t0:.1f} s")

    plan = InferencePlan("serve", "h100")
    for stage in ("decode", "prefill_chunk"):
        plan.choices[f"{stage}.attention"] = OpChoice(
            "cuda_attention", {"block_q": block_q, "max_segments": 4}, 0.0)
        for role in MATMUL_ROLES:
            plan.choices[f"{stage}.{role}"] = OpChoice("cuda_matmul", {}, 0.0)
    rcfg = RuntimeConfig(max_slots=8, block_size=16, max_blocks_per_seq=64,
                         chunk_tokens=256, chunk_segments=4, max_new_tokens=32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]

    def serve(router, label, profile=False):
        eng = ContinuousEngine(model, params, rcfg, router=router, device=DEVICE)
        firsts = _spy_first_logits(eng)
        log(f"[{label}] pool {tuple(eng.cache.k.shape)} x2 "
            f"{2 * eng.cache.k.numel() * eng.cache.k.element_size() / 1e9:.2f} GB")
        for p in prompts:
            eng.submit(p)
        torch.cuda.synchronize()
        if profile:
            from torch.profiler import ProfilerActivity
            with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
                done = eng.run()
                torch.cuda.synchronize()
        else:
            done = eng.run()
            torch.cuda.synchronize()
        s = eng.metrics.summary()
        if profile:
            _log_device_profile(prof, s["wall_s"], label)
        log(f"[{label}] {int(s['requests'])} requests, {int(s['tokens_out'])} "
            f"tokens in {s['wall_s']:.3f} s: {s['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {s['ttft_p50_s']:.3f} s p95 {s['ttft_p95_s']:.3f} s, "
            f"latency p95 {s['latency_p95_s']:.3f} s; steps: "
            f"{int(s['chunk_steps'])} unified ({int(s['prefill_chunks'])} chunks, "
            f"{int(s['packed_segments'])} packed segments, fill "
            f"{s['chunk_fill_frac']:.2f}), {int(s['decode_only_steps'])} "
            f"decode-only, {int(s['decode_steps'])} with decode rows; "
            f"prefill_time {s['prefill_time_s']:.3f} s decode_time "
            f"{s['decode_time_s']:.3f} s; preemptions {int(s['preemptions'])}")
        if len(done) != len(prompts):
            raise AssertionError(f"[{label}] {len(done)} of {len(prompts)} finished")
        for r in done:
            if len(r.output) != rcfg.max_new_tokens:
                raise AssertionError(f"[{label}] request {r.rid}: {len(r.output)} tokens")
            if not all(0 <= t < cfg.vocab for t in r.output):
                raise AssertionError(f"[{label}] request {r.rid}: token out of range")
        for rid, logits in firsts.items():
            if logits.shape != (cfg.vocab,) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"[{label}] request {rid}: bad first-token logits")
        eng.cache.alloc.check_invariants()
        if eng.cache.alloc.num_used != 0:
            raise AssertionError(f"[{label}] pool did not drain")
        if s["decode_only_steps"] == 0 or s["packed_segments"] == 0 or \
                s["prefill_chunks"] <= len(prompts):
            raise AssertionError(f"[{label}] chunking / packing / decode-only "
                                 "steps did not all occur")
        return {r.rid: r.output for r in done}, firsts, s

    counters = (KA.paged_decode_attention, KA.paged_prefill_attention,
                KM.matmul_fused)
    for fn in counters:
        fn.launches = 0
    out_k, first_k, summary = serve(PlanRouter(plan), "kernel lanes", profile)
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"launches on the serving path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the serving path")

    out_t, first_t, _ = serve(PlanRouter(None), "torch lanes", profile)
    compared, agree, max_dlogit = 0, 0, 0.0
    for rid, ref_logits in first_t.items():
        max_dlogit = max(max_dlogit,
                         (first_k[rid] - ref_logits).abs().max().item())
        top2 = torch.topk(ref_logits, 2).values
        margin = float(top2[0] - top2[1])
        if margin > FIRST_TOKEN_MARGIN:
            compared += 1
            agree += out_k[rid][0] == out_t[rid][0]
            if out_k[rid][0] != out_t[rid][0]:
                raise AssertionError(
                    f"request {rid}: first token {out_k[rid][0]} on the kernel "
                    f"lanes vs {out_t[rid][0]} on the torch lanes at margin {margin:.3f}")
    same_stream = sum(out_k[r] == out_t[r] for r in out_t)
    log(f"first tokens: {agree}/{compared} agree where the torch-lane top-2 "
        f"margin > {FIRST_TOKEN_MARGIN} (of {len(first_t)}); max |logit "
        f"difference| {max_dlogit:.4f}; whole 32-token streams identical for "
        f"{same_stream}/{len(out_t)}")
    if compared == 0:
        raise AssertionError("no request had a first-token margin to compare")
    return launches, summary


def _log_device_profile(prof, wall_s, label):
    """Device time by kernel over a serving run (torch.profiler, CUDA
    activity only), and the device's busy share of the run's wall time."""
    rows = []
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total", 0) or 0
        if t_us > 0:
            rows.append((t_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(t for t, _, _ in rows) / 1e6
    log(f"[{label}] profile: device busy {busy_s:.3f} s of {wall_s:.3f} s wall "
        f"({100 * busy_s / max(wall_s, 1e-9):.1f}%); top kernels by device time:")
    for t_us, key, count in rows[:12]:
        log(f"[{label}]   {t_us / 1e3:10.2f} ms  {count:7d} calls  {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace both serving runs with torch.profiler and "
                         "print device time by kernel")
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel checks (no result line)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import attention as KA
        from repro_torch.kernels import matmul as KM
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_environment(torch)

    checks = [
        Check("paged_decode_attention", "src/repro_torch/kernels/csrc/paged_decode.cu",
              "src/repro/kernels/attention.py:365", KA.paged_decode_attention),
        Check("paged_prefill_attention", "src/repro_torch/kernels/csrc/paged_prefill.cu",
              "src/repro/kernels/attention.py:294", KA.paged_prefill_attention),
        Check("matmul_fused", "src/repro_torch/kernels/csrc/matmul.cu",
              "src/repro/kernels/matmul.py:57", KM.matmul_fused),
    ]
    log("== kernels against their plain versions")
    check_decode(torch, checks[0])
    check_prefill(torch, checks[1], PREFILL_BLOCK_Q)
    check_matmul(torch, checks[2], get_config("qwen3-1.7b"))
    torch.cuda.synchronize()
    if args.skip_serve:
        log("--skip-serve: stopping after the kernel checks")
        return 3

    log("== serving qwen3-1.7b through ContinuousEngine")
    launches, _ = phase_serve(torch, get_config("qwen3-1.7b"), PREFILL_BLOCK_Q,
                              args.profile)
    kernels = [c.record(launches[c.fn.__name__]) for c in checks]
    print(json.dumps({"kernels": kernels}))
    print(smi)                       # the card's name and power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
