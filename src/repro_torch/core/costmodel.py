"""Search fitness on the H100: measured device time, or an analytic model
of the port's kernels.

The paper's fitness is measured (§2.3 Step2: "compile the generated codes
just-in-time ... execute them to get the runtime"); the JAX package
defaults to an analytic model of its TPU, with the same interface.  The
port has both, over its own Hopper kernels:

  * `WallClockFitness` (the default of `Tuner`, `SearchTask`, `select` and
    `build_serve_plan`, which raise where there is no GPU) times both lanes
    of the backend race — a tuned kernel configuration (`__call__`) and the
    vendor lane, the port's `ref_ops` on cuBLAS / cuDNN (`vendor_time`) —
    on the same inputs.  On the GPU a measurement is device time: a few
    calls captured in one CUDA graph through `launch.program.Program` (its
    first call runs them eagerly, which also grows a split launch's
    counters) and replayed between CUDA events, the calls cycling through
    enough copies of the inputs that the 50 MB L2 holds none of them from
    one call to the next.  No host time between launches enters it.  On a
    CPU device (an explicit choice) the host clock times the plain
    versions.  A configuration is measured once and its time reused when
    the search revisits it.
  * `ModelFitness` prices a configuration from the launch geometry the
    kernel's own module computes for it (`kernels.matmul.geometry`,
    `kernels.conv2d.geometry`, `kernels.attention.flash_blocks`) and the
    vendor lane from what `ref_ops` runs on CUDA.  It runs on the host, so
    a plan can be tuned where there is no GPU and loaded on the card; it is
    never a silent fallback for a missing device.

The model.  A tiled launch (the GEMM, the conv) runs its CTAs in waves of
`resident` CTAs per SM over the 132 SMs.  Each CTA walks its k-steps
through its cp.async ring: per step it computes a padded tile on the
tensor cores at the rate `mma.sync` reaches (MMA_SYNC_EFF of the `wgmma`
peak `hw.H100` states; the f32 conv's 3xTF32 three TF32 products at the
TF32 rate; the f32 GEMM on the CUDA cores) and loads its x and w slabs —
x once per column tile, w once per row tile, so the re-reads come from L2
— at the lesser of its share of the L2 rate and what the bytes its ring
keeps in flight allow over one memory latency (Little's law; element-wise
loads keep SCALAR_INFLIGHT bytes a thread).  The launch costs the larger of
the waves' compute and loads and the unique bytes over HBM (inputs,
output, and a split's f32 partials written and read once), plus its
launch, a pipeline fill per wave and, for a split, the serial tail in
which the last CTA of a tile sums the S partials.  The conv's 3xTF32
tile is bound by latency, not by the SM: its k-steps are priced at a rate
of the CTA's own, measured on the card (`conv2d_cost`).  The flash kernel walks,
for each query tile, only the key tiles up to its last row's diagonal
(top-left causal mask), re-reading K/V per query tile from L2 through a
two-stage ring (one tile in flight), with its softmax on the CUDA cores.

`max_segments` (the chunk lane's packing width, read by the scheduler)
is priced by what packing does on the card.  A packed chunk of `ns`
segments commits `ns` requests' prompt segments in one unified step where
single-segment packing takes `ns` steps, so the node's per-step fixed cost
— its launch in the captured step program — is shared by `ns` segments.
Against that, `paged_prefill.cu` walks each segment that intersects a
query tile as a pass of its own: each segment boundary makes one query
tile per KV head run a second pass, which pays another pipeline fill and
re-stages a key tile.  So t(ns) = body + LAUNCH_S / ns + (ns - 1) x the
boundary passes' share of the card: an optimum strictly inside the width
range, where the wall-clock fitness, whose one launch cannot price
packing, ties every width (`UNPRICED_KEYS`).

The vendor lanes: matmul is one cuBLAS product (`torch.matmul`; bf16 with
f32 accumulation), then the bias add and the activation as PyTorch
elementwise kernels; conv is `F.conv2d` on cuDNN with TF32 off — f32 on
the CUDA cores, a tile per CTA over the whole K, no split — after a pad
where SAME padding is asymmetric, then the bias add and the activation;
attention is `ref_ops.attention`'s einsum lane (the logits materialized in
f32, masked at the bottom right, so it reads the whole context).

Every efficiency constant below is fitted to an H100 device time recorded
in PERF.md (NVIDIA H100 80GB HBM3, 700.00 W) and names it; every rate is
`hw.H100`'s.  `tests/test_torch_costmodel.py` holds the model to those
records and to `roofline_bound`, and `chip_smoke.py` checks it
configuration by configuration against device time on the card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import time
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import hw
from repro_torch.core import ref_ops
from repro_torch.core.schedules import Config, OpDesc
from repro_torch.kernels import attention as attn_kernel
from repro_torch.kernels import conv2d as conv_kernel
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.platform import DeviceLike, resolve_device

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# config keys no kernel reads at launch: `max_segments` is the chunk lane's
# packing width, read by the scheduler (`PlanRouter.chunk_segments`); one
# kernel launch cannot price it, so the wall-clock fitness ties its values
# (the model prices it: see the module docstring)
UNPRICED_KEYS = ("max_segments",)

# ---------------------------------------------------------------- the card
# The efficiency constants are fitted to device times of an NVIDIA H100
# 80GB HBM3 at 700.00 W recorded in PERF.md (CUDA-graph replay), which
# `tests/test_torch_costmodel.py` lists as records.  The seven marked
# [GEMM] were fitted together, by a coordinate search for the least worst
# log ratio of model to record over the GEMM's 26 records (PERF.md §6 row
# 3 and its table at granite's and qwen2-moe's shapes: every one within
# 1.18x); each comment names the records that pin it most.
#
# a launch's floor inside a replayed CUDA graph: PERF.md §6 row 5, an empty
# launch of the elementwise kernel's geometry, 0.0012 ms
LAUNCH_S = 1.2e-6
# [GEMM] one memory latency (a pipeline fill, a split's arrive; Little's
# law for the bytes a CTA keeps in flight): the M = 8 shapes, where few
# bytes per CTA leave it exposed (qwen2-moe qkv 0.0092 ms, granite k / v
# 0.0108 ms)
MEM_LATENCY_S = 1.2e-6
# [GEMM] HBM efficiency of a streaming launch (and of PyTorch's elementwise
# kernels): the weight-bound M = 8 shapes (granite mlp_up 0.0430 / mlp_down
# 0.0412 ms, qwen2-moe lm_head 0.2131 ms against its 0.1865 ms bound)
HBM_EFF = 0.77
# [GEMM] the L2 rate at which the tiles re-read their x and w slabs: qwen3
# lm_head at M = 256 (265 TFLOP/s, PERF.md §6 row 3) and the M = 256
# column (granite mlp_up 0.1565 ms)
L2_BW = 4.0e12
# [GEMM] the fraction of the wgmma peak (`hw.H100`) that the tiles'
# mma.sync reaches: the M = 256 column and mamba2's chunk lane (in_proj 256
# x 2560 -> 10576, 0.0943 ms)
MMA_SYNC_EFF = 0.30
# [GEMM] the CUDA-core tiles' rate (the f32 GEMM, the f32 flash tile), a
# fraction of the FP32 peak: ResNet-18's fc (M = 1, K = 512, N = 1000,
# 0.0105 ms)
F32_TILE_EFF = 0.25
# [GEMM] the rate at which the last CTA of a split tile reads the S f32
# partials: granite k / v at M = 8 (S = 32 partial tiles, 0.0108 ms)
TAIL_BW = 42e9
# [GEMM] bytes a thread keeps in flight on element-wise loads (the GEMM's
# path for K or N not a multiple of 8; bf16 conv gathers for Cin not a
# multiple of its k-step): granite lm_head (N % 8 = 3) at M = 8, 0.6077 ms
SCALAR_INFLIGHT = 40
# The conv tile (3xTF32 in f32), fitted by least squares on log time to
# the device times of all 157 valid configurations of ResNet-18's 15
# distinct convs measured by `chip_smoke.py` phase 10 (PR 23; PERF.md §6):
# rms log error 0.095.  A CTA's k-step costs CONV_STEP_S plus its tile's
# products at CONV_CTA_FLOPS, a rate of the CTA's own that co-resident CTAs
# do not share (the three dependent m16n8k8 products of each fragment and
# the hi / lo splits from scalar shared-memory loads leave the tile bound
# by latency, not by the SM's tensor cores); a Cin that is not a multiple
# of the k-step adds CONV_GATHER_S for each element a thread gathers (the
# stem); a split's last CTA sums the partials CONV_TAIL_LOADS a batch
# (`csrc/conv2d.cu`'s SB) at CONV_TAIL_BATCH_S a batch.
CONV_STEP_S = 0.51e-6
CONV_CTA_FLOPS = 2.8e11
CONV_GATHER_S = 81e-9
CONV_TAIL_LOADS = 8
CONV_TAIL_BATCH_S = 0.34e-6
# CUDA-core operations per score in the flash tile (mma_attention.cuh):
# scale, mask select, running max, subtract, exp, sum, round to bf16
SOFTMAX_OPS = 7
# --- the vendor lanes
# cuBLAS's fixed cost per product (launch and its latency): torch.matmul
# at qwen2-moe qkv M = 8, 0.0063 ms against a 0.0025 ms bound
CUBLAS_FIXED_S = 3.6e-6
# cuBLAS's HBM efficiency: torch.matmul at qwen2-moe lm_head M = 8, 0.2039
# ms against 0.1865
CUBLAS_HBM_EFF = 0.93
# cuBLAS's fraction of the bf16 peak: torch.matmul at qwen3 lm_head M =
# 256, 601 TFLOP/s (PERF.md §6 row 3 / ROADMAP queue 2)
CUBLAS_MMA_EFF = 0.61
# cuBLAS's slowdown where K or N is not a multiple of 8, of its bytes and
# of its arithmetic: torch.matmul at granite lm_head (N = 49155) at M = 8,
# 0.3372 ms, and at M = 256, 0.7207 ms
CUBLAS_UNALIGNED_BYTES = 2.6
CUBLAS_UNALIGNED_FLOPS = 4.2
# cuDNN's f32 conv (TF32 off) at batch 1: a CUDNN_TILE output tile a CTA,
# over the whole K, at CUDNN_F32_EFF of an SM's FP32 rate, after a fixed
# CUDNN_FIXED_S: fitted by least squares on log time to the vendor lane's
# device times at ResNet-18's 15 distinct convs (`chip_smoke.py` phase 10,
# PR 23: rms log error 0.077); F.conv2d + relu over the 20 convs then
# comes to 1.02x PERF.md §6 row 4's 1.0567 ms, the stem to 1.43x below
# the kernel's (1.40x measured, §5)
CUDNN_TILE = (64, 64)
CUDNN_F32_EFF = 0.57
CUDNN_FIXED_S = 4.3e-6


def roofline_bound(op: OpDesc, chip: hw.Chip = hw.H100) -> float:
    """The least time the chip could take for `op` (seconds): the larger of
    its flops over the peak for its dtype (f32 CUDA cores for f32, bf16
    tensor cores for bf16) and its bytes (each input read once, the output
    written once) over the HBM rate."""
    return max(op.flops() / chip.peak_flops(op.dtype), op.io_bytes() / chip.hbm_bw)


def kernel_bound(op: OpDesc, chip: hw.Chip = hw.H100) -> float:
    """`roofline_bound` of the work the kernel lane must do: the op itself,
    but for causal attention with Sq < Skv, whose top-left mask lets no
    query row see a key past Sq (`roofline_bound` counts the whole
    context there: PERF.md §6 row 6 measured the decode node's 8 x 1 x
    1024 call at 0.0037 ms, below that bound's 0.020)."""
    if op.kind == "attention" and op.d["q"] < op.d["kv"]:
        d = op.d
        op = OpDesc.attention(d["b"], d["q"], d["q"], d["h"], d["d"], op.dtype)
    return roofline_bound(op, chip)


@dataclasses.dataclass
class CostBreakdown:
    compute_s: float     # the waves' arithmetic (tensor or CUDA cores)
    memory_s: float      # the waves' loads, or the unique bytes over HBM
    overhead_s: float    # launch, pipeline fills, a split's serial tail

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.overhead_s


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- the GEMM
def _gemm_geometry(op: OpDesc, cfg: Config) -> mm_kernel.GemmGeometry:
    """The geometry `ops.matmul` launches for `cfg`: its (tile_m, split_k)
    through `kernels.matmul.geometry` where it gives them, else the
    default rule `gemm_geometry`."""
    m, n, k = op.gemm_view()
    dtype = _TORCH_DTYPES[op.dtype]
    if "tile_m" in cfg and "split_k" in cfg:
        geo = mm_kernel.geometry(m, n, k, dtype, cfg["tile_m"], cfg["split_k"])
        if geo is None:
            raise ValueError(f"matmul config {cfg}: the GEMM cannot launch it at "
                             f"M={m} N={n} K={k} {op.dtype}")
        return geo
    return mm_kernel.gemm_geometry(m, n, k, dtype)


def matmul_cost(op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> CostBreakdown:
    """`csrc/matmul.cu` at `cfg`: bm x 128 x 64 bf16 tiles on mma.sync (a
    4-stage ring; 3 at bm 128) or the 64 x 64 x 16 f32 tile on the CUDA
    cores (loads, then products: no ring), S splits of K.  A CTA's
    products go at its SM's share of the rate; its x and w slabs come at
    the lesser of its share of L2_BW and what its ring keeps in flight
    over a memory latency."""
    m, n, k = op.gemm_view()
    item = hw.itemsize(op.dtype)
    geo = _gemm_geometry(op, cfg)
    tiles_m, tiles_n = _cdiv(m, geo.bm), _cdiv(n, geo.bn)
    ctas = tiles_m * tiles_n * geo.split
    steps = geo.steps_per_split(k)
    threads = mm_kernel.tile_threads(geo, item)
    resident = chip.resident_blocks(mm_kernel.tile_smem_bytes(geo, item), threads)
    waves = _cdiv(ctas, resident * chip.sms)
    rows, cols = m / tiles_m, n / tiles_n            # a CTA's valid outputs
    step_bytes = (rows + cols) * geo.bk * item       # past M / N: zero-filled, not read
    if item == 4:
        rate, overlapped = chip.peak_f32_flops * F32_TILE_EFF, False
        inflight = step_bytes
    else:
        rate, overlapped = chip.peak_bf16_flops * MMA_SYNC_EFF, True
        inflight = (geo.stages - 1) * step_bytes
        if k % 8 or n % 8:                           # element loads, no ring
            inflight, overlapped = threads * SCALAR_INFLIGHT, False
    compute = _cdiv(ctas, chip.sms) * 2.0 * geo.bm * geo.bn * geo.bk * steps \
        * chip.sms / rate
    loads = max(ctas * step_bytes * steps / L2_BW,
                waves * step_bytes * steps * MEM_LATENCY_S / inflight)
    if not overlapped:
        compute, loads = 0.0, compute + loads
    unique = item * (m * k + k * n + m * n)
    overhead = LAUNCH_S + waves * MEM_LATENCY_S
    if geo.split > 1:
        # partials written and read once; the arrive; the last CTA's sum
        unique += 2 * geo.split * m * n * 4
        overhead += waves * MEM_LATENCY_S + geo.split * rows * cols * 4 / TAIL_BW
    return CostBreakdown(compute, max(loads, unique / (chip.hbm_bw * HBM_EFF)), overhead)


# ---------------------------------------------------------------- the conv
def _conv_args(op: OpDesc):
    d = op.d
    return (d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"], d["kw"],
            d["stride"], "SAME" if d["pad"] else "VALID")


def conv2d_cost(op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> CostBreakdown:
    """`csrc/conv2d.cu` at `cfg` (`kernels.conv2d.geometry`): an implicit
    GEMM of `row_block` output rows x `bn` channels a tile, BK = 32
    k-steps, split-K where the tiles leave SMs idle; f32 as 3xTF32 (three
    TF32 products a step), bf16 on m16n8k16 (one; not measured: the f32
    tile's per-CTA rate).  A wave of `resident` CTAs an SM walks its
    k-steps at the CTA's own rate (CONV_STEP_S, CONV_CTA_FLOPS, the stem's
    CONV_GATHER_S), never faster than the SMs' tensor cores at MMA_SYNC_EFF;
    a split adds its partials' serial sum."""
    args = _conv_args(op)
    n, h, w, cin, cout, kh, kw, stride, padding = args
    item = hw.itemsize(op.dtype)
    cfg = cfg if "bn" in cfg and "row_block" in cfg else {
        **conv_kernel.default_config(*args), **cfg}
    geo = conv_kernel.geometry(*args, cfg["bn"], cfg["row_block"], chip, itemsize=item)
    if geo is None:
        raise ValueError(f"conv config {cfg}: the conv kernel cannot launch it")
    bn, bk, threads = cfg["bn"], conv_kernel.BK, conv_kernel.THREADS
    steps = _cdiv(geo.steps, geo.split)
    ctas = geo.tiles_m * geo.tiles_n * geo.split
    waves = _cdiv(ctas, chip.resident_blocks(geo.smem_bytes, threads) * chip.sms)
    products = 3 if item == 4 else 1
    step_flops = 2.0 * products * geo.bm * bn * bk
    step_s = CONV_STEP_S + step_flops / CONV_CTA_FLOPS
    if cin % bk:
        step_s += geo.bm * bk / threads * CONV_GATHER_S
    peak = chip.peak_tf32_flops if item == 4 else chip.peak_bf16_flops
    compute = max(waves * steps * step_s,
                  _cdiv(ctas, chip.sms) * steps * step_flops * chip.sms
                  / (peak * MMA_SYNC_EFF))
    m = n * geo.oh * geo.ow
    unique = item * (n * h * w * cin + kh * kw * cin * cout + m * cout)
    tail = 0.0
    if geo.split > 1:
        unique += 2 * geo.split * m * cout * 4
        tail = (_cdiv(geo.rows * bn, threads) * _cdiv(geo.split, CONV_TAIL_LOADS)
                * CONV_TAIL_BATCH_S)
    overhead = LAUNCH_S + waves * (1 + (geo.split > 1)) * MEM_LATENCY_S + tail
    return CostBreakdown(compute, unique / (chip.hbm_bw * HBM_EFF), overhead)


# --------------------------------------------------------- flash attention
def attention_cost(op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> CostBreakdown:
    """`csrc/flash_attention.cu` at the tile `kernels.attention.flash_blocks`
    launches for `cfg`, on the race's MHA-shaped K/V (an `OpDesc` carries no
    KV-head count): a CTA per (query tile, head, batch) walks the key
    tiles up to its last row's diagonal (top-left causal mask), one tile
    in flight in its two-stage ring, Q·Kᵀ and P·V on mma.sync over its
    query warps' 16-vector fragments, the softmax on the CUDA cores.
    `max_segments` as the module docstring says."""
    d = op.d
    b, sq, skv, heads, hd = d["b"], d["q"], d["kv"], d["h"], d["d"]
    item = hw.itemsize(op.dtype)
    geo = attn_kernel.flash_blocks(cfg.get("block_q"), cfg.get("block_kv"), sq, 1, hd,
                                   item)
    bq, bkv = geo.block_q, geo.block_kv
    qt = _cdiv(sq, bq)
    ctas = qt * heads * b
    resident = chip.resident_blocks(geo.smem_bytes, attn_kernel.THREADS)
    active = min(ctas, resident * chip.sms)
    if item == 2:
        vectors = _cdiv(bq, 16) * 16                 # a query warp's 16-row fragment
        mma_rate = chip.peak_bf16_flops * MMA_SYNC_EFF / max(chip.sms, active)
    else:                                            # the CUDA-core tile
        vectors = bq
        mma_rate = chip.peak_f32_flops * F32_TILE_EFF / max(chip.sms, active)
    cuda_rate = chip.peak_f32_flops / max(chip.sms, active)
    tile_bytes = 2 * bkv * hd * item
    t_tile = max(vectors * bkv * (4.0 * attn_kernel.dmax_of(hd) / mma_rate
                                  + SOFTMAX_OPS / cuda_rate),
                 tile_bytes / min(L2_BW / active, tile_bytes / MEM_LATENCY_S))
    # key tiles a query tile walks (top-left mask: row r sees keys 0..r)
    walks = [min(r0 + min(bq, sq - r0), skv) for r0 in range(0, sq, bq)]
    tiles = [_cdiv(kmax, bkv) for kmax in walks]
    cta_s = [MEM_LATENCY_S + t * t_tile for t in tiles]
    per_head = sum(cta_s)
    slots = resident * chip.sms
    body = max(max(cta_s), per_head * heads * b / slots)
    keys = min(skv, max(tiles) * bkv)                # keys any query tile reads
    unique = item * (2 * b * sq * heads * hd + 2 * b * keys * heads * hd)
    memory = unique / (chip.hbm_bw * HBM_EFF)
    overhead = LAUNCH_S
    ns = int(cfg.get("max_segments") or 1)
    if ns > 1:
        # one launch commits ns segments; each boundary re-runs a pass
        boundary = heads * b * (MEM_LATENCY_S + t_tile) / active
        overhead = LAUNCH_S / ns + (ns - 1) * boundary
    return CostBreakdown(body, memory, overhead)


_KIND_COST = {"matmul": matmul_cost, "conv2d": conv2d_cost,
              "attention": attention_cost}


def kernel_time(op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> float:
    """The modeled device seconds of the port's kernel for `op` at `cfg`
    (the counterpart of the reference's `pallas_time`)."""
    return _KIND_COST[op.kind](op, cfg, chip).total_s


# ---------------------------------------------------------- the vendor lanes
def elementwise_time(nbytes: float, chip: hw.Chip = hw.H100) -> float:
    """One PyTorch elementwise kernel moving `nbytes`."""
    return LAUNCH_S + nbytes / (chip.hbm_bw * HBM_EFF)


def _cublas(flops: float, nbytes: float, dtype: str, aligned: bool,
            chip: hw.Chip) -> float:
    item = hw.itemsize(dtype)
    peak = chip.peak_flops(dtype) * (CUBLAS_MMA_EFF if item == 2 else 1.0)
    t_flops = flops / peak * (1.0 if aligned else CUBLAS_UNALIGNED_FLOPS)
    t_bytes = nbytes / (chip.hbm_bw * CUBLAS_HBM_EFF) * (
        1.0 if aligned else CUBLAS_UNALIGNED_BYTES)
    return CUBLAS_FIXED_S + max(t_flops, t_bytes)


def cublas_time(m: int, n: int, k: int, dtype: str,
                chip: hw.Chip = hw.H100) -> float:
    """One `torch.matmul` of (M, K) @ (K, N): bf16 on the tensor cores
    with f32 accumulation, f32 (TF32 off) on the CUDA cores."""
    return _cublas(2.0 * m * n * k, hw.itemsize(dtype) * (m * k + k * n + m * n),
                   dtype, not (k % 8 or n % 8), chip)


def cudnn_time(op: OpDesc, chip: hw.Chip = hw.H100) -> float:
    """One `F.conv2d` with its bias (cuDNN, TF32 off) on a padded
    channels-last input: a CUDNN_TILE output tile a CTA over the whole K,
    one CTA an SM at CUDNN_F32_EFF of its FP32 rate (for bf16, the cuBLAS
    fraction of the tensor-core rate), then the bias add."""
    m, cout, kdim = op.gemm_view()
    bm, bn = CUDNN_TILE
    item = hw.itemsize(op.dtype)
    sm_rate = chip.peak_flops(op.dtype) / chip.sms * (
        CUDNN_F32_EFF if item == 4 else CUBLAS_MMA_EFF)
    waves = _cdiv(_cdiv(m, bm) * _cdiv(cout, bn), chip.sms)
    body = max(waves * 2.0 * bm * bn * kdim / sm_rate,
               op.io_bytes() / (chip.hbm_bw * HBM_EFF))
    return (CUDNN_FIXED_S + LAUNCH_S + MEM_LATENCY_S + body
            + elementwise_time(2 * m * cout * item + 4 * cout, chip))


def _einsum_attention_time(op: OpDesc, chip: hw.Chip) -> float:
    """`ref_ops.attention` on CUDA: q, k, v laid out for two batched cuBLAS
    products, the (b, h, q, kv) logits written in the input dtype, cast to
    f32, scaled, masked (ones, tril, full_like, where), softmaxed, cast
    back, and the P·V product laid out as (b, q, h, d)."""
    d = op.d
    b, sq, skv, heads, hd = d["b"], d["q"], d["kv"], d["h"], d["d"]
    item = hw.itemsize(op.dtype)
    bh = b * heads
    logits = bh * sq * skv
    q_el, kv_el = b * sq * heads * hd, b * skv * heads * hd
    flops = 2.0 * logits * hd
    t = sum(elementwise_time(2 * e * item, chip) for e in (q_el, kv_el, kv_el))
    t += _cublas(flops, item * (q_el + kv_el + logits), op.dtype, hd % 8 == 0, chip)
    t += elementwise_time(logits * (item + 4), chip)              # .float()
    t += elementwise_time(logits * 8, chip)                       # * scale
    t += 2 * elementwise_time(sq * skv, chip)                     # ones, tril
    t += elementwise_time(logits * 4, chip)                       # full_like
    t += elementwise_time(logits * 12 + sq * skv, chip)           # where
    t += elementwise_time(logits * 8, chip)                       # softmax
    t += elementwise_time(logits * (4 + item), chip)              # .to(dtype)
    t += _cublas(flops, item * (logits + kv_el + q_el), op.dtype, skv % 8 == 0, chip)
    t += elementwise_time(2 * q_el * item, chip)                  # out layout
    return t


def vendor_model_time(op: OpDesc, chip: hw.Chip = hw.H100) -> float:
    """The modeled device seconds of the race's vendor lane for `op`, as
    `WallClockFitness.vendor_runner` runs it (the counterpart of the
    reference's `xla_time`)."""
    item = hw.itemsize(op.dtype)
    if op.kind == "matmul":
        m, n, k = op.gemm_view()
        t = cublas_time(m, n, k, op.dtype, chip)
        t += elementwise_time(item * (2 * m * n + n), chip)       # + bias
        if op.activation not in (None, "none", "identity"):
            t += elementwise_time(2 * m * n * item, chip)
        return t
    if op.kind == "conv2d":
        d = op.d
        t = cudnn_time(op, chip)
        (pt, pb), (pl, pr) = ((conv_kernel._ref.same_pads(d["h"], d["kh"], d["stride"]),
                               conv_kernel._ref.same_pads(d["w"], d["kw"], d["stride"]))
                              if d["pad"] else ((0, 0), (0, 0)))
        if (pt, pl) != (pb, pr):                     # F.pad, then a VALID conv
            padded = d["n"] * (d["h"] + pt + pb) * (d["w"] + pl + pr) * d["cin"]
            t += elementwise_time(item * (d["n"] * d["h"] * d["w"] * d["cin"] + padded),
                                  chip)
        if op.activation not in (None, "none", "identity"):
            t += elementwise_time(2 * d["n"] * d["oh"] * d["ow"] * d["cout"] * item, chip)
        return t
    if op.kind == "attention":
        return _einsum_attention_time(op, chip)
    raise ValueError(op.kind)


# ---------------------------------------------------------------- fitness
class Fitness:
    """Maps a candidate config to a runtime (lower is better).  The genetic
    search turns this into the paper's fitness f(a_i) = 1/runtime.

    `kind` tags what the returned number *is* — the search cache keys on it,
    because a runtime measured under one fitness is meaningless under
    another.  `vendor_time` prices the vendor lane of the backend race under
    the same fitness."""

    kind: str = "model"

    def __call__(self, op: OpDesc, cfg: Config) -> float:
        raise NotImplementedError

    def vendor_time(self, op: OpDesc) -> float:
        raise NotImplementedError(
            f"{type(self).__name__} does not time the vendor lane")


class ModelFitness(Fitness):
    """The analytic fitness: `kernel_time` for a configuration,
    `vendor_model_time` for the vendor lane.  It runs on the host (`device`
    is the CPU: a `Tuner` builds its PPO agent there), so a plan tuned with
    it needs no GPU."""

    kind = "model"
    device = torch.device("cpu")

    def __init__(self, chip: hw.Chip = hw.H100):
        self.chip = chip
        self.evals = 0

    def __call__(self, op: OpDesc, cfg: Config) -> float:
        self.evals += 1
        return kernel_time(op, cfg, self.chip)

    def vendor_time(self, op: OpDesc) -> float:
        return vendor_model_time(op, self.chip)


def copies_for(nbytes: int, chip: hw.Chip = hw.H100) -> int:
    """Input copies a timing cycles through so that L2 holds none of them
    from one call to the next (twice L2 in all, at most 16)."""
    return max(1, min(16, math.ceil(2 * chip.l2_bytes / max(1, nbytes))))


class WallClockFitness(Fitness):
    """Measured fitness: run the kernel at the operator's shape and time it
    (device time by CUDA-graph replay on the GPU, the host clock on the CPU;
    the module docstring says how).

    A configuration runs the port's kernel lane (`kernels.ops.conv2d` /
    `kernels.ops.matmul` / `kernels.ops.attention` with `cfg`) on inputs
    made once per operator from seed 0.

    An attention node races unequal work where Sq < Skv: the kernel lane
    masks causally at the top left, as the Pallas kernel does, and skips
    the key tiles past each query tile's diagonal, while the vendor lane
    (`ref_ops.attention`) aligns the mask at the bottom right and reads the
    whole context."""

    kind = "wallclock"
    # calls captured in one graph, at least (one per input copy beyond)
    GRAPH_CALLS = 4

    def __init__(self, repeats: int = 10, warmup: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.repeats = repeats
        self.warmup = warmup
        self.evals = 0          # calls, as the JAX fitness counts them
        self.measured = 0       # distinct measurements
        self._inputs: Dict[str, List[Tuple]] = {}
        self._times: Dict[Tuple[str, str], float] = {}

    # ---------------------------------------------------------- inputs
    def inputs(self, op: OpDesc) -> List[Tuple]:
        """Copies of the operands of `op` on the device, made once per
        operator: conv2d (NHWC x, HWIO w, f32 bias), matmul ((M, K) x,
        (K, N) w, bias in x's dtype), attention (q, k, v) in (B, S, H, D).  On the
        GPU as many copies as `copies_for` their bytes; one on the CPU."""
        key = op.signature()
        if key not in self._inputs:
            gen = torch.Generator(device="cpu").manual_seed(0)
            dtype = _TORCH_DTYPES[op.dtype]
            d = op.d
            if op.kind == "conv2d":
                xs = (d["n"], d["h"], d["w"], d["cin"])
                ws = (d["kh"], d["kw"], d["cin"], d["cout"])
                fan_in = d["kh"] * d["kw"] * d["cin"]
                nout = d["cout"]
            elif op.kind == "matmul":
                xs, ws, fan_in, nout = (d["m"], d["k"]), (d["k"], d["n"]), d["k"], d["n"]
            if op.kind == "attention":
                host = [torch.randn((d["b"], s, d["h"], d["d"]), generator=gen)
                        for s in (d["q"], d["kv"], d["kv"])]
                one = tuple(t.to(self.device, dtype) for t in host)
            else:
                x = torch.randn(xs, generator=gen)
                w = torch.randn(ws, generator=gen) / fan_in ** 0.5
                b = torch.randn((nout,), generator=gen) * 0.1
                # the bias in the dtype each lane reads: x's for the matmul,
                # f32 for the conv, so no cast runs inside a timed call
                bdt = dtype if op.kind == "matmul" else torch.float32
                one = (x.to(self.device, dtype), w.to(self.device, dtype),
                       b.to(self.device, bdt))
            n = 1
            if self.device.type == "cuda":
                n = copies_for(sum(t.numel() * t.element_size() for t in one))
            self._inputs[key] = [one] + [tuple(t.clone() for t in one)
                                         for _ in range(n - 1)]
        return self._inputs[key]

    def kernel_runner(self, op: OpDesc, cfg: Config) -> List[Callable]:
        """One call of the kernel lane per input copy."""
        from repro_torch.kernels import ops as kops

        def run(x, w, b):
            if op.kind == "attention":
                # what the engine's pallas_attention lane runs for the node
                return kops.attention(x, w, b, causal=True, config=cfg)
            if op.kind == "conv2d":
                padding = "SAME" if op.d["pad"] else "VALID"
                return kops.conv2d(x, w, b, stride=op.d["stride"], padding=padding,
                                   layout="NHWC", activation=op.activation, config=cfg)
            return kops.matmul(x, w, b, config=cfg, activation=op.activation)

        return [lambda c=c: run(*c) for c in self.inputs(op)]

    def vendor_runner(self, op: OpDesc) -> List[Callable]:
        """One call of the vendor lane per input copy."""
        if op.kind == "attention":
            return [lambda c=c: ref_ops.run_op("attention", list(c), {"causal": True})
                    for c in self.inputs(op)]
        if op.kind == "conv2d":
            attrs = {"stride": op.d["stride"], "layout": "NHWC",
                     "padding": "SAME" if op.d["pad"] else "VALID",
                     "activation": op.activation}
            # laid out once, as the Engine does
            ins = [(x, ref_ops.nhwc_conv_weight(w), b) for x, w, b in self.inputs(op)]
            return [lambda c=c: ref_ops.run_op("fused_conv2d", list(c), attrs)
                    for c in ins]
        attrs = {"activation": op.activation}
        return [lambda c=c: ref_ops.run_op("fused_matmul", list(c), attrs)
                for c in self.inputs(op)]

    # ---------------------------------------------------------- timing
    def time(self, fns: List[Callable]) -> float:
        """Median seconds of one call of `fns` (one per input copy, called
        in turn).  On the GPU: max(GRAPH_CALLS, len(fns)) calls captured in
        one CUDA graph (`launch.program`: the program's first call runs
        them eagerly), replayed `warmup` times, then `repeats` replays each
        between two CUDA events.  On the CPU: the host clock around each of
        `repeats` calls after `warmup`."""
        if self.device.type != "cuda":
            for i in range(self.warmup):
                fns[i % len(fns)]()
            samples = []
            for i in range(self.repeats):
                t0 = time.perf_counter()
                fns[i % len(fns)]()
                samples.append(time.perf_counter() - t0)
            return statistics.median(samples)
        from repro_torch.launch.program import Program

        calls = max(self.GRAPH_CALLS, len(fns))
        program = Program(lambda: [fns[i % len(fns)]() for i in range(calls)],
                          "wallclock_fitness", self.device)
        program((), ())                          # eager warm-up, then the capture
        for _ in range(self.warmup):
            program((), ())
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.repeats)]
        torch.cuda.synchronize(self.device)
        for start, end in events:
            start.record()
            program((), ())
            end.record()
        torch.cuda.synchronize(self.device)
        return statistics.median(start.elapsed_time(end) / 1e3 / calls
                                 for start, end in events)

    def _measure(self, op: OpDesc, lane: str, cfg: Config, make) -> float:
        key = (op.signature(), lane + json.dumps(cfg, sort_keys=True))
        if key not in self._times:
            self._times[key] = self.time(make())
            self.measured += 1
        return self._times[key]

    def __call__(self, op: OpDesc, cfg: Config) -> float:
        self.evals += 1
        # keyed on the knobs the kernel reads: configs that differ only in
        # a scheduler knob share one measurement and tie exactly
        read = {k: v for k, v in cfg.items() if k not in UNPRICED_KEYS}
        return self._measure(op, "kernel", read, lambda: self.kernel_runner(op, read))

    def vendor_time(self, op: OpDesc) -> float:
        return self._measure(op, "vendor", {}, lambda: self.vendor_runner(op))
