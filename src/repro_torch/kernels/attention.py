"""Wrappers of the port's four attention kernels:

  * `paged_decode_attention` / `paged_prefill_attention`
    (`csrc/paged_decode.cu`, `csrc/paged_prefill.cu`), the Hopper
    counterparts of `flash_decode_paged` and `flash_prefill_paged` in
    `repro.kernels.attention`: they take the whole (num_blocks, block_size,
    Hkv, D) pool of one layer and put the KV head in the kernel's grid —
    no Python loop over KV heads;
  * `flash_attention` (`csrc/flash_attention.cu`), the counterpart of
    `flash_attention_padded`: dense (B, Sq, H, D) x (B, Skv, Hkv, D)
    attention, GQA by KV-head index, the causal mask aligned at the top
    left as in the Pallas kernel, ragged Sq / Skv masked in the kernel (no
    padded copies); knobs `block_q` (query rows per CTA) and `block_kv`
    (keys per shared-memory tile), whose launch geometry `flash_geometry`
    decides — the schedule template validates with the same function;
  * `dense_decode_attention` (`csrc/dense_decode.cu`), the counterpart of
    `flash_decode_padded`: one token per sequence over dense (B, S, Hkv, D)
    caches, in one launch with the KV head and the split in the grid.

Three bodies run them.  The bf16 instances of the prefill and flash
kernels run the tensor-core tile of `csrc/mma_attention.cuh` (mma.sync on
bf16 fragments, K/V in a two-stage cp.async ring of tiles of 16, 32, 64 or
128 keys); their f32 instances run the CUDA-core tile of
`csrc/paged_attention.cuh`; paged and dense decode run the split-KV body
of `csrc/split_decode.cuh` in every dtype (grid (sequence, KV head,
split), the splits of `decode_splits` / `dense_decode_splits` combined in
split order by the CTA that finishes last, in the same launch).
`mma_tile_smem_bytes`, `paged_tile_smem_bytes` and
`split_decode_smem_bytes` mirror the three bodies' shared memory.

A CPU tensor takes the plain version in `repro_torch.kernels.ref`; a CUDA
tensor launches the kernel or raises.  Each wrapper counts its launches in
a plain int attribute `launches` (`build.counted`; a replayed CUDA graph
adds the launches it captured).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PREFILL_MAX_VECTORS = 32      # query rows x G per prefill CTA (paged_prefill.cu)
DECODE_MAX_GROUP = 16         # G = H / Hkv per decode CTA (paged_decode.cu,
                              # dense_decode.cu)
FLASH_MAX_VECTORS = 32        # query rows x G per flash CTA (flash_attention.cu)
FLASH_BLOCK_Q = (4, 8, 16, 32)
FLASH_BLOCK_KV = (16, 32, 64, 128)
DEFAULT_BLOCK_KV = 64
PREFILL_BLOCK_KV = 64         # keys per staged tile of bf16 paged prefill
MMA_QWARPS = 2                # mma::QWARPS: query warps of 16 vectors
THREADS = 128                 # paged::THREADS == mma::THREADS
MAX_D = 256                   # paged::MAX_D
MAX_GRID_Z = 65_535
DECODE_SPLIT_KEYS = 128       # key positions per split of paged decode
SPLIT_STAGE_BYTES = 32_768    # split::STAGE_BYTES (csrc/split_decode.cuh)
SPLIT_MAX_CHUNK = 64          # split::MAX_CHUNK


def _check_common(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  what: str,
                  kv_layout: str = "pools must be (num_blocks, block_size, Hkv, D)"
                  ) -> int:
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported")
    for t in (q, k_pool, v_pool):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on the GPU")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: q, k_pool and v_pool must share a dtype")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"{what}: {kv_layout}")
    d = q.shape[-1]
    if k_pool.shape[3] != d or d % 8 or d > MAX_D:
        raise ValueError(f"{what}: head dim {d} must match K/V, be a "
                         f"multiple of 8 and at most {MAX_D}")
    return _DTYPES[q.dtype]


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of t's device (what
    `torch.cuda.current_stream(dev).cuda_stream` gives, without building a
    Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@functools.lru_cache(maxsize=1024)
def decode_splits(nbt: int, block_size: int) -> Tuple[int, int]:
    """(splits, keys per split) of a paged decode launch over block tables
    of `nbt` blocks of `block_size` rows: splits of DECODE_SPLIT_KEYS keys
    rounded up to whole blocks, as many as cover the table.  A function of
    the table's shape alone — never of the lengths, which live on the
    device — so a decode step costs no host sync."""
    kps = -(-DECODE_SPLIT_KEYS // block_size) * block_size
    keys = nbt * block_size
    while -(-keys // kps) > MAX_GRID_Z:
        kps *= 2
    return -(-keys // kps), kps


def dmax_of(d: int) -> int:
    """The head-dim bound of the attention instance (tensor-core tile or
    split decode) that runs head dim d: `ptx::dmax_of` (64, 128 or 256;
    dims past d are zero-filled)."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def split_chunk_keys(d: int, itemsize: int) -> int:
    """Keys per staged chunk of the split decode body: `split::chunk_keys`
    of `csrc/split_decode.cuh` (K + V rows of one chunk, at the instance's
    head-dim bound, within SPLIT_STAGE_BYTES; at most SPLIT_MAX_CHUNK)."""
    return min(SPLIT_STAGE_BYTES // (2 * dmax_of(d) * itemsize), SPLIT_MAX_CHUNK)


def split_decode_smem_bytes(group: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory of a split decode CTA: `split::layout` of
    `csrc/split_decode.cuh`, term for term, for the instance that runs
    `group` query heads per KV head (MAXG: the next power of two) at head
    dim d (rows of the head-dim bound): f32 queries, a two-stage ring of K
    and of V chunks, f32 scores, three f32 per-vector stats and the
    arrival flag, each region 16-byte aligned."""
    maxg = 1 << max(0, group - 1).bit_length()
    dmax = dmax_of(d)
    c = split_chunk_keys(d, itemsize)
    off = _a16(maxg * dmax * 4)
    off = _a16(off + 2 * c * dmax * itemsize)
    off = _a16(off + 2 * c * dmax * itemsize)
    off = _a16(off + maxg * c * 4)
    for _ in range(3):
        off = _a16(off + maxg * 4)
    return _a16(off + 4)


def _index(t: torch.Tensor) -> torch.Tensor:
    return t.to(device="cuda", dtype=torch.int32).contiguous()


@build.counted
def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, D) queries over each slot's first `lengths[b]` KV rows, read
    through `block_tables` (B, nbt) from one layer's pools -> (B, H, D)."""
    if q.device.type == "cpu":
        return _ref.paged_decode_attention_ref(q, k_pool, v_pool, lengths,
                                               block_tables, scale)
    dtype = _check_common(q, k_pool, v_pool, "paged_decode_attention")
    b, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    if h % hkv or h // hkv > DECODE_MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with at most "
                         f"{DECODE_MAX_GROUP} query heads per KV head")
    if lengths.shape != (b,) or block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("lengths must be (B,) and block_tables (B, nbt)")
    lengths, block_tables = _index(lengths), _index(block_tables)
    nbt = block_tables.shape[1]
    nsplit, kps = decode_splits(nbt, bs)
    out = torch.empty_like(q)
    ws = counters = None
    if nsplit > 1:
        ws = torch.empty(b * hkv * nsplit * (h // hkv) * (d + 2),
                         dtype=torch.float32, device=q.device)
        counters = build.counters("paged_decode", q.device, b * hkv)
    fn = build.load("paged_decode")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
             b, h, hkv, d, bs, nbt, kps, nsplit, scale, dtype,
             ws.data_ptr() if ws is not None else None,
             counters.data_ptr() if counters is not None else None, _stream(q))
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def prefill_block_q(block_q: Optional[int], c: int, group: int) -> int:
    """Query rows per prefill CTA, and per flash CTA (`flash_blocks`): the
    tuned `block_q` (default: as many as fit), clamped so a tile holds at
    most 32 query vectors (PREFILL_MAX_VECTORS == FLASH_MAX_VECTORS) and to
    the `c` rows there are, so a `block_q` tuned on the flash kernel
    launches as is on paged prefill."""
    cap = max(1, PREFILL_MAX_VECTORS // group)
    return max(1, min(block_q or cap, cap, c))


@build.counted
def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, seg_tables: torch.Tensor,
                            seg_info: torch.Tensor, *,
                            block_q: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Segment-packed prefill: (1, C, H, D) chunk queries, each row
    attending causally to its own segment's committed KV through
    `seg_tables` (S, nbt) and `seg_info` (S, 3) [row_offset, seg_len,
    kv_start] -> (1, C, H, D).  Rows past the packed fill come out as zeros
    on the kernel (finite values on the plain version); callers discard
    them."""
    if q.device.type == "cpu":
        return _ref.packed_prefill_attention_ref(q, k_pool, v_pool, seg_tables,
                                                 seg_info, scale)
    dtype = _check_common(q, k_pool, v_pool, "paged_prefill_attention")
    if q.dim() != 4 or q.shape[0] != 1:
        raise ValueError("q must be (1, C, H, D)")
    _, c, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    if h % hkv or h // hkv > PREFILL_MAX_VECTORS:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with at most "
                         f"{PREFILL_MAX_VECTORS} query heads per KV head")
    if seg_tables.dim() != 2 or seg_info.shape != (seg_tables.shape[0], 3):
        raise ValueError("seg_tables must be (S, nbt) and seg_info (S, 3)")
    seg_tables, seg_info = _index(seg_tables), _index(seg_info)
    bq = prefill_block_q(block_q, c, h // hkv)
    out = torch.empty_like(q)
    fn = build.load("paged_prefill")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             seg_tables.data_ptr(), seg_info.data_ptr(), out.data_ptr(),
             c, h, hkv, d, bs, seg_tables.shape[1], seg_tables.shape[0], bq,
             scale, dtype, _stream(q))
    build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


def _a16(x: int) -> int:
    return (x + 15) & ~15


def paged_tile_smem_bytes(nq: int, block_kv: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory of a CUDA-core tile CTA: `paged::layout` of
    `csrc/paged_attention.cuh`, term for term (f32 queries, K rows padded
    by one 32-bit word, V rows, f32 scores, three f32 per-vector stats,
    each region 16-byte aligned)."""
    off = _a16(nq * (d + 1) * 4)
    off = _a16(off + block_kv * (d + 4 // itemsize) * itemsize)
    off = _a16(off + block_kv * d * itemsize)
    off = _a16(off + nq * block_kv * 4)
    for _ in range(3):
        off = _a16(off + nq * 4)
    return off


def mma_tile_smem_bytes(nq: int, block_kv: int, d: int) -> int:
    """Dynamic shared memory of a tensor-core tile CTA: `mma::layout` of
    `csrc/mma_attention.cuh`, term for term (bf16 rows of DMAX + 8
    elements: the query rows rounded up to a warp's 16, then a two-stage
    K/V ring of `block_kv` rows each, which the KV warps' f32 merge of
    (acc, m, l) reuses at the end)."""
    dmax = dmax_of(d)
    row = (dmax + 8) * 2
    ring = 2 * 2 * block_kv * row
    merge = MMA_QWARPS * (dmax // 8 * 4 + 4) * 32 * 4
    return _a16((nq + 15) // 16 * 16 * row) + _a16(max(ring, merge))


@dataclasses.dataclass(frozen=True)
class FlashGeometry:
    block_q: int                # query rows per CTA
    block_kv: int               # keys per shared-memory tile
    smem_bytes: int


@functools.lru_cache(maxsize=4096)
def flash_geometry(block_q: int, block_kv: int, group: int, d: int,
                   itemsize: int, chip: hw.Chip = hw.H100) -> Optional[FlashGeometry]:
    """The launch geometry of one configuration of the tile a dtype runs
    (the tensor-core tile for bf16, itemsize 2; the CUDA-core tile for
    f32), or None when it is outside the tile's limits: more than
    FLASH_MAX_VECTORS query vectors (block_q x G) per CTA, a head dim the
    tile does not take, a tensor-core `block_kv` outside FLASH_BLOCK_KV (its
    instances split a tile of 16, 32, 64 or 128 keys between two warps), or
    a tile that does not fit the chip's shared memory or threads per
    block.  Registers are fixed at compile time
    (`__launch_bounds__(128)`)."""
    if block_q < 1 or block_kv < 1 or group < 1:
        return None
    if block_q * group > FLASH_MAX_VECTORS or d % 8 or d > MAX_D:
        return None
    if itemsize == 2:
        if block_kv not in FLASH_BLOCK_KV:
            return None
        smem = mma_tile_smem_bytes(block_q * group, block_kv, d)
    else:
        smem = paged_tile_smem_bytes(block_q * group, block_kv, d, itemsize)
    if smem > chip.smem_per_block or THREADS > chip.max_threads_per_block:
        return None
    return FlashGeometry(block_q, block_kv, smem)


@functools.lru_cache(maxsize=4096)
def flash_blocks(block_q: Optional[int], block_kv: Optional[int], sq: int,
                 group: int, d: int, itemsize: int) -> FlashGeometry:
    """The geometry a call launches: the tuned `block_q` / `block_kv`
    (defaults: as many rows as fit, DEFAULT_BLOCK_KV keys), clamped to the
    tile's limits — TPU-sized blocks of a JAX plan shrink to the largest
    tile that fits, the tensor-core tile's `block_kv` to one of
    FLASH_BLOCK_KV — and `block_q` to Sq (`prefill_block_q`)."""
    if group > FLASH_MAX_VECTORS:
        raise ValueError(f"{group} query heads per KV head: the flash kernel "
                         f"takes at most {FLASH_MAX_VECTORS}")
    tensor_cores = itemsize == 2
    bq = prefill_block_q(block_q, sq, group)
    bkv = min(block_kv or DEFAULT_BLOCK_KV, FLASH_BLOCK_KV[-1])
    if tensor_cores:
        bkv = max([b for b in FLASH_BLOCK_KV if b <= bkv] or FLASH_BLOCK_KV[:1])
    geo = flash_geometry(bq, bkv, group, d, itemsize)
    while geo is None and bkv // 2 >= (FLASH_BLOCK_KV[0] if tensor_cores else 1):
        bkv //= 2
        geo = flash_geometry(bq, bkv, group, d, itemsize)
    if geo is None:
        raise ValueError(f"no flash tile fits: G={group}, D={d}")
    return geo


@build.counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None) -> torch.Tensor:
    """Dense attention: q (B, Sq, H, D) over k, v (B, Skv, Hkv, D) ->
    (B, Sq, H, D); causal rows see keys 0..i (top-left alignment)."""
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal, scale)
    dtype = _check_common(q, k, v, "flash_attention",
                          "k and v must both be (B, Skv, Hkv, D)")
    if q.dim() != 4 or k.shape[0] != q.shape[0]:
        raise ValueError("q must be (B, Sq, H, D), with K/V's batch")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if b > MAX_GRID_Z or sq < 1:
        raise ValueError(f"batch {b} must be 1..{MAX_GRID_Z} and Sq >= 1")
    geo = flash_blocks(block_q, block_kv, sq, h // hkv, d, q.element_size())
    out = torch.empty_like(q)
    fn = build.load("flash_attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, skv, h, hkv, d, geo.block_q, geo.block_kv, int(causal),
             scale, dtype, _stream(q))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def dense_decode_splits(s: int) -> Tuple[int, int]:
    """(splits, keys per split) of a dense decode launch over caches of S
    rows: `decode_splits` with the cache as a table of S one-row blocks,
    so splits of DECODE_SPLIT_KEYS keys, as many as cover S.  A function
    of S alone — never of the lengths, which live on the device."""
    return decode_splits(s, 1)


@build.counted
def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One token per sequence: q (B, H, D) over the first `lengths[b]` rows
    (taken within [0, S]) of dense caches (B, S, Hkv, D) -> (B, H, D)."""
    if q.device.type == "cpu":
        return _ref.dense_decode_attention_ref(q, k_cache, v_cache, lengths, scale)
    dtype = _check_common(q, k_cache, v_cache, "dense_decode_attention",
                          "caches must both be (B, S, Hkv, D)")
    if q.dim() != 3:
        raise ValueError("q must be (B, H, D)")
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or lengths.shape != (b,) or s < 1:
        raise ValueError("caches must be (B, S, Hkv, D) with S >= 1 and lengths (B,)")
    if h % hkv or h // hkv > DECODE_MAX_GROUP:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv} with at most "
                         f"{DECODE_MAX_GROUP} query heads per KV head")
    lengths = _index(lengths)
    nsplit, kps = dense_decode_splits(s)
    out = torch.empty_like(q)
    ws = counters = None
    if nsplit > 1:
        ws = torch.empty(b * hkv * nsplit * (h // hkv) * (d + 2),
                         dtype=torch.float32, device=q.device)
        counters = build.counters("dense_decode", q.device, b * hkv)
    fn = build.load("dense_decode")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), b, s, h, hkv, d, kps, nsplit,
             scale, dtype, ws.data_ptr() if ws is not None else None,
             counters.data_ptr() if counters is not None else None, _stream(q))
    build.check(err, "dense_decode_attention")
    dense_decode_attention.launches += 1
    return out
