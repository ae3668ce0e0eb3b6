"""Wrappers of the two paged attention kernels (`csrc/paged_decode.cu`,
`csrc/paged_prefill.cu`), the Hopper counterparts of `flash_decode_paged`
and `flash_prefill_paged` in `repro.kernels.attention`.

Unlike the Pallas wrappers, these take the whole (num_blocks, block_size,
Hkv, D) pool of one layer and put the KV head in the kernel's grid — no
Python loop over KV heads.  A CPU tensor takes the plain version in
`repro_torch.kernels.ref`; a CUDA tensor launches the kernel or raises.
Each wrapper counts its launches in a plain int attribute `launches`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PREFILL_MAX_VECTORS = 32      # query rows x G per prefill CTA (paged_prefill.cu)
DECODE_MAX_GROUP = 16         # G = H / Hkv per decode CTA (paged_decode.cu)


def _check_common(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  what: str) -> int:
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
        raise ValueError(f"{what}: pools must be (num_blocks, block_size, Hkv, D)")
    d = q.shape[-1]
    if k_pool.shape[3] != d or d % 8 or d > 256:
        raise ValueError(f"{what}: head dim {d} must match the pool, be a "
                         "multiple of 8 and at most 256")
    return _DTYPES[q.dtype]


def _index(t: torch.Tensor) -> torch.Tensor:
    return t.to(device="cuda", dtype=torch.int32).contiguous()


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
    out = torch.empty_like(q)
    fn = build.load("paged_decode")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
             b, h, hkv, d, bs, block_tables.shape[1], scale, dtype,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def prefill_block_q(block_q: Optional[int], c: int, group: int) -> int:
    """Rows per prefill CTA: the tuned `block_q` (default: as many as fit),
    clamped so a tile holds at most PREFILL_MAX_VECTORS query vectors."""
    cap = max(1, PREFILL_MAX_VECTORS // group)
    return max(1, min(block_q or cap, cap, c))


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
             scale, dtype, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
