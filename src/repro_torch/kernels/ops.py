"""Public wrappers over the port's kernels, with the signatures of
`repro.kernels.ops` (`matmul`, `attention_decode_paged`,
`attention_prefill_packed`).

A CPU tensor goes to the kernel's plain version; a CUDA tensor goes to the
kernel or the call raises — there is no fallback.  The tuned `config` dicts
of the JAX plans are accepted: `block_q` sizes the prefill kernel's query
tile; the matmul's TPU tile keys (bm / bn / bk / order) have no meaning for
the Hopper GEMM, which picks its tile from M, and are ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.attention import (paged_decode_attention,
                                           paged_prefill_attention)
from repro_torch.kernels.matmul import matmul_fused

Config = Optional[Dict[str, Any]]


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, config: Config = None,
           activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., K) @ (K, N) [+ bias] -> activation, f32 accumulation."""
    del config
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = matmul_fused(x2.contiguous(), w, bias, activation, out_dtype)
    return out.reshape(*lead, w.shape[-1])


def attention_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor, *,
                           scale: Optional[float] = None,
                           config: Config = None) -> torch.Tensor:
    """Paged decode attention: q (B, H, D), pools (num_blocks, block_size,
    Hkv, D), lengths (B,) valid context lengths including the new token,
    block_tables (B, nbt) -> (B, H, D)."""
    del config  # block geometry is fixed by the pool; nothing to tune yet
    return paged_decode_attention(q.contiguous(), k_pool, v_pool, lengths,
                                  block_tables, scale)


def attention_prefill_packed(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, seg_tables: torch.Tensor,
                             seg_info: torch.Tensor, *,
                             scale: Optional[float] = None,
                             config: Config = None) -> torch.Tensor:
    """Segment-packed paged prefill attention: q (1, C, H, D), seg_tables
    (S, nbt), seg_info (S, 3) [row_offset, seg_len, kv_start] ->
    (1, C, H, D).  The tuned `block_q` is the query tile height."""
    block_q = (config or {}).get("block_q")
    return paged_prefill_attention(q.contiguous(), k_pool, v_pool, seg_tables,
                                   seg_info, block_q=block_q, scale=scale)
