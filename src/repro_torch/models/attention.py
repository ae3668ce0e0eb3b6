"""GQA attention with RoPE and qk-norm against the paged KV pool — the port
of the serving half of `repro.models.attention` (`attn_init`,
`_project_qkv`, `packed_row_map`, `attn_prefill_packed`,
`attn_decode_paged`).

Attention backends: `torch` runs the gather lanes (the plain versions in
`repro_torch.kernels.ref`, which mirror the JAX XLA lanes), and
`cuda_attention` runs the hand-written paged kernels through
`repro_torch.kernels.ops`.

The new rows' K/V are written into the pools IN PLACE (`index_put_` on the
layer's view of the pool), where JAX writes functionally (`.at[].set`) and
donates the pool buffers to the step program.  Padding rows and inactive
slots still write into the null sink block 0.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import packed_row_map
from repro_torch.models.common import (Params, apply_rope, dense, dense_init,
                                       norm_init, rms_norm)

__all__ = ["attn_init", "packed_row_map", "attn_prefill_packed",
           "attn_decode_paged"]


def attn_init(gen: torch.Generator, cfg: ModelConfig,
              d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.hd
    p: Params = {
        "wq": dense_init(gen, d, cfg.n_heads * hd),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, gen.device)
        p["k_norm"] = norm_init(hd, gen.device)
    return p


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor]):
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (vlm family) is a later slice")
    b, s, _ = x.shape
    hd = cfg.hd
    # role-tagged: the plan's stage `qkv_proj` choice dispatches these
    q = dense(p["wq"], x, role="qkv_proj").reshape(b, s, cfg.n_heads, hd)
    k = dense(p["wk"], x, role="qkv_proj").reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x, role="qkv_proj").reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_prefill_packed(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        seg_tables: torch.Tensor, positions: torch.Tensor,
                        seg_info: torch.Tensor, *, backend: str = "torch",
                        backend_config: Optional[Dict[str, Any]] = None
                        ) -> torch.Tensor:
    """Segment-packed prefill attention against one layer's paged pools.

    x (1, C, d) carries contiguous prompt segments from up to S requests;
    each row's K/V is written into its OWN segment's blocks (row r of
    segment s at absolute position kv_start_s + r - row_offset_s; padding
    rows go to the null sink), then every row attends causally to its
    request's committed rows.  Returns the attention block's output
    (1, C, d); the pools are updated in place."""
    b, c, _ = x.shape
    block_size = k_pool.shape[1]
    nbt = seg_tables.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)

    sid, pos, valid = packed_row_map(seg_info, c)
    row_tables = seg_tables.long()[sid]                          # (C, nbt)
    rows = torch.arange(c, device=x.device)
    blk = row_tables[rows, torch.clamp(pos // block_size, 0, nbt - 1)]
    blk = torch.where(valid, blk, torch.zeros_like(blk))        # padding -> sink
    off = pos % block_size
    k_pool[blk, off] = k_new[0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[0].to(v_pool.dtype)

    if backend == "cuda_attention":
        from repro_torch.kernels import ops
        out = ops.attention_prefill_packed(q, k_pool, v_pool, seg_tables,
                                           seg_info, config=backend_config)
    else:
        out = _ref.packed_prefill_attention_ref(q, k_pool, v_pool, seg_tables,
                                                seg_info)
    return dense(p["wo"], out.reshape(b, c, cfg.n_heads * cfg.hd))


def attn_decode_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor, *,
                      backend: str = "torch") -> torch.Tensor:
    """Decode attention against one layer's paged pools.

    x (B, 1, d), one new token per slot at position lengths[b]; its K/V row
    is written into the slot's current block (inactive slots carry all-null
    tables and length 0, so they write into the sink block 0), then the
    token attends to the slot's first lengths[b] + 1 rows.  Returns
    (B, 1, d); the pools are updated in place."""
    b = x.shape[0]
    block_size = k_pool.shape[1]
    lengths = lengths.long()
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None])

    bidx = torch.arange(b, device=x.device)
    blk = block_tables.long()[bidx, lengths // block_size]
    off = lengths % block_size
    k_pool[blk, off] = k_new[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[:, 0].to(v_pool.dtype)

    qh = q.reshape(b, cfg.n_heads, cfg.hd)
    if backend == "cuda_attention":
        from repro_torch.kernels import ops
        out = ops.attention_decode_paged(qh, k_pool, v_pool, lengths + 1,
                                         block_tables)
    else:
        out = _ref.paged_decode_attention_ref(qh, k_pool, v_pool, lengths + 1,
                                              block_tables)
    return dense(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.hd))
