"""GQA attention with RoPE and qk-norm — the port of the serving half of
`repro.models.attention`: the paged path (`attn_init`, `_project_qkv`,
`packed_row_map`, `attn_prefill_packed`, `attn_decode_paged`) and the
dense-cache path of the fixed-batch engine (`attn_forward` with
`return_kv`, `init_cache`, `attn_decode`).

The dense path is the reference's XLA lane, outside any Pallas kernel, so
here it is plain PyTorch: Q·Kᵀ in the working dtype, then cast to f32 and
scaled, the softmax in f32, the probabilities rounded to V's dtype before
P·V.  The reference scans long prompts (>= 1024 keys) in KV chunks with an
online softmax to bound its memory, equal to the direct form to ~1e-6;
the port computes every length in the direct form.

Attention backends: `torch` runs the gather lanes (the plain versions in
`repro_torch.kernels.ref`, which mirror the JAX XLA lanes), and
`cuda_attention` runs the hand-written paged kernels through
`repro_torch.kernels.ops`.

The new rows' K/V are written into the pools IN PLACE (`index_put_` on the
layer's view of the pool), where JAX writes functionally (`.at[].set`) and
donates the pool buffers to the step program.  Padding rows and inactive
slots still write into the null sink block 0.  Rows that share a
destination there all write the values of the last of them (`write_rows`),
so the sink holds one outcome — the sequential scatter's, last write wins
— however the device orders the writes: inactive slots read the sink row
they wrote, and where their outputs matter (an MoE's capacity queue takes
them in) a race would make a step differ from run to run.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import packed_row_map
from repro_torch.models.common import (Params, apply_rope, dense, dense_init,
                                       norm_init, rms_norm)

__all__ = ["attn_init", "attn_forward", "init_cache", "attn_decode",
           "packed_row_map", "attn_prefill_packed", "attn_decode_paged",
           "decode_write_rows", "packed_write_rows"]


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


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_per_kv: int) -> torch.Tensor:
    """`repro.models.attention._sdpa_direct`: (B, Sq, H, D) x (B, Skv, Hkv,
    D), GQA grouped, the causal mask aligned at the bottom right."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, q_per_kv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril(skv - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, _ref.NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, sq, h, d)


def attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 positions: Optional[torch.Tensor] = None, causal: bool = True,
                 return_kv: bool = False):
    """Full-sequence attention over x (B, S, d) -> (B, S, d), and with
    `return_kv` the (K, V) it built, each (B, S, Hkv, hd), for the cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, causal, cfg.q_per_kv)
    y = dense(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.hd))
    return (y, (k, v)) if return_kv else y


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed dense K / V caches (L, B, max_seq, Hkv, hd)."""
    shape = (n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """One new token per sequence, x (B, 1, d) at position lengths[b],
    against one layer's dense caches (B, S_max, Hkv, hd): the token's K/V
    row is written at lengths[b] IN PLACE (where JAX returns new caches),
    then it attends to rows 0..lengths[b].  Returns (B, 1, d)."""
    b = x.shape[0]
    lengths = lengths.long()
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None])
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, lengths] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, lengths] = v_new[:, 0].to(v_cache.dtype)
    qg = q.reshape(b, cfg.n_kv_heads, cfg.q_per_kv, cfg.hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * (
        1.0 / math.sqrt(cfg.hd))
    pos = torch.arange(k_cache.shape[1], device=x.device)[None, None, None, :]
    logits = torch.where(pos <= lengths[:, None, None, None], logits,
                         torch.full_like(logits, _ref.NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache)
    return dense(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.hd))


def write_rows(blk: torch.Tensor, off: torch.Tensor, block_size: int):
    """(blk, off, src) of a batch of pool-row writes: row i goes to
    (blk[i], off[i]) with the values of row src[i], the last row writing
    the same destination (itself where none does)."""
    dest = blk * block_size + off
    idx = torch.arange(dest.shape[0], device=dest.device)
    src = torch.where(dest[:, None] == dest[None, :], idx[None, :], -1).amax(1)
    return blk, off, src


def decode_write_rows(block_tables: torch.Tensor, lengths: torch.Tensor,
                      block_size: int):
    """The decode lane's writes: slot b's new row at position lengths[b]
    of its table (inactive slots: the sink's row 0)."""
    lengths = lengths.long()
    bidx = torch.arange(lengths.shape[0], device=lengths.device)
    blk = block_tables.long()[bidx, lengths // block_size]
    return write_rows(blk, lengths % block_size, block_size)


def packed_write_rows(seg_tables: torch.Tensor, seg_info: torch.Tensor, c: int,
                      block_size: int):
    """The chunk lane's writes: row r of segment s at absolute position
    kv_start_s + r - row_offset_s of its segment's table; padding rows
    into the sink."""
    nbt = seg_tables.shape[1]
    sid, pos, valid = packed_row_map(seg_info, c)
    row_tables = seg_tables.long()[sid]                          # (C, nbt)
    rows = torch.arange(c, device=seg_tables.device)
    blk = row_tables[rows, torch.clamp(pos // block_size, 0, nbt - 1)]
    blk = torch.where(valid, blk, torch.zeros_like(blk))        # padding -> sink
    return write_rows(blk, pos % block_size, block_size)


def attn_prefill_packed(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        seg_tables: torch.Tensor, positions: torch.Tensor,
                        seg_info: torch.Tensor, *, backend: str = "torch",
                        backend_config: Optional[Dict[str, Any]] = None,
                        rows) -> torch.Tensor:
    """Segment-packed prefill attention against one layer's paged pools.

    x (1, C, d) carries contiguous prompt segments from up to S requests;
    each row's K/V is written into its OWN segment's blocks (row r of
    segment s at absolute position kv_start_s + r - row_offset_s; padding
    rows go to the null sink), then every row attends causally to its
    request's committed rows.  `rows`: `packed_write_rows`' result, the
    same for every layer of a step.  Returns the attention block's output
    (1, C, d); the pools are updated in place."""
    b, c, _ = x.shape
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    blk, off, src = rows
    k_pool[blk, off] = k_new[0, src].to(k_pool.dtype)
    v_pool[blk, off] = v_new[0, src].to(v_pool.dtype)

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
                      backend: str = "torch", rows) -> torch.Tensor:
    """Decode attention against one layer's paged pools.

    x (B, 1, d), one new token per slot at position lengths[b]; its K/V row
    is written into the slot's current block (inactive slots carry all-null
    tables and length 0, so they write into the sink block 0), then the
    token attends to the slot's first lengths[b] + 1 rows.  `rows`:
    `decode_write_rows`' result, the same for every layer of a step.
    Returns (B, 1, d); the pools are updated in place."""
    b = x.shape[0]
    lengths = lengths.long()
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None])
    blk, off, src = rows
    k_pool[blk, off] = k_new[src, 0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[src, 0].to(v_pool.dtype)

    qh = q.reshape(b, cfg.n_heads, cfg.hd)
    if backend == "cuda_attention":
        from repro_torch.kernels import ops
        out = ops.attention_decode_paged(qh, k_pool, v_pool, lengths + 1,
                                         block_tables)
    else:
        out = _ref.paged_decode_attention_ref(qh, k_pool, v_pool, lengths + 1,
                                              block_tables)
    return dense(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.hd))
