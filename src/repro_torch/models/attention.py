"""GQA attention with RoPE / M-RoPE and qk-norm, and cross-attention —
the port of the serving half of `repro.models.attention`: the paged path
(`attn_init`, `_project_qkv`, `packed_row_map`, `attn_prefill_packed`,
`attn_decode_paged`), the dense-cache path of the fixed-batch engine
(`attn_forward` with `return_kv`, `init_cache`, `attn_decode`) and the
encoder-decoder's cross-attention (`attn_forward` with `kv_override`,
`cross_kv`), and the logical axes of the parameters and the dense caches
(`attn_logical_axes`, `cache_logical_axes`).

With M-RoPE (`cfg.mrope_sections`) positions carry a trailing axis of 3
(t, h, w); the decode lanes rotate the new token at (len, len, len), as
the reference does (it projects twice there and drops the first result;
the port projects once).

The dense path is the reference's XLA lane, outside any Pallas kernel, so
here it is plain PyTorch in the reference's two forms, picked as `_sdpa`
picks them.  The direct form: Q·Kᵀ in the working dtype, then cast to f32
and scaled, the softmax in f32, the probabilities rounded to V's dtype
before P·V.  From 1024 keys on, where a divisor of Skv in [64, 1024] gives
more than one chunk (`_kv_chunk_for`), the chunked form: an online softmax
over KV chunks carrying (m, l, acc) in f32, so the largest temporary is
(B, H, Sq, chunk) where the direct form's is (B, H, Sq, Skv).  Under
autograd each chunk body runs under `torch.utils.checkpoint`, recomputed
in backward as the reference's `jax.checkpoint` body is.  The two forms
round differently in bf16 (the chunked one rounds each chunk's P·V
product to V's dtype), so each length takes the reference's form.

Attention backends: `torch` runs the gather lanes (the plain versions in
`repro_torch.kernels.ref`, which mirror the JAX XLA lanes), and
`cuda_attention` runs the hand-written paged kernels through
`repro_torch.kernels.ops`.

Tensor parallelism (the paged path, `distributed.collectives`): a rank
holds its block of the query heads, of `wo`'s rows and the KV heads its
query heads read (`tp_kv_heads`; all of them where they split, else the
ones it needs), so the paged kernels run at the rank's own head counts;
`wo`'s partial output is summed over the ranks before the residual add.

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

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import reduce_if_sharded
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import packed_row_map
from repro_torch.models.common import (Params, apply_mrope, apply_rope, dense,
                                       dense_init, norm_init, rms_norm)

__all__ = ["attn_init", "attn_logical_axes", "tp_kv_heads", "attn_forward", "cross_kv",
           "init_cache", "cache_logical_axes", "attn_decode",
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


def attn_logical_axes(cfg: ModelConfig) -> Params:
    p = {
        "wq": {"w": ("embed", "heads")},
        "wk": {"w": ("embed", "kv_heads")},
        "wv": {"w": ("embed", "kv_heads")},
        "wo": {"w": ("heads", "embed")},
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": (None,)}
        p["k_norm"] = {"scale": (None,)}
    return p


def tp_kv_heads(cfg: ModelConfig, rules, rank: int, size: int) -> Tuple[int, int]:
    """(first, count) of the KV heads rank `rank` of a `size`-wide
    tensor-parallel axis holds under `rules`: its block of them where
    "kv_heads" is split; where only "heads" is split (the KV heads do not
    divide the axis), the ones its block of query heads reads, so each
    local query head j reads local KV head j // (local heads / count), as
    on one device.  A layout under which the rank's query heads do not
    read equal groups of its KV heads in order raises."""
    heads = size > 1 and rules.lookup("heads") == "model"
    kv = size > 1 and rules.lookup("kv_heads") == "model"
    if kv and not heads:
        raise ValueError("kv_heads split over the model axis with heads replicated")
    if not heads:
        return 0, cfg.n_kv_heads
    if kv:
        n = cfg.n_kv_heads // size
        return rank * n, n
    hl, g = cfg.n_heads // size, cfg.q_per_kv
    first = rank * hl // g
    n = ((rank + 1) * hl - 1) // g - first + 1
    if hl % n or any(first + j // (hl // n) != (rank * hl + j) // g
                     for j in range(hl)):
        raise ValueError(f"rank {rank} of {size}: query heads {rank * hl}.."
                         f"{(rank + 1) * hl - 1} (G={g}) do not read equal groups of "
                         f"KV heads {first}..{first + n - 1}")
    return first, n


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor]):
    """q (B, S, Hq, hd), k / v (B, S, Hkv, hd), the head counts those of
    the projections' weights: the whole model's on one device, a rank's
    own (`tp_kv_heads`) under tensor parallelism."""
    b, s, _ = x.shape
    hd = cfg.hd
    # role-tagged: the plan's stage `qkv_proj` choice dispatches these
    q = dense(p["wq"], x, role="qkv_proj").reshape(b, s, -1, hd)
    k = dense(p["wk"], x, role="qkv_proj").reshape(b, s, -1, hd)
    v = dense(p["wv"], x, role="qkv_proj").reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if positions is not None:
        if cfg.mrope_sections:
            q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _decode_positions(cfg: ModelConfig, lengths: torch.Tensor) -> torch.Tensor:
    """The decode token's positions: (B, 1), or (B, 1, 3) = (len, len, len)
    with M-RoPE."""
    pos = lengths[:, None]
    return pos[..., None].expand(-1, 1, 3) if cfg.mrope_sections else pos


_CHUNKED_KV_THRESHOLD = 1024
_KV_CHUNK = 1024


def _sdpa_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
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


def _chunk_body(causal: bool, start: int, qpos: torch.Tensor, qg: torch.Tensor,
                m_prev: torch.Tensor, l_prev: torch.Tensor, acc: torch.Tensor,
                k_blk: torch.Tensor, v_blk: torch.Tensor):
    """One KV chunk of the online softmax: the carry (m, l, acc) advanced
    over keys start .. start + chunk - 1, in the reference's roundings."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk).float() * (
        1.0 / math.sqrt(qg.shape[-1]))
    if causal:
        kpos = start + torch.arange(k_blk.shape[1], device=qg.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full_like(s, _ref.NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(v_blk.dtype), v_blk)
    return m_new, l_new, acc


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  q_per_kv: int, kv_chunk: int = _KV_CHUNK) -> torch.Tensor:
    """`repro.models.attention._sdpa_chunked`: the online softmax over
    Skv / kv_chunk KV chunks (a Python loop where the reference scans),
    the carry in f32, each chunk's P·V product in V's dtype added to the
    f32 accumulator, the output acc / max(l, 1e-30) in q's dtype.  Under
    autograd (grad enabled and an input that requires it) each chunk body
    is checkpointed, its logits recomputed in backward; otherwise it runs
    as is and holds no graph."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if skv % kv_chunk:
        raise ValueError(f"Skv={skv} is not a multiple of the chunk {kv_chunk}")
    qg = q.reshape(b, sq, hkv, q_per_kv, d)
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    m = torch.full((b, hkv, q_per_kv, sq), _ref.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, q_per_kv, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, q_per_kv, sq, d), dtype=torch.float32, device=q.device)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for start in range(0, skv, kv_chunk):
        body = functools.partial(_chunk_body, causal, start, qpos)
        args = (qg, m, l, acc, k[:, start:start + kv_chunk],
                v[:, start:start + kv_chunk])
        if grad:
            m, l, acc = checkpoint(body, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = body(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _kv_chunk_for(skv: int, target: int = _KV_CHUNK) -> int:
    """Largest divisor of skv that is <= target and >= 64; 0 where none."""
    for c in range(min(target, skv), 63, -1):
        if skv % c == 0:
            return c
    return 0


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_per_kv: int) -> torch.Tensor:
    """`repro.models.attention._sdpa`: the chunked form from
    `_CHUNKED_KV_THRESHOLD` keys on where `_kv_chunk_for` gives more than
    one chunk, the direct form otherwise."""
    skv = k.shape[1]
    if skv >= _CHUNKED_KV_THRESHOLD:
        chunk = _kv_chunk_for(skv)
        if chunk and skv // chunk > 1:
            return _sdpa_chunked(q, k, v, causal, q_per_kv, kv_chunk=chunk)
    return _sdpa_direct(q, k, v, causal, q_per_kv)


def attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 positions: Optional[torch.Tensor] = None, causal: bool = True,
                 kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 return_kv: bool = False):
    """Full-sequence attention over x (B, S, d) -> (B, S, d), and with
    `return_kv` the (K, V) it built, each (B, S, Hkv, hd), for the cache.
    `kv_override` (K, V) makes it cross-attention: only the query is
    projected (`wq` with no role, q-norm, no RoPE) and every query sees
    every key."""
    b, s, _ = x.shape
    if kv_override is not None:
        q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rms_norm(p["q_norm"], q)
        k, v = kv_override
        causal = False
    else:
        q, k, v = _project_qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, causal, cfg.q_per_kv)
    y = dense(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.hd))
    return (y, (k, v)) if return_kv else y


def cross_kv(p: Params, cfg: ModelConfig, enc: torch.Tensor):
    """The encoder output's K / V (B, S_enc, Hkv, hd) for one decoder
    layer's cross-attention, computed once per prompt."""
    b, s, _ = enc.shape
    k = dense(p["wk"], enc).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = dense(p["wv"], enc).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k)
    return k, v


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed dense K / V caches (L, B, max_seq, Hkv, hd)."""
    shape = (n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes() -> Dict[str, Any]:
    """Logical axes of the dense K / V caches (L, B, max_seq, Hkv, hd)."""
    ax = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": ax, "v": ax}


def attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """One new token per sequence, x (B, 1, d) at position lengths[b],
    against one layer's dense caches (B, S_max, Hkv, hd): the token's K/V
    row is written at lengths[b] IN PLACE (where JAX returns new caches),
    then it attends to rows 0..lengths[b].  Returns (B, 1, d)."""
    b = x.shape[0]
    lengths = lengths.long()
    q, k_new, v_new = _project_qkv(p, cfg, x, _decode_positions(cfg, lengths))
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
    return reduce_if_sharded(dense(p["wo"], out.reshape(b, c, -1)), "heads")


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
    q, k_new, v_new = _project_qkv(p, cfg, x, _decode_positions(cfg, lengths))
    blk, off, src = rows
    k_pool[blk, off] = k_new[src, 0].to(k_pool.dtype)
    v_pool[blk, off] = v_new[src, 0].to(v_pool.dtype)

    qh = q.reshape(b, -1, cfg.hd)
    if backend == "cuda_attention":
        from repro_torch.kernels import ops
        out = ops.attention_decode_paged(qh, k_pool, v_pool, lengths + 1,
                                         block_tables)
    else:
        out = _ref.paged_decode_attention_ref(qh, k_pool, v_pool, lengths + 1,
                                              block_tables)
    return reduce_if_sharded(dense(p["wo"], out.reshape(b, 1, -1)), "heads")
