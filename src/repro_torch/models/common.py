"""Shared model building blocks (the port of `repro.models.common`): norms,
RoPE / M-RoPE, projections, the embedding, and the training losses
(`cross_entropy`, `chunked_softmax_xent`).  The embedding lookup and the
LM head are two of the tensor-parallel sites (`distributed.collectives`).

Parameters are plain dicts of tensors laid out as the JAX package lays
them out (`dense` weights (d_in, d_out) used as `x @ w`), so a JAX params
tree converts leaf for leaf (`repro_torch.bridge`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import current as current_tp

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    # scaled in place: one f32 copy of the weight, not two, while it is drawn
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device).mul_(scale)
    return {"w": w}


def dense(p: Params, x: torch.Tensor, role: Optional[str] = None,
          activation: Optional[str] = None) -> torch.Tensor:
    """Projection `x @ w`, routable through the plan's matmul lanes by
    `role` ('qkv_proj' / 'mlp_up' / 'mlp_down' / 'lm_head'); `activation`
    rides in the hand-written GEMM's epilogue (applied after the product on
    the torch lane).  With no role and no activation this is `x @ w`."""
    w = p["w"].to(x.dtype)
    if role is None and activation is None:
        return x @ w
    from repro_torch.kernels.dispatch import dispatch_dense
    return dispatch_dense(role, x, w, activation=activation)


def norm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, -1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layer_norm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and population variance, then scale and bias."""
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a device tensor built from it would be a
    # host-to-device copy that waits for the GPU at every layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  Rotates the
    two halves of the head dim (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    angles = angles[..., None, :]                              # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections, theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the head dim's D/2 frequency pairs are
    split into (temporal, height, width) sections, each rotated by its own
    position stream.  x: (..., S, H, D); positions_3d (..., S, 3).  Each
    pair's stream is picked by comparing its index with the sections'
    Python-int boundaries, so nothing is copied from the host (the decode
    and chunk programs are captured in CUDA graphs)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    pair = torch.arange(d // 2, device=x.device)
    first, second = sections[0], sections[0] + sections[1]
    pos = positions_3d.float()
    pos = torch.where(pair < first, pos[..., 0:1],
                      torch.where(pair < second, pos[..., 1:2], pos[..., 2:3]))
    angles = (pos * freqs)[..., None, :]                       # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> Params:
    return {"emb": torch.randn((vocab, d), generator=gen, device=gen.device).mul_(0.01)}


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The rows of the embedding table at `tokens`.  Under a tensor-parallel
    context whose rules split "vocab", this rank holds a contiguous block
    of the table's rows: each token outside it reads zeros, and the ranks'
    lookups are summed (one real row and zeros: exact)."""
    tp = current_tp()
    if tp is None or not tp.sharded("vocab"):
        return p["emb"].to(dtype)[tokens.long()]
    rows = p["emb"].shape[0]
    idx = tokens.long() - tp.rank * rows
    hit = (idx >= 0) & (idx < rows)
    x = p["emb"].to(dtype)[idx.clamp(0, rows - 1)]
    return tp.all_reduce(torch.where(hit[..., None], x, torch.zeros_like(x)))


def lm_head_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """LM head projection `x @ w` (w: (d_model, vocab)), role-tagged so the
    plan's `lm_head` choice dispatches it.  Under a tensor-parallel context
    this rank holds a block of w's columns ("vocab": the logits are
    gathered along the vocabulary) or of its rows ("embed_vec", where the
    vocabulary does not divide the axis: the product of x's matching
    block is summed over the ranks)."""
    tp = current_tp()
    if tp is not None and tp.sharded("vocab"):
        return tp.all_gather(dense(p, x, role="lm_head"), -1)
    if tp is not None and tp.sharded("embed_vec"):
        k = p["w"].shape[0]
        xs = x[..., tp.rank * k:(tp.rank + 1) * k].contiguous()
        return tp.all_reduce(dense(p, xs, role="lm_head"))
    return dense(p, x, role="lm_head")


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (tied) embedding table: x @ emb.T (gathered along
    the vocabulary where the table's rows are split)."""
    logits = x @ p["emb"].to(x.dtype).T
    tp = current_tp()
    return tp.all_gather(logits, -1) if tp is not None and tp.sharded("vocab") else logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32 (over the mask's ones when given)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _xent_chunk(xb: torch.Tensor, w_lm: torch.Tensor, lb: torch.Tensor,
                mb: torch.Tensor):
    """One sequence chunk's (sum of masked NLL, sum of the mask)."""
    logits = (xb @ w_lm.to(xb.dtype)).float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, lb.long()[..., None])[..., 0]
    nll = (logz - gold) * mb
    return torch.sum(nll), torch.sum(mb)


def chunked_softmax_xent(x: torch.Tensor, w_lm: torch.Tensor,
                         labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over sequence chunks WITHOUT materialising the full
    (B, S, V) logits: each chunk of `chunk` positions (all B rows) runs
    under `torch.utils.checkpoint`, so its logits are reduced to two
    scalars and recomputed in backward, as the reference's `jax.checkpoint`
    scan body is.  The sums run in the reference's order (a carry plus each
    chunk's sum, then tot / max(cnt, 1)).  When S is not a multiple of
    `chunk`, or S <= chunk, the logits are made whole (`cross_entropy`)."""
    b, s, d = x.shape
    if s % chunk or s <= chunk:
        return cross_entropy(x @ w_lm.to(x.dtype), labels, mask)
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, d).transpose(0, 1)
    lc = labels.reshape(b, nc, chunk).transpose(0, 1)
    mc = (mask.reshape(b, nc, chunk).transpose(0, 1) if mask is not None
          else torch.ones(lc.shape, dtype=torch.float32, device=x.device))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        nll, m = checkpoint(_xent_chunk, xc[i], w_lm, lc[i], mc[i],
                            use_reentrant=False, preserve_rng_state=False)
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)
