"""Shared model building blocks (the port of `repro.models.common`): norms,
RoPE / M-RoPE, projections, the embedding, and the training losses
(`cross_entropy`, `chunked_softmax_xent`).  The embedding lookup, the
LM head and the loss are tensor-parallel sites (`distributed.collectives`):
on a rank of a mesh the loss runs on the rank's block of the LM head
(a vocab-parallel log-sum-exp, or the rows' partial logits summed) and
reduces its sums over the data axis.

Parameters are plain dicts of tensors laid out as the JAX package lays
them out (`dense` weights (d_in, d_out) used as `x @ w`), so a JAX params
tree converts leaf for leaf (`repro_torch.bridge`).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import bind
from repro_torch.distributed.collectives import current as current_tp
from repro_torch.distributed.collectives import current_data

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
        return tp.all_gather(dense(p, tp.enter(x), role="lm_head"), -1)
    if tp is not None and tp.sharded("embed_vec"):
        return tp.all_reduce(dense(p, _rank_block(tp, tp.enter(x), p["w"].shape[0]),
                                   role="lm_head"))
    return dense(p, x, role="lm_head")


def _rank_block(tp, x: torch.Tensor, k: int) -> torch.Tensor:
    """This rank's block of x's last dim, k wide."""
    return x[..., tp.rank * k:(tp.rank + 1) * k].contiguous()


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (tied) embedding table: x @ emb.T (gathered along
    the vocabulary where the table's rows are split)."""
    tp = current_tp()
    if tp is None or not tp.sharded("vocab"):
        return x @ p["emb"].to(x.dtype).T
    return tp.all_gather(tp.enter(x) @ p["emb"].to(x.dtype).T, -1)


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


# ---------------------------------------------------------------------------
# Gradients straight into `.grad`: a leaf read in several places of one
# backward (a stacked leaf's layers, the LM head in each loss chunk) would
# otherwise have every read's gradient held by autograd until the last has
# run, and summed there, beside the leaf's `.grad`.
# ---------------------------------------------------------------------------

_INTO_GRAD = contextvars.ContextVar("grads_into_grad", default=False)


@contextlib.contextmanager
def grads_into_grad():
    """Within it, `layer_into_grad` and `cast_into_grad` of a leaf that
    requires a gradient give tensors whose backward adds their gradient
    into the leaf's `.grad` (zeros, allocated at the first such read) as
    soon as it is computed, and passes none on.  The train step's
    `loss_and_grads` enters it; `torch.autograd.grad` does not see
    gradients added so."""
    token = _INTO_GRAD.set(True)
    try:
        yield
    finally:
        _INTO_GRAD.reset(token)


def _into_grad(t: torch.Tensor) -> bool:
    if not (_INTO_GRAD.get() and t.is_leaf and t.requires_grad and torch.is_grad_enabled()):
        return False
    if t.grad is None:
        t.grad = torch.zeros_like(t)
    return True


class _LayerInto(torch.autograd.Function):
    """Layer `i` of a stacked leaf; backward adds its gradient into row `i`
    of the leaf's `.grad`."""

    @staticmethod
    def forward(ctx, stack, i):
        ctx.grad, ctx.i = stack.grad, i
        return stack[i]

    @staticmethod
    def backward(ctx, g):
        ctx.grad[ctx.i].add_(g)
        return None, None


class _CastInto(torch.autograd.Function):
    """A leaf cast to `dtype`; backward adds the cast's gradient (in
    `dtype`, never copied to the leaf's) into the leaf's `.grad`."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.grad = t.grad
        return t.to(dtype)

    @staticmethod
    def backward(ctx, g):
        ctx.grad.add_(g)
        return None, None


def grads_into_grad_active() -> bool:
    """Whether this thread is inside `grads_into_grad`."""
    return _INTO_GRAD.get()


def layer_into_grad(t: torch.Tensor, i: int) -> torch.Tensor:
    """Layer `i` of a layer-stacked leaf, within `grads_into_grad` a view
    whose gradient goes into row `i` of the leaf's `.grad` as soon as it is
    computed.  Autograd runs a ready node in order of creation, latest
    first, so the view is to be made just before its layer's forward: its
    node then runs right after that layer's backward, before the layer
    below's; a view made earlier waits, its gradient held, until the whole
    backward has run.  Outside it, or for a leaf that takes no gradient,
    `t[i]`."""
    if not _into_grad(t):
        return t[i]
    return _LayerInto.apply(t, i)


def cast_into_grad(t: torch.Tensor, dtype) -> torch.Tensor:
    """`t.to(dtype)`; within `grads_into_grad` its gradient goes into the
    leaf's `.grad` at once (the LM head, read once a loss chunk)."""
    if not _into_grad(t):
        return t.to(dtype)
    return _CastInto.apply(t, dtype)


def _xent_chunk(xb: torch.Tensor, w_lm: torch.Tensor, lb: torch.Tensor,
                mb: torch.Tensor):
    """One sequence chunk's (sum of masked NLL, sum of the mask)."""
    logits = (xb @ cast_into_grad(w_lm, xb.dtype)).float()
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
    tp, dp = current_tp(), current_data()
    if dp is not None or (tp is not None and (tp.sharded("vocab")
                                              or tp.sharded("embed_vec"))):
        return _mesh_xent(tp, dp, x, w_lm, labels, mask, chunk)
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


def _xent_sums_sharded(tp, xb: torch.Tensor, w_lm: torch.Tensor, lb: torch.Tensor,
                       mb: torch.Tensor):
    """`_xent_chunk` where the LM head is split over the model axis: on the
    rank's vocabulary block, a vocab-parallel log-sum-exp (the max and the
    sum of exponentials reduced over the ranks, the gold logit from the
    rank whose block holds the label), so no rank holds more than its
    block of a chunk's logits; on the rank's rows of it ("embed_vec"),
    the chunk's partial logits summed over the ranks."""
    if tp is None or not (tp.sharded("vocab") or tp.sharded("embed_vec")):
        return _xent_chunk(xb, w_lm, lb, mb)
    if tp.sharded("embed_vec"):
        logits = tp.all_reduce(_rank_block(tp, xb, w_lm.shape[0])
                               @ cast_into_grad(w_lm, xb.dtype))
        return _xent_chunk_logits(logits.float(), lb, mb)
    logits = (xb @ cast_into_grad(w_lm, xb.dtype)).float()
    v = logits.shape[-1]
    m = tp.max(logits.detach().amax(-1, keepdim=True))
    logz = m[..., 0] + torch.log(tp.all_reduce(torch.exp(logits - m).sum(-1)))
    idx = lb.long() - tp.rank * v
    hit = (idx >= 0) & (idx < v)
    gold = torch.gather(logits, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
    gold = tp.all_reduce(torch.where(hit, gold, torch.zeros_like(gold)))
    nll = (logz - gold) * mb
    return torch.sum(nll), torch.sum(mb)


def _xent_chunk_logits(logits: torch.Tensor, lb: torch.Tensor, mb: torch.Tensor):
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, lb.long()[..., None])[..., 0]
    nll = (logz - gold) * mb
    return torch.sum(nll), torch.sum(mb)


def _mesh_xent(tp, dp, x: torch.Tensor, w_lm: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor], chunk: int) -> torch.Tensor:
    """`chunked_softmax_xent` on a rank of a mesh: over chunks of `chunk`
    positions where S is a multiple of it and longer, else one chunk of
    S, each chunk's (sum of masked NLL, sum of the mask) on the rank's
    LM head block (`_xent_sums_sharded`, checkpointed where there are
    several chunks; the recompute repeats the chunk's collectives in the
    same order on every rank).  The two sums are reduced over the data
    axis before the division, so the loss is the masked mean over the
    whole (micro)batch, the same bits on every rank."""
    b, s, d = x.shape
    if tp is not None and (tp.sharded("vocab") or tp.sharded("embed_vec")):
        x = tp.enter(x)
    n = chunk if not (s % chunk or s <= chunk) else s
    nc = s // n
    xc = x.reshape(b, nc, n, d).transpose(0, 1)
    lc = labels.reshape(b, nc, n).transpose(0, 1)
    mc = (mask.reshape(b, nc, n).transpose(0, 1).float() if mask is not None
          else torch.ones(lc.shape, dtype=torch.float32, device=x.device))
    body = functools.partial(_xent_sums_sharded, tp)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        if nc > 1:
            nll, m = checkpoint(bind(body), xc[i], w_lm, lc[i], mc[i],
                                use_reentrant=False, preserve_rng_state=False)
        else:
            nll, m = body(xc[i], w_lm, lc[i], mc[i])
        tot = tot + nll
        cnt = cnt + m
    if dp is not None:
        tot, cnt = dp.all_reduce(tot), dp.all_reduce(cnt)
    return tot / torch.clamp(cnt, min=1.0)
