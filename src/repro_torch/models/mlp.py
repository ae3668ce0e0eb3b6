"""MLP and mixture-of-experts layers — the port of `repro.models.mlp`
(`mlp_init` / `mlp_apply`, `moe_init` / `moe_capacity` / `moe_apply`, and
the parameters' logical axes `mlp_logical_axes` / `moe_logical_axes`).

The MoE keeps the reference's capacity-based scatter dispatch
(GShard-style): each group's (token, choice) pairs queue for their expert
in `t * k + j` order, pairs at or past the capacity are dropped (they add
exactly zero), and every expert runs on a fixed (capacity, d) buffer.
Every shape is a function of the input's shape alone and nothing is read
back to the host, so the layer is capturable in a CUDA graph.

Under tensor parallelism "experts" is split over the model axis (expert
parallelism, the reference's `experts -> model`): the router is
replicated, so every rank routes the whole batch the same way, fills the
capacity buffers of its own E / tp experts, runs their products and
all-gathers the experts' outputs, concatenated in rank order, before the
gather and the combine over the k choices.  The combine's sum is then the
one-device sum; summing per-rank partial outputs instead would
reassociate it.  In training the experts' input enters the split region
through `distributed.collectives`' `enter` (its gradient through the
rank's experts summed over the ranks); the router's path stays whole on
every rank, so the router's gradient needs no sum.

Where "expert_ffn" is split over the model axis instead (TP inside the
experts, where n_experts does not divide it), every rank holds every
expert's w_in / w_gate columns and w_out rows of its block of the
expert width: each routes the whole batch, runs its slices and the
experts' partial outputs are summed over the ranks in rank order before
the gather.

With the batch split over the data axes ("batch" over "data" or "pod" x
"data", `distributed.collectives.split_group("batch")`) a rank holds its
rows.  Prefill groups by sequence, so nothing crosses the ranks; at decode
the whole batch is one capacity group, as in the reference: the capacity
is that of the whole batch, and each pair's place in its expert's queue
is offset by the lower ranks' counts of that expert (an exclusive prefix
sum over the batch group), so each rank keeps and drops exactly the pairs
the one-device group does and runs only its own tokens.
With the sequence split ("seq" over "data", the sequence-parallel
prefill) a prefill group, one row's sequence, spans the ranks: the
capacity is that of the whole sequence, and each pair's place is offset,
row by row, by the lower ranks' counts of its expert (the same prefix
sum over the "seq" group), since the lower ranks hold the earlier tokens.
`record_drops()` collects each decode call's kept pairs of the whole
group, `record_drops(prefill=True)` each prefill call's, for the
differential tests.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (current, enter_if_sharded, reduce_if_sharded,
                                                 split_group)
from repro_torch.kernels.ref import apply_activation
from repro_torch.models.common import Params, dense, dense_init


def mlp_init(gen: torch.Generator, d: int, f: int, gated: bool = True) -> Params:
    p = {"w_in": dense_init(gen, d, f), "w_out": dense_init(gen, f, d)}
    if gated:
        p["w_gate"] = dense_init(gen, d, f)
    return p


def mlp_logical_axes(gated: bool = True) -> Params:
    p = {"w_in": {"w": ("embed", "ffn")}, "w_out": {"w": ("ffn", "embed")}}
    if gated:
        p["w_gate"] = {"w": ("embed", "ffn")}
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    # role-tagged for the plan's stage matmul dispatch; the gate's
    # activation rides in the hand-written GEMM's epilogue (the torch lane
    # applies it after the product).  Where "ffn" is split over a
    # tensor-parallel axis, this rank's w_in / w_gate columns and w_out rows
    # give a partial output, summed over the ranks (and x's gradient, a
    # partial of the rank's columns, is summed in backward).
    x = enter_if_sharded(x, "ffn")
    if "w_gate" in p:
        h = dense(p["w_in"], x, role="mlp_up")
        h = dense(p["w_gate"], x, role="mlp_up", activation=act) * h
    else:
        h = dense(p["w_in"], x, role="mlp_up", activation=act)
    return reduce_if_sharded(dense(p["w_out"], h, role="mlp_down"), "ffn")


# ------------------------------------------------------------------ MoE
def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Router (d, E), the expert stacks w_in / w_gate (E, d, f) and w_out
    (E, f, d) as bare tensors, and the shared experts as one gated MLP of
    width n_shared * f with its (d, 1) sigmoid gate."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    dev = gen.device
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": dense_init(gen, d, e),
        "w_in": torch.randn((e, d, f), generator=gen, device=dev).mul_(scale),
        "w_gate": torch.randn((e, d, f), generator=gen, device=dev).mul_(scale),
        "w_out": torch.randn((e, f, d), generator=gen, device=dev).div_(math.sqrt(f)),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.n_shared_experts * f)
        p["shared_gate"] = dense_init(gen, d, 1)
    return p


def moe_logical_axes(cfg: ModelConfig) -> Params:
    p = {
        "router": {"w": ("embed", None)},
        "w_in": ("experts", "embed", "expert_ffn"),
        "w_gate": ("experts", "embed", "expert_ffn"),
        "w_out": ("experts", "expert_ffn", "embed"),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_logical_axes()
        p["shared_gate"] = {"w": ("embed", None)}
    return p


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert for a group: the top-k share at the capacity
    factor, rounded up to a multiple of 4, at least 4."""
    cap = int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(4, -(-cap // 4) * 4)


def moe_route(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """The routing of a group batch x (B, S, d): -> (expert ids (B, S*k),
    queue positions (B, S*k), router weights (B, S*k) in x's dtype).

    Softmax in f32, then the top k — a stable descending sort, so equal
    probabilities keep the lower expert first, as `jax.lax.top_k` does —
    then the optional renormalisation.  A pair's position is the number
    of pairs before it, in t * k + j order, that chose the same expert."""
    b, s, _ = x.shape
    k = cfg.top_k
    logits = dense(p["router"], x)                       # (B, S, E), no role
    probs = torch.softmax(logits.float(), -1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    if cfg.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_i = top_i.reshape(b, s * k)
    onehot = Fn.one_hot(flat_i, cfg.n_experts)           # (B, T, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = before.gather(-1, flat_i[..., None])[..., 0]   # (B, T)
    return flat_i, pos, top_p.to(x.dtype).reshape(b, s * k)


# the kept masks while `record_drops` is on, and whether it records the
# prefill calls (module globals: the serving steps run on the caller's
# thread)
_drops: Optional[List[torch.Tensor]] = None
_drops_prefill = False


@contextlib.contextmanager
def record_drops(prefill: bool = False):
    """Collect, for every decode call of `moe_apply` in the enclosed calls,
    the (T,) bool mask of the whole capacity group's (token, choice) pairs
    that were kept (pairs in t * k + j order, the whole batch's even where
    a rank holds some rows: gathered over the batch group); with `prefill`,
    for every prefill call instead, the (B, S * k) masks of its groups
    (the whole sequence's even where a rank holds a block of it: gathered
    over the "seq" group); -> the list, in call order."""
    global _drops, _drops_prefill
    prev, _drops = (_drops, _drops_prefill), []
    _drops_prefill = prefill
    try:
        yield _drops
    finally:
        _drops, _drops_prefill = prev


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              act: str = "silu", seq=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Groups are sequences; at S == 1 (decode)
    the whole batch is one group.  Expert products are batched matmuls
    over (E, B * capacity, d) buffers in x's dtype (the reference runs
    them as einsums outside any kernel); the shared experts go through
    `mlp_apply`, so a plan's mlp_up / mlp_down lanes run them.  Where
    "experts" is split over a tensor-parallel axis, p's expert stacks are
    the rank's E / tp experts, where "expert_ffn" is, their slices of
    the expert width; with the batch split the decode group spans every
    rank's rows, with `seq` (a `distributed.collectives.SeqSplit`: x is
    the rank's block of each row's sequence) a prefill group spans every
    rank's block (see the module docstring)."""
    b, s, d = x.shape
    squeeze = s == 1 and seq is None
    if squeeze:
        x = x.reshape(1, b, d)
        b, s = 1, b
    k = cfg.top_k
    batch = split_group("batch") if squeeze else None
    cap = moe_capacity(cfg, seq.total if seq is not None else
                       s * (1 if batch is None else batch.size))
    flat_i, pos, weights = moe_route(p, cfg, x)
    if batch is not None:
        counts = Fn.one_hot(flat_i[0], cfg.n_experts).sum(0)
        pos = pos + batch.exclusive_prefix_sum(counts)[flat_i]
    if seq is not None:                                  # row by row of the batch
        counts = Fn.one_hot(flat_i, cfg.n_experts).sum(1)             # (B, E)
        pos = pos + seq.group.exclusive_prefix_sum(counts).gather(1, flat_i)
    keep = pos < cap
    if _drops is not None and squeeze != _drops_prefill:
        if batch is not None:
            keep_all = batch._gather(keep)
        elif seq is not None:
            keep_all = seq.gather(keep.reshape(b, s, k))
        else:
            keep_all = keep
        _drops.append((keep_all.reshape(-1) if squeeze else keep_all.reshape(b, -1)).cpu())

    # the rank's experts [lo, lo + e): all of them on one device
    tp = current()
    ep = tp is not None and tp.sharded("experts")
    efn = tp is not None and tp.sharded("expert_ffn")
    e = p["w_in"].shape[0]
    lo = tp.rank * e if ep else 0
    local = (flat_i >= lo) & (flat_i < lo + e)

    # scatter each kept pair's token into its expert's queue; a dropped
    # pair (or another rank's) is written to a spare row past the
    # capacity (of a spare expert), which is cut off
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = x.new_zeros((b, e + 1, cap + 1, d))
    # the experts' input: with expert parallelism its gradient through the
    # rank's experts is a partial, summed over the ranks in backward (the
    # router's path is whole on every rank)
    xe = tp.enter(x) if ep or efn else x
    buf[rows, torch.where(local, flat_i - lo, e), torch.where(keep, pos, cap)] = \
        xe.repeat_interleave(k, dim=1)
    xin = buf[:, :e, :cap].transpose(0, 1).reshape(e, b * cap, d)

    h = torch.bmm(xin, p["w_in"].to(x.dtype))
    g = torch.bmm(xin, p["w_gate"].to(x.dtype))
    h = apply_activation(g, act) * h
    y = torch.bmm(h, p["w_out"].to(x.dtype)).reshape(e, b, cap, d)
    if efn:
        y = tp.all_reduce(y)                             # the expert width's partials
    if ep:
        y = tp.all_gather(y, 0)                          # (E, B, cap, d), exact
    y = y.transpose(0, 1)

    out_tk = y[rows, flat_i, pos.clamp(max=cap - 1)]     # (B, T, d)
    out_tk = out_tk * (weights * keep.to(x.dtype))[..., None]
    out = out_tk.reshape(b, s, k, d).sum(dim=2)

    if cfg.n_shared_experts:
        gate = torch.sigmoid(dense(p["shared_gate"], x).float())
        out = out + mlp_apply(p["shared"], x, act) * gate.to(x.dtype)
    if squeeze:
        out = out.reshape(s, 1, d)
    return out
