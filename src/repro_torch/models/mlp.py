"""MLP and mixture-of-experts layers — the port of `repro.models.mlp`
(`mlp_init` / `mlp_apply`, `moe_init` / `moe_capacity` / `moe_apply`, and
the parameters' logical axes `mlp_logical_axes` / `moe_logical_axes`).

The MoE keeps the reference's capacity-based scatter dispatch
(GShard-style): each group's (token, choice) pairs queue for their expert
in `t * k + j` order, pairs at or past the capacity are dropped (they add
exactly zero), and every expert runs on a fixed (capacity, d) buffer.
Every shape is a function of the input's shape alone and nothing is read
back to the host, so the layer is capturable in a CUDA graph.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import reduce_if_sharded
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
    # give a partial output, summed over the ranks.
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
        "w_in": torch.randn((e, d, f), generator=gen, device=dev) * scale,
        "w_gate": torch.randn((e, d, f), generator=gen, device=dev) * scale,
        "w_out": torch.randn((e, f, d), generator=gen, device=dev) / math.sqrt(f),
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


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              act: str = "silu") -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Groups are sequences; at S == 1 (decode)
    the whole batch is one group.  Expert products are batched matmuls
    over (E, B * capacity, d) buffers in x's dtype (the reference runs
    them as einsums outside any kernel); the shared experts go through
    `mlp_apply`, so a plan's mlp_up / mlp_down lanes run them."""
    b, s, d = x.shape
    squeeze = s == 1
    if squeeze:
        x = x.reshape(1, b, d)
        b, s = 1, b
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, s)
    flat_i, pos, weights = moe_route(p, cfg, x)
    keep = pos < cap

    # scatter each kept pair's token into its expert's queue; a dropped
    # pair is written to a spare row past the capacity, which is cut off
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = x.new_zeros((b, e, cap + 1, d))
    buf[rows, flat_i, torch.where(keep, pos, cap)] = x.repeat_interleave(k, dim=1)
    xin = buf[:, :, :cap].transpose(0, 1).reshape(e, b * cap, d)

    h = torch.bmm(xin, p["w_in"].to(x.dtype))
    g = torch.bmm(xin, p["w_gate"].to(x.dtype))
    h = apply_activation(g, act) * h
    y = torch.bmm(h, p["w_out"].to(x.dtype)).reshape(e, b, cap, d).transpose(0, 1)

    out_tk = y[rows, flat_i, pos.clamp(max=cap - 1)]     # (B, T, d)
    out_tk = out_tk * (weights * keep.to(x.dtype))[..., None]
    out = out_tk.reshape(b, s, k, d).sum(dim=2)

    if cfg.n_shared_experts:
        gate = torch.sigmoid(dense(p["shared_gate"], x).float())
        out = out + mlp_apply(p["shared"], x, act) * gate.to(x.dtype)
    if squeeze:
        out = out.reshape(s, 1, d)
    return out
