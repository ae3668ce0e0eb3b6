"""AdamW + cosine LR schedule + global-norm clipping — the port of
`repro.optim.adamw`, as plain functions on nested-dict trees of tensors.

The arithmetic is the reference's, not `torch.optim.AdamW`'s: clip by the
global f32 norm (scale = min(1, max_norm / (norm + 1e-9))), advance the
step before the schedule reads it, bias-correct at t = step, and write
p - lr * (u + wd * p) in f32, cast to the parameter's dtype, with weight
decay on every leaf (norm scales and the embedding too).  The moments are
f32 and `step` is an int32 tensor on the parameters' device, so nothing is
read back to the host.  Where JAX returns new buffers (and donates the old
ones), `adamw_update` writes the parameters and the moments IN PLACE under
`torch.no_grad()` and returns the same tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to `cfg.lr`, then cosine decay to lr * min_lr_ratio
    at `total_steps` (f32; `step` an int or a tensor, kept on its
    device)."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree, cuts=None, tp=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.

    Over a tree of one rank's shards (`cuts`, the `distributed.sharding.
    LeafCut` of each leaf, and `tp`, the model axis' `TensorParallel`),
    the whole tree's norm: each leaf's sum of squares over the positions
    the rank owns (a split leaf's over its shard, the positions several
    ranks hold counted by their owner alone, a whole leaf by rank 0 of the
    axis alone), the per-leaf sums reduced over the axis in rank order,
    then summed over the leaves as on one device: the same bits on every
    rank."""
    if cuts is None or tp is None:
        leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))

    def owned_sq(cut, x):
        if cut.dim is None:
            sq = torch.sum(torch.square(x.float()))
            return sq if tp.rank == 0 else torch.zeros_like(sq)
        if cut.shared:
            x = x.index_select(cut.dim, cut.owned().to(x.device))
        return torch.sum(torch.square(x.float()))

    leaves = list(tree_leaves(tree_map(owned_sq, cuts, tree)))
    return torch.sqrt(torch.sum(tp.all_reduce(torch.stack(leaves))))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """-> (every leaf times min(1, max_norm / (norm + 1e-9)), the norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, tree), norm


def adamw_init(params) -> Dict[str, Any]:
    """f32 zero moments shaped like `params` and a zero int32 step on the
    parameters' device."""
    device = next(tree_leaves(params)).device
    zeros = lambda t: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), t)
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, gnorm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on `params` from `grads` (not modified): the
    parameters, m, v and step are updated in place and returned with the
    metrics {"lr", "grad_norm"} (the norm taken before clipping).

    `gnorm`: the gradients' global norm where `grads` are not the whole
    tree (a rank's shards, or the ZeRO-1 slices of them, with `params`,
    m and v the same slices: views updated in place); default
    `global_norm(grads)`."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"]
    step += 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (u + cfg.weight_decay * pf))

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, state, {"lr": lr, "grad_norm": gnorm}
