"""Tensor-parallel collectives over a mesh's model axis, and the context the
model's tensor-parallel sites read.

The reference shards a serving step by constraining activations to
logical axes and letting XLA insert the collectives.  The port runs each
rank's step on plain tensors (its local parameter shards and KV heads) and
calls the collectives itself, at the reference's constrain sites
(`models.common.embed` / `lm_head_logits` / `unembed`, the attention
output, `models.mlp.mlp_apply`'s down projection).  A `TensorParallel`
holds the model axis' process group, this rank's index on it, its size and
the engine's sharding rules; `tensor_parallel(tp)` installs it around a
step program's body and `current()` answers the sites.  Outside that
context (one device, a 1-wide model axis, training) every site is the
single-device code.

Two operations:

  * `all_reduce(x)`: the sum of the ranks' partial `x`, computed as an
    all-gather of the partials viewed as raw bytes, then a sum in rank
    order in f32, rounded once to x's dtype.  Every rank gets the same
    bits, as the sampler needs (each rank draws from its own copy of the
    logits), and the result does not depend on the backend, so a gloo
    world computes what an NCCL world will;
  * `all_gather(x, dim)`: the ranks' `x` concatenated along `dim` in rank
    order.

On a gloo group a CUDA tensor is always staged through host memory: it is
copied to the host, gathered there and copied back, on every call (gloo
has no device transport).  On an NCCL group the gather runs on the
device.  Which one is decided by the group's backend, not by an error.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.distributed.sharding import ShardingRules, axis_sizes


class TensorParallel:
    """This rank's view of the model axis: `group` (a torch.distributed
    process group of the axis' `size` ranks), `rank` (this rank's index on
    the axis) and the sharding `rules` (pruned for the mesh) that decide
    which logical axes are split over it."""

    def __init__(self, group, rank: int, size: int, rules: ShardingRules):
        import torch.distributed as dist

        self.group = group
        self.rank = rank
        self.size = size
        self.rules = rules
        self.backend = str(dist.get_backend(group))

    @classmethod
    def from_mesh(cls, mesh, rules: ShardingRules) -> Optional["TensorParallel"]:
        """The model axis of a DeviceMesh (`launch.mesh.tp_mesh`), or None
        where the axis is 1 wide."""
        size = axis_sizes(mesh).get("model", 1)
        if size <= 1:
            return None
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        return cls(mesh.get_group("model"), coord["model"], size, rules)

    def sharded(self, axis: str) -> bool:
        """Whether logical `axis` is split over the model axis."""
        return self.size > 1 and self.rules.lookup(axis) == "model"

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (same shape and dtype on all) stacked in rank
        order, (size, *x.shape), on x's device: one all-gather of the raw
        bytes into one buffer."""
        import torch.distributed as dist

        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        staged = raw.cpu() if self.backend == "gloo" and raw.device.type != "cpu" else raw
        whole = staged.new_empty(self.size * staged.numel())
        gather(whole, staged, group=self.group)
        return whole.to(x.device).view(x.dtype).reshape(self.size, *x.shape)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of their partial `x`, in rank order in
        f32, rounded once to x's dtype: the same bits on every rank.  On
        the device: one cast of the gathered partials to f32 (none for
        f32), size - 1 adds, one cast back."""
        whole = self._gather(x).float()
        acc = whole[0]
        for i in range(1, self.size):
            acc = acc + whole[i]
        return acc.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' `x` concatenated along `dim` in rank order."""
        return torch.cat(self._gather(x).unbind(0), dim)


_tls = threading.local()


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Install `tp` (None: single-device code) for the enclosed calls."""
    prev = getattr(_tls, "tp", None)
    _tls.tp = tp
    try:
        yield tp
    finally:
        _tls.tp = prev


def current() -> Optional[TensorParallel]:
    """The installed `TensorParallel`, or None."""
    return getattr(_tls, "tp", None)


def reduce_if_sharded(x: torch.Tensor, axis: str) -> torch.Tensor:
    """`x` summed over the model axis where logical `axis` (the reduced
    dim of the product that made it) is split over it; `x` itself
    elsewhere."""
    tp = current()
    if tp is None or not tp.sharded(axis):
        return x
    return tp.all_reduce(x)
