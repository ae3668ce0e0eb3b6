"""Collectives over the axes of a mesh, differentiable, and the contexts
the model's tensor-parallel sites and the training loss read.

The reference shards a step by constraining activations to logical axes
and letting XLA insert the collectives.  The port runs each rank's step
on plain tensors (its local parameter shards and KV heads) and calls the
collectives itself, at the reference's constrain sites
(`models.common.embed` / `lm_head_logits` / `unembed` /
`chunked_softmax_xent`, the attention output, `models.mlp.mlp_apply`'s
down projection, the MoE's expert outputs, mamba's gated activations).
An `AxisGroup` is this rank's view of one mesh axis, or of the axes the
batch splits over ("pod" x "data"), as one group ranked by the flattened
coordinate, pod-major, as GSPMD orders a dim over a tuple of axes: its
process group, its index on the axes and their size.  A
`TensorParallel` is the model axis' group plus the sharding rules that
decide which logical axes are split over it; `tensor_parallel(tp)`
installs it around a step's body and `current()` answers the sites.
`data_parallel(dp)` installs the data axis' group, which the training
loss reduces its sums over (`current_data()`), `mesh_axes(groups)` binds
mesh axis names, as `shard_map` does, for
`optim.compress.compressed_allgather_mean`, and `split_groups(groups)`
installs, for the fixed-batch serving steps, the groups the logical axes
"batch", "kv_seq", "ssm_state" and "seq" are split over (`split_group(name)`:
the batch's rows, the KV cache's positions, the SSM state's columns, a
prompt's positions in the sequence-parallel prefill: `seq_split`).
Outside those contexts (one device, a 1-wide axis) every site is the
single-device code.

Four operations, each a `torch.autograd.Function`:

  * `all_reduce(x)`: the sum of the ranks' partial `x`, computed as an
    all-gather of the partials viewed as raw bytes, then a sum in rank
    order in f32, rounded once to x's dtype.  Every rank gets the same
    bits, as the sampler needs (each rank draws from its own copy of the
    logits), and the result does not depend on the backend, so a gloo
    world computes what an NCCL world will.  Backward: the identity (the
    gradient of the replicated sum is the same on every rank);
  * `all_gather(x, dim)`: the ranks' `x` concatenated along `dim` in rank
    order.  Backward: this rank's slice of the gradient;
  * `enter(x)`, the conjugate of `all_reduce`: the identity forward, and
    in backward the sum over the ranks of the gradient.  It sits where a
    replicated activation enters a product split over the axis (the
    column-split projections): each rank's gradient of it is the partial
    sum of its own columns' terms;
  * `stacked(x)`: every rank's `x` stacked in rank order, (size,
    *x.shape), where each rank reads every other's block in its own way
    (the sequence split: `SeqSplit`).  Backward: the sum over the ranks of
    their gradients at this rank's slot, in rank order in f32 (f64 for
    f64), a reduce-scatter run as one all-gather of every rank's gradient.

Each runs its forward bits unchanged with autograd off or on, so serving
reads the same numbers it always did.  Backward runs where autograd runs
it, on a worker thread for CUDA tensors, so a recomputed forward
(`torch.utils.checkpoint`) must see the contexts the first forward saw:
`bind(fn)` captures them.

On a gloo group a CUDA tensor is always staged through host memory: it is
copied to the host, gathered there and copied back, on every call (gloo
has no device transport).  On an NCCL group the gather runs on the
device.  Which one is decided by the group's backend, not by an error.

Every collective of the port is one all-gather of raw bytes
(`AxisGroup._gather`).  `count_collectives()` tallies them for the dry run
(`launch/dryrun.py`) under the reference's kinds: a sum or max over the
ranks is an "all-reduce", a gather an "all-gather", each with the bytes
of this rank's operand (what it puts on the wire, as the reference's
`collective_bytes` counts them).  With no tally installed the check costs
one global read a call.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from repro_torch.distributed.sharding import ShardingRules, axis_sizes, uneven_block


# the reference's collective kinds (`repro/launch/dryrun.py`), in its order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


class CollectiveTally:
    """Calls and this rank's operand bytes per collective kind."""

    def __init__(self):
        self.per_kind_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.counts = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def add(self, kind: str, nbytes: int) -> None:
        self.per_kind_bytes[kind] += nbytes
        self.counts[kind] += 1

    def as_dict(self) -> Dict[str, object]:
        """The reference's record: per_kind_bytes, counts, total_bytes."""
        return {"per_kind_bytes": dict(self.per_kind_bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.per_kind_bytes.values())}


# a module global, not thread-local: backward runs collectives on
# autograd's threads
_tally: Optional[CollectiveTally] = None


@contextlib.contextmanager
def count_collectives():
    """Tally every collective of the enclosed calls, on any thread
    (`CollectiveTally`); an enclosing tally sees none of them."""
    global _tally
    prev, _tally = _tally, CollectiveTally()
    try:
        yield _tally
    finally:
        _tally = prev


class AxisGroup:
    """This rank's view of a mesh axis: `group` (a torch.distributed
    process group of the axis' `size` ranks) and `rank` (this rank's index
    on the axis)."""

    def __init__(self, group, rank: int, size: int):
        import torch.distributed as dist

        self.group = group
        self.rank = rank
        self.size = size
        self.backend = str(dist.get_backend(group))

    @classmethod
    def from_mesh(cls, mesh, axes) -> Optional["AxisGroup"]:
        """The group of DeviceMesh axis `axes` (a name, or a tuple of names
        in the mesh's order), or None where they are 1 wide.  Over several
        axes wider than 1 it is one group of their product, this rank's
        index the flattened coordinate, the first axis major (a flattened
        sub-mesh: building it is collective, every rank of the mesh calls
        this with the same axes)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        sizes = axis_sizes(mesh)
        wide = [a for a in axes if sizes.get(a, 1) > 1]
        if not wide:
            return None
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        if len(wide) == 1:
            return cls(mesh.get_group(wide[0]), coord[wide[0]], sizes[wide[0]])
        rank, size = 0, 1
        for a in wide:
            rank, size = rank * sizes[a] + coord[a], size * sizes[a]
        flat = mesh[tuple(wide)]._flatten("_".join(wide))
        return cls(flat.get_group(), rank, size)

    def _gather(self, x: torch.Tensor, kind: str = "all-gather") -> torch.Tensor:
        """Every rank's `x` (same shape and dtype on all) stacked in rank
        order, (size, *x.shape), on x's device: one all-gather of the raw
        bytes into one buffer, tallied as `kind`."""
        import torch.distributed as dist

        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
        if _tally is not None:
            _tally.add(kind, raw.numel())
        staged = raw.cpu() if self.backend == "gloo" and raw.device.type != "cpu" else raw
        whole = staged.new_empty(self.size * staged.numel())
        gather(whole, staged, group=self.group)
        return whole.to(x.device).view(x.dtype).reshape(self.size, *x.shape)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """The rank-order f32 sum of the gathered partials, rounded once."""
        acc, *rest = self._gather(x, "all-reduce").float().unbind(0)
        for part in rest:
            acc = acc + part
        return acc.to(x.dtype)

    def sum_in_place(self, x: torch.Tensor, chunk: int = 1 << 26) -> torch.Tensor:
        """`x` replaced by the rank-order sum over the ranks (`_sum`'s bits),
        `chunk` elements at a time, so a large tensor (a gradient leaf)
        needs only a chunk's gathered copies beside it."""
        flat = x.view(-1)
        for part in flat.split(chunk):
            part.copy_(self._sum(part))
        return x

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of their partial `x`, in rank order in
        f32, rounded once to x's dtype: the same bits on every rank.  On
        the device: one cast of the gathered partials to f32 (none for
        f32), size - 1 adds, one cast back.  Backward: the identity."""
        return _AllReduce.apply(x, self)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' `x` concatenated along `dim` in rank order.
        Backward: this rank's slice."""
        return _AllGather.apply(x, self, dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """`x` itself forward; its gradient summed over the ranks."""
        return _Enter.apply(x, self)

    def stacked(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` stacked in rank order, (size, *x.shape): the
        bits of `_gather`.  Where `x` takes a gradient its backward is the
        reduce-scatter of `_Stacked`, a collective: every rank's `x` must
        take one or none, and every rank's graph must reach the result."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Stacked.apply(x, self)
        return self._gather(x)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks (no gradient)."""
        return self._gather(x, "all-reduce").amax(0)

    def exclusive_prefix_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the lower ranks' `x`, in rank order (zeros on rank
        0): one all-gather (no gradient)."""
        parts = self._gather(x)
        out = torch.zeros_like(x)
        for part in parts[:self.rank].unbind(0):
            out = out + part
        return out

    def barrier(self) -> None:
        """Return once every rank of the axis has reached this call."""
        self._gather(torch.zeros(1, device="cuda" if self.backend == "nccl" else "cpu"))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis._sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.dim, ctx.rank, ctx.n = dim, axis.rank, x.shape[dim]
        return torch.cat(axis._gather(x).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _Stacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._gather(x)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        acc, *rest = axis._gather(g.contiguous(), "reduce-scatter")[:, axis.rank] \
            .to(torch.promote_types(g.dtype, torch.float32)).unbind(0)
        for part in rest:
            acc = acc + part
        return acc.to(g.dtype), None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._sum(g), None


class TensorParallel(AxisGroup):
    """This rank's view of the model axis (an `AxisGroup`) and the sharding
    `rules` (pruned for the mesh) that decide which logical axes are split
    over it."""

    def __init__(self, group, rank: int, size: int, rules: ShardingRules):
        super().__init__(group, rank, size)
        self.rules = rules

    @classmethod
    def from_mesh(cls, mesh, rules: ShardingRules) -> Optional["TensorParallel"]:
        """The model axis of a DeviceMesh (`launch.mesh.tp_mesh`,
        `make_mesh`), or None where the axis is 1 wide."""
        size = axis_sizes(mesh).get("model", 1)
        if size <= 1:
            return None
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        return cls(mesh.get_group("model"), coord["model"], size, rules)

    def sharded(self, axis: str) -> bool:
        """Whether logical `axis` is split over the model axis."""
        return self.size > 1 and self.rules.lookup(axis) == "model"


_tls = threading.local()


@contextlib.contextmanager
def _installed(name: str, value):
    prev = getattr(_tls, name, None)
    setattr(_tls, name, value)
    try:
        yield value
    finally:
        setattr(_tls, name, prev)


def tensor_parallel(tp: Optional[TensorParallel]):
    """Install `tp` (None: single-device code) for the enclosed calls."""
    return _installed("tp", tp)


def data_parallel(dp: Optional[AxisGroup]):
    """Install the data axis' group (None: one data rank) for the enclosed
    calls: the training loss sums its NLL and mask over it."""
    return _installed("dp", dp)


def mesh_axes(groups: Optional[Dict[str, AxisGroup]]):
    """Bind mesh axis names to groups ({name: AxisGroup or None for a
    1-wide axis}) for the enclosed calls, as `shard_map` binds them."""
    return _installed("axes", groups)


def split_groups(groups: Optional[Dict[str, Optional[AxisGroup]]]):
    """Install {logical axis: the group it is split over, or None} for the
    enclosed calls: the fixed-batch steps read "batch" (the MoE's decode
    capacity group spans the batch's rows), "kv_seq" (the KV cache's
    positions), "ssm_state" (the SSM state's columns) and "seq" (a
    prompt's positions, `seq_split`)."""
    return _installed("split", groups)


def split_group(name: str) -> Optional[AxisGroup]:
    """The group logical axis `name` is split over under `split_groups`
    (None: not split, or no groups installed)."""
    groups = getattr(_tls, "split", None)
    return None if groups is None else groups.get(name)


class SeqSplit:
    """A sequence of `total` positions split over `group` (the "seq" rule's
    axes) in `sharding.uneven_block`'s blocks: the sequence-parallel
    prefill's and training step's view of them.  `start` / `count` are
    this rank's block, `width` the longest block's (ceil(total / size)); a
    block may be short or empty.  Every gather here is one all-gather of
    the blocks padded to `width`, the same bits on every rank; `parts`
    and `gather` are `AxisGroup.stacked`, whose backward returns to each
    rank the sum of every rank's gradient of its block (`last`, read by
    the prefill alone, takes no gradient)."""

    def __init__(self, group: AxisGroup, total: int):
        self.group, self.total = group, total
        self.width = -(-total // group.size)
        self.start, self.count = uneven_block(total, group)
        self.counts = [min(total, (r + 1) * self.width) - min(total, r * self.width)
                       for r in range(group.size)]

    def parts(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's `x` (its block along `dim`, the other dims alike on
        every rank), padded with zeros to `width` along `dim`, stacked in
        rank order: (size, *padded shape)."""
        pad = list(x.shape)
        pad[dim] = self.width - x.shape[dim]
        if pad[dim]:
            x = torch.cat([x, x.new_zeros(pad)], dim)
        return self.group.stacked(x)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence along `dim` from every rank's block `x`."""
        parts = self.parts(x, dim)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts.unbind(0), self.counts)],
                         dim)

    def last(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence's last row x[:, -1:] (from the rank whose
        block holds position total - 1), on every rank."""
        row = x[:, -1:] if self.count else x.new_zeros((x.shape[0], 1, *x.shape[2:]))
        return self.group._gather(row)[(self.total - 1) // self.width]


def seq_split(total: int) -> Optional[SeqSplit]:
    """The `SeqSplit` of a prompt of `total` positions over the installed
    "seq" group (`split_groups`), or None where the sequence is whole."""
    group = split_group("seq")
    return None if group is None else SeqSplit(group, total)


def current() -> Optional[TensorParallel]:
    """The installed `TensorParallel`, or None."""
    return getattr(_tls, "tp", None)


def current_data() -> Optional[AxisGroup]:
    """The installed data-axis group, or None."""
    return getattr(_tls, "dp", None)


def axis_group(name: str) -> Optional[AxisGroup]:
    """The group bound to mesh axis `name` (None where it is 1 wide);
    raises NameError where no mesh binds it, as JAX does for an unbound
    axis name."""
    groups = getattr(_tls, "axes", None)
    if groups is None or name not in groups:
        raise NameError(f"unbound axis name: {name!r} (bind it with mesh_axes)")
    return groups[name]


def bind(fn):
    """`fn` run under the contexts installed now, wherever it is called
    (a recomputed forward runs on autograd's thread)."""
    tp, dp, axes = current(), current_data(), getattr(_tls, "axes", None)
    split = getattr(_tls, "split", None)

    def run(*args, **kwargs):
        with tensor_parallel(tp), data_parallel(dp), mesh_axes(axes), split_groups(split):
            return fn(*args, **kwargs)

    return run


def reduce_if_sharded(x: torch.Tensor, axis: str) -> torch.Tensor:
    """`x` summed over the model axis where logical `axis` (the reduced
    dim of the product that made it) is split over it; `x` itself
    elsewhere."""
    tp = current()
    if tp is None or not tp.sharded(axis):
        return x
    return tp.all_reduce(x)


def enter_if_sharded(x: torch.Tensor, axis: str) -> torch.Tensor:
    """`x` entering a product whose output dim, logical `axis`, is split
    over the model axis: `TensorParallel.enter` there (the identity
    forward), `x` itself elsewhere."""
    tp = current()
    if tp is None or not tp.sharded(axis):
        return x
    return tp.enter(x)
