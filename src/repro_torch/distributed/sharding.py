"""Logical-axis sharding rules (DP / TP / EP / SP / pod) — the port of
`repro.distributed.sharding` onto `torch.distributed` DTensor placements.

Model code never names mesh axes.  It names *logical* axes ("batch",
"heads", "ffn", "experts", "vocab", "seq", "embed", ...), and a
`ShardingRules` table maps each to a physical mesh axis, a tuple of axes,
or None.  The same model runs on one device (no rules: every `constrain`
is a no-op), a 16 x 16 mesh, or the 2 x 16 x 16 multi-pod mesh; only the
rules change.

Physical axes:
  pod    pod-level data parallelism
  data   data parallelism / ZeRO-1 shard axis / sequence parallelism
  model  tensor parallelism (heads, ffn, vocab) and expert parallelism

A spec is a plain tuple with one entry per tensor dim, the entries of
the reference's `PartitionSpec`: None, a mesh axis name, or a tuple of
names.  Its DTensor placements (`placements`) give each mesh dim
`Shard(i)` where tensor dim i's entry names it and `Replicate()`
elsewhere (and on a dim of size 1); an entry naming several axes shards
that dim over them in the mesh's order (major to minor, as JAX does), so
an entry naming them out of that order raises: DTensor cannot express it
without strided shards, and the default table never asks for one.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` or anything with
the reference's `shape` mapping of axis name -> size (`axis_sizes`), such
as `jax.sharding.AbstractMesh`, which needs no devices: the rule tables
are pure Python.  Only the placements need a DeviceMesh's dim names.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> physical mesh axis (or tuple of axes, or None)."""

    rules: Tuple[Tuple[str, object], ...] = (
        ("batch", ("pod", "data")),   # DP over pod + data
        ("seq", None),                # sequence replicated by default
        ("seq_sharded", "data"),      # SP: long-context activations
        ("embed", None),              # residual stream replicated
        ("heads", "model"),           # TP over attention heads
        ("kv_heads", "model"),
        ("ffn", "model"),             # TP over the FFN hidden dim
        ("experts", "model"),         # EP
        ("vocab", "model"),           # TP over the vocabulary
        ("ssm_heads", "model"),       # TP over mamba heads
        ("conv_dim", "model"),
        ("layers", None),
        ("expert_cap", None),
        ("expert_ffn", None),         # TP inside experts when EP is indivisible
        ("embed_vec", None),          # lm_head d_model dim (the TP target
                                      # when vocab is indivisible)
        ("embed_tbl", None),          # embedding table d_model dim: never
                                      # model-sharded (a gather on a
                                      # dim-1-sharded table)
        ("moe_tokens", None),         # MoE (B, S*k, d) dispatch token dim
        ("kv_seq", None),             # KV-cache sequence dim (SP on long ctx)
        ("ssm_state", None),          # mamba state dim (sharded on long ctx)
        ("zero", "data"),             # ZeRO-1 optimizer-state shard axis
    )

    def lookup(self, name: Optional[str]):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        raise KeyError(f"unknown logical axis {name!r}")

    def spec(self, logical: Sequence[Optional[str]]) -> Tuple:
        return tuple(self.lookup(a) for a in logical)

    def replace(self, **kw) -> "ShardingRules":
        table = dict(self.rules)
        table.update(kw)
        return ShardingRules(tuple(table.items()))


DEFAULT_RULES = ShardingRules()


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (its dim names and shape) or of a
    mesh with the reference's `shape` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def prune_for_mesh(rules: ShardingRules, mesh) -> ShardingRules:
    """Drop physical axes the mesh does not have (e.g. 'pod' on one pod)."""
    present = set(axis_sizes(mesh))

    def prune(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in present else None
        kept = tuple(a for a in v if a in present)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    return ShardingRules(tuple((k, prune(v)) for k, v in rules.rules))


_tls = threading.local()


def activation_rules(rules: Optional[ShardingRules]):
    """Context manager installing the rules `constrain` reads."""
    class _Ctx:
        def __enter__(self):
            self.prev = getattr(_tls, "rules", None)
            _tls.rules = rules
            return rules

        def __exit__(self, *exc):
            _tls.rules = self.prev

    return _Ctx()


def placements(mesh, spec: Sequence) -> tuple:
    """The DTensor placements of `spec` on the DeviceMesh `mesh`: one per
    mesh dim, `Shard(i)` where tensor dim i's entry names it, else
    `Replicate()`; a mesh dim of size 1 holds the whole tensor, so it is
    `Replicate()` whatever names it.  Raises on an axis the mesh lacks, an axis named twice,
    and an entry naming its axes out of the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    seen = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not in the "
                                 f"mesh's {tuple(names)}")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} twice")
            seen.add(a)
            if sizes[a] > 1:
                out[names.index(a)] = Shard(i)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} names its axes out of the mesh's "
                             f"order {tuple(names)}: a strided shard")
    return tuple(out)


def constrain(x, logical: Sequence[Optional[str]]):
    """The active rules' layout for `x`: a no-op outside `activation_rules`
    and on a plain tensor; a DTensor is redistributed to the rules'
    placements (trailing dims past `logical` replicated)."""
    rules = getattr(_tls, "rules", None)
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = rules.spec(list(logical) + [None] * (x.ndim - len(logical)))
    want = placements(x.device_mesh, spec)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def logical_to_spec(rules: ShardingRules, logical: Sequence[Optional[str]]) -> Tuple:
    return rules.spec(logical)


class NamedSharding(NamedTuple):
    """One leaf's layout: the mesh, its spec and the DTensor placements."""

    mesh: Any
    spec: Tuple
    placements: Tuple

    def distribute(self, tensor):
        """`tensor` (global, on every rank) as a DTensor of this layout."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh, list(self.placements))


def named_sharding(mesh, spec: Sequence) -> NamedSharding:
    spec = tuple(spec)
    return NamedSharding(mesh, spec, placements(mesh, spec))


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def map_axes(fn, tree, *rest):
    """`fn` over the logical-axes leaves of a nested dict (and the same
    places of `rest`)."""
    if is_axes(tree):
        return fn(tree, *rest)
    return {k: map_axes(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter sharding: every model publishes a tree of logical-axis tuples
# matching its parameter tree (`logical_axes()`); these turn it into one
# NamedSharding per leaf.
# ---------------------------------------------------------------------------

def params_shardings(mesh, rules: ShardingRules, logical_tree):
    return map_axes(lambda logical: named_sharding(mesh, rules.spec(logical)),
                    logical_tree)


def input_shardings(mesh, rules: ShardingRules, logical_tree):
    return params_shardings(mesh, rules, logical_tree)


# ---------------------------------------------------------------------------
# Local shards: what one rank holds of a tensor under a spec, as a plain
# tensor (the tensor-parallel engine runs its step on these, not on
# DTensors).
# ---------------------------------------------------------------------------

def local_shard(tensor, spec: Sequence, sizes: Dict[str, int],
                coords: Dict[str, int]):
    """The block of `tensor` that the rank at mesh coordinates `coords`
    ({axis: index}) holds under `spec` on a mesh of axis `sizes`: each
    dim whose entry names axes splits into prod(sizes) equal contiguous
    blocks, the rank's block numbered over those axes major to minor (the
    DTensor / JAX order).  A dim that does not divide raises.  A split
    leaf is a fresh contiguous tensor (it keeps no reference to the whole
    one); an unsplit leaf is `tensor` itself."""
    out = tensor
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            n *= sizes.get(a, 1)
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
        if n == 1:
            continue
        if out.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(tensor.shape)} does not split "
                             f"into {n} blocks over {axes}")
        step = out.shape[i] // n
        out = out.narrow(i, idx * step, step)
    if out is tensor:
        return tensor
    return torch.empty_like(out, memory_format=torch.contiguous_format).copy_(out)


def local_params(params, logical_tree, rules: ShardingRules,
                 sizes: Dict[str, int], coords: Dict[str, int]):
    """`local_shard` of every leaf of `params` under `rules` applied to
    its logical axes (trailing dims past a leaf's axes replicated).  A dim
    that does not divide raises ValueError naming the leaf's axes."""
    def shard(axes, leaf):
        axes = tuple(axes) + (None,) * (leaf.dim() - len(axes))
        try:
            return local_shard(leaf, rules.spec(axes), sizes, coords)
        except ValueError as e:
            raise ValueError(f"logical axes {axes}: {e}") from None

    return map_axes(shard, logical_tree, params)


# ---------------------------------------------------------------------------
# Leaf cuts: how one rank's shard of a training-state leaf sits in the whole
# leaf, so the state can be cut from a checkpoint, gathered back to it, and
# its gradients summed where several ranks hold the same positions.
# ---------------------------------------------------------------------------

class LeafCut(NamedTuple):
    """One leaf's cut for one rank.  `dim` is the dim split over the model
    axis (None: the rank holds the whole leaf), `indices[r]` the whole
    leaf's positions along it that rank r holds (in its local order),
    `full` the whole leaf's length there and `rank` this rank's index;
    `owners[r]`: the local positions of rank r that no lower rank holds
    (each position of the whole leaf is owned once); `shared`: some
    position is held by several ranks, `n_shared` of them, this rank's
    local positions among them `shared_local` and their slots in the
    sorted list of them `shared_slot`; `blocks`: the ranks hold equal
    contiguous blocks in rank order.  `partial`: a whole leaf read inside
    a split region, whose gradient on each rank is a partial sum over the
    model axis.  `zero_dim`, `zero_rank` and `zero_size`: the ZeRO-1 slice
    of the (model-cut) leaf this rank updates, its block `zero_rank` of
    `zero_size` along `zero_dim` (None: none).  `device`: where the rank
    keeps the leaf (a checkpoint restored under this cut lands there).
    Build a split one with `LeafCut.split`."""

    dim: Optional[int] = None
    indices: Tuple = ()
    full: int = 0
    rank: int = 0
    owners: Tuple = ()
    shared: bool = False
    n_shared: int = 0
    shared_local: Any = None
    shared_slot: Any = None
    blocks: bool = False
    partial: bool = False
    zero_dim: Optional[int] = None
    zero_rank: int = 0
    zero_size: int = 1
    device: Any = None

    @classmethod
    def split(cls, dim: int, indices, full: int, rank: int) -> "LeafCut":
        indices = tuple(torch.as_tensor(i, dtype=torch.long) for i in indices)
        seen, owners, count = set(), [], {}
        for idx in indices:
            pos = idx.tolist()
            owners.append(torch.tensor([p for p, i in enumerate(pos) if i not in seen],
                                       dtype=torch.long))
            seen.update(pos)
            for i in pos:
                count[i] = count.get(i, 0) + 1
        slot = {i: s for s, i in enumerate(sorted(i for i, c in count.items() if c > 1))}
        mine = [(p, slot[i]) for p, i in enumerate(indices[rank].tolist()) if i in slot]
        n = len(indices[0])
        blocks = n * len(indices) == full and all(
            torch.equal(i, torch.arange(r * n, (r + 1) * n)) for r, i in enumerate(indices))
        return cls(dim=dim, indices=indices, full=full, rank=rank, owners=tuple(owners),
                   shared=bool(slot), n_shared=len(slot),
                   shared_local=torch.tensor([p for p, _ in mine], dtype=torch.long),
                   shared_slot=torch.tensor([s for _, s in mine], dtype=torch.long),
                   blocks=blocks)

    @property
    def index(self):
        """This rank's positions along `dim`."""
        return self.indices[self.rank]

    def owned(self, r: Optional[int] = None):
        """The local positions of rank r (default: this rank) it owns."""
        return self.owners[self.rank if r is None else r]

    def model_local(self, tensor):
        """The rank's model-axis shard of the whole `tensor` (a fresh
        contiguous tensor; `tensor` itself where nothing is cut)."""
        if self.dim is None:
            return tensor
        return tensor.index_select(self.dim, self.index.to(tensor.device))

    def zero_slice(self, tensor):
        """The ZeRO-1 block of a model-axis shard (a view)."""
        if self.zero_dim is None:
            return tensor
        n = tensor.shape[self.zero_dim] // self.zero_size
        return tensor.narrow(self.zero_dim, self.zero_rank * n, n)

    def local(self, tensor):
        """What this rank holds of the whole `tensor`: its model-axis shard,
        then its ZeRO-1 block, contiguous."""
        out = self.model_local(tensor)
        if self.zero_dim is None:
            return out
        return self.zero_slice(out).clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# The fixed-batch serving cut: a rank's block of the batch, of the KV
# cache's positions, of the SSM state's columns and of a prompt's
# positions, each split over a group (an `AxisGroup` of the mesh axes the
# logical axis names, or anything with `rank` and `size`).
# ---------------------------------------------------------------------------

def local_block(n: int, group, what: str = "dim") -> Tuple[int, int]:
    """(start, count) of this rank's contiguous block of `n` positions
    split over `group` (None: all of them), the block GSPMD's placement
    gives rank `group.rank`; raises ValueError where `n` does not divide,
    as the reference's placement does."""
    if group is None or group.size == 1:
        return 0, n
    if n % group.size:
        raise ValueError(f"{what} ({n}) does not split into {group.size} blocks")
    count = n // group.size
    return group.rank * count, count


def uneven_block(n: int, group) -> Tuple[int, int]:
    """(start, count) of this rank's block of `n` positions split over
    `group` (None: all of them) as GSPMD splits a dim its axis need not
    divide: blocks of ceil(n / size), rank r's [r c, min(n, (r + 1) c)),
    so the last blocks may be short or empty.  The activations of the
    sequence-parallel prefill ("seq" over "data") take these blocks; caches
    and parameters keep `local_block`'s even ones."""
    if group is None or group.size == 1:
        return 0, n
    width = -(-n // group.size)
    start = min(n, group.rank * width)
    return start, min(n, start + width) - start


def local_rows(n: int, group) -> Tuple[int, int]:
    """(start, count) of this rank's rows of a batch of `n` split over
    `group` (the "batch" rule's axes): `local_block`."""
    return local_block(n, group, "a batch")


def local_cache(cache, model, rules: ShardingRules, groups: Dict[str, Any]):
    """A whole fixed-batch cache (the model's `init_cache` / `prefill`
    tree) cut to one rank's: from `model.cache_logical_axes()`, each dim
    named "batch", "kv_seq" or "ssm_state" narrowed to the rank's block
    over `groups[name]` (None or absent: whole), and under `groups["model"]`
    (the model axis' view, anything with `rank` and `size`; None: one rank)
    the KV heads and SSM heads the rank holds: the KV heads its query heads
    read where "heads" splits and "kv_heads" does not, all of them where
    "kv_seq" takes the model axis (`attention.tp_kv_heads`); the conv
    window at its head-aligned channels where "ssm_heads" splits
    (`mamba.tp_columns`).  Fresh contiguous tensors."""
    from repro_torch.models import attention as A
    from repro_torch.models import mamba as M

    cfg = model.cfg
    tp = groups.get("model")
    size = 1 if tp is None else tp.size
    split_heads = size > 1 and rules.lookup("ssm_heads") == "model"

    def cut(axes, leaf):
        out = leaf
        for i, name in enumerate(axes):
            if name in ("batch", "kv_seq", "ssm_state"):
                start, n = local_block(leaf.shape[i], groups.get(name),
                                       f"dim {i} ({name!r}) of {tuple(leaf.shape)}")
                out = out.narrow(i, start, n)
            elif name == "kv_heads" and size > 1:
                first, n = A.tp_kv_heads(cfg, rules, tp.rank, size)
                out = out.narrow(i, first, n)
            elif name == "ssm_heads" and split_heads:
                start, n = local_block(leaf.shape[i], tp, f"dim {i} (ssm_heads)")
                out = out.narrow(i, start, n)
            elif name == "conv_dim" and split_heads:
                _, chans = M.tp_columns(cfg, tp.rank, size, leaf.device)
                out = out.index_select(i, chans)
        return out.clone(memory_format=torch.contiguous_format)

    return map_axes(cut, model.cache_logical_axes(), cache)
