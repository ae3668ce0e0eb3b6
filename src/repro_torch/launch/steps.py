"""The serving step functions and their step programs — the port of the
serving builders of `repro.launch.steps`.

`unified_step` and `decode_only_step` are the paged step bodies; both end
in keyed sampling (`kernels.sampling.sample_tokens`) on each lane, as
`repro/launch/steps.py` does.  `graph_unified_step` and
`graph_decode_only_step`, the counterparts of `jit_unified_step` and
`jit_decode_only_step`, wrap them in a `launch.program.Program`: on a CUDA
device each is captured in a CUDA graph once, at the engine's fixed
shapes, and every later step replays it (on the CPU, or with graphs off,
the body runs eagerly).  The attention backends and per-stage matmul
tables are fixed per program, baked in at capture as JAX closes them over
at trace time.  A program is called as `program((params, k_pool, v_pool),
host_arrays)`; the KV pools (L, num_blocks, block_size, Hkv, hd) are
updated in place, where JAX donates them.

Tensor-parallel serving runs the same two programs on every rank, each
over the rank's local parameter shards and KV pools (`tp`, a
`distributed.collectives.TensorParallel`, installed around the model
calls): one signature each at every width.  At tp > 1 they run eagerly:
an NCCL world of two ranks cannot share one card, so capturing its
collectives in a CUDA graph waits for a machine with more cards.

`graph_commit_prefill` and `graph_cow_block` (`jit_commit_prefill`,
`jit_cow_block`) are two more programs, each with one signature: the
resume commit's scatter of swapped-in K/V into the pools, at one padded
shape, and the copy-on-write of one block.

`ssm_unified_step` / `ssm_decode_only_step` and `ssm_commit_state` are
the state-cache family's counterparts (`jit_ssm_unified_step`,
`jit_ssm_decode_only_step`, `jit_ssm_commit_state`) over the slot-pooled
conv / SSM pools (L, rows, ...); `graph_ssm_unified_step`,
`graph_ssm_decode_only_step` and `graph_ssm_commit_state` are their
programs, one signature each.  Every row index and segment scalar is a
program input, so admission, chunk progress, preemption and resume
capture nothing.  Under tensor parallelism they run over the rank's
shards and pools as the decoder's programs do, eagerly at tp > 1.

`prefill_step` and `serve_step` (`make_prefill_step`, `make_serve_step`)
are the fixed-batch engine's dense-cache steps.  They run eagerly: the
reference retraces them per prompt length.  On a (pod, data, model) mesh
the engine runs them on every rank over its shards, its rows of the batch
and its cache (`local_cache_shapes`) inside the rank's contexts
(`ServeMesh`: the model axis' `TensorParallel` and the groups "batch",
"kv_seq", "ssm_state" and "seq" are split over), under the caller's rules
pruned for the mesh (`fixed_batch_rules`, which refuses a split this path
does not run).  With "seq" over "data" (a batch too small to split over
the data axes, `rules_for_shape`'s long_500k layout) the prefill is
sequence-parallel: each rank runs its block of the prompt and gets the
whole prompt's logits and its own part of the cache.

`cost_dict` normalises a cost record, as the reference's does, for the
dry run (`launch/dryrun.py`).

`TrainConfig` and `make_train_step(model, train_cfg, rules)` are the
training step: value and gradient of `model.loss` with microbatched
accumulation (`loss_and_grads`), then `optim.adamw_update` in place,
eagerly, on one device.  `mesh_train_step(model, mesh, rules, train_cfg,
batch_specs)` is the counterpart of the reference's `jit_train_step`,
which jits that step with sharded, donated state: it returns the step of
one rank of a (pod, data, model) mesh, each rank a process, over the
rank's cut of the state (`state_layouts`: the tensor-parallel shards of
`model.tp_layout`, TP inside the experts included, and the ZeRO-1 blocks
of the moments where `make_state_shardings` gives them a "data" dim, from
`zero1_axes`); the batch's rows split over "pod" x "data", or the
sequence's positions over "data" (a replicated batch), the gradients made
whole over "model" and summed over the split axes, the norm the whole
tree's.  `train_rules` refuses what the reference refuses and what the
step does not run; `gather_state` gathers a rank's state back to the
whole tree.

The shardings (`batch_logical_axes`, `rules_for_shape`,
`make_batch_shardings`, `cache_shardings`, `paged_pool_sharding`,
`slot_state_shardings`) are the reference's: the shape- and config-aware
rule table, and one `distributed.sharding.NamedSharding` (mesh, spec,
DTensor placements) per leaf.  A mesh is a DeviceMesh, or for the tables
alone anything with the reference's `shape` mapping.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.collectives import (AxisGroup, TensorParallel, data_parallel,
                                                 mesh_axes, split_groups, tensor_parallel)
from repro_torch.distributed.sharding import (DEFAULT_RULES, LeafCut, ShardingRules,
                                              activation_rules, axis_sizes, map_axes,
                                              named_sharding, params_shardings,
                                              prune_for_mesh)
from repro_torch.kernels.dispatch import MatmulTable, matmul_dispatch
from repro_torch.kernels.sampling import sample_tokens
from repro_torch.launch.program import Program
from repro_torch.models.common import grads_into_grad
from repro_torch.optim import AdamWConfig, adamw_update, global_norm
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    zero1: bool = True
    compress_pod_grads: bool = False
    opt: AdamWConfig = AdamWConfig()


def cost_dict(cost) -> Dict[str, float]:
    """A cost record as one dict: the reference normalises
    `Compiled.cost_analysis()` (a dict, or a one-element list in older JAX
    releases); the dry run (`launch/dryrun.py`) passes its own record
    through it, for parity."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return dict(cost)


# ---------------------------------------------------------------- shardings
def batch_logical_axes(batch_specs: Dict[str, Any]) -> Dict[str, Any]:
    """("batch", None, ...) for each entry of a batch (anything with a
    `shape`)."""
    return {k: ("batch",) + (None,) * (len(v.shape) - 1)
            for k, v in batch_specs.items()}


def rules_for_shape(cfg: ModelConfig, shape: ShapeSpec, mesh) -> ShardingRules:
    """The reference's shape- and config-aware rule overrides (the baseline
    sharding scheme).  Each sharded dim must divide its mesh axis:
      * heads / kv_heads / ffn indivisible by |model| -> replicated;
      * vocab indivisible -> the LM head's d_model dim ('embed_vec') takes
        the model axis instead;
      * n_experts indivisible -> TP inside the experts ('expert_ffn');
      * mamba heads / conv channels indivisible -> replicated.
    Decode with KV heads indivisible by |model| shards the cache's
    sequence dim over 'model'; a batch that does not split over data x pod
    is replicated and the sequence / state dims take 'data' (SP); training
    at 16k tokens and more shards the sequence over 'data'."""
    rules = DEFAULT_RULES
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)

    if cfg.n_heads and cfg.n_heads % m:
        rules = rules.replace(heads=None)
    if cfg.n_kv_heads and cfg.n_kv_heads % m:
        rules = rules.replace(kv_heads=None)
    if cfg.d_ff and cfg.d_ff % m:
        rules = rules.replace(ffn=None)
    if cfg.vocab % m:
        rules = rules.replace(vocab=None)
        if cfg.d_model % m == 0:
            rules = rules.replace(embed_vec="model")
    if cfg.n_experts:
        if cfg.n_experts % m:
            rules = rules.replace(experts=None)
            if cfg.d_expert % m == 0:
                rules = rules.replace(expert_ffn="model")
    if cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        conv_dim = d_in + 2 * cfg.ssm_state
        if nh % m:
            rules = rules.replace(ssm_heads=None)
        if conv_dim % m:
            rules = rules.replace(conv_dim=None)

    if (shape.kind == "decode" and cfg.n_kv_heads and cfg.n_kv_heads % m
            and shape.seq_len % m == 0):
        rules = rules.replace(kv_seq="model")

    if shape.global_batch % dp != 0 or shape.global_batch < dp:
        d = sizes.get("data", 1)
        rules = rules.replace(
            batch=None,
            kv_seq="data" if shape.seq_len % d == 0 else None,
            ssm_state="data" if (cfg.ssm_state and cfg.ssm_state % d == 0) else None,
            seq="data" if shape.seq_len % d == 0 else None,
        )
    if shape.kind == "train" and shape.seq_len >= 16_384:
        rules = rules.replace(seq="data")
    return rules


def make_batch_shardings(mesh, rules: ShardingRules, batch_specs):
    """One NamedSharding per batch entry: rows over the "batch" axes."""
    return {k: named_sharding(mesh, rules.spec(axes))
            for k, axes in batch_logical_axes(batch_specs).items()}


def cache_shardings(model, mesh, rules: ShardingRules, batch: int, max_seq: int):
    """The fixed-batch cache's NamedShardings, its shapes taken from
    `model.init_cache` on the meta device (no memory); axes past a leaf's
    logical tuple replicated."""
    shapes = model.init_cache(batch, max_seq, device="meta")

    def spec_of(axes, leaf):
        axes = tuple(axes) + (None,) * (leaf.dim() - len(axes))
        return named_sharding(mesh, rules.spec(axes))

    return map_axes(spec_of, model.cache_logical_axes(), shapes)


def local_cache_shapes(model, batch: int, max_seq: int,
                       tp: Optional[TensorParallel] = None,
                       groups: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """{leaf: shape} of the fixed-batch cache of a whole `batch` and
    `max_seq` that one rank holds under `tp` and the split `groups`
    (`ServeMesh.groups`; the whole cache's with neither), from
    `model.init_cache` on the meta device: K / V (and the encoder-decoder's
    ek / ev) at the rank's KV heads and positions, the conv window at its
    head-aligned channels (d_in / tp + 2n, not conv_dim / tp), the SSM
    state at its heads and columns, every leaf at its rows."""
    with split_groups(groups):
        shapes = model.init_cache(batch, max_seq, device="meta", tp=tp)
    return {k: tuple(v.shape) for k, v in shapes.items()}


# the logical axes the tensor-parallel serving paths split, over "model"
TP_SPLIT_AXES = ("heads", "kv_heads", "ffn", "experts", "vocab", "embed_vec",
                 "ssm_heads", "conv_dim")
# the other splits of the fixed-batch steps: logical axis -> the sets of
# wide mesh axes it may take (the serving layouts of the production meshes)
SERVE_SPLITS = {"batch": (["data"], ["pod"], ["pod", "data"]),
                "kv_seq": (["model"], ["data"]), "ssm_state": (["data"],),
                "expert_ffn": (["model"],), "seq": (["data"],)}
# the groups the fixed-batch steps read (`distributed.collectives.split_group`)
SPLIT_AXES = ("batch", "kv_seq", "ssm_state", "seq")
# logical axes of one tensor that may not take the same mesh axis
_SAME_TENSOR = (("batch", "kv_seq"), ("batch", "ssm_state"), ("batch", "seq"),
                ("kv_seq", "kv_heads"), ("experts", "expert_ffn"))


def _wide(rules: ShardingRules, name: str, sizes) -> list:
    target = rules.lookup(name)
    axes = () if target is None else (target,) if isinstance(target, str) else target
    return [a for a in axes if sizes.get(a, 1) > 1]


def fixed_batch_rules(rules: ShardingRules, mesh) -> ShardingRules:
    """The caller's `rules` pruned for `mesh` (`prune_for_mesh`, as the
    reference's `jit_prefill_step` / `jit_serve_step` prune them) for the
    fixed-batch steps on it: the TP_SPLIT_AXES over "model" and the
    SERVE_SPLITS ("batch" over "data" / "pod" x "data", "kv_seq" over
    "model" or "data", "ssm_state" over "data", "expert_ffn" over "model",
    "seq" over "data": the sequence-parallel prefill, in uneven blocks
    where the axis does not divide the prompt).  Any other split raises
    NotImplementedError naming the axis; two logical axes of one tensor
    on the same mesh axis raise ValueError, as does an indivisible split
    where the rank's shards are cut, as the reference's placement does."""
    rules = prune_for_mesh(rules, mesh)
    sizes = axis_sizes(mesh)
    for name, _ in rules.rules:
        wide = _wide(rules, name, sizes)
        # "seq_sharded" and "zero" name no serving tensor (ZeRO-1 is training's)
        if (not wide or name in ("seq_sharded", "zero")
                or (name in TP_SPLIT_AXES and wide == ["model"])):
            continue
        if wide not in SERVE_SPLITS.get(name, ()):
            raise NotImplementedError(
                f"logical axis {name!r} is split over mesh axes {tuple(wide)} of sizes "
                f"{tuple(sizes[a] for a in wide)}: the fixed-batch steps split "
                f"{', '.join(TP_SPLIT_AXES)} over 'model' and "
                + "; ".join(f"{k} over {' or '.join('x'.join(w) for w in v)}"
                            for k, v in SERVE_SPLITS.items())
                + " (the layouts rules_for_shape picks; no ROADMAP item ports another)")
    for a, b in _SAME_TENSOR:
        both = set(_wide(rules, a, sizes)) & set(_wide(rules, b, sizes))
        if both:
            raise ValueError(f"logical axes {a!r} and {b!r} of one tensor both take mesh "
                             f"axis {sorted(both)[0]!r}")
    return rules


class ServeMesh:
    """This rank's view of a (pod, data, model) mesh for the fixed-batch
    steps under `rules` (`fixed_batch_rules`'): `tp`, the model axis'
    `TensorParallel` (None where it is 1 wide), and `groups`, {"batch",
    "kv_seq", "ssm_state", "seq": the `AxisGroup` of the mesh axes the rule
    splits it over, or None}; `contexts()` installs both for a step's
    body.  Building it is collective (every rank of the mesh builds it)."""

    def __init__(self, mesh, rules: ShardingRules):
        self.rules = rules
        self.tp = TensorParallel.from_mesh(mesh, rules)
        self.groups = {name: AxisGroup.from_mesh(mesh, rules.lookup(name))
                       for name in SPLIT_AXES}

    @property
    def batch(self) -> Optional[AxisGroup]:
        """The group the batch's rows are split over."""
        return self.groups["batch"]

    def contexts(self):
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(tensor_parallel(self.tp))
        stack.enter_context(split_groups(self.groups))
        return stack


def paged_pool_sharding(model, mesh, rules: ShardingRules):
    """The paged KV pools' NamedSharding: blocks replicated, KV heads as
    the dense cache's head axis."""
    return named_sharding(mesh, rules.spec(model.paged_cache_logical_axes()["k"]))


def slot_state_shardings(model, mesh, rules: ShardingRules):
    """(conv, ssm) NamedShardings of the slot state pools: pool rows
    replicated, feature axes per `MambaLM.slot_state_logical_axes`."""
    axes = model.slot_state_logical_axes()
    return (named_sharding(mesh, rules.spec(axes["conv"])),
            named_sharding(mesh, rules.spec(axes["ssm"])))


def loss_and_grads(model, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1):
    """-> (loss, metrics, grads) of `model.loss` at `params` (a tree of f32
    master tensors, left without gradients afterwards).

    With k = `microbatches` > 1 the batch's rows split into k consecutive
    slices (microbatch i holds rows i*B/k ... (i+1)*B/k - 1, as the
    reference's reshape to (k, B/k, ...)); each backward adds into the
    leaves' `.grad` (0 + g_1 + g_2 + ..., the reference's f32 sum from
    zeros; a stacked leaf's layers and the LM head's reads add into it as
    their backward runs, `models.common.grads_into_grad`) and the sum is
    divided by k after; the loss is the sum of the k losses over k and the
    metrics {"loss"}.  With k = 1 the metrics are the model's own dict.  A
    leaf the loss does not reach gets zeros."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    try:
        # the checkpointed regions (a layer, a loss chunk) are recomputed
        # to their end: stopping after the last saved tensor would save only
        # the reductions after it, and the stop (an exception raised inside
        # the recompute) was seen lost on the card in a loss chunk's
        # recompute ("SystemError: error return without exception set")
        with grads_into_grad(), set_checkpoint_early_stop(False):
            loss, metrics = _backward(model, params, batch, microbatches)
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        if microbatches > 1:
            for g in tree_leaves(grads):
                g.div_(microbatches)
    finally:
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
    return loss, metrics, grads


def _backward(model, params, batch, microbatches: int):
    """`loss_and_grads`' forward and backward passes: -> (loss, metrics),
    the gradients summed into the leaves' `.grad`."""
    if microbatches == 1:
        loss, metrics = model.loss(params, batch)
        loss.backward()
        return loss.detach(), {name: v.detach() for name, v in metrics.items()}
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    n = rows // microbatches
    loss = torch.zeros((), dtype=torch.float32, device=next(tree_leaves(params)).device)
    for i in range(microbatches):
        l, _ = model.loss(params, {name: v[i * n:(i + 1) * n] for name, v in batch.items()})
        l.backward()
        loss = loss + l.detach()
    loss = loss / microbatches
    return loss, {"loss": loss}


def make_train_step(model, train_cfg: TrainConfig, rules: Optional[ShardingRules]):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradients of `loss_and_grads`, then AdamW (parameters and moments
    updated in place); metrics add "lr" and "grad_norm" (before
    clipping).  All tensors stay on the parameters' device.  The step of
    one device: `rules` are installed for the body, as the reference
    installs them (`activation_rules`; a no-op on plain tensors), and
    `mesh_train_step` runs it on a rank of a mesh."""

    def train_step(params, opt_state, batch):
        with activation_rules(rules):
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  train_cfg.microbatches)
            params, opt_state, om = adamw_update(params, grads, opt_state, train_cfg.opt)
        return params, opt_state, dict(metrics, **om)

    return train_step


# ------------------------------------------------------ training on a mesh
def zero1_axes(logical_tree, shapes_tree, mesh, rules: ShardingRules):
    """ZeRO-1: each leaf's first logical axis that is None and whose dim
    (in `shapes_tree`, leaves with a `shape`) divides the "zero" rule's
    mesh axis becomes "zero" (the data axis), as the reference's."""
    zset = rules.lookup("zero")
    zsize = axis_sizes(mesh).get(zset, 1) if isinstance(zset, str) else 1

    def rewrite(axes, shaped):
        if zsize <= 1:
            return axes
        used = {a for a in axes if a is not None}
        out = list(axes)
        for i, (a, dim) in enumerate(zip(axes, shaped.shape)):
            if a is None and dim % zsize == 0 and "zero" not in used:
                out[i] = "zero"
                break
        return tuple(out)

    return map_axes(rewrite, logical_tree, shapes_tree)


def make_state_shardings(model, mesh, rules: ShardingRules,
                         train_cfg: Optional[TrainConfig] = None):
    """NamedShardings of the (params, opt_state) trees on `mesh`, the
    reference's entry for entry: the parameters by their logical axes,
    the moments by `zero1_axes` of them where `train_cfg.zero1`, the step
    replicated (opt_state None without `train_cfg`)."""
    p_logical = model.logical_axes()
    p_shard = params_shardings(mesh, rules, p_logical)
    if train_cfg is None:
        return p_shard, None
    mv_logical = p_logical
    if train_cfg.zero1:
        mv_logical = zero1_axes(p_logical, model.param_shapes(), mesh, rules)
    mv_shard = params_shardings(mesh, rules, mv_logical)
    return p_shard, {"m": mv_shard, "v": mv_shard, "step": named_sharding(mesh, ())}


# the splits of the train step beside the TP_SPLIT_AXES over "model":
# logical axis -> the sets of wide mesh axes it may take ("kv_seq" and
# "ssm_state" name cache dims, no tensor of the step: rules_for_shape puts
# them over "data" beside "seq")
TRAIN_SPLITS = {"batch": (["data"], ["pod"], ["pod", "data"]), "zero": (["data"],),
                "seq": (["data"],), "expert_ffn": (["model"],), "kv_seq": (["data"],),
                "ssm_state": (["data"],)}


def train_rules(rules: ShardingRules, mesh) -> ShardingRules:
    """The caller's `rules` pruned for `mesh` for training on it: the
    TP_SPLIT_AXES and "expert_ffn" (TP inside the experts) over "model",
    "batch" over "data", "pod" or both (pod-major), "zero" (ZeRO-1) over
    "data", and "seq" over "data" (sequence-parallel training, where the
    reference runs it: the batch replicated).  "batch" and "seq" on the
    same mesh axis raise ValueError, as the reference's placement refuses a
    spec naming an axis twice (DuplicateSpecError); any other split raises
    NotImplementedError naming the axis, as do a "batch" and a "seq" both
    split and a "data" or "pod" axis that neither splits."""
    rules = prune_for_mesh(rules, mesh)
    sizes = axis_sizes(mesh)
    for name, _ in rules.rules:
        wide = _wide(rules, name, sizes)
        if (not wide or name == "seq_sharded"          # a logical axis no model names
                or (name in TP_SPLIT_AXES and wide == ["model"])
                or wide in TRAIN_SPLITS.get(name, ())):
            continue
        raise NotImplementedError(
            f"logical axis {name!r} is split over mesh axes {tuple(wide)} of sizes "
            f"{tuple(sizes[a] for a in wide)}: training on a mesh splits "
            f"{', '.join(TP_SPLIT_AXES)} over 'model' and "
            + "; ".join(f"{k} over {' or '.join('x'.join(w) for w in v)}"
                        for k, v in TRAIN_SPLITS.items()))
    batch, seq = _wide(rules, "batch", sizes), _wide(rules, "seq", sizes)
    both = set(batch) & set(seq)
    if both:
        raise ValueError(f"logical axes 'batch' and 'seq' of one tensor both take mesh "
                         f"axis {sorted(both)[0]!r}")
    if batch and seq:
        raise NotImplementedError(
            f"the batch over {tuple(batch)} and the sequence over {tuple(seq)}: "
            "sequence-parallel training runs a replicated batch, as rules_for_shape "
            "gives it")
    for axis in ("pod", "data"):
        if sizes.get(axis, 1) > 1 and axis not in batch + seq:
            raise NotImplementedError(
                f"neither the batch nor the sequence is split over the {axis!r} axis "
                f"of size {sizes[axis]}: training on a mesh splits one of them over "
                f"it")
    return rules


class RankMesh:
    """This rank's groups on a (pod, data, model) training mesh: `tp`, the
    model axis' `TensorParallel` under `rules`; `batch`, the axes the
    batch's rows are split over (pod-major); `seq`, those the sequence's
    positions are (`SeqSplit`); `dp`, whichever of the two is split (the
    loss's sums and the gradients' sum); `zero`, the "zero" rule's axis
    (the ZeRO-1 slices); `axes`, every mesh axis by name (None where 1 wide);
    `device`, this rank's device (`device` if given, else the mesh's
    device type: the dry run's "cpu" mesh over a fake world keeps its
    state on "meta"); `writer`: the rank at coordinate 0 of every axis.
    Every group is None where its axis is 1 wide."""

    def __init__(self, mesh, rules: ShardingRules, device=None):
        self.mesh, self.rules = mesh, rules
        self.tp = TensorParallel.from_mesh(mesh, rules)
        self.batch = AxisGroup.from_mesh(mesh, rules.lookup("batch"))
        self.seq = AxisGroup.from_mesh(mesh, rules.lookup("seq"))
        self.dp = self.batch if self.seq is None else self.seq
        self.zero = AxisGroup.from_mesh(mesh, rules.lookup("zero"))
        self.axes = {name: AxisGroup.from_mesh(mesh, name) for name in mesh.mesh_dim_names}
        self.writer = all(c == 0 for c in mesh.get_coordinate())
        if device is not None:
            self.device = torch.device(device)
        elif mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)

    def contexts(self):
        """The rank's contexts for a step's body: the model axis, the loss's
        group (`dp`), the sequence's split ("seq") and the mesh's axis
        names."""
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(tensor_parallel(self.tp))
        stack.enter_context(data_parallel(self.dp))
        stack.enter_context(split_groups({"seq": self.seq}))
        stack.enter_context(mesh_axes(self.axes))
        return stack

    def any(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank of the mesh (one reduction)."""
        x = torch.tensor([1.0 if flag else 0.0])
        for g in self.axes.values():
            if g is not None:
                x = g._sum(x if g.backend != "nccl" else x.to(self.device)).cpu()
        return bool(x.item() > 0)

    def max(self, value: float) -> float:
        """The largest of every rank's `value` (one reduction an axis)."""
        x = torch.tensor([float(value)], dtype=torch.float64)
        for g in self.axes.values():
            if g is not None:
                x = g.max(x if g.backend != "nccl" else x.to(self.device)).cpu()
        return float(x.item())

    def barrier(self) -> None:
        """Return once every rank of the mesh has reached this call."""
        for g in self.axes.values():
            if g is not None:
                g.barrier()


class _OneRank:
    """The layout view of a 1-wide model axis."""

    def __init__(self, rules):
        self.rules, self.rank, self.size = rules, 0, 1


def state_layouts(model, mesh, rules: ShardingRules, train_cfg: TrainConfig,
                  rank_mesh: Optional[RankMesh] = None):
    """The train state's cut on this rank of `mesh` ({"params", "opt": {"m",
    "v", "step"}}, a `distributed.sharding.LeafCut` a leaf, on the rank's
    device): the parameters as `model.tp_layout` cuts them (the
    tensor-parallel shards), the moments so too and then, where
    `make_state_shardings` gives a leaf's moments a "data" dim (ZeRO-1),
    the rank's block of it along the data axis."""
    rm = RankMesh(mesh, rules) if rank_mesh is None else rank_mesh
    cuts = model.tp_layout(rm.tp if rm.tp is not None else _OneRank(rules))
    cuts = tree_map(lambda c: c._replace(device=rm.device), cuts)
    _, opt_shard = make_state_shardings(model, mesh, rules, train_cfg)
    zset = rules.lookup("zero")

    def with_zero(cut, sharding):
        dims = [i for i, e in enumerate(sharding.spec) if e == zset and zset is not None]
        if not dims or rm.zero is None:
            return cut
        return cut._replace(zero_dim=dims[0], zero_rank=rm.zero.rank,
                            zero_size=rm.zero.size)

    mv = tree_map(with_zero, cuts, opt_shard["m"])
    return {"params": cuts, "opt": {"m": mv, "v": mv, "step": LeafCut(device=rm.device)}}


def sync_grads(grads, cuts, tp: Optional[TensorParallel]):
    """A rank's gradients made whole over the model axis, in place: where
    several ranks hold a position (`LeafCut.shared`) each holds a partial
    of its gradient, so those positions' gradients are summed over their
    holders (placed in a buffer of every shared position, the others'
    slots zero, summed over the axis in rank order, read back); a
    `partial` whole leaf is summed over the axis.  Every other leaf's
    gradient is already whole on its rank."""
    if tp is None:
        return grads

    def one(cut, g):
        if cut.partial:
            tp.sum_in_place(g)
        elif cut.dim is not None and cut.shared:
            # the positions several ranks hold, in a buffer of all of them
            shape = list(g.shape)
            shape[cut.dim] = cut.n_shared
            pos, slot = cut.shared_local.to(g.device), cut.shared_slot.to(g.device)
            buf = g.new_zeros(shape).index_copy_(cut.dim, slot, g.index_select(cut.dim, pos))
            g.index_copy_(cut.dim, pos, tp.sum_in_place(buf).index_select(cut.dim, slot))
        return g

    return tree_map(one, cuts, grads)


def _gather_zero(cut: LeafCut, t: torch.Tensor, zero: Optional[AxisGroup]) -> torch.Tensor:
    """A ZeRO-1 slice's model-axis shard: the data ranks' blocks in order."""
    if cut.zero_dim is None or zero is None:
        return t
    return torch.cat(zero._gather(t).unbind(0), cut.zero_dim)


def gather_state(model, state, layouts, rank_mesh: RankMesh, on_leaf=None):
    """The whole train state from the ranks' shards (collective over the
    mesh, leaf by leaf in the tree's order): each moment's ZeRO-1 blocks
    gathered over the data axis, then every leaf's model-axis shards
    (`zoo.gather_cut`).  -> the whole tree (fresh tensors: a later step
    does not change them), or with `on_leaf(key, whole)` the tree of its
    results (each whole leaf dropped after its call)."""
    from repro_torch.models.zoo import gather_cut
    from repro_torch.tree import tree_flatten_with_paths

    flat_cuts = dict(tree_flatten_with_paths(layouts))
    out = {}
    for key, t in tree_flatten_with_paths(state):
        cut = flat_cuts[key]
        whole = _gather_zero(cut, t.detach(), rank_mesh.zero)
        if rank_mesh.tp is not None and cut.dim is not None:
            whole = gather_cut(cut, whole, rank_mesh.tp)
        elif cut.zero_dim is None or rank_mesh.zero is None:
            whole = whole.clone()                 # the rank's own tensor
        out[key] = on_leaf(key, whole) if on_leaf else whole
    return _unflatten(out)


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def rank_batch(batch: Dict[str, Any], microbatches: int, dp: Optional[AxisGroup],
               device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, on `device`, `dp` the group the
    rows are split over (`RankMesh.batch`; ranked pod-major over "pod" x
    "data"): microbatch i is the global rows [i B / k, (i + 1) B / k) as
    in the reference, and the rank takes its contiguous share of each,
    concatenated in microbatch order (so `loss_and_grads`' k consecutive
    slices are its shares of the k microbatches).  With `dp` None (a
    replicated batch, as under sequence-parallel training) every row: the
    model takes its block of positions from them (`SeqSplit`)."""
    rows = next(iter(batch.values())).shape[0]
    n_dp = dp.size if dp is not None else 1
    if rows % (microbatches * n_dp):
        raise ValueError(f"batch of {rows} rows does not split into {microbatches} "
                         f"microbatches over {n_dp} data ranks")
    if n_dp == 1:
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    n, share = rows // microbatches, rows // (microbatches * n_dp)

    def mine(v):
        v = torch.as_tensor(v)
        return torch.cat([v[i * n + dp.rank * share:i * n + (dp.rank + 1) * share]
                          for i in range(microbatches)]).to(device)

    return {k: mine(v) for k, v in batch.items()}


def _pieces(params, grads, opt_state, piece: int = 1 << 24):
    """(params, grads, opt_state) as flat trees whose large contiguous
    leaves are split into views of `piece` elements, so AdamW's
    elementwise update (the same bits a piece at a time) needs a piece's
    temporaries, not a whole leaf's; the step counter is shared."""
    from repro_torch.tree import tree_flatten_with_paths

    m, v = (dict(tree_flatten_with_paths(opt_state[k])) for k in ("m", "v"))
    g = dict(tree_flatten_with_paths(grads))
    out = ({}, {}, {"m": {}, "v": {}, "step": opt_state["step"]})
    for key, p in tree_flatten_with_paths(params):
        leaves = (p, g[key], m[key], v[key])
        if p.numel() > piece and all(t.is_contiguous() for t in leaves):
            parts = zip(*(t.view(-1).split(piece) for t in leaves))
        else:
            parts = [leaves]
        for i, (pp, gg, mm, vv) in enumerate(parts):
            name = f"{key}#{i}"
            out[0][name], out[1][name] = pp, gg
            out[2]["m"][name], out[2]["v"][name] = mm, vv
    return out


def mesh_train_step(model, mesh, rules: ShardingRules, train_cfg: TrainConfig,
                    batch_specs=None, device=None):
    """The rank's train step on a (pod, data, model) `mesh` — the counterpart of
    the reference's `jit_train_step(model, mesh, rules, train_cfg,
    batch_specs)`, which computes the same step on the same mesh:
    (params, opt_state, batch) -> (params, opt_state, metrics), the state
    this rank's cut (`state_layouts`), `batch` the GLOBAL batch (tensors or
    arrays on any device; `batch_specs` is unused, as the shapes come with
    the batch); `device`: the rank's device (`RankMesh`).

      * the loss is the reference's: the rank computes on its share of
        each microbatch (`rank_batch`; where "seq" is split, on its block
        of every row's positions, `collectives.SeqSplit`) inside its
        contexts, and the masked mean's sums of NLL and of the mask are
        reduced over the split axes (`RankMesh.dp`) before the division
        (`models.common.chunked_softmax_xent`), so the loss is the whole
        microbatch's, the same bits on every rank;
      * the gradients are made whole over the model axis (`sync_grads`),
        then summed over `RankMesh.dp` in rank order in f32: each rank's
        gradient already carries the whole microbatch's 1 / count, so the
        sum is the reference's mean of its rows' (or positions') terms
        (under the sequence split the gathers' backward has returned to
        each rank what the other ranks' positions read of its block);
      * `grad_norm` and the clip scale are the whole tree's
        (`optim.global_norm` over the cuts), the same bits on every rank;
      * with ZeRO-1 each data rank updates its blocks of the moments and
        the parameters, then the parameters' blocks are all-gathered over
        the data axis (the same bits as updating the whole leaf); AdamW
        runs on pieces of the leaves (`_pieces`: the same bits, a piece's
        temporaries).

    The rules are `train_rules`' (a split this path does not run raises
    NotImplementedError, one the reference refuses ValueError).  The step carries `layouts` (`state_layouts`),
    `rank_mesh` (the rank's `RankMesh`) and `grads(params, batch)` (its
    first half: the loss, the metrics and the rank's whole gradients);
    `on_grads`, if given, is called with those gradients before the
    update."""
    rules = train_rules(rules, mesh)
    rm = RankMesh(mesh, rules, device)
    layouts = state_layouts(model, mesh, rules, train_cfg, rm)
    p_cuts, m_cuts = layouts["params"], layouts["opt"]["m"]

    @torch.no_grad()
    def _sum_data(g):
        return rm.dp.sum_in_place(g)

    def grads_of(params, batch):
        """(loss, metrics, the rank's whole gradients of its shards)."""
        local = rank_batch(batch, train_cfg.microbatches, rm.batch, rm.device)
        with rm.contexts(), activation_rules(rules):
            loss, metrics, grads = loss_and_grads(model, params, local,
                                                  train_cfg.microbatches)
        with torch.no_grad():
            grads = sync_grads(grads, p_cuts, rm.tp)
            if rm.dp is not None:
                grads = tree_map(_sum_data, grads)
        return loss, metrics, grads

    def train_step(params, opt_state, batch, on_grads=None):
        loss, metrics, grads = grads_of(params, batch)
        if on_grads is not None:
            on_grads(grads)
        with torch.no_grad():
            gnorm = global_norm(grads, p_cuts, rm.tp)
            zp = tree_map(lambda c, t: c.zero_slice(t), m_cuts, params)
            zg = tree_map(lambda c, t: c.zero_slice(t), m_cuts, grads)
            _, _, om = adamw_update(*_pieces(zp, zg, opt_state), train_cfg.opt,
                                    gnorm=gnorm)
            del zg, grads
            tree_map(lambda c, p, z: p.copy_(_gather_zero(c, z, rm.zero))
                     if c.zero_dim is not None and rm.zero is not None else p,
                     m_cuts, params, zp)
        return params, opt_state, dict(metrics, **om)

    train_step.layouts = layouts
    train_step.rank_mesh = rm
    train_step.grads = grads_of
    return train_step


def unified_step(model, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 dec_tables, dec_lengths, dec_tokens, ch_tokens, seg_tables,
                 seg_info, dec_sampling, dec_keys, seg_sampling, seg_keys, *,
                 decode_attn_backend: str = "torch",
                 chunk_attn_backend: str = "torch",
                 chunk_attn_config: Optional[Dict[str, Any]] = None,
                 decode_matmul_table: Optional[MatmulTable] = None,
                 chunk_matmul_table: Optional[MatmulTable] = None,
                 tp: Optional[TensorParallel] = None):
    """-> (dec_next (slots,), seg_next (S,), seg_logits (S, V))

    The serving step for steps that carry prompt work: the prefill lane
    runs a packed chunk of prompt segments (K/V committed to each segment's
    blocks), then the decode lane advances every slot (the lanes touch
    disjoint blocks — a request never prefills and decodes in one step).
    seg_next[s] is segment s's first token, valid only for segments that
    complete their prompt this step; `seg_logits` are the logits it was
    drawn from, returned for callers that inspect them.  Each lane's
    tokens are drawn on the device (`sample_tokens`) from its sampling and
    key arrays.  `tp`: the rank's tensor-parallel context (its local
    parameters and pools; the logits come out whole on every rank)."""
    with tensor_parallel(tp), matmul_dispatch(chunk_matmul_table):
        ch_logits = model.prefill_packed_paged(
            params, k_pool, v_pool, seg_tables, ch_tokens, seg_info,
            attn_backend=chunk_attn_backend, attn_config=chunk_attn_config)
    with tensor_parallel(tp), matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_paged(
            params, k_pool, v_pool, dec_tables, dec_lengths, dec_tokens,
            attn_backend=decode_attn_backend)
    nxt = sample_tokens(logits[:, -1], dec_sampling, dec_keys)
    seg_next = sample_tokens(ch_logits[0], seg_sampling, seg_keys)
    return nxt, seg_next, ch_logits[0]


def decode_only_step(model, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     dec_tables, dec_lengths, dec_tokens, dec_sampling,
                     dec_keys, *, decode_attn_backend: str = "torch",
                     decode_matmul_table: Optional[MatmulTable] = None,
                     tp: Optional[TensorParallel] = None):
    """-> dec_next (slots,): the unified step's decode lane without the
    chunk lane, for steps with no prompt work."""
    with tensor_parallel(tp), matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_paged(
            params, k_pool, v_pool, dec_tables, dec_lengths, dec_tokens,
            attn_backend=decode_attn_backend)
    return sample_tokens(logits[:, -1], dec_sampling, dec_keys)


def graph_unified_step(model, device, *, graphed: bool = True, pool=None,
                       **lanes) -> Program:
    """The unified step program: `unified_step` with the model and the
    lanes (`decode_attn_backend`, `chunk_attn_backend`,
    `chunk_attn_config`, `decode_matmul_table`, `chunk_matmul_table`,
    `tp`) fixed.  Inputs: dec_tables, dec_lengths, dec_tokens, ch_tokens,
    seg_tables, seg_info, dec_sampling, dec_keys, seg_sampling, seg_keys."""
    return Program(functools.partial(unified_step, model, **lanes), "unified",
                   device, graphed=graphed, pool=pool)


def graph_decode_only_step(model, device, *, graphed: bool = True, pool=None,
                           **lanes) -> Program:
    """The decode-only step program: `decode_only_step` with the model and
    the decode lane (`decode_attn_backend`, `decode_matmul_table`, `tp`)
    fixed.
    Inputs: dec_tables, dec_lengths, dec_tokens, dec_sampling, dec_keys."""
    return Program(functools.partial(decode_only_step, model, **lanes),
                   "decode_only", device, graphed=graphed, pool=pool)


def graph_commit_prefill(device, *, graphed: bool = True, pool=None) -> Program:
    """The resume-commit program: `commit_prefill`, called as
    `program((k_pool, v_pool, ks, vs), (block_ids,))` where ks / vs are the
    caller's fixed (L, S, S_pad, Hkv, hd) device buffers (bound: the
    caller fills them in place before each call) and block_ids is the
    (S, S_pad / block_size) int32 host array, so it has one signature."""
    return Program(commit_prefill, "commit", device, graphed=graphed, pool=pool)


def graph_cow_block(device, *, graphed: bool = True, pool=None) -> Program:
    """The copy-on-write program: `cow_block`, called as
    `program((k_pool, v_pool), (src, dst))` with (1,) int32 block ids."""
    return Program(cow_block, "cow", device, graphed=graphed, pool=pool)


def commit_prefill(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   ks: torch.Tensor, vs: torch.Tensor,
                   block_ids: torch.Tensor) -> None:
    """Scatter S resuming requests' K/V (L, S, S_pad, Hkv, hd) into the
    pools at `block_ids` (S, S_pad / block_size), in place.  Padding
    entries point at the null sink block, whose contents are unspecified."""
    n_layers, block_size = k_pool.shape[0], k_pool.shape[2]
    n_seg, s_pad = ks.shape[1], ks.shape[2]
    nb = s_pad // block_size
    kb = ks.reshape(n_layers, n_seg * nb, block_size, *ks.shape[3:])
    vb = vs.reshape(n_layers, n_seg * nb, block_size, *vs.shape[3:])
    flat_ids = block_ids.reshape(-1).long()
    k_pool[:, flat_ids] = kb.to(k_pool.dtype)
    v_pool[:, flat_ids] = vb.to(v_pool.dtype)


def cow_block(k_pool: torch.Tensor, v_pool: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> None:
    """Copy-on-write: duplicate physical block `src` into `dst` ((1,) int
    tensors) in both pools, in place (the allocator has already repointed
    the writer's table at `dst`)."""
    src, dst = src.long(), dst.long()
    k_pool.index_copy_(1, dst, k_pool.index_select(1, src))
    v_pool.index_copy_(1, dst, v_pool.index_select(1, src))


# ------------------------------------------- slot-pooled (ssm) serving
def ssm_unified_step(model, params, conv_pool: torch.Tensor,
                     ssm_pool: torch.Tensor, dec_state_idx, dec_tokens,
                     ch_tokens, ch_state_idx, ch_seg_len, ch_seg_start,
                     dec_sampling, dec_keys, ch_sampling, ch_keys, *,
                     decode_matmul_table: Optional[MatmulTable] = None,
                     chunk_matmul_table: Optional[MatmulTable] = None,
                     tp: Optional[TensorParallel] = None):
    """-> (dec_next (slots,), ch_next (1,), ch_logits (1, V))

    The ssm step for steps that carry prompt work: one C-token prompt
    segment (rows past `ch_seg_len` made exact identities) committed into
    the chunk request's state row `ch_state_idx` — `ch_seg_start == 0`
    selects zero carries on the device — then a decode token for every
    slot (`dec_state_idx` maps slot -> pool row; idle and prefilling slots
    point at the null row).  The lanes touch disjoint rows.  ch_next is
    the segment's next-token draw, read by the host only when the segment
    completes its prompt; ch_logits are what it was drawn from.  `tp`: the
    rank's tensor-parallel context (its local parameters and pools; the
    logits come out whole on every rank)."""
    with tensor_parallel(tp), matmul_dispatch(chunk_matmul_table):
        ch_logits = model.prefill_chunk_slots(
            params, conv_pool, ssm_pool, ch_state_idx, ch_tokens, ch_seg_len,
            ch_seg_start)
    with tensor_parallel(tp), matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_slots(params, conv_pool, ssm_pool,
                                         dec_state_idx, dec_tokens)
    nxt = sample_tokens(logits[:, -1], dec_sampling, dec_keys)
    ch_next = sample_tokens(ch_logits[:, -1], ch_sampling, ch_keys)
    return nxt, ch_next, ch_logits[:, -1]


def ssm_decode_only_step(model, params, conv_pool: torch.Tensor,
                         ssm_pool: torch.Tensor, dec_state_idx, dec_tokens,
                         dec_sampling, dec_keys, *,
                         decode_matmul_table: Optional[MatmulTable] = None,
                         tp: Optional[TensorParallel] = None):
    """-> dec_next (slots,): the ssm unified step's decode lane alone."""
    with tensor_parallel(tp), matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_slots(params, conv_pool, ssm_pool,
                                         dec_state_idx, dec_tokens)
    return sample_tokens(logits[:, -1], dec_sampling, dec_keys)


def ssm_commit_state(conv_pool: torch.Tensor, ssm_pool: torch.Tensor,
                     conv: torch.Tensor, ssm: torch.Tensor,
                     rows: torch.Tensor) -> None:
    """Scatter S resuming requests' state, conv (L, S, W-1, conv_dim) and
    ssm (L, S, nh, hd, n), into pool rows `rows` (S,), in place.  Padding
    entries point at the null row, whose contents are unspecified."""
    rows = rows.long()
    conv_pool.index_copy_(1, rows, conv.to(conv_pool.dtype))
    ssm_pool.index_copy_(1, rows, ssm.to(ssm_pool.dtype))


def graph_ssm_unified_step(model, device, *, graphed: bool = True, pool=None,
                           **lanes) -> Program:
    """The ssm unified step program (`decode_matmul_table`,
    `chunk_matmul_table`, `tp` fixed), called as `program((params, conv_pool,
    ssm_pool), (dec_state_idx, dec_tokens, ch_tokens, ch_state_idx,
    ch_seg_len, ch_seg_start, dec_sampling, dec_keys, ch_sampling,
    ch_keys))`."""
    return Program(functools.partial(ssm_unified_step, model, **lanes), "unified",
                   device, graphed=graphed, pool=pool)


def graph_ssm_decode_only_step(model, device, *, graphed: bool = True, pool=None,
                               **lanes) -> Program:
    """The ssm decode-only program (`decode_matmul_table`, `tp` fixed),
    called as
    `program((params, conv_pool, ssm_pool), (dec_state_idx, dec_tokens,
    dec_sampling, dec_keys))`."""
    return Program(functools.partial(ssm_decode_only_step, model, **lanes),
                   "decode_only", device, graphed=graphed, pool=pool)


def graph_ssm_commit_state(device, *, graphed: bool = True, pool=None) -> Program:
    """The ssm resume-commit program: `ssm_commit_state`, called as
    `program((conv_pool, ssm_pool, conv, ssm), (rows,))` with the caller's
    fixed device buffers conv / ssm (filled in place before each call) and
    the (S,) int32 host array of rows, so it has one signature."""
    return Program(ssm_commit_state, "commit", device, graphed=graphed, pool=pool)


def prefill_step(model, params, tokens: torch.Tensor, max_seq: int,
                 extras: Optional[Dict[str, torch.Tensor]] = None):
    """The fixed-batch prefill: tokens (B, S) and the batch's modality
    extras (`vision_embeds` / `audio_embeds`, (B, ...)) -> (last-position
    logits (B, 1, V), the model's fixed-batch cache: dense K/V of
    `max_seq` rows, Mamba2's carries, or both, and the encoder's cross
    K/V).  Inside a rank's `tensor_parallel` context it runs on the rank's
    shards, the cache at the rank's widths (`local_cache_shapes`), the
    logits whole on every rank; inside its `ServeMesh.contexts()` with
    "seq" split, on its block of the prompt (the whole prompt is passed)."""
    return model.prefill(params, {"tokens": tokens, **(extras or {})}, max_seq)


def serve_step(model, params, cache, tokens: torch.Tensor):
    """The fixed-batch decode step: tokens (B, 1) -> (logits (B, 1, V),
    the cache advanced by one row, updated in place), on the rank's shards
    and cache inside its `tensor_parallel` context."""
    return model.decode_step(params, cache, tokens)
