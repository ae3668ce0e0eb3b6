"""The dry run: one rank's step of every (arch x shape x mesh) cell on the
meta device — the port of `repro.launch.dryrun`.

The reference forces 512 host devices, builds the production meshes
(16 x 16, and 2 x 16 x 16 across pods), lowers and compiles the real
train / prefill / serve step under `rules_for_shape` and writes one JSON
artifact per cell.  The port runs the same step programs on plain tensors
of one rank, each rank a process, so a cell is one rank's step: this
process starts a fake world of 256 or 512 ranks (torch's testing process
group, `torch.testing._internal.distributed.fake_pg`; rank 0, no
transport), builds `make_production_mesh(multi_pod=..., device_type=
"cpu")` on it, and runs rank 0's step once on meta tensors: the model's
rank-0 state (`launch.steps.state_layouts` for training, the rank's
`tp_local_params` for serving) and an `input_specs` batch.  Every rank of
a cell runs the same shapes, so rank 0's counts are the cell's
per-device counts.  The world is destroyed after each cell, so `--all`
moves between worlds.  Nothing is allocated and no GPU is needed.

Each artifact carries the reference's keys:
  * `cost.flops_per_device` from `torch.utils.flop_counter.FlopCounterMode`
    (products, convolutions and attention; `flops_by_op` splits it).  The
    reference's count, XLA's, also holds every elementwise op's FLOPs
    (about 5 % of qwen3-1.7b train_4k's); the port's does not;
  * `cost.bytes_accessed_per_device` and `cost.transcendentals` from
    `launch.costcount.CostCounter` (`bytes_by_op`, `transcendentals_by_op`
    split them): the bytes every aten op of the step reads and writes, each
    op its own kernel as in the port's eager step, so XLA's "bytes
    accessed" with no fusion (the reference's count fuses, and is lower),
    collectives' operands and results under their own op names; and one
    transcendental per output element of the ops XLA counts as such
    (exp, log, rsqrt, the softmaxes, ...; the module's docstring has the
    rules);
  * `memory.argument_bytes` / `output_bytes`: the bytes of the rank's
    state and batch (and cache) going in and of the step's results coming
    out, by group in `argument_bytes_by_group`;
    `argument_bytes_placements` is the same state under
    `make_state_shardings`' placements (the reference's layout, leaf by
    leaf), where the port's cut holds less (wk / wv at the KV heads the
    rank's query heads read); `temp_bytes` and `peak_bytes_per_device`
    from `torch.distributed._tools.mem_tracker.MemTracker`'s peak
    (`peak_by_category`), or null with `memory_note` where it cannot run;
  * `collectives` from `distributed.collectives.count_collectives` (every
    collective of the port is one all-gather of raw bytes, tallied as the
    all-reduce or all-gather it implements); `comm_debug_mode_count` is
    the number of c10d collectives torch's `CommDebugMode` saw, a
    cross-check that is logged and not gated;
  * `params`, `active_params`, `tokens`, `lower_s` (the meta run's
    seconds), `cost_method: "meta"`, and `kernels: "none"`: the train
    step and the fixed-batch steps reach no hand-written kernel (the
    torch lanes: no plan's matmul table, the dense attention forms), so
    every op runs as a torch op that the counters see.  A kernel wrapper
    handed meta tensors raises, as off the CPU it launches or raises, so a
    path that reached one would fail its cell, not be counted short (a
    ctypes launch is invisible to every dispatch mode).

Training runs `mesh_train_step` with `TrainConfig(microbatches=
REPRO_MICROBATCHES or 4, zero1=True)` and `remat="full"`, as the
reference lowers it; prefill and decode run the fixed-batch
`prefill_step` / `serve_step` under `fixed_batch_rules` in the rank's
contexts (`launch.steps.ServeMesh`): its rows of the batch (over "data",
or "pod" x "data"), the cache of those rows at its KV heads, positions
("kv_seq") and SSM state columns ("ssm_state"), as `init_cache` gives
them under the groups.  The reference's
environment variables keep their meaning: REPRO_LAYERS (layer count),
REPRO_CAPF (MoE capacity factor), REPRO_REMAT (training's remat policy),
REPRO_RULES ("axis=mesh_axis,..." overrides, "+" joining axes) and
REPRO_MICROBATCHES.  REPRO_COST_PROGRAM has no counterpart: the meta run
is one program, whose layers are a Python loop, so every layer is counted
(`models.runmode`).

A layout the port refuses is recorded as the reference records a
failure: status "error" with the exception's message; a split that does
not divide is a ValueError, as the reference's placement raises one.

Usage (no GPU, no network; one cell takes 1–4 minutes on the CPU, `--all
--both-meshes` about 15, an existing artifact is skipped):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --continue-on-error
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import (REGISTRY, SHAPES, ModelConfig, ShapeSpec, get_config,
                                 input_specs, runnable)
from repro_torch.distributed.collectives import count_collectives
from repro_torch.distributed.sharding import axis_sizes, local_rows, local_shard
from repro_torch.launch.costcount import CostCounter
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import (ServeMesh, TrainConfig, cost_dict, fixed_batch_rules,
                                      make_state_shardings, mesh_train_step, prefill_step,
                                      rank_batch, rules_for_shape, serve_step)
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_map

META = torch.device("meta")


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake process group of `size` ranks
    (collectives return at once, nothing moves), destroyed on exit.  Raises
    where torch has no fake process group or a group is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world, but a process "
                           "group is already up in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_config(cfg: ModelConfig, kind: str) -> ModelConfig:
    """`cfg` under REPRO_LAYERS / REPRO_CAPF, and for training the remat
    policy REPRO_REMAT (default "full", the reference's baseline)."""
    if os.environ.get("REPRO_LAYERS"):
        cfg = dataclasses.replace(cfg, n_layers=int(os.environ["REPRO_LAYERS"]))
    if os.environ.get("REPRO_CAPF"):
        cfg = dataclasses.replace(cfg, capacity_factor=float(os.environ["REPRO_CAPF"]))
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=os.environ.get("REPRO_REMAT", "full"))
    return cfg


def rule_overrides(rules):
    """`rules` with REPRO_RULES' overrides ("kv_seq=model,ffn=,heads=data";
    "+" joins mesh axes, an empty value is None)."""
    overrides = os.environ.get("REPRO_RULES", "")
    if not overrides:
        return rules
    kv = {}
    for item in overrides.split(","):
        k, _, v = item.partition("=")
        v = v.strip()
        kv[k.strip()] = tuple(v.split("+")) if "+" in v else (v or None)
    return rules.replace(**kv)


def nbytes(tree) -> int:
    """The bytes of the tensors of a pytree (dicts, tuples, lists)."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, device=META, memory_format=torch.contiguous_format)


def placement_bytes(shapes, shardings, mesh) -> int:
    """The bytes rank 0 holds of the whole leaves `shapes` (meta) under
    `shardings` (NamedShardings, the reference's layout)."""
    sizes, coords = axis_sizes(mesh), dict.fromkeys(axis_sizes(mesh), 0)
    flat = dict(tree_flatten_with_paths(shardings))
    return sum(local_shard(t, flat[k].spec, sizes, coords).numel() * t.element_size()
               for k, t in tree_flatten_with_paths(shapes))


class Meters:
    """The counters of one meta run: FLOPs, bytes accessed and
    transcendentals, the collective tally, torch's CommDebugMode and
    MemTracker, with the state's tensors registered by category (`params`
    as parameters, `opt` as optimizer state, `other` as other) and the gradients as gradients once `gradients` is called
    with them (the train step's `on_grads`, after its backward: the port
    allocates each leaf's `.grad` at its first read in the forward, so
    until then MemTracker files them under activations)."""

    def __init__(self, params, opt=None, other=()):
        from torch.utils.flop_counter import FlopCounterMode

        self.flops = FlopCounterMode(display=False)
        self.cost = CostCounter()
        self.mem, self.mem_note = None, None
        try:
            from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType
        except ImportError as e:
            self.mem_note = f"MemTracker unavailable: {e}"
        else:
            self.mem, self._kinds = MemTracker(), _MemRefType
            self._tag(params, _MemRefType.PARAM)
            self._tag(opt or {}, _MemRefType.OPT)
            self.mem.track_external(*other)

    def _tag(self, tree, kind) -> None:
        for t in tree_leaves(tree):
            self.mem._update_and_maybe_create_winfos(t, kind)

    def gradients(self, grads) -> None:
        """File the tensors of `grads` under MemTracker's gradients."""
        if self.mem is not None:
            self._tag(grads, self._kinds.GRAD)

    @contextlib.contextmanager
    def __call__(self):
        from torch.distributed.tensor.debug import CommDebugMode

        with contextlib.ExitStack() as stack:
            if self.mem is not None:
                stack.enter_context(self.mem)
            self.comm = stack.enter_context(CommDebugMode())
            stack.enter_context(self.flops)
            self.tally = stack.enter_context(count_collectives())
            # last, so that it sees each op as the step calls it, before
            # FlopCounterMode decomposes any
            stack.enter_context(self.cost)
            yield

    def record(self, argument_bytes: int) -> Dict[str, Any]:
        by_op = {str(op): int(n) for op, n in
                 self.flops.get_flop_counts().get("Global", {}).items()}
        out = {"cost": cost_dict({"flops": self.flops.get_total_flops(),
                                  "transcendentals": self.cost.total_transcendentals(),
                                  "bytes accessed": self.cost.total_bytes()}),
               "flops_by_op": by_op, "bytes_by_op": self.cost.by_op(self.cost.bytes_by_op),
               "transcendentals_by_op": self.cost.by_op(self.cost.transcendentals_by_op),
               "collectives": self.tally.as_dict(),
               "comm_debug_mode_count": int(self.comm.get_total_counts())}
        if self.mem is None:
            out["memory"] = {"temp_bytes": None, "peak_bytes_per_device": None,
                             "memory_note": self.mem_note}
            return out
        peak = self.mem.get_tracker_snapshot("peak").get(META, {})
        total = int(peak.get("Total", 0))
        out["memory"] = {"temp_bytes": total - argument_bytes, "peak_bytes_per_device": total,
                         "peak_by_category": {str(getattr(k, "value", k)): int(v)
                                              for k, v in peak.items()}}
        return out


def _train_cell(model, cfg, shape, mesh, rules, train_cfg: TrainConfig) -> Dict[str, Any]:
    step = mesh_train_step(model, mesh, rules, train_cfg, device=META)
    layouts, rm = step.layouts, step.rank_mesh
    shapes = model.param_shapes()
    params = tree_map(lambda c, p: _fresh(c.model_local(p)), layouts["params"], shapes)
    opt = adamw_init(tree_map(lambda c, p: c.zero_slice(p), layouts["opt"]["m"], params))
    batch = input_specs(cfg, shape)
    local = rank_batch(batch, train_cfg.microbatches, rm.batch, META)
    groups = {"params": nbytes(params), "m": nbytes(opt["m"]), "v": nbytes(opt["v"]),
              "step": nbytes(opt["step"]), "batch": nbytes(local)}
    p_shard, o_shard = make_state_shardings(model, mesh, rm.rules, train_cfg)
    placed = {"params": placement_bytes(shapes, p_shard, mesh),
              "m": placement_bytes(shapes, o_shard["m"], mesh),
              "v": placement_bytes(shapes, o_shard["v"], mesh),
              "step": groups["step"], "batch": groups["batch"]}
    meters = Meters(params, opt)
    argument = sum(groups.values())
    with meters():
        out = step(params, opt, batch, on_grads=meters.gradients)
    rec = meters.record(argument)
    rec["memory"].update(argument_bytes=argument, output_bytes=nbytes(out),
                         argument_bytes_by_group=groups,
                         argument_bytes_placements=sum(placed.values()),
                         placement_bytes_by_group=placed)
    return rec


def _serve_cell(model, cfg, shape, mesh, rules) -> Dict[str, Any]:
    rules = fixed_batch_rules(rules, mesh)
    sm = ServeMesh(mesh, rules)
    params = tree_map(_fresh, model.param_shapes())
    if sm.tp is not None:
        params = tree_map(_fresh, model.tp_local_params(params, sm.tp))
    start, rows = local_rows(shape.global_batch, sm.batch)
    batch = {k: _fresh(v.narrow(0, start, rows)) for k, v in input_specs(cfg, shape).items()}
    if shape.kind == "prefill":
        inputs, groups = batch, {k: nbytes(v) for k, v in batch.items()}
        extras = {k: v for k, v in inputs.items() if k != "tokens"}
        call = lambda: prefill_step(model, params, inputs["tokens"], shape.seq_len, extras)
    else:
        with sm.contexts():
            cache = model.init_cache(shape.global_batch, shape.seq_len, META, sm.tp)
        inputs = {"cache": cache, "tokens": batch["tokens"]}
        groups = {**{k: nbytes(v) for k, v in cache.items()},
                  "tokens": nbytes(batch["tokens"])}
        call = lambda: serve_step(model, params, inputs["cache"], inputs["tokens"])
    groups = {"params": nbytes(params), **groups}
    argument = sum(groups.values())
    meters = Meters(params, other=pytree.tree_leaves(inputs))
    with meters(), sm.contexts(), torch.no_grad():
        out = call()
    rec = meters.record(argument)
    rec["memory"].update(argument_bytes=argument, output_bytes=nbytes(out),
                         argument_bytes_by_group=groups)
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               train_cfg: Optional[TrainConfig] = None, *,
               cfg: Optional[ModelConfig] = None, shape: Optional[ShapeSpec] = None,
               mesh_shape: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """One cell's record: rank 0's step on meta tensors in a fake world of
    the mesh's size.  `cfg`, `shape` and `mesh_shape` replace the arch's
    published config, the named shape and the production mesh (the tests'
    miniature cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    production = mesh_shape is None
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    name = "x".join(str(n) for n in mesh_shape)
    skip = runnable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": name, "status": "skip",
                "reason": skip}
    cfg = cell_config(cfg, shape.kind)
    train_cfg = train_cfg or TrainConfig(
        microbatches=int(os.environ.get("REPRO_MICROBATCHES", "4")), zero1=True)
    n_dev = math.prod(mesh_shape)
    with fake_world(n_dev):
        mesh = (make_production_mesh(multi_pod=multi_pod, device_type="cpu") if production
                else make_mesh(mesh_shape, device_type="cpu"))
        model = build_model(cfg)
        rules = rule_overrides(rules_for_shape(cfg, shape, mesh))
        t0 = time.perf_counter()
        if shape.kind == "train":
            rec = _train_cell(model, cfg, shape, mesh, rules, train_cfg)
        else:
            rec = _serve_cell(model, cfg, shape, mesh, rules)
        t_lower = time.perf_counter() - t0
    cost = rec.pop("cost")
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "n_devices": n_dev,
        "status": "ok",
        "lower_s": round(t_lower, 2),
        "cost_method": "meta",
        "kernels": "none",
        "memory": rec.pop("memory"),
        "cost": {"flops_per_device": float(cost.get("flops", 0.0)),
                 "transcendentals": float(cost.get("transcendentals", 0.0)),
                 "bytes_accessed_per_device": float(cost.get("bytes accessed", 0.0))},
        **rec,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": (shape.global_batch * shape.seq_len
                   if shape.kind != "decode" else shape.global_batch),
        "kind": shape.kind,
    }


def cell_record(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """`lower_cell`'s record, or the reference's record of a failure:
    status "error", the exception and the end of its traceback."""
    try:
        return lower_cell(arch, shape_name, multi_pod)
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _summary(res: Dict[str, Any]) -> str:
    if res["status"] == "skip":
        return f"  {res['reason']}"
    if res["status"] == "error":
        return f"  ERROR: {res['error']}"
    mem = res["memory"]
    peak = mem["peak_bytes_per_device"]
    lines = [f"  ok: {res['lower_s']}s, {res['cost']['flops_per_device']:.4e} flops/dev, "
             f"{res['cost']['bytes_accessed_per_device']:.4e} bytes/dev, "
             f"{res['cost']['transcendentals']:.4e} transcendentals/dev, "
             f"argument {mem['argument_bytes']:,} B, peak "
             f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}/dev, "
             f"{res['collectives']['total_bytes'] / 2**20:.1f} MiB collectives/dev "
             f"({sum(res['collectives']['counts'].values())} calls tallied, "
             f"CommDebugMode saw {res['comm_debug_mode_count']})"]
    if "placement_bytes_by_group" in mem:
        diff = {k: mem["argument_bytes_by_group"][k] - v
                for k, v in mem["placement_bytes_by_group"].items()}
        lines.append(f"  argument bytes minus the placements', by group: {diff}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(REGISTRY) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"[cached] {tag}")
            continue
        print(f"[meta run] {tag} ...", flush=True)
        res = cell_record(arch, shape, mp)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
        print(_summary(res), flush=True)
        if res["status"] == "error":
            failures += 1
            if not args.continue_on_error:
                raise SystemExit(f"{tag}: {res['error']}")
    print(f"done; {failures} failures")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
