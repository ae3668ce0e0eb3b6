"""System-level exploration (paper §2.5), the port of
`repro.core.selection`.

For every compute operator in an optimized graph, race the available
implementations — the vendor lane (the port's `ref_ops`: cuDNN / cuBLAS)
and every applicable tuned kernel template (the hand-written Hopper
kernels) — and single out the fastest for the inference plan.  Both lanes
are priced by the tuner's one fitness: device time on the GPU, on the same
inputs (`WallClockFitness`, the default), or the analytic model of the
H100 (`ModelFitness`), which builds a plan on any host.

The vendor lane keeps the JAX plans' backend name, "xla", so that plans
move between the two packages; on the port it runs PyTorch.

With `model_parallel` > 1 the race gains the reference's LAYOUT axis:
each node whose role has a model-parallel layout
(`costmodel.MATMUL_LAYOUT_ROLES`) and whose shard dim divides the width is
raced again at its per-device shard shape on the same fitness, plus the
price of the collective that layout implies, and the faster layout is the
choice's `layout` (`PlanRouter.serve_rules` folds the verdicts into the
sharding rules of a tensor-parallel engine).

`select` honours `third_party=False` to reproduce the paper's §3.4 ablation
("excluding these TensorRT operators incorporated only results in very
marginal performance loss of 2%"): the vendor lane is then raced only for
operators no kernel template covers.  Every tunable op kind (conv2d,
matmul, attention) has a template now, so a WPK-only plan runs every
tunable node on a hand-written kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch import hw
from repro_torch.core import costmodel
from repro_torch.core.graph import Graph, Node
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.core.schedules import OpDesc, templates_for
from repro_torch.core.search.tuner import Tuner

TUNABLE_OPS = ("conv2d", "fused_conv2d", "matmul", "fused_matmul", "attention")
VENDOR = "xla"


def op_desc_of(graph: Graph, node: Node, dtype: str = "bfloat16") -> Optional[OpDesc]:
    """Lift a graph node into the hardware-relevant OpDesc."""
    if node.op in ("conv2d", "fused_conv2d"):
        x = graph.tensors[node.inputs[0]].shape
        w = graph.tensors[node.inputs[1]].shape
        layout = node.attrs.get("layout", "NCHW")
        if layout == "NCHW":
            n, cin, h, wd = x
            cout, _, kh, kw = w
        else:
            n, h, wd, cin = x
            kh, kw, _, cout = w
        return OpDesc.conv2d(n, h, wd, cin, cout, kh, kw,
                             stride=node.attrs.get("stride", 1),
                             padding=node.attrs.get("padding", "SAME"),
                             dtype=dtype, activation=node.attrs.get("activation"),
                             label=node.name)
    if node.op in ("matmul", "fused_matmul"):
        x = graph.tensors[node.inputs[0]].shape
        w = graph.tensors[node.inputs[1]].shape
        m = 1
        for s in x[:-1]:
            m *= s
        return OpDesc.matmul(m, w[-1], x[-1], dtype=dtype,
                             activation=node.attrs.get("activation"), label=node.name)
    if node.op == "attention":
        q = graph.tensors[node.inputs[0]].shape
        k = graph.tensors[node.inputs[1]].shape
        b, qlen, heads, hd = q
        return OpDesc.attention(b, qlen, k[1], heads, hd, dtype=dtype, label=node.name)
    return None


def _race_backends(op: OpDesc, tuner: Tuner, third_party: bool):
    """Race the vendor lane against every applicable tuned kernel template
    for ONE op shape, both timed by the tuner's fitness; -> (backend, cfg,
    time, candidates)."""
    candidates: Dict[str, float] = {}
    best_backend, best_cfg, best_t = None, {}, float("inf")
    templates = templates_for(op)
    if third_party or not templates:
        t_vendor = tuner.fitness.vendor_time(op)
        candidates[VENDOR] = t_vendor
        best_backend, best_cfg, best_t = VENDOR, {}, t_vendor
    for template in templates:
        res = tuner.tune(op, template)
        candidates[template.name] = res.runtime_s
        if res.runtime_s < best_t:
            best_backend, best_cfg, best_t = (template.name, res.config,
                                              res.runtime_s)
    return best_backend, best_cfg, best_t, candidates


def select(
    graph: Graph,
    tuner: Optional[Tuner] = None,
    chip: hw.Chip = hw.H100,
    dtype: str = "bfloat16",
    third_party: bool = True,
    model_parallel: int = 1,
) -> InferencePlan:
    """Build the inference plan for `graph`: per tunable node, the backend
    with the least time under the tuner's fitness (measured on the GPU by
    default), its tuned config and that time.

    `model_parallel` > 1 opens the LAYOUT axis of the race: a node whose
    role (the last part of its stage-qualified name) is in
    `costmodel.MATMUL_LAYOUT_ROLES` is raced again at its per-device shard
    shape on the same fitness, plus the price of the collective that layout
    implies (`costmodel.layout_collective_time`); both times land in the
    choice's `layout_candidates` and the faster layout in `layout`, with
    its backend.  A shard dim that does not divide `model_parallel` keeps
    the replicated layout and races nothing (no illegal candidate)."""
    tuner = tuner or Tuner(chip=chip)
    plan = InferencePlan(graph.name, chip.name)

    for node in graph.toposort():
        if node.op not in TUNABLE_OPS:
            continue
        op = op_desc_of(graph, node, dtype)
        if op is None:
            continue
        best_backend, best_cfg, best_t, candidates = _race_backends(
            op, tuner, third_party)
        choice = OpChoice(best_backend, best_cfg, best_t, candidates)

        role = node.name.rsplit(".", 1)[-1]
        sharded = costmodel.sharded_op_desc(op, role, model_parallel)
        if sharded is not None:
            mp_backend, mp_cfg, mp_t, mp_cands = _race_backends(
                sharded, tuner, third_party)
            mp_t += costmodel.layout_collective_time(op, role, model_parallel, chip)
            choice.layout_candidates = {"replicated": best_t,
                                        "model_parallel": mp_t}
            if mp_backend is not None and mp_t < best_t:
                choice = OpChoice(mp_backend, mp_cfg, mp_t, mp_cands,
                                  layout="model_parallel",
                                  layout_candidates=choice.layout_candidates)
        plan.choices[node.name] = choice
    return plan
