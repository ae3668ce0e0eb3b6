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
    default), its tuned config and that time."""
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1 (the layout race) is not ported yet: "
            "ROADMAP.md queue 1, item 8b (TP serving)")
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
        plan.choices[node.name] = OpChoice(best_backend, best_cfg, best_t,
                                           candidates)
    return plan
