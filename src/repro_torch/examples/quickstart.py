"""WPK quickstart: the paper's Figure-1a pipeline on a small conv net —
the port of `examples/quickstart.py`.

    graph import -> graph optimization (§2.1) -> automated search (§2.3)
    -> system-level backend selection (§2.5) -> runtime engine

The same graph from the same numpy seeds, `optimize_graph`, a genetic
`Tuner`, `select` (at its bf16 default, as the JAX example; the f32 graph
runs the plan's tiles where f32 launches them, else the kernel's default
geometry) and the `Engine` with `default_registry()` (the hand-written
conv, GEMM and elementwise kernels), then `verify_against_reference`.  On the GPU the tuner's fitness is device time
on the card (`WallClockFitness`); with `--device cpu` the plain path runs
and the plan is tuned on the analytic model of the H100 (`ModelFitness`),
so no time is measured on the host.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import (Engine, Graph, ModelFitness, Tuner, WallClockFitness,
                              default_registry, optimize_graph, select)
from repro_torch.platform import resolve_device


def build_graph() -> Graph:
    rng = np.random.default_rng(0)
    g = Graph("quickstart")
    x = g.add_input("x", (4, 3, 32, 32))
    w1 = g.add_constant("w1", rng.standard_normal((16, 3, 3, 3)).astype(np.float32) * 0.2)
    c1 = g.add_node("conv2d", [x, w1], (4, 16, 32, 32), {"stride": 1, "padding": "SAME"})
    sc = g.add_constant("sc", (rng.random(16) + 0.5).astype(np.float32))
    sh = g.add_constant("sh", rng.standard_normal(16).astype(np.float32) * 0.1)
    b1 = g.add_node("batch_norm", [c1, sc, sh], (4, 16, 32, 32))
    r1 = g.add_node("relu", [b1], (4, 16, 32, 32))
    d1 = g.add_node("dropout", [r1], (4, 16, 32, 32))   # removed at inference
    w2 = g.add_constant("w2", rng.standard_normal((32, 16, 3, 3)).astype(np.float32) * 0.2)
    c2 = g.add_node("conv2d", [d1, w2], (4, 32, 16, 16), {"stride": 2, "padding": "SAME"})
    g2 = g.add_node("gelu", [c2], (4, 32, 16, 16))
    gp = g.add_node("global_avg_pool", [g2], (4, 32))
    wf = g.add_constant("wf", rng.standard_normal((32, 10)).astype(np.float32) * 0.3)
    out = g.add_node("matmul", [gp, wf], (4, 10))
    g.set_outputs([out])
    return g


def fitness_label(fitness, device: torch.device) -> str:
    """What the plan's times are: device time on the named card, or the
    analytic H100 model."""
    if getattr(fitness, "kind", "") == "wallclock" and device.type == "cuda":
        return f"device time on {torch.cuda.get_device_name(device)}"
    if getattr(fitness, "kind", "") == "wallclock":
        return f"host time on the {device.type}"
    return "modeled for the H100 (analytic fitness)"


def main(argv=None) -> Dict[str, Any]:
    """Run the pipeline; -> {"graph", "optimized", "plan", "engine",
    "input", "max_err"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fitness = WallClockFitness(device=device) if device.type == "cuda" else ModelFitness()

    g = build_graph()
    print(f"imported   : {g}")

    gopt = optimize_graph(g)                       # §2.1
    print(f"optimized  : {gopt}")

    tuner = Tuner(methods=("genetic",), fitness=fitness)   # §2.3 (add 'rl' for §2.4)
    plan = select(gopt, tuner=tuner)                      # §2.2 + §2.5
    print(f"plan       : {plan.backend_histogram()}, "
          f"{plan.total_modeled_time_s() * 1e6:.1f} us/batch, "
          f"{fitness_label(fitness, device)}")
    for name, choice in plan.choices.items():
        print(f"  {name:24s} -> {choice.backend:16s} "
              f"{choice.modeled_time_s * 1e6:7.2f} us  "
              f"(candidates: {({k: round(v * 1e6, 2) for k, v in choice.candidates.items()})})")

    engine = Engine(gopt, plan, default_registry(), device=device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 3, 32, 32))
                         .astype(np.float32)).to(device)
    err = engine.verify_against_reference(x)
    print(f"engine     : optimized plan == reference graph (max err {err:.2e})")
    return {"graph": g, "optimized": gopt, "plan": plan, "engine": engine, "input": x,
            "max_err": err}


if __name__ == "__main__":
    main()
