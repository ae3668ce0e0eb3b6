"""End-to-end serving example (the paper is an inference system) — the port
of `examples/serve_inference.py`.

Boots a small qwen3-family LM, briefly trains it on the synthetic pipeline
so decode produces the learnable next-token structure, then serves a queue
of requests through the continuous-batching runtime: WPK inference plan ->
plan-aware router -> slot scheduler -> paged KV-cache -> ONE unified step
program (token-budget chunked-prefill lane + the decode batch, captured in
a CUDA graph on the GPU) that requests join and leave in flight.

On the GPU the plan is tuned on device time (`WallClockFitness`); with
`--device cpu` the plain path runs and the plan is tuned on the analytic
H100 model (`ModelFitness`).  `--tp N` serves on `launch.mesh.tp_mesh(N)`,
one process a rank, started by `torchrun` (which sets RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT): gloo on the CPU, nccl on the GPUs; rank 0
trains and every rank serves its shards.  The JAX example's `--devices`
(the JAX CPU backend's count of virtual host devices) has no torch
meaning and is left out: a rank is a process.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_inference [--requests 12]
      PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.examples.serve_inference \
          --tp 2 --device cpu
"""

import argparse
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ModelFitness, Tuner, WallClockFitness
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.launch.steps import TrainConfig, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.platform import resolve_device
from repro_torch.serve import ContinuousEngine, PlanRouter, RuntimeConfig, build_serve_plan
from repro_torch.tree import tree_leaves


def _mesh(tp: int, device: torch.device):
    """The (1, tp) serving mesh of a torchrun world (None at tp 1)."""
    if tp <= 1:
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import tp_mesh

    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl")
    return tp_mesh(tp, device_type=device.type)


def main(argv=None) -> Dict[str, Any]:
    """Train, tune, serve; -> {"correct", "served", "summary", "loss"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--no-plan", action="store_true",
                    help="skip WPK plan tuning (torch lanes throughout)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel mesh width for SERVING (one process a rank, "
                         "started by torchrun); token streams are the same across "
                         "widths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = _mesh(args.tp, device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = mesh is None or int(os.environ.get("RANK", "0")) == 0
    say = print if rank0 else (lambda *a, **k: None)

    cfg = get_config("qwen3-1.7b").reduced(n_layers=2, d_model=128, d_ff=256, vocab=211)
    model = build_model(cfg)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))

    # warm-up training on one device (rank 0 of a mesh; the others take
    # its parameters)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    loss = float("nan")
    if rank0:
        opt = adamw_init(params)
        step = make_train_step(model, TrainConfig(opt=AdamWConfig(
            lr=3e-3, warmup_steps=5, total_steps=args.train_steps)), DEFAULT_RULES)
        for i in range(args.train_steps):
            b = {k: torch.as_tensor(v).to(device) for k, v in data.batch(i).items()}
            params, opt, m = step(params, opt, b)
        loss = float(m["loss"]) if args.train_steps else loss
        say(f"warm-up train: final loss {loss:.3f} ({args.train_steps} steps)")
    if mesh is not None:
        import torch.distributed as dist

        for leaf in tree_leaves(params):
            dist.broadcast(leaf, 0)

    rcfg = RuntimeConfig(max_slots=4, block_size=16, max_blocks_per_seq=4,
                         max_new_tokens=args.new_tokens)
    router = PlanRouter(None)
    if not args.no_plan:
        fitness = (WallClockFitness(device=device) if device.type == "cuda"
                   else ModelFitness())
        t0 = time.perf_counter()
        plan = build_serve_plan(
            cfg, prefill_len=32, slots=rcfg.max_slots, max_seq=rcfg.max_seq,
            chunk_tokens=rcfg.chunk_width,
            tuner=Tuner(methods=("random",), random_budget=16, fitness=fitness),
            model_parallel=args.tp)
        router = PlanRouter(plan)
        say(f"serve plan tuned in {time.perf_counter() - t0:.1f}s: {router.describe()}")

    engine = ContinuousEngine(model, params, rcfg, router=router, device=device, mesh=mesh,
                              rules=None if mesh is None else DEFAULT_RULES)
    if mesh is not None:
        say(f"serving mesh {engine.mesh_tag} | decode layouts "
            f"{router.layout_table('decode')}")
    rng = np.random.default_rng(0)
    prompts = {}
    for _ in range(args.requests):
        start = int(rng.integers(0, cfg.vocab))
        prompt = (start + 17 * np.arange(16)) % cfg.vocab  # pipeline's rule
        prompts[engine.submit(prompt)] = prompt

    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0

    correct = 0
    for req in done:
        prompt = prompts[req.rid]
        want = (prompt[-1] + 17 * (1 + np.arange(args.new_tokens))) % cfg.vocab
        correct += int(np.array_equal(req.output, want))
    s = engine.metrics.summary()
    say(f"served {len(done)} requests in {wall:.2f}s | "
        f"{s['tokens_per_s']:,.0f} tok/s | "
        f"latency p50 {s['latency_p50_s']:.2f}s p95 {s['latency_p95_s']:.2f}s | "
        f"ttft p50 {s['ttft_p50_s']:.2f}s | "
        f"slot occ {s['slot_occupancy_mean']:.0%} | "
        f"cache occ mean {s['cache_occupancy_mean']:.0%} "
        f"max {s['cache_occupancy_max']:.0%}")
    say(f"{correct}/{len(done)} requests continued the learned sequence exactly")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return {"correct": correct, "served": len(done), "summary": s, "loss": loss,
            "wall_s": wall}


if __name__ == "__main__":
    main()
