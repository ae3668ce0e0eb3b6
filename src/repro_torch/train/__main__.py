"""Training entry point with the full fault-tolerance loop — the port of
`examples/train_lm.py`.

Trains a small-LM config (scaled-down qwen3 family, ~10M params by default)
for a few hundred steps on the deterministic synthetic pipeline, with
periodic atomic checkpoints.  Re-running the same command resumes from the
latest checkpoint automatically; touch `<ckpt_dir>/PREEMPT` while it runs to
watch the preemption path save-and-exit.  Runs on the GPU unless
`--device cpu` is given.

Run:  PYTHONPATH=src python -m repro_torch.train [--steps 200] [--d-model 256]

On a (data, model) mesh, one process a rank, started by `torchrun` (which
sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT): gloo on the CPU,
nccl on the GPUs, e.g. data 2 x model 2 on the CPU:

      PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.train \
          --mesh 2,2 --device cpu --steps 20
"""

import argparse
import os
import tempfile

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import TrainConfig, rules_for_shape
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) mesh of DATA x MODEL ranks, one "
                         "process each (start them with torchrun)")
    args = ap.parse_args()
    mesh = None
    if args.mesh:
        import torch
        import torch.distributed as dist

        shape = tuple(int(n) for n in args.mesh.split(","))
        device_type = "cpu" if args.device == "cpu" else "cuda"
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if device_type == "cpu" else "nccl")
        mesh = make_mesh(shape, device_type=device_type)

    cfg = get_config("qwen3-1.7b").reduced(
        n_layers=args.layers, d_model=args.d_model, d_ff=4 * args.d_model,
        n_heads=4, n_kv_heads=2, head_dim=args.d_model // 4, vocab=4096)
    model = build_model(cfg)
    n_params = cfg.param_count()
    if not args.mesh or os.environ.get("RANK", "0") == "0":
        print(f"model ~{n_params / 1e6:.1f}M params "
              f"({cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} vocab={cfg.vocab})")

    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))
    # the reference's divisibility-guarded rules for this shape and mesh
    rules = DEFAULT_RULES if mesh is None else rules_for_shape(
        cfg, ShapeSpec("train", "train", args.seq, args.batch), mesh)
    trainer = Trainer(
        model, mesh, rules, data,
        TrainerConfig(
            steps=args.steps, ckpt_every=25, ckpt_dir=args.ckpt_dir,
            log_every=10,
            train=TrainConfig(
                microbatches=2,
                opt=AdamWConfig(lr=1e-3, warmup_steps=20,
                                total_steps=args.steps))),
        device=args.device)

    start, state = trainer.restore_or_init()
    if start:
        trainer.log(f"resuming from checkpoint at step {start}")
    step, state, info = trainer.run(start_step=start, state=state)
    trainer.log(f"finished at step {step}; preempted={info['preempted']}; "
                 f"stragglers at {info['stragglers']}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
