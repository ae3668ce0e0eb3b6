"""Training entry point with the full fault-tolerance loop — the port of
`examples/train_lm.py`.

Trains a small-LM config (scaled-down qwen3 family, ~10M params by default)
for a few hundred steps on the deterministic synthetic pipeline, with
periodic atomic checkpoints.  Re-running the same command resumes from the
latest checkpoint automatically; touch `<ckpt_dir>/PREEMPT` while it runs to
watch the preemption path save-and-exit.  Runs on the GPU unless
`--device cpu` is given.

Run:  PYTHONPATH=src python -m repro_torch.train [--steps 200] [--d-model 256]
"""

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.steps import TrainConfig
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
    args = ap.parse_args()

    cfg = get_config("qwen3-1.7b").reduced(
        n_layers=args.layers, d_model=args.d_model, d_ff=4 * args.d_model,
        n_heads=4, n_kv_heads=2, head_dim=args.d_model // 4, vocab=4096)
    model = build_model(cfg)
    n_params = cfg.param_count()
    print(f"model ~{n_params / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} vocab={cfg.vocab})")

    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))
    trainer = Trainer(
        model, data,
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
        print(f"resuming from checkpoint at step {start}")
    step, state, info = trainer.run(start_step=start, state=state)
    print(f"finished at step {step}; preempted={info['preempted']}; "
          f"stragglers at {info['stragglers']}")


if __name__ == "__main__":
    main()
