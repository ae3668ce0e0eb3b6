"""Fault-tolerant training loop — the port of `repro.train.trainer`.

  * checkpoint/restart — atomic checkpoints every `ckpt_every` steps
    (async, one-deep pipeline) + auto-resume from the latest valid step,
    including optimizer state and the (stateless) data-pipeline cursor;
  * preemption handling — a `PREEMPT` sentinel file (what a cluster agent
    writes on SIGTERM) triggers save-and-exit at the next step boundary;
  * straggler mitigation — per-step wall time is tracked against a rolling
    median of 32; steps slower than `straggler_factor`x are recorded with
    their step index and returned.

The state is {"params": f32 master tensors, "opt": {"m", "v", "step"}} on
the trainer's device (the GPU unless the caller passes `device="cpu"`);
the train step (`launch.steps.make_train_step`) runs eagerly and updates
it in place.  Restoring onto another mesh waits for TP training (ROADMAP.md queue
1, item 8c); the reference's `mesh` and `rules` arguments have no
counterpart yet.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData
from repro_torch.launch.steps import TrainConfig, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.platform import resolve_device


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    # the reference's /tmp/repro_ckpt, under this process's temp directory
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    preempt_file: Optional[str] = None  # default: <ckpt_dir>/PREEMPT
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class ShapeGenerator(torch.Generator):
    """A generator whose `device` is "meta": `model.init(ShapeGenerator())`
    gives the parameter tree's shapes and dtypes without drawing or
    allocating anything (the reference's `jax.eval_shape`)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class Trainer:
    def __init__(self, model, data: SyntheticLMData, cfg: TrainerConfig,
                 device=None):
        self.model = model
        self.data = data
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self.preempt_file = cfg.preempt_file or os.path.join(cfg.ckpt_dir, "PREEMPT")
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.metrics_log: List[Dict[str, float]] = []
        self._step_fn = make_train_step(model, cfg.train)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen)
        return {"params": params, "opt": adamw_init(params)}

    def state_template(self) -> Dict[str, Any]:
        """The state's tree of meta tensors (shapes and dtypes only)."""
        params = self.model.init(ShapeGenerator())
        opt = adamw_init(params)
        return {"params": params, "opt": opt}

    def restore_or_init(self, seed: int = 0):
        """(step, state) from the latest checkpoint, or (0, init_state)
        when there is none or it cannot be restored."""
        try:
            step, state = self.ckpt.restore_latest(self.state_template(), self.device)
        except Exception:
            step, state = None, None
        if state is None:
            return 0, self.init_state(seed)
        return step, state

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    # ------------------------------------------------------------------
    def run(self, start_step: Optional[int] = None,
            state: Optional[Dict[str, Any]] = None,
            on_step: Optional[Callable[[int, Dict[str, float]], None]] = None):
        """Train from `start_step` / `state` (default: `restore_or_init`)
        to `cfg.steps`; -> (step, state, {"preempted", "stragglers"})."""
        if state is None:
            start_step, state = self.restore_or_init()
        step = start_step or 0
        preempted = False

        while step < self.cfg.steps:
            batch = self._batch(step)
            t0 = time.perf_counter()
            state["params"], state["opt"], metrics = self._step_fn(
                state["params"], state["opt"], batch)
            loss = float(metrics["loss"])  # blocks; realistic step time
            dt = time.perf_counter() - t0
            # the first two steps after a start are warm-up: left out of
            # the straggler baseline (fleet warm-up convention)
            if step - (start_step or 0) >= 2:
                if len(self.step_times) >= 3:
                    med = float(np.median(self.step_times[-32:]))
                    if dt > self.cfg.straggler_factor * med:
                        self.stragglers.append(step)
                self.step_times.append(dt)

            step += 1
            row = {"step": step, "loss": loss, "step_s": dt,
                   "grad_norm": float(metrics.get("grad_norm", 0.0))}
            self.metrics_log.append(row)
            if on_step:
                on_step(step, row)
            if step % self.cfg.log_every == 0:
                tok = int(np.prod(batch["tokens"].shape))
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"({tok / dt:,.0f} tok/s, {dt * 1e3:.0f} ms)")

            if step % self.cfg.ckpt_every == 0 or step == self.cfg.steps:
                self.ckpt.save_async(step, state,
                                     {"data": self.data.state_dict(step)})
            if os.path.exists(self.preempt_file):
                print(f"preemption requested; checkpointing at step {step}")
                self.ckpt.wait()
                self.ckpt.save(step, state,
                               {"data": self.data.state_dict(step),
                                "preempted": True})
                preempted = True
                break

        self.ckpt.wait()
        return step, state, {"preempted": preempted,
                             "stragglers": self.stragglers}
