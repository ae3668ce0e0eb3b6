"""Fault-tolerant training loop — the port of `repro.train.trainer`.

  * checkpoint/restart — atomic checkpoints every `ckpt_every` steps
    (async, one-deep pipeline) + auto-resume from the latest valid step,
    including optimizer state and the (stateless) data-pipeline cursor;
  * preemption handling — a `PREEMPT` sentinel file (what a cluster agent
    writes on SIGTERM) triggers save-and-exit at the next step boundary;
    on a mesh the ranks agree on it with one reduction a step, so a rank
    that sees the file first cannot leave the others inside a collective;
  * straggler mitigation — per-step wall time is tracked against a rolling
    median of 32; steps slower than `straggler_factor`x are recorded with
    their step index and returned;
  * elastic restart — `restore_or_init` restores the latest checkpoint onto
    the *current* mesh (`launch.steps.make_state_shardings`, each rank
    keeping its cut), so a job may resume on another topology; the ranks
    agree on the outcome, every one restoring the same step or every one
    starting from the seed.

`Trainer(model, mesh, rules, data, cfg)`, the reference's signature.  With
`mesh=None` the state is {"params": f32 master tensors, "opt": {"m", "v",
"step"}} on the trainer's device (the GPU unless the caller passes
`device="cpu"`) and the step is `launch.steps.make_train_step`.  On a
(data, model) DeviceMesh (`launch.mesh.make_mesh`; every rank of the
world runs the same Trainer, one process each) the state is the rank's cut
(`launch.steps.state_layouts`: its tensor-parallel shards and ZeRO-1
blocks, on its device), drawn as the single-device model's state from the
seed and cut, and the step is `launch.steps.mesh_train_step`; checkpoints
gather the whole state (collective), the rank at coordinate 0 writes them
and every rank waits for the rename.  Both run eagerly and update the
state in place.
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
from repro_torch.checkpoint.manager import leaf_to_numpy, place
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.steps import (TrainConfig, gather_state, make_train_step,
                                      mesh_train_step)
from repro_torch.optim import adamw_init
from repro_torch.platform import resolve_device
from repro_torch.tree import tree_map


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


class Trainer:
    def __init__(self, model, mesh, rules: Optional[ShardingRules], data: SyntheticLMData,
                 cfg: TrainerConfig, device=None):
        self.model = model
        self.mesh = mesh
        self.rules = rules
        self.data = data
        self.cfg = cfg
        self.preempt_file = cfg.preempt_file or os.path.join(cfg.ckpt_dir, "PREEMPT")
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.metrics_log: List[Dict[str, float]] = []
        if mesh is None:
            self.device = resolve_device(device)
            self.rank_mesh = self.layouts = None
            self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            self._step_fn = make_train_step(model, cfg.train, rules)
            return
        self._step_fn = mesh_train_step(model, mesh, rules, cfg.train)
        self.rank_mesh, self.layouts = self._step_fn.rank_mesh, self._step_fn.layouts
        self.rules = self.rank_mesh.rules
        self.device = self.rank_mesh.device
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts,
                                      gather=self._gather_host,
                                      writer=self.rank_mesh.writer,
                                      barrier=self.rank_mesh.barrier)

    def _gather_host(self, state) -> Dict[str, np.ndarray]:
        """The whole state as host copies, flat (collective; only the
        writer keeps them)."""
        keep = self.rank_mesh.writer
        flat: Dict[str, np.ndarray] = {}

        def host(key, whole):
            if keep:
                flat[key] = leaf_to_numpy(key, whole)

        gather_state(self.model, state, self.layouts, self.rank_mesh, on_leaf=host)
        return flat

    def full_state(self, state) -> Dict[str, Any]:
        """The whole state (on a mesh: gathered from every rank's cut,
        collective; the same tensors on every rank)."""
        if self.mesh is None:
            return state
        return gather_state(self.model, state, self.layouts, self.rank_mesh)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """The single-device model's state from `seed`, on a mesh cut to
        this rank (the whole parameters drawn on the rank's device, then
        cut)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen)
        if self.mesh is None:
            return {"params": params, "opt": adamw_init(params)}
        params = tree_map(place, params, self.layouts["params"])
        m = tree_map(lambda c, p: c.zero_slice(p), self.layouts["opt"]["m"], params)
        return {"params": params, "opt": adamw_init(m)}

    def state_template(self) -> Dict[str, Any]:
        """The whole state's tree of meta tensors (shapes and dtypes only)."""
        params = self.model.param_shapes()
        opt = adamw_init(params)
        return {"params": params, "opt": opt}

    def state_shardings(self):
        """Where each leaf of the state goes: this device with no mesh, the
        rank's cut on a mesh (`launch.steps.state_layouts`, which places
        the moments by `make_state_shardings`)."""
        return self.device if self.mesh is None else self.layouts

    def restore_or_init(self, seed: int = 0):
        """(step, state) from the latest checkpoint, or (0, init_state)
        when there is none or it cannot be restored.  On a mesh the ranks
        agree (two reductions): unless every rank restored the same step,
        every rank starts from the seed, so no rank runs steps the others
        do not."""
        try:
            step, state = self.ckpt.restore_latest(self.state_template(),
                                                   self.state_shardings())
        except Exception:
            step, state = None, None
        if self.mesh is not None:
            mine = -1 if state is None else step
            if self.rank_mesh.max(mine) != -self.rank_mesh.max(-mine):
                self.log("ranks restored different checkpoints or failed to "
                         "restore; every rank starts from the seed")
                step, state = None, None
        if state is None:
            return 0, self.init_state(seed)
        return step, state

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(v) for k, v in self.data.batch(step).items()}
        if self.mesh is not None:
            return batch          # the rank's step takes its rows
        return {k: v.to(self.device) for k, v in batch.items()}

    def _preempted(self) -> bool:
        seen = os.path.exists(self.preempt_file)
        return seen if self.mesh is None else self.rank_mesh.any(seen)

    def log(self, msg: str) -> None:
        """Print `msg` (on a mesh: on the writing rank only)."""
        if self.mesh is None or self.rank_mesh.writer:
            print(msg)

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
                self.log(f"step {step:5d} loss {loss:8.4f} "
                          f"({tok / dt:,.0f} tok/s, {dt * 1e3:.0f} ms)")

            if step % self.cfg.ckpt_every == 0 or step == self.cfg.steps:
                self.ckpt.save_async(step, state,
                                     {"data": self.data.state_dict(step)})
            if self._preempted():
                self.log(f"preemption requested; checkpointing at step {step}")
                self.ckpt.wait()
                self.ckpt.save(step, state,
                               {"data": self.data.state_dict(step),
                                "preempted": True})
                preempted = True
                break

        self.ckpt.wait()
        return step, state, {"preempted": preempted,
                             "stragglers": self.stragglers}
