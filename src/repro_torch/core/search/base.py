"""Shared search machinery: a task couples (op, template, fitness, chip)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import hw
from repro_torch.core.costmodel import Fitness, WallClockFitness
from repro_torch.core.schedules import Config, OpDesc, Template


@dataclasses.dataclass
class SearchResult:
    op: OpDesc
    template: str
    config: Config
    runtime_s: float          # best fitness value found (modeled or measured)
    evals: int                # number of fitness evaluations spent
    wall_s: float             # search wall-clock
    method: str
    history: List[float] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {
            "op": self.op.signature(),
            "label": self.op.label,
            "template": self.template,
            "config": self.config,
            "runtime_s": self.runtime_s,
            "evals": self.evals,
            "wall_s": self.wall_s,
            "method": self.method,
        }


class SearchTask:
    """One (operator, schedule-template) tuning problem."""

    def __init__(self, op: OpDesc, template: Template,
                 fitness: Optional[Fitness] = None,
                 chip: hw.Chip = hw.H100, seed: int = 0):
        self.op = op
        self.template = template
        self.fitness = fitness or WallClockFitness()
        self.chip = chip
        self.rng = np.random.default_rng(seed)
        self.evals = 0
        self._best: Optional[Config] = None
        self._best_time = float("inf")
        self.history: List[float] = []

    def evaluate(self, cfg: Config) -> float:
        """Runtime of one candidate; tracks global best (the paper keeps the
        best configuration ever seen, not just the final population)."""
        if not self.template.validate(self.op, cfg, self.chip):
            return float("inf")
        t = self.fitness(self.op, cfg)
        self.evals += 1
        if t < self._best_time:
            self._best_time = t
            self._best = dict(cfg)
        self.history.append(self._best_time)
        return t

    def random_config(self) -> Config:
        return self.template.random_config(self.op, self.rng, self.chip)

    def result(self, method: str, wall_s: float) -> SearchResult:
        assert self._best is not None, "no valid configuration evaluated"
        return SearchResult(self.op, self.template.name, self._best,
                            self._best_time, self.evals, wall_s, method,
                            list(self.history))


def timed(fn):
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        return out, time.perf_counter() - t0
    return wrapper
