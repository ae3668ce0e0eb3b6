"""Tuner: orchestrates the searches for one operator (the port of
`repro.core.search.tuner`).

Mirrors the paper's end-to-end usage (§3): "given an operator, we used both
genetic search and RL-search to identify optimal code generation
configurations and single out the best for use", with the §3.3 cache
checked first.  The tuner runs both by default (`methods=("genetic",
"rl")`; "random" is the baseline), keeps the fastest configuration any of
them found, and caches it under the method that found it.  With no
`fitness` the tuner measures device time on the GPU (`WallClockFitness`),
and raises where there is none; `Tuner(fitness=ModelFitness())` tunes on
the analytic model of the H100 on any host.  Without an `rl` search the
PPO agent runs on the fitness's device (the CPU for `ModelFitness`, the
GPU for a fitness that names none).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch import hw
from repro_torch.core.costmodel import Fitness, WallClockFitness
from repro_torch.core.schedules import OpDesc, Template, templates_for
from repro_torch.core.search.base import SearchResult, SearchTask
from repro_torch.core.search.cache import MODEL_FITNESS, SearchCache
from repro_torch.core.search.genetic import GeneticSearch
from repro_torch.core.search.random_search import random_search
from repro_torch.core.search.rl_search import RLSearch


class Tuner:
    def __init__(
        self,
        chip: hw.Chip = hw.H100,
        fitness: Optional[Fitness] = None,
        cache: Optional[SearchCache] = None,
        methods: Sequence[str] = ("genetic", "rl"),
        genetic: Optional[GeneticSearch] = None,
        rl: Optional[RLSearch] = None,
        random_budget: int = 64,
        seed: int = 0,
    ):
        self.chip = chip
        self.fitness = fitness if fitness is not None else WallClockFitness()
        self.cache = cache if cache is not None else SearchCache()
        self.methods = tuple(methods)
        self.genetic = genetic or GeneticSearch()
        self.rl = rl or RLSearch(seed=seed, device=getattr(self.fitness, "device", None))
        self.random_budget = random_budget
        self.seed = seed
        self.log: List[SearchResult] = []

    @property
    def fitness_kind(self) -> str:
        """Cache-key tag of the active fitness ('model' when untagged)."""
        return getattr(self.fitness, "kind", MODEL_FITNESS)

    def _make_task(self, op: OpDesc, template: Template) -> SearchTask:
        return SearchTask(op, template, self.fitness, self.chip, seed=self.seed)

    def tune(self, op: OpDesc, template: Optional[Template] = None,
             use_cache: bool = True) -> SearchResult:
        """Best configuration for `op` under `template` (default: the
        kind-appropriate template)."""
        template = template or templates_for(op)[0]

        if use_cache:
            hit = self.cache.get(self.chip.name, op, template.name,
                                 fitness=self.fitness_kind)
            if hit is not None:
                return SearchResult(op, template.name, hit["config"],
                                    hit["runtime_s"], 0, 0.0,
                                    hit["method"] + "+cache")

        results: List[SearchResult] = []
        for method in self.methods:
            task = self._make_task(op, template)
            if method == "genetic":
                results.append(self.genetic.run(task))
            elif method == "rl":
                results.append(self.rl.run(task))
            elif method == "random":
                results.append(random_search(task, self.random_budget))
            else:
                raise ValueError(method)

        best = min(results, key=lambda r: r.runtime_s)
        self.log.extend(results)
        self.cache.put(self.chip.name, op, template.name,
                       best.config, best.runtime_s, best.method,
                       fitness=self.fitness_kind)
        return best
