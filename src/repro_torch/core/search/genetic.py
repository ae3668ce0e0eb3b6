"""Genetic search (paper §2.3), implemented exactly as described.

Chromosome = the parameter vector s = {c_0 … c_{n-1}} (indices into each
tunable's finite choice list).  The four steps:

  Step1  initialise a random population; every random configuration is
         *verified first* against hardware constraints (VMEM-fit here; the
         paper's example is the <=1024-threads-per-block CUDA rule);
  Step2  fitness f(a_i) = a function of measured runtime — we use
         f = 1/runtime so faster individuals are "healthier";
  Step3  selection probability p(a_i) = f(a_i) / Σ f (Eq. 1); sort
         descending; top-k ELITES always survive; remaining |a'|-k children
         are bred by roulette-wheel parent selection using cumulative
         probabilities P(a_i) (Eq. 2) with inverse-transform sampling
         (P(a_{i-1}) < v <= P(a_i) selects individual i), then crossover +
         mutation;
  Step4  stop when the runtimes of all individuals in the generation are
         close enough (relative spread < `converge_rtol`), or at
         `max_generations`.  Population size may vary across generations
         (the paper notes theirs does) — we support a schedule.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.search.base import SearchResult, SearchTask


class GeneticSearch:
    def __init__(
        self,
        population: int = 24,
        elites: int = 4,
        mutation_rate: float = 0.15,
        crossover_rate: float = 0.9,
        max_generations: int = 12,
        converge_rtol: float = 0.02,
        population_schedule: Optional[Sequence[int]] = None,
    ):
        self.population = population
        self.elites = elites
        self.mutation_rate = mutation_rate
        self.crossover_rate = crossover_rate
        self.max_generations = max_generations
        self.converge_rtol = converge_rtol
        self.population_schedule = population_schedule

    # ------------------------------------------------------------------
    def _roulette_pick(self, rng, cum_p: np.ndarray) -> int:
        """Inverse-transform sampling over cumulative selection probs."""
        v = rng.uniform(0.0, cum_p[-1])
        return int(np.searchsorted(cum_p, v, side="left"))

    def _crossover(self, rng, a: List[int], b: List[int]) -> List[int]:
        """Uniform gene-wise crossover."""
        return [ai if rng.random() < 0.5 else bi for ai, bi in zip(a, b)]

    def _mutate(self, task: SearchTask, rng, vec: List[int]) -> List[int]:
        axes = task.template.axes(task.op)
        out = list(vec)
        for i, (_, choices) in enumerate(axes):
            if rng.random() < self.mutation_rate:
                out[i] = int(rng.integers(len(choices)))
        return out

    def _valid_vec(self, task: SearchTask, vec: List[int]) -> bool:
        cfg = task.template.decode(task.op, vec)
        return task.template.validate(task.op, cfg, task.chip)

    # ------------------------------------------------------------------
    def run(self, task: SearchTask) -> SearchResult:
        t0 = time.perf_counter()
        rng = task.rng
        tmpl, op = task.template, task.op

        # Step1: verified random init.
        pop = [tmpl.encode(op, task.random_config()) for _ in range(self.population)]

        for gen in range(self.max_generations):
            # Step2: fitness = 1/runtime.
            runtimes = np.array([task.evaluate(tmpl.decode(op, v)) for v in pop])
            finite = np.isfinite(runtimes)
            if not finite.any():
                pop = [tmpl.encode(op, task.random_config()) for _ in range(len(pop))]
                continue
            fit = np.where(finite, 1.0 / np.maximum(runtimes, 1e-12), 0.0)

            # Step4: convergence — all runtimes in this generation are close.
            rt = runtimes[finite]
            if len(rt) == len(pop) and (rt.max() - rt.min()) <= self.converge_rtol * rt.min():
                break

            # Step3: Eq.1 selection probabilities, sorted descending.
            p = fit / fit.sum()
            order = np.argsort(-p)
            pop_sorted = [pop[i] for i in order]
            p_sorted = p[order]

            next_size = (
                self.population_schedule[min(gen, len(self.population_schedule) - 1)]
                if self.population_schedule
                else len(pop)
            )
            k = min(self.elites, next_size)
            new_pop = [list(v) for v in pop_sorted[:k]]  # elites always pass

            # Eq.2 cumulative probabilities over the m crossover participants.
            m = len(pop_sorted)
            cum_p = np.cumsum(p_sorted[:m])
            tries = 0
            while len(new_pop) < next_size and tries < 50 * next_size:
                tries += 1
                i = self._roulette_pick(rng, cum_p)
                j = self._roulette_pick(rng, cum_p)
                child = (
                    self._crossover(rng, pop_sorted[i], pop_sorted[j])
                    if rng.random() < self.crossover_rate
                    else list(pop_sorted[i])
                )
                child = self._mutate(task, rng, child)
                if self._valid_vec(task, child):
                    new_pop.append(child)
            while len(new_pop) < next_size:  # top-up with fresh random valids
                new_pop.append(tmpl.encode(op, task.random_config()))
            pop = new_pop

        return task.result("genetic", time.perf_counter() - t0)


def genetic_search(task: SearchTask, **kw) -> SearchResult:
    return GeneticSearch(**kw).run(task)
