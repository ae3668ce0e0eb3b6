"""Random search — the weakest baseline in the paper's Figure 3a."""

from __future__ import annotations

import time

from repro_torch.core.search.base import SearchResult, SearchTask


def random_search(task: SearchTask, budget: int = 64) -> SearchResult:
    t0 = time.perf_counter()
    for _ in range(budget):
        task.evaluate(task.random_config())
    return task.result("random", time.perf_counter() - t0)
