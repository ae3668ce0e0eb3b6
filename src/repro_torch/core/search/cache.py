"""Search-result cache (paper §3.3): "a caching mechanism to reuse search
results ... can further expedite the search process for a family of models
composed from the same backbone".

Keyed on (chip name, template, FITNESS KIND, operator signature) — the
paper's computational-identity criterion (same shapes, filter size, stride,
padding) is exactly what `OpDesc.signature()` encodes.  The fitness kind
('model' analytical vs 'wallclock' measured) is part of the key because the
cached `runtime_s` is only meaningful under the fitness that produced it: a
cache populated under the analytical model must MISS for a wall-clock tuner
(and vice versa) instead of feeding stale configs and bogus runtimes into
plan selection.  Legacy entries persisted before the tag existed are served
as model-fitness.  Persisted as JSON so offline tuning databases ship with
the inference binary.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

from repro_torch.core.schedules import OpDesc

# Fitness kind of entries written before the key carried a tag, and the
# default when a caller doesn't say (the JAX Tuner's default ModelFitness;
# the port's Tuner passes "wallclock").
MODEL_FITNESS = "model"


class SearchCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._store: Dict[str, Dict[str, Any]] = {}
        self.hits = 0
        self.misses = 0
        if path and os.path.exists(path):
            with open(path) as f:
                self._store = json.load(f)

    @staticmethod
    def key(chip_name: str, op: OpDesc, template: str,
            fitness: str = MODEL_FITNESS) -> str:
        return f"{chip_name}|{template}|{fitness}|{op.signature()}"

    @staticmethod
    def _legacy_key(chip_name: str, op: OpDesc, template: str) -> str:
        """Pre-fitness-tag key format (treated as model-fitness entries)."""
        return f"{chip_name}|{template}|{op.signature()}"

    def get(self, chip_name: str, op: OpDesc, template: str,
            fitness: str = MODEL_FITNESS) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._store.get(self.key(chip_name, op, template, fitness))
            if entry is None and fitness == MODEL_FITNESS:
                # back-compat: untagged legacy entries are model-fitness
                entry = self._store.get(self._legacy_key(chip_name, op, template))
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, chip_name: str, op: OpDesc, template: str,
            config: Dict[str, Any], runtime_s: float, method: str,
            fitness: str = MODEL_FITNESS) -> None:
        with self._lock:
            self._store[self.key(chip_name, op, template, fitness)] = {
                "config": config,
                "runtime_s": runtime_s,
                "method": method,
            }

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            return
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(self._store, f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic commit

    def __len__(self) -> int:
        return len(self._store)
