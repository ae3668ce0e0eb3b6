"""InferencePlan: the output of WPK's optimization — per-operator backend
choice + tuned configuration + modeled runtime (paper: "to create an
optimized inference plan, WPK systematically explores high-speed operator
implementations from third-party libraries besides our automatically
generated codes and singles out the best implementation per operator")."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass
class OpChoice:
    backend: str                       # 'xla' | 'pallas_matmul' | ...
    config: Dict[str, Any]             # tuned schedule config ({} for xla)
    modeled_time_s: float
    candidates: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the layout dimension of the race (tensor-parallel serving): which
    # sharding this op's weights/activations run under, and the modeled
    # time of every layout raced.  Plans tuned before the layout axis
    # existed load as 'replicated' with no candidates — the single-device
    # semantics they were tuned under.
    layout: str = "replicated"         # 'replicated' | 'model_parallel'
    layout_candidates: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class InferencePlan:
    graph_name: str
    chip: str
    choices: Dict[str, OpChoice] = dataclasses.field(default_factory=dict)

    def total_modeled_time_s(self) -> float:
        return sum(c.modeled_time_s for c in self.choices.values())

    def backend_histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {}
        for c in self.choices.values():
            h[c.backend] = h.get(c.backend, 0) + 1
        return h

    def to_json(self) -> Dict[str, Any]:
        return {
            "graph": self.graph_name,
            "chip": self.chip,
            "total_modeled_time_s": self.total_modeled_time_s(),
            "choices": {k: v.to_json() for k, v in self.choices.items()},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @staticmethod
    def load(path: str) -> "InferencePlan":
        with open(path) as f:
            d = json.load(f)
        plan = InferencePlan(d["graph"], d["chip"])
        for k, v in d["choices"].items():
            plan.choices[k] = OpChoice(v["backend"], v["config"],
                                       v["modeled_time_s"], v.get("candidates", {}),
                                       v.get("layout", "replicated"),
                                       v.get("layout_candidates", {}))
        return plan

    def choice(self, node_name: str) -> Optional[OpChoice]:
        return self.choices.get(node_name)
