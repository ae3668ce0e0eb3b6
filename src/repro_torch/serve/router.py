"""Plan-aware backend routing for the serving runtime — the query half of
`repro.serve.router.PlanRouter`.

A stage-qualified `InferencePlan` names a choice per serve-graph node
(`decode.attention`, `prefill_chunk.mlp_up`, ...).  `PlanRouter` answers the
runtime's dispatch questions from it: which attention backend each lane
runs, how many segments one chunk may pack, and each stage's matmul lane
table.  Vendor choices (`xla` in plans tuned by the JAX package, `torch`
here) map to the port's torch lanes; any other choice maps to the
hand-written CUDA lane (`cuda_attention` / `cuda_matmul`), so a plan tuned
by the JAX package selects the same lanes here.  With no plan every query
answers the torch lane.  Building and tuning plans is a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core.plan import InferencePlan, OpChoice

# the decoder family's serve stages (the ssm family's are a later slice)
STAGES = ("prefill", "decode", "prefill_chunk")

# the prefill lane's default width, shared by RuntimeConfig and the plans
DEFAULT_CHUNK_TOKENS = 32

VENDOR_BACKENDS = ("xla", "torch")


class PlanRouter:
    """Answers serve-time dispatch questions from a stage-qualified plan."""

    def __init__(self, plan: Optional[InferencePlan] = None):
        self.plan = plan

    def _lookup(self, stage: str, op: str) -> Optional[OpChoice]:
        if self.plan is None:
            return None
        choice = self.plan.choice(f"{stage}.{op}")
        if choice is not None:
            return choice
        for name, c in self.plan.choices.items():
            if name.startswith(f"{stage}.") and name.split(".", 1)[1].startswith(op):
                return c
        if stage == "prefill_chunk":
            # plans tuned before the chunk stage existed: the whole-prompt
            # prefill choice is the closest shape family
            return self._lookup("prefill", op)
        return None

    def attention_backend(self, stage: str) -> Tuple[str, Dict[str, Any]]:
        """-> ('torch' | 'cuda_attention', tuned config)."""
        assert stage in STAGES, stage
        c = self._lookup(stage, "attention")
        if c is None or c.backend in VENDOR_BACKENDS:
            return "torch", {}
        return "cuda_attention", dict(c.config)

    def chunk_segments(self, default: int = 1) -> int:
        """Packing width of the prefill lane.  A kernel choice carrying a
        tuned `max_segments` returns it; kernel choices tuned before the
        segmented kernel (no `max_segments`) pack one segment; a vendor
        choice or no plan defers to the engine's default."""
        if self.plan is None:
            return max(1, default)
        c = self._lookup("prefill_chunk", "attention")
        if c is None or c.backend in VENDOR_BACKENDS:
            return max(1, default)
        if "max_segments" in c.config:
            return max(1, int(c.config["max_segments"]))
        return 1

    def matmul_config(self, stage: str,
                      which: str = "qkv_proj") -> Tuple[str, Dict[str, Any]]:
        """-> ('torch' | 'cuda_matmul', tuned config) for a stage matmul."""
        assert stage in STAGES, stage
        c = self._lookup(stage, which)
        if c is None or c.backend in VENDOR_BACKENDS:
            return "torch", {}
        return "cuda_matmul", dict(c.config)

    def matmul_table(self, stage: str) -> Dict[str, Tuple[str, Dict[str, Any]]]:
        """Every stage matmul's (backend, config) keyed by role — the table
        `kernels.dispatch.matmul_dispatch` installs around the stage's
        lane."""
        from repro_torch.kernels.dispatch import MATMUL_ROLES
        return {role: self.matmul_config(stage, role) for role in MATMUL_ROLES}
