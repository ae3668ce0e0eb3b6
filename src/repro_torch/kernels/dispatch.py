"""Backend dispatch: from an `InferencePlan` choice to a matmul callable
(the port of `repro.kernels.dispatch`).

  * a **lane registry** mapping a backend name to a callable
    ``lane(x, w, *, config, activation)`` — `torch` is the vendor lane
    (`x @ w`, then the activation; JAX's `xla` lane) and `cuda_matmul` is the
    hand-written GEMM with the activation fused into its epilogue (JAX's
    `pallas_matmul` lane);
  * a **dispatch context** (`matmul_dispatch`) holding a per-stage table
    ``role -> (backend, config)`` for the model's named matmuls
    (``qkv_proj`` / ``mlp_up`` / ``mlp_down`` / ``lm_head``).  In JAX the
    table is read while jit traces the step program; PyTorch runs eagerly,
    so here it is read at call time, on every role-tagged projection;
  * `dispatch_dense(role, x, w)` — what `models.common.dense` calls for a
    role-tagged projection.  With no active context it is ``x @ w``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import apply_activation

MatmulChoice = Tuple[str, Dict[str, Any]]
MatmulTable = Dict[str, MatmulChoice]

MATMUL_ROLES = ("qkv_proj", "mlp_up", "mlp_down", "lm_head")

LaneFn = Callable[..., torch.Tensor]

_LANES: Dict[str, LaneFn] = {}


def register_lane(name: str):
    """Register a matmul lane under `name` (decorator)."""

    def deco(fn: LaneFn) -> LaneFn:
        _LANES[name] = fn
        return fn

    return deco


@register_lane("torch")
def torch_lane(x: torch.Tensor, w: torch.Tensor, *,
               config: Optional[Dict] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """Vendor lane: `x @ w` in the working dtype, then the activation —
    the rounding points of JAX's XLA lane."""
    del config
    return apply_activation(x @ w, activation)


@register_lane("cuda_matmul")
def cuda_matmul_lane(x: torch.Tensor, w: torch.Tensor, *,
                     config: Optional[Dict] = None,
                     activation: Optional[str] = None) -> torch.Tensor:
    """Hand-written lane: the tiled GEMM kernel, activation in its f32
    epilogue (the plain f32-accumulating version on CPU tensors)."""
    from repro_torch.kernels import ops

    return ops.matmul(x, w, config=config, activation=activation)


_tls = threading.local()


@contextlib.contextmanager
def matmul_dispatch(table: Optional[MatmulTable]):
    """Install a per-stage matmul dispatch table for the enclosed calls."""
    prev = getattr(_tls, "table", None)
    _tls.table = dict(table or {})
    try:
        yield
    finally:
        _tls.table = prev


def dispatch_dense(role: Optional[str], x: torch.Tensor, w: torch.Tensor,
                   activation: Optional[str] = None) -> torch.Tensor:
    """Route one role-tagged projection through the chosen lane; outside a
    dispatch context, or for a role the table does not name, the torch
    lane."""
    table = getattr(_tls, "table", None)
    if table is None or role is None:
        return torch_lane(x, w, activation=activation)
    backend, config = table.get(role, ("torch", {}))
    lane = _LANES.get(backend)
    if lane is None:
        raise KeyError(
            f"plan chose unknown matmul backend {backend!r} for role "
            f"{role!r}; registered lanes: {sorted(_LANES)}")
    return lane(x, w, config=config, activation=activation)
