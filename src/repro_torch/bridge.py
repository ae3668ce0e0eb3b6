"""Parameter bridge: a JAX params tree, as numpy arrays, into the port's
tensors.

The tree's structure is kept as it is (nested dicts of leaves); each leaf
becomes a tensor of the same dtype and shape.  `torch.from_numpy` rejects
ml_dtypes' bfloat16, so bf16 leaves travel as their raw 16-bit patterns:
`a.view(np.uint16).astype(np.int16)` (a bit-preserving reinterpretation of
the same 16 bits) and then `.view(torch.bfloat16)` — the round trip is
exact.  Call as `params_from_jax(jax.tree.map(np.asarray, params))`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable contiguous copy


def params_from_jax(tree: Any) -> Any:
    """Nested dict (or list/tuple) of numpy leaves -> same nesting of CPU
    tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v) for v in tree)
    return leaf_from_numpy(tree)
