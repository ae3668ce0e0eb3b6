"""Parameter bridge: a JAX params tree, as numpy arrays, into the port's
tensors.

The tree's structure is kept as it is (nested dicts of leaves); each leaf
becomes a tensor of the same dtype and shape.  `torch.from_numpy` rejects
ml_dtypes' bfloat16, so bf16 leaves travel as their raw 16-bit patterns:
`a.view(np.uint16).astype(np.int16)` (a bit-preserving reinterpretation of
the same 16 bits) and then `.view(torch.bfloat16)` — the round trip is
exact.  Call as `params_from_jax(jax.tree.map(np.asarray, params))`.
`load_ppo_params` carries the RL-search's PPO parameters into the port's
policy and value modules.  `train_state_from_jax` / `train_state_to_numpy`
carry a train state {"params", "opt": {"m", "v", "step"}} across, the
former also straight into one rank's cut of a mesh.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.manager import leaf_to_numpy, place
from repro_torch.tree import tree_map


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


def load_ppo_params(policy, value, tree: Any) -> None:
    """Copy the JAX PPO parameters (`repro.core.search.ppo.init_params`'s
    tree as numpy: {"policy": [{"w", "b"}, ...], "value": [...]}) into a
    PPO agent's two modules (`PolicyNet`, `ValueNet`), layer by layer.  A
    JAX weight is (fan_in, fan_out); `nn.Linear.weight` is (out, in)."""
    params = params_from_jax(tree)
    for module, layers in ((policy, params["policy"]), (value, params["value"])):
        if len(module.layers) != len(layers):
            raise ValueError(f"{len(layers)} JAX layers for {len(module.layers)} "
                             "linear layers")
        with torch.no_grad():
            for linear, p in zip(module.layers, layers):
                linear.weight.copy_(p["w"].T)
                linear.bias.copy_(p["b"])


def train_state_from_jax(tree: Any, shardings: Any = None) -> Any:
    """A JAX train state {"params", "opt": {"m", "v", "step"}} as numpy
    (`jax.tree.map(np.asarray, state)`) -> the port's state: tensors of
    the same dtypes (f32 leaves, an int32 0-d step), on the CPU, or each
    leaf placed as `shardings` says (`checkpoint.manager.place`: a device,
    or a tree such as `launch.steps.state_layouts`' cut of one rank of a
    mesh, so the exported state lands as the rank's shards)."""
    state = {"params": params_from_jax(tree["params"]),
             "opt": params_from_jax(tree["opt"])}
    if isinstance(shardings, dict):
        return tree_map(place, state, shardings)
    return tree_map(lambda t: place(t, shardings), state)


def train_state_to_numpy(state: Any) -> Any:
    """The port's train state -> the same tree of host numpy copies (the
    checkpoint's leaf conversion: a bfloat16 leaf raises, naming it)."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        return leaf_to_numpy("/".join(prefix), tree)

    return walk(state, ())
