"""Constant folding (paper §2.1): "applies to sub-graphs whose output values
can be computed statically beforehand"."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ref_ops
from repro_torch.core.graph import Graph


def constant_folding(graph: Graph, max_fold_bytes: int = 256 * 1024 * 1024) -> Graph:
    """Evaluate every node whose inputs are all constants and replace it with
    a constant tensor.  `max_fold_bytes` guards against materialising folded
    tensors larger than what we would ever want in the inference binary."""
    g = graph.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if not all(i in g.constants for i in node.inputs):
                continue
            out_spec = g.tensors[node.outputs[0]]
            if out_spec.nbytes() > max_fold_bytes:
                continue
            # evaluated on CPU tensors, stored back as numpy (as the JAX pass
            # stores the numpy value of its jnp result)
            vals = [torch.from_numpy(np.ascontiguousarray(g.constants[i]))
                    for i in node.inputs]
            out = ref_ops.run_op(node.op, vals, node.attrs).numpy()
            out_name = node.outputs[0]
            g.constants[out_name] = out
            g.tensors[out_name].shape = tuple(out.shape)
            g.tensors[out_name].dtype = str(out.dtype)
            g.remove_node(node)
            changed = True
    g.prune_tensors()
    return g
