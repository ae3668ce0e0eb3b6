"""Computational-graph IR for the WPK inference compiler (the port's copy of
`repro.core.graph`; only `TensorSpec.nbytes` differs, reading item sizes
from `repro_torch.hw` because numpy has no bfloat16 without ml_dtypes).

The paper abstracts a DNN as "a computational graph with operators as nodes
and tensors representing data movement as edges" (§1).  This module is that
IR: a small, explicit, serialisable graph that the optimization passes
(`repro_torch.core.passes`), the automated searches
(`repro_torch.core.search`), the system-level backend selection
(`repro_torch.core.selection`) and the runtime engine
(`repro_torch.core.engine`) all operate on.

Design notes
------------
* Tensors are identified by string names; `Node`s consume/produce names.
* Constants (weights after training — invariant during inference, which is
  exactly the property the paper exploits) live in `Graph.constants`.
* The op vocabulary is deliberately small and inference-oriented; every op
  has a plain PyTorch implementation in `repro_torch.core.ref_ops` used for
  constant folding and as the correctness oracle for every optimized plan.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.hw import bytes_of

# Op vocabulary.  Fused ops are produced by the fusion pass.
ELEMENTWISE_UNARY = (
    "relu",
    "gelu",
    "silu",
    "tanh",
    "sigmoid",
    "identity",
    "dropout",  # inference: identity (paper lists dropout removal explicitly)
    "neg",
    "exp",
)
ELEMENTWISE_BINARY = ("add", "mul", "sub", "div")
COMPUTE_OPS = ("conv2d", "matmul", "attention")
FUSED_OPS = (
    "fused_conv2d",      # conv2d (+bias) (+activation)
    "fused_matmul",      # matmul (+bias) (+activation)
    "fused_elementwise", # chain of elementwise ops
)
OTHER_OPS = (
    "bias_add",
    "batch_norm",   # inference form: y = x * scale + shift (folded stats)
    "layer_norm",
    "softmax",
    "max_pool",
    "avg_pool",
    "global_avg_pool",
    "reshape",
    "transpose",
    "flatten",
    "concat",
    "constant",
)
ALL_OPS = ELEMENTWISE_UNARY + ELEMENTWISE_BINARY + COMPUTE_OPS + FUSED_OPS + OTHER_OPS


@dataclasses.dataclass
class TensorSpec:
    """Shape/dtype metadata for one edge of the graph."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"

    def nbytes(self) -> int:
        return bytes_of(self.shape, self.dtype)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "shape": list(self.shape), "dtype": self.dtype}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TensorSpec":
        return TensorSpec(d["name"], tuple(d["shape"]), d["dtype"])


@dataclasses.dataclass
class Node:
    """One operator instance."""

    op: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def signature(self, graph: "Graph") -> str:
        """Hardware-relevant identity of this node, used as the search-cache
        key (§3.3: "two convolution operators are considered computationally
        identical if they have the same input/output shape, filter matrix
        size, stride and padding")."""
        in_specs = [
            (tuple(graph.tensors[t].shape), graph.tensors[t].dtype) for t in self.inputs
        ]
        attrs = {k: v for k, v in sorted(self.attrs.items()) if k != "label"}
        return json.dumps([self.op, in_specs, attrs], sort_keys=True, default=str)

    def to_json(self) -> Dict[str, Any]:
        return {
            "op": self.op,
            "name": self.name,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable(self.attrs),
        }


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return {"__ndarray__": x.tolist(), "dtype": str(x.dtype)}
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


class Graph:
    """A DAG of `Node`s over named tensors."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: List[Node] = []
        self.tensors: Dict[str, TensorSpec] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.constants: Dict[str, np.ndarray] = {}
        self._ctr = 0

    # ------------------------------------------------------------------ build
    def fresh(self, prefix: str = "t") -> str:
        self._ctr += 1
        return f"{prefix}_{self._ctr}"

    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        self.tensors[name] = TensorSpec(name, tuple(shape), dtype)
        self.inputs.append(name)
        return name

    def add_constant(self, name: str, value: np.ndarray) -> str:
        value = np.asarray(value)
        self.tensors[name] = TensorSpec(name, tuple(value.shape), str(value.dtype))
        self.constants[name] = value
        return name

    def add_node(
        self,
        op: str,
        inputs: Sequence[str],
        out_shape: Sequence[int],
        attrs: Optional[Dict[str, Any]] = None,
        out_dtype: str = "float32",
        name: Optional[str] = None,
    ) -> str:
        assert op in ALL_OPS, f"unknown op {op}"
        for t in inputs:
            assert t in self.tensors, f"unknown tensor {t} feeding {op}"
        name = name or f"{op}_{self.fresh('n')}"
        out = self.fresh(op)
        self.tensors[out] = TensorSpec(out, tuple(out_shape), out_dtype)
        self.nodes.append(Node(op, name, list(inputs), [out], dict(attrs or {})))
        return out

    def set_outputs(self, names: Sequence[str]) -> None:
        self.outputs = list(names)

    # -------------------------------------------------------------- structure
    def producer(self, tensor: str) -> Optional[Node]:
        for n in self.nodes:
            if tensor in n.outputs:
                return n
        return None

    def consumers(self, tensor: str) -> List[Node]:
        return [n for n in self.nodes if tensor in n.inputs]

    def toposort(self) -> List[Node]:
        """Kahn toposort; raises on cycles."""
        ready = set(self.inputs) | set(self.constants)
        remaining = list(self.nodes)
        order: List[Node] = []
        while remaining:
            progress = False
            nxt = []
            for n in remaining:
                if all(i in ready for i in n.inputs):
                    order.append(n)
                    ready.update(n.outputs)
                    progress = True
                else:
                    nxt.append(n)
            if not progress:
                raise ValueError(
                    f"graph {self.name} has a cycle or dangling input: "
                    f"{[n.name for n in nxt]}"
                )
            remaining = nxt
        return order

    def validate(self) -> None:
        self.toposort()
        for o in self.outputs:
            assert o in self.tensors, f"output {o} not defined"

    def copy(self) -> "Graph":
        g = Graph(self.name)
        g.nodes = [
            Node(n.op, n.name, list(n.inputs), list(n.outputs), dict(n.attrs))
            for n in self.nodes
        ]
        g.tensors = {k: TensorSpec(v.name, v.shape, v.dtype) for k, v in self.tensors.items()}
        g.inputs = list(self.inputs)
        g.outputs = list(self.outputs)
        g.constants = dict(self.constants)
        g._ctr = self._ctr
        return g

    def remove_node(self, node: Node) -> None:
        self.nodes.remove(node)

    def rewire(self, old_tensor: str, new_tensor: str) -> None:
        """Point every consumer of `old_tensor` at `new_tensor`."""
        for n in self.nodes:
            n.inputs = [new_tensor if i == old_tensor else i for i in n.inputs]
        self.outputs = [new_tensor if o == old_tensor else o for o in self.outputs]

    def prune_tensors(self) -> None:
        """Drop tensor specs/constants no longer referenced."""
        live = set(self.inputs) | set(self.outputs)
        for n in self.nodes:
            live.update(n.inputs)
            live.update(n.outputs)
        self.tensors = {k: v for k, v in self.tensors.items() if k in live}
        self.constants = {k: v for k, v in self.constants.items() if k in live}

    # ------------------------------------------------------------------ stats
    def op_histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {}
        for n in self.nodes:
            h[n.op] = h.get(n.op, 0) + 1
        return h

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "nodes": [n.to_json() for n in self.nodes],
            "tensors": {k: v.to_json() for k, v in self.tensors.items()},
            "inputs": self.inputs,
            "outputs": self.outputs,
            "constants": {k: v.shape for k, v in self.constants.items()},
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Graph({self.name}: {len(self.nodes)} nodes, "
            f"{len(self.inputs)} in, {len(self.outputs)} out, "
            f"hist={self.op_histogram()})"
        )
