"""Bytes accessed and transcendentals of an eager PyTorch run, counted op by
op: the two counters of XLA's `cost_analysis()` that FlopCounterMode does
not keep, as XLA would count them with no fusion.

`CostCounter` is a TorchDispatchMode.  Every aten op the run dispatches is
its own kernel in the port's eager step, so the bytes it moves are the
bytes of that kernel:

  * views and metadata ops move nothing (`func.is_view`, `detach`, `alias`,
    `expand`, `t`, `as_strided`, `_unsafe_view`, `lift_fresh`, `empty*`);
  * an op reads, once per distinct input tensor, the bytes of the elements
    that tensor addresses (a dimension of stride 0, an `expand`, counts
    once), and writes its outputs' bytes;
  * an in-place op or an `out=` op reads and writes the tensor it mutates;
    `copy_` reads the source and writes the destination;
  * gathers (`embedding`, `index_select`, `gather`, `index.Tensor`) read
    their indices and as many source bytes as they write: XLA's convention
    for `gather`;
  * scatters (`index_copy`, `index_put`, `index_add`, `scatter*`,
    `embedding_dense_backward`, in place or not) read their indices and
    updates and write the elements they touch, never the whole target
    (XLA's `scatter` also reads the touched elements of its operand: one
    update's bytes more);
  * fills (`zeros`, `ones`, `full`, `fill_`, `zero_`, `*_like`, `new_*`)
    write their output;
  * collectives (the `c10d` ops) count their operand and result bytes, as
    XLA's cost analysis does, under their own op name, so that a reader
    can take them out.

Transcendentals are one per output element of every op that XLA's cost
analysis on the CPU counts as transcendental (`TRANSCENDENTAL`), with these
rules measured there (tests/test_torch_costcount.py holds each one):
softplus two (exp, log1p); `_log_softmax` one more per row (the log of the
sum); `logsumexp` one per input element and one per result;
`silu_backward`, `gelu_backward`, `softplus_backward` and
`_log_softmax_backward_data` one, as each recomputes an exponential (XLA's
vjp alone counts the same); the backward ops that read the forward's
output (`_softmax_backward_data`, `tanh_backward`, `sigmoid_backward`)
none; `pow` one where the exponent is a tensor or a scalar that is not an
integer (XLA rewrites integer powers into products, and 0.5 / -0.5 into
sqrt / rsqrt).  Ops outside the table count none.

What the counter sees is what the dispatcher sees: a hand-written kernel
launched through `ctypes` (a kernel-lane serving path) is invisible to it,
which is why the dry run runs the torch lanes.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# transcendentals per output element, as XLA's cost analysis counts them
TRANSCENDENTAL = {
    "exp": 1, "expm1": 1, "exp2": 1, "log": 1, "log1p": 1, "log2": 1, "log10": 1,
    "sigmoid": 1, "silu": 1, "tanh": 1, "rsqrt": 1, "sqrt": 1, "sin": 1, "cos": 1,
    "erf": 1, "gelu": 1, "softplus": 2, "_softmax": 1, "_safe_softmax": 1,
    "_log_softmax": 1, "silu_backward": 1, "gelu_backward": 1, "softplus_backward": 1,
    "_log_softmax_backward_data": 1, "pow": 1, "logsumexp": 1,
}
_METADATA = {"detach", "alias", "expand", "t", "as_strided", "_unsafe_view", "lift_fresh",
             "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
_FILL = {"zeros", "ones", "full", "fill", "zero", "zeros_like", "ones_like", "full_like",
         "new_zeros", "new_ones", "new_full", "scalar_tensor"}
_GATHER = {"embedding", "index_select", "gather", "index"}
_SCATTER = {"index_copy", "index_put", "index_add", "scatter", "scatter_add",
            "scatter_reduce", "embedding_dense_backward"}


class _Rule(NamedTuple):
    kind: str                 # "none", "fill", "copy", "gather", "scatter", "collective", "plain"
    name: str                 # the op's name without a trailing "_"
    key: str                  # its name in the by-op maps: "aten.mm"
    mutated: Tuple[Tuple[int, str], ...]   # (position, name) of the arguments it writes


def _rule(func) -> _Rule:
    name = func._schema.name.split("::")[-1].rstrip("_") or func._schema.name
    mutated = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
    if func.namespace == "c10d":
        kind = "collective"
    elif func.is_view or name in _METADATA:
        kind = "none"
    elif name == "copy":
        kind = "copy"
    else:
        kind = next((k for k, names in (("fill", _FILL), ("gather", _GATHER),
                                        ("scatter", _SCATTER)) if name in names), "plain")
    return _Rule(kind, name, str(func._overloadpacket), mutated)


def addressed_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements `t` addresses: a dimension of stride 0
    counts once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride or not size:
            n *= size
    return n


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _distinct_bytes(tensors, skip=()) -> int:
    seen = {id(t) for t in skip}
    n = 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            n += addressed_bytes(t)
    return n


def _index_put_elements(target: torch.Tensor, indices) -> int:
    """The elements `target[indices] = ...` touches: the broadcast index
    positions (a bool mask: every position it covers) times the dimensions
    no index covers."""
    lead, covered, rest = [], 0, 1
    for i in indices:
        if i is None:
            rest *= target.shape[covered]
            covered += 1
        else:
            lead.append(i.shape if i.dtype != torch.bool else (i.numel(),))
            covered += i.dim() if i.dtype == torch.bool else 1
    for size in target.shape[covered:]:
        rest *= size
    return math.prod(torch.broadcast_shapes(*lead)) * rest if lead else target.numel()


def _scatter_bytes(name: str, args) -> int:
    """Indices and updates read, the touched elements written."""
    if name == "embedding_dense_backward":
        grad, index = args[0], args[1]
        return addressed_bytes(index) + 2 * addressed_bytes(grad)
    target = args[0]
    if name == "index_put":
        indices = [i for i in args[1] if i is not None]
        touched = _index_put_elements(target, args[1])
        return (_distinct_bytes(indices) + addressed_bytes(args[2])
                + touched * target.element_size())
    index = args[2]
    src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
    if name in ("index_copy", "index_add"):
        updates, touched = addressed_bytes(src), src.numel()
    else:   # scatter*: the first index.shape elements of src, or a scalar
        touched = index.numel()
        updates = 0 if src is None else touched * src.element_size()
    return addressed_bytes(index) + updates + touched * target.element_size()


def _transcendentals(rule: _Rule, args, out) -> int:
    per = TRANSCENDENTAL.get(rule.name, 0)
    if not per:
        return 0
    if rule.name == "pow":
        exponent = args[1]
        if not isinstance(exponent, torch.Tensor) and float(exponent).is_integer():
            return 0
    if rule.name == "logsumexp":      # an exp per input element, a log per result
        return args[0].numel() + out.numel()
    elements = sum(t.numel() for t in _tensors(out))
    if rule.name == "_log_softmax" and out.dim():
        elements += out.numel() // out.shape[args[1]]
    return per * elements


class CostCounter(TorchDispatchMode):
    """Counts the bytes each aten op moves and its transcendentals (see the
    module docstring); `bytes_by_op` / `transcendentals_by_op` are keyed by
    the op's name as FlopCounterMode keys FLOPs ("aten.mm")."""

    def __init__(self):
        super().__init__()
        self._rules: Dict[object, _Rule] = {}
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.transcendentals_by_op: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = self._rules.get(func)
        if rule is None:
            rule = self._rules[func] = _rule(func)
        if rule.kind == "none":
            return out
        self.bytes_by_op[rule.key] += self._bytes(rule, args, kwargs, out)
        n = _transcendentals(rule, args, out)
        if n:
            self.transcendentals_by_op[rule.key] += n
        return out

    @staticmethod
    def _bytes(rule: _Rule, args, kwargs, out) -> int:
        if rule.kind == "copy":
            return addressed_bytes(args[1]) + addressed_bytes(args[0])
        if rule.kind == "scatter":
            return _scatter_bytes(rule.name, args)
        mutated = _tensors([args[i] if i < len(args) else kwargs.get(name)
                            for i, name in rule.mutated])
        written = _distinct_bytes(mutated) if mutated else _distinct_bytes(_tensors(out))
        if rule.kind == "fill":
            return written
        if rule.kind == "gather":
            return _distinct_bytes(_tensors((args[1:], kwargs))) + 2 * written
        inputs = _tensors((args, kwargs))
        if rule.kind == "collective":
            # c10d schemas mark no argument as written: the results are the
            # tensors returned, the operands the other tensor arguments (an
            # in-place all-reduce: the returned tensors are both)
            results = _tensors(out)
            return (_distinct_bytes(inputs, skip=results) or written) + written
        return _distinct_bytes(inputs) + written

    @staticmethod
    def by_op(counts: Dict[str, int]) -> Dict[str, int]:
        """`counts` as a plain dict, the largest first."""
        return dict(sorted(counts.items(), key=lambda kv: -kv[1]))

    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def total_transcendentals(self) -> int:
        return sum(self.transcendentals_by_op.values())
