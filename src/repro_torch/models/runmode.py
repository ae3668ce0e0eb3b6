"""The dry run's lowering mode — the port of `repro.models.runmode`.

The reference lowers each dry-run cell twice, because XLA's
`cost_analysis()` counts a while-loop body once: a deploy program
(layers scanned) and, under `cost_mode(True)`, a cost program whose layer
scans `layer_scan` unrolls so that every layer's FLOPs appear.

The port's layers are already a Python loop, and its dry run counts what
one run of the step executes (`torch.utils.flop_counter.FlopCounterMode`
over the meta device, `launch/dryrun.py`): every layer's products are
seen whether or not cost mode is on, so cost mode changes no count.
`COST_MODE` and `cost_mode` are kept for parity (a caller of the
reference's API runs unchanged); the models do not route through
`layer_scan`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

COST_MODE = False


class cost_mode:
    """`with cost_mode(on):` sets COST_MODE for the enclosed calls and
    restores the previous value after, so the contexts nest."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        global COST_MODE
        self.prev = COST_MODE
        COST_MODE = self.on

    def __exit__(self, *exc):
        global COST_MODE
        COST_MODE = self.prev


def layer_scan(body: Callable, init: Any, xs: Any, length: Optional[int] = None):
    """`jax.lax.scan`'s contract as a Python loop: `body(carry, x) ->
    (carry, y)` over the leading dim of every leaf of `xs` (a pytree of
    tensors, or None with `length`), -> (the last carry, the ys stacked
    along a new leading dim, leaf by leaf; None where the body gives
    None).  The loop runs every layer in either mode."""
    leaves, spec = pytree.tree_flatten(xs)            # None is a leaf here
    tensors = [leaf for leaf in leaves if leaf is not None]
    n = tensors[0].shape[0] if tensors else length
    if n is None:
        raise ValueError("layer_scan needs xs with leaves or a length")
    if length is not None and n != length:
        raise ValueError(f"length {length} does not match the leading dim {n} of xs")
    carry, ys = init, []
    for i in range(n):
        x = pytree.tree_unflatten([None if leaf is None else leaf[i] for leaf in leaves], spec)
        carry, y = body(carry, x)
        ys.append(y)
    if not ys:
        return carry, None
    return carry, pytree.tree_map(lambda *ts: None if ts[0] is None else torch.stack(ts),
                                  *ys)
