"""Captured programs: the port's counterpart of `jax.jit`.

A `Program` wraps `fn(*bound, *inputs)`, where `inputs` change every call
(host arrays or tensors of fixed shapes) and `bound` are the tensors it
updates or reads in place (parameters, KV pools).  On a CUDA device it is
captured in one CUDA graph per input signature — the inputs' shapes and
dtypes, on the program's device — as `jax.jit` compiles one executable per
abstract signature:

  * the first call of a signature allocates the signature's static input
    buffers on the device, copies the inputs in and runs `fn` eagerly on
    them.  That call is the warm-up — it builds the kernels, allocates the
    split kernels' counters (`kernels.build.counters`), sets their shared
    memory attributes and warms cuBLAS — and its result is returned.  The
    capture follows at once, on the same buffers; a capture executes
    nothing, so what `fn` writes in place is written once;
  * every later call copies its inputs into the static buffers (host
    arrays through one pinned staging buffer each, `non_blocking`) and
    replays the graph.  It returns the graph's static outputs: they are
    overwritten by the program's next call.

A failed capture raises; nothing falls back to eager execution.  On the
CPU, or with `graphed=False` (kept to compare against, as `jit=False` is in
the reference), nothing is captured: every call runs `fn` eagerly on the
static buffers.  Signatures are recorded all the same, so `_cache_size()`
— the count of captured (or seen) signatures, the number
`jax.stages.Wrapped._cache_size()` gives — means the same on both devices.

A call must pass the same `bound` objects as the first: the graph holds
their addresses, and a replay would read the old tensors.  A replay runs
no Python, so the kernel wrappers' `launches` counters (`build.counted`)
would only count the warm-up; the launches counted while capturing are
kept per signature and added back on every replay.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build


class _Signature:
    """One signature's static input buffers, staging buffers and graph."""

    def __init__(self, inputs: List[torch.Tensor], device: torch.device):
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in inputs]
        pin = device.type == "cuda"
        self.staging = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        if pin and t.device.type == "cpu" else None
                        for t in inputs]
        self.copied = torch.cuda.Event() if pin else None
        self.graph = None
        self.outputs = None
        self.launches: Dict[Callable, int] = {}

    def load(self, inputs: List[torch.Tensor]) -> None:
        """Copy the call's inputs into the static buffers."""
        if self.copied is not None:
            self.copied.synchronize()      # the last call's copies left staging
        for dst, stage, src in zip(self.static, self.staging, inputs):
            if stage is None:
                dst.copy_(src)
            else:
                stage.copy_(src)
                dst.copy_(stage, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


class Program:
    """`fn` captured once per input signature on a CUDA device (see the
    module docstring).  `pool`: a `torch.cuda.graph_pool_handle()` shared
    with programs that never run at the same time as this one."""

    def __init__(self, fn: Callable, name: str, device: torch.device, *,
                 graphed: bool = True, pool: Optional[Any] = None):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.graphed = graphed and self.device.type == "cuda"
        self.pool = pool
        self._signatures: Dict[Tuple, _Signature] = {}
        self._bound: Optional[Tuple] = None
        self.captures = 0
        self.replays = 0

    def _cache_size(self) -> int:
        """Signatures captured (on the CPU or with graphs off: seen)."""
        return len(self._signatures)

    def _check_bound(self, bound: Tuple) -> None:
        if self._bound is None:
            self._bound = bound
        elif len(bound) != len(self._bound) or any(
                a is not b for a, b in zip(bound, self._bound)):
            raise ValueError(
                f"program {self.name!r} was first called with other parameters "
                "or pools: its graphs read the tensors of the first call")

    def __call__(self, bound: Sequence, inputs: Sequence):
        bound = tuple(bound)
        self._check_bound(bound)
        inputs = [_as_tensor(a) for a in inputs]
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        sig = self._signatures.get(key)
        if sig is None:
            sig = _Signature(inputs, self.device)
            sig.load(inputs)
            out = self.fn(*bound, *sig.static)           # the warm-up
            if self.graphed:
                self._capture(sig, bound)
            self._signatures[key] = sig
            return out
        sig.load(inputs)
        if sig.graph is None:
            return self.fn(*bound, *sig.static)
        sig.graph.replay()
        self.replays += 1
        for fn, n in sig.launches.items():
            fn.launches += n
        return sig.outputs

    def _capture(self, sig: _Signature, bound: Tuple) -> None:
        """Capture `fn` on the signature's static buffers; the launches the
        wrappers count meanwhile are the graph's, not executions.  Python's
        cyclic garbage collector is off during the capture: collecting an
        unreachable program there would destroy its graph, a CUDA call the
        capture forbids, and the capture would fail."""
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn(*bound, *sig.static)
        finally:
            if collecting:
                gc.enable()
            for fn, n in before.items():
                if fn.launches != n:
                    sig.launches[fn] = fn.launches - n
                    fn.launches = n
        sig.graph, sig.outputs = graph, outputs
        self.captures += 1
