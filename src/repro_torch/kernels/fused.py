"""Wrapper of the fused elementwise chain (`csrc/fused_elementwise.cu`),
the Hopper counterpart of `repro.kernels.fused.fused_elementwise`.

One launch applies a chain of up to `MAX_STAGES` stages over a flat index:
activations (relu / gelu (tanh) / silu / tanh / sigmoid / identity) and
binary ops (add / mul / sub / div), each binary stage consuming the next of
up to `MAX_EXTRAS` same-shape extra operands.  Every stage is computed in
f32 and rounded to the working dtype after it, so a bf16 chain rounds where
a chain of separate bf16 ops would.  Any other op raises KeyError, as the
Pallas kernel's lookup does.

A CPU tensor takes `repro_torch.kernels.ref.fused_elementwise_ref`; a CUDA
tensor launches the kernel or raises.  Launches are counted in the plain
int attribute `fused_elementwise.launches` (`build.counted`; a replayed
CUDA graph adds the launches it captured).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.matmul import ACTIVATIONS

MAX_STAGES = 8
MAX_EXTRAS = 4
BINARY_CODES = {"add": 6, "mul": 7, "sub": 8, "div": 9}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Stage = Union[str, Dict[str, Any]]


def chain_code(chain: Sequence[Stage]):
    """(n_stages, packed op codes: 4 bits per stage, stage 0 lowest,
    number of binary stages) of a chain whose stages are {'op': name}
    dicts or bare names, as the Pallas kernel accepts; raises KeyError on
    an op the kernel does not have and ValueError past its limits."""
    ops = [s["op"] if isinstance(s, dict) else s for s in chain]
    if len(ops) > MAX_STAGES:
        raise ValueError(f"fused_elementwise: {len(ops)} stages > {MAX_STAGES}")
    code = 0
    for i, op in enumerate(ops):
        c = BINARY_CODES[op] if op in BINARY_CODES else ACTIVATIONS[op]
        code |= c << (4 * i)
    return len(ops), code, sum(op in BINARY_CODES for op in ops)


@build.counted
def fused_elementwise(x: torch.Tensor, chain: Sequence[Stage],
                      extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Apply `chain` to x in one pass; binary stages take `extras` in
    order.  Every extra has x's shape, dtype and device."""
    if x.device.type == "cpu":
        return _ref.fused_elementwise_ref(x, chain, extras)
    n_stages, code, n_binary = chain_code(chain)
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_elementwise: dtype {x.dtype} not supported")
    if n_binary != len(extras) or len(extras) > MAX_EXTRAS:
        raise ValueError(f"fused_elementwise: {n_binary} binary stages, "
                         f"{len(extras)} extras (at most {MAX_EXTRAS})")
    if x.device.type != "cuda":
        raise ValueError("fused_elementwise: x must be a GPU tensor")
    for t in extras:
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError("fused_elementwise: extras must match x's shape, "
                             "dtype and GPU device")
    x = x.contiguous()
    extras = [e.contiguous() for e in extras]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ptrs = [e.data_ptr() for e in extras] + [None] * (MAX_EXTRAS - len(extras))
    fn = build.load("fused_elementwise")
    err = fn(x.data_ptr(), *ptrs, out.data_ptr(), x.numel(), n_stages, code,
             _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_elementwise")
    fused_elementwise.launches += 1
    return out
