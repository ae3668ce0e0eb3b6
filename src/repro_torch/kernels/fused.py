"""Wrapper of the fused elementwise chain (`csrc/fused_elementwise.cu`),
the Hopper counterpart of `repro.kernels.fused.fused_elementwise`.

One launch applies a chain of up to `MAX_STAGES` stages over a flat index:
activations (relu / gelu (tanh) / silu / tanh / sigmoid / identity) and
binary ops (add / mul / sub / div), each binary stage consuming the next of
up to `MAX_EXTRAS` same-shape extra operands.  Every stage is computed in
f32 and rounded to the working dtype after it, so a bf16 chain rounds where
a chain of separate bf16 ops would.  Any other op raises KeyError, as the
Pallas kernel's lookup does.

The kernel streams 16-byte vectors in a launch geometry that `geometry`
computes from the size, the pointers' alignment and the SM count.  The
output takes x's offset within 16 bytes, so that an offset view of x (with
extras offset alike) still streams in 16-byte accesses.

A CPU tensor takes `repro_torch.kernels.ref.fused_elementwise_ref`; a CUDA
tensor launches the kernel or raises.  Launches are counted in the plain
int attribute `fused_elementwise.launches` (`build.counted`; a replayed
CUDA graph adds the launches it captured).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import hw
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.matmul import ACTIVATIONS

MAX_STAGES = 8
MAX_EXTRAS = 4
BINARY_CODES = {"add": 6, "mul": 7, "sub": 8, "div": 9}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The launch geometry (csrc/fused_elementwise.cu's MAX_THREADS, MAX_UNROLL
# and VEC_BYTES).  At streaming sizes a block is THREADS threads that each
# load UNROLL vectors before computing, and the grid holds RESIDENT blocks
# per SM: of unroll 1 / 2 / 4 with 2 / 4 / 8 blocks, chip_smoke.py's sweep
# on an H100 has (2, 4) within 2 % of the fastest pair in f32 and bf16,
# and (1, 2), the fewest bytes in flight, ~20 % slower.
VEC_BYTES = 16
THREADS = 256
MAX_UNROLL = 4
UNROLL = 2
RESIDENT = 4

Stage = Union[str, Dict[str, Any]]


class Geometry(NamedTuple):
    vec: int       # elements per access: 16 bytes' worth, or 1 (scalar body)
    unroll: int    # vectors a thread loads before it computes
    threads: int
    blocks: int
    head: int      # scalar elements before the first 16-byte boundary
    nvec: int      # whole vectors after the head
    tail: int      # scalar elements after the last whole vector


def geometry(n: int, itemsize: int, misalign: Optional[int], unroll: int = UNROLL,
             resident: int = RESIDENT) -> Geometry:
    """The launch geometry of an n-element chain whose pointers (x, every
    extra and out) all lie `misalign` bytes past a 16-byte boundary, or
    None where they differ (then every element takes the scalar body).

    With at least SMs x THREADS x `unroll` vectors the kernel streams: SMs
    x `resident` blocks of THREADS threads, each loading `unroll` vectors
    per thread before it computes.  Below that every SM gets one block and
    an equal share of the vectors: `unroll` vectors a thread where the
    share exceeds THREADS, in a block as narrow as the share allows (a
    multiple of 32 threads), so a small tensor reaches every SM rather
    than a few of them.  `unroll` and `resident` differ from their
    defaults only where chip_smoke.py measures the streaming geometry."""
    if misalign is None:
        vec, head = 1, 0
    else:
        if misalign % itemsize or not 0 <= misalign < VEC_BYTES:
            raise ValueError(f"fused_elementwise: offset {misalign} of "
                             f"{itemsize}-byte elements")
        vec = VEC_BYTES // itemsize
        head = min(n, (-misalign % VEC_BYTES) // itemsize)
    nvec = (n - head) // vec
    tail = n - head - nvec * vec
    sms = hw.H100.sms
    if nvec >= sms * THREADS * unroll:
        threads, blocks = THREADS, sms * resident
    else:
        blocks = max(1, min(sms, nvec))
        share = -(-nvec // blocks)
        unroll = max(1, -(-share // THREADS))
        threads = 32 * max(1, -(-share // (32 * unroll)))
    return Geometry(vec, unroll, threads, blocks, head, nvec, tail)


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


def _empty_aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of x's shape and dtype whose address lies as
    far past a 16-byte boundary as x's does."""
    shift = x.data_ptr() % VEC_BYTES // x.element_size()
    if not shift:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    return buf[shift:].view(x.shape)


@build.counted
def fused_elementwise(x: torch.Tensor, chain: Sequence[Stage],
                      extras: Sequence[torch.Tensor] = (), *,
                      geo: Optional[Geometry] = None) -> torch.Tensor:
    """Apply `chain` to x in one pass; binary stages take `extras` in
    order.  Every extra has x's shape, dtype and device.  `geo` replaces
    the launch geometry `geometry` picks (for measuring others)."""
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
    out = _empty_aligned_like(x)
    if x.numel() == 0:
        return out
    offsets = {t.data_ptr() % VEC_BYTES for t in [x, out, *extras]}
    if geo is None:
        geo = geometry(x.numel(), x.element_size(),
                       offsets.pop() if len(offsets) == 1 else None)
    ptrs = [e.data_ptr() for e in extras] + [None] * (MAX_EXTRAS - len(extras))
    fn = build.load("fused_elementwise")
    err = fn(x.data_ptr(), *ptrs, out.data_ptr(), x.numel(), n_stages, code,
             _DTYPES[x.dtype], geo.vec, geo.unroll, geo.threads, geo.blocks, geo.head,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_elementwise")
    fused_elementwise.launches += 1
    return out
