"""Wrapper of the direct NHWC convolution (`csrc/conv2d.cu`), the Hopper
counterpart of `repro.kernels.conv2d.conv2d_direct`.

The kernel takes the UNPADDED input and applies SAME padding itself, by
masked loads at TensorFlow's offsets, so no padded copy is written.  Its
launch geometry is decided here, in Python, by `geometry()`: the
schedule template `Conv2dTemplate` validates a configuration with the same
function, so a config the search proposes is one the kernel launches.

Knobs (read at launch): `bn`, the output-channel tile of a block (16, 32,
64 or 128), and `row_block`, the output rows a block covers (each block
covers whole output rows).  A block has 256 threads; each owns a
TM × 4 register tile of (pixels × channels), TM the smallest of 2/4/8/16
that covers the block's row_block·OW pixels — a configuration whose block
holds more pixels than 16 × 256·4/bn is invalid.  The input channels are
walked in chunks of `bc` (a power of two ≤ 32, the largest whose halo and
weight slices fit `SMEM_TARGET`), staging for each chunk the input halo
((row_block−1)·stride + Kh rows × (OW−1)·stride + Kw columns × bc) and
the (Kh·Kw·bc × bn) weight slice in shared memory, as f32.

A CPU tensor takes `repro_torch.kernels.ref.conv2d_ref`; a CUDA tensor
launches the kernel or raises.  Launches are counted in the plain int
attribute `conv2d_direct.launches`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import hw
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.matmul import ACTIVATIONS

THREADS = 256
TN = 4                          # output channels per thread
BN_CHOICES = (16, 32, 64, 128)
TM_CHOICES = (2, 4, 8, 16)      # pixels per thread (compiled instances)
ROW_BLOCKS = (1, 2, 4, 8)
BC_MAX = 32
SMEM_TARGET = 96 * 1024         # a chunk's tiles; two blocks fit one SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Geometry:
    oh: int
    ow: int
    pad_top: int
    pad_left: int
    tm: int                     # pixels per thread
    bc: int                     # input channels per shared-memory chunk
    smem_bytes: int


def out_size(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    if padding == "VALID":
        return (size - k) // stride + 1
    raise ValueError(f"padding {padding!r}")


def geometry(n: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
             stride: int, padding: str, bn: int, row_block: int,
             chip: hw.Chip = hw.H100) -> Optional[Geometry]:
    """The kernel's launch geometry for one configuration, or None when the
    configuration is outside the kernel's limits (an unknown bn or
    row_block, more pixels per block than the register tile covers, more
    image x row-block blocks than a grid's y dimension holds, or tiles that
    do not fit the chip's shared memory or threads per block).

    Registers are not a limit a configuration can break: the kernel is
    compiled with `__launch_bounds__(THREADS)`, so ptxas fits every TM
    instance into at most 255 registers per thread and spills past that
    (ptxas -v reports the spill; PERF.md has it); 256 x 255 <= 65,536, so
    one block always fits an SM's register file."""
    if bn not in BN_CHOICES or row_block not in ROW_BLOCKS:
        return None
    oh, ow = out_size(h, kh, stride, padding), out_size(w, kw, stride, padding)
    if oh < 1 or ow < 1:
        return None
    rows = THREADS // (bn // TN)
    tm = next((t for t in TM_CHOICES if rows * t >= row_block * ow), None)
    if tm is None:
        return None
    if THREADS > chip.max_threads_per_block or n * -(-oh // row_block) > chip.max_grid_y:
        return None
    hr = (row_block - 1) * stride + kh
    wc = (ow - 1) * stride + kw
    per_channel = 4 * (hr * wc + kh * kw * bn)          # f32 in shared memory
    bc = 1
    while bc * 2 <= min(cin, BC_MAX) and bc * 2 * per_channel <= SMEM_TARGET:
        bc *= 2
    smem = bc * per_channel
    if smem > chip.smem_per_block:
        return None
    pad_top = pad_left = 0
    if padding == "SAME":
        pad_top, pad_left = _ref.same_pads(h, kh, stride)[0], _ref.same_pads(w, kw, stride)[0]
    return Geometry(oh, ow, pad_top, pad_left, tm, bc, smem)


def default_config(n, h, w, cin, cout, kh, kw, stride, padding) -> dict:
    """A valid configuration for a conv the plan did not tune: bn 64 (or
    the narrowest tile that covers Cout) and one output row per block,
    which gives the most blocks at batch 1."""
    bn = next((b for b in BN_CHOICES if b >= min(cout, 64)), BN_CHOICES[-1])
    for rb in ROW_BLOCKS:
        if geometry(n, h, w, cin, cout, kh, kw, stride, padding, bn, rb):
            return {"bn": bn, "row_block": rb}
    return {"bn": BN_CHOICES[0], "row_block": 1}


def conv2d_direct(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                  padding: str = "SAME", bn: int = 64, row_block: int = 1,
                  activation: Optional[str] = None) -> torch.Tensor:
    """act(conv(x (N, H, W, Cin), w (Kh, Kw, Cin, Cout)) + bias (Cout,))
    -> (N, OH, OW, Cout) in x's dtype, f32 accumulation, one rounding."""
    if x.device.type == "cpu":
        return _ref.conv2d_ref(x, w, bias, stride, padding, activation)
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv2d_direct: dtype {x.dtype} not supported")
    if activation not in ACTIVATIONS:
        raise KeyError(activation)
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d_direct: shapes {tuple(x.shape)} * {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    geo = geometry(n, h, wd, cin, cout, kh, kw, stride, padding, bn, row_block)
    if geo is None:
        raise ValueError(
            f"conv2d_direct: bn={bn} row_block={row_block} is outside the "
            f"kernel's limits for x {tuple(x.shape)} w {tuple(w.shape)} "
            f"stride {stride} {padding} (see kernels.conv2d.geometry)")
    for t in (x, w):
        if t.device.type != "cuda" or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("conv2d_direct: x and w must be contiguous GPU "
                             "tensors of one dtype")
    if bias is not None:
        if bias.shape != (cout,) or bias.device != x.device:
            raise ValueError("conv2d_direct: bias must be (Cout,) on x's device")
        bias = bias.float().contiguous()       # added in f32, as in Pallas
    out = torch.empty((n, geo.oh, geo.ow, cout), dtype=x.dtype, device=x.device)
    fn = build.load("conv2d")
    err = fn(x.data_ptr(), w.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             n, h, wd, cin, cout, kh, kw, stride, geo.pad_top, geo.pad_left,
             geo.oh, geo.ow, row_block, bn, geo.tm, geo.bc, geo.smem_bytes,
             ACTIVATIONS[activation], _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "conv2d_direct")
    conv2d_direct.launches += 1
    return out


conv2d_direct.launches = 0
