"""Wrapper of the NHWC convolution (`csrc/conv2d.cu`), the Hopper
counterpart of `repro.kernels.conv2d.conv2d_direct`.

The kernel is an implicit GEMM on the tensor cores (M = N·OH·OW output
pixels, N = Cout, K = Kh·Kw·Cin; bf16 on mma.sync m16n8k16, f32 as 3xTF32
on m16n8k8).  It takes the UNPADDED input and applies SAME padding itself,
by zero-filled loads at TensorFlow's offsets, so no padded copy is
written.  Its launch geometry is decided here, in Python, by `geometry()`:
the schedule template `Conv2dTemplate` validates a configuration with the
same function, so a config the search proposes is one the kernel launches.

Knobs (read at launch): `bn`, the output channels of a tile (16, 32, 64 or
128), and `row_block`, the whole output rows of a tile: a contiguous range
of `row_block`·OW pixels of the flattened M, padded to the tile height
`bm`, the next of 16 / 32 / 64 / 128.  A row wider than 128 pixels is
cut, at row_block 1 only, into 128-pixel ranges.  Valid tiles are those of
`CONV_TILES`: four warps, each owning whole 16 x 16 fragment pairs
(bn 16 needs bm >= 64, bn 32 bm >= 32), at most 64 x 128 or 128 x 64.  K
walks in steps of BK = 32 through a STAGES-slot cp.async ring.  Where the
tile grid leaves SMs idle, K is split (`split`, from the shape alone) and
the last CTA of a tile sums the f32 partials in split order in the same
launch; its int32 counters come from `build.counters("conv2d", ...)`.

A CPU tensor takes `repro_torch.kernels.ref.conv2d_ref`; a CUDA tensor
launches the kernel or raises.  Launches are counted in the plain int
attribute `conv2d_direct.launches` (`build.counted`; a replayed CUDA graph
adds the launches it captured).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import hw
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.matmul import ACTIVATIONS

THREADS = 128                   # four warps
BK = 32                         # K per pipeline step (csrc/conv2d.cu)
STAGES = 3                      # cp.async ring slots
BM_CHOICES = (16, 32, 64, 128)  # tile heights (pixels, padded to 16s)
BN_CHOICES = (16, 32, 64, 128)
ROW_BLOCKS = (1, 2, 4, 8)
# the (bm, bn) tiles `csrc/conv2d.cu` is built with (its CONV_TILES)
CONV_TILES = ((64, 16), (128, 16), (32, 32), (64, 32), (128, 32), (16, 64),
              (32, 64), (64, 64), (128, 64), (16, 128), (32, 128), (64, 128))
SPLIT_WAVES = 2                 # CTAs per SM a split grid aims at
MIN_SPLIT_STEPS = 4             # k-steps a split walks, at least
MAX_SPLIT = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Geometry:
    oh: int
    ow: int
    pad_top: int
    pad_left: int
    bm: int                     # tile height
    rows: int                   # output pixels per tile (<= bm)
    tiles_m: int
    tiles_n: int
    steps: int                  # k-steps of BK
    split: int                  # split-K count S
    smem_bytes: int


def out_size(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    if padding == "VALID":
        return (size - k) // stride + 1
    raise ValueError(f"padding {padding!r}")


def tile_smem_bytes(bm: int, bn: int, itemsize: int) -> int:
    """Dynamic shared memory of a tile: `smem_bytes` of `csrc/conv2d.cu`
    (STAGES slots of A (bm rows of BK + 4 f32 / + 8 bf16) and B (BK rows of
    bn + 8), which the f32 output tile, bm x (bn + 4), reuses)."""
    lda = BK + (4 if itemsize == 4 else 8)
    ring = STAGES * (bm * lda + BK * (bn + 8)) * itemsize
    return max(ring, bm * (bn + 4) * 4)


def split_count(tiles: int, steps: int, sms: int = hw.H100.sms) -> int:
    """Split-K count of a grid of `tiles` output tiles over `steps` k-steps:
    1 where the tiles alone give every SM a CTA; otherwise as many splits
    as keep the grid within SPLIT_WAVES CTAs per SM, each at least
    MIN_SPLIT_STEPS k-steps, at most MAX_SPLIT, then evened out so that
    every split has whole k-steps and none is empty."""
    if tiles >= sms:
        return 1
    split = max(1, min(SPLIT_WAVES * sms // tiles, steps // MIN_SPLIT_STEPS, MAX_SPLIT))
    return -(-steps // -(-steps // split))


@functools.lru_cache(maxsize=4096)
def geometry(n: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
             stride: int, padding: str, bn: int, row_block: int,
             chip: hw.Chip = hw.H100, itemsize: int = 4) -> Optional[Geometry]:
    """The kernel's launch geometry for one configuration, or None when the
    configuration is outside the kernel's limits: an unknown bn or
    row_block, row_block > 1 rows of more than 128 pixels, a (bm, bn) tile
    the library is not built with, more Cout tiles than a grid's y
    dimension holds, or a ring that does not fit the chip's shared memory.

    Registers are not a limit a configuration can break: the kernel is
    compiled with `__launch_bounds__(128)` and every tile's accumulators
    fit (ptxas -v reports the registers and any spill; PERF.md has
    them).  The split depends on the shape and the tile alone, never on
    the data, so a launch is capturable in a CUDA graph."""
    if bn not in BN_CHOICES or row_block not in ROW_BLOCKS:
        return None
    oh, ow = out_size(h, kh, stride, padding), out_size(w, kw, stride, padding)
    if oh < 1 or ow < 1:
        return None
    m = n * oh * ow
    rows = min(row_block * ow, m)
    if rows > BM_CHOICES[-1]:
        if row_block > 1:
            return None
        rows = BM_CHOICES[-1]
    bm = next(b for b in BM_CHOICES if b >= rows)
    smem = tile_smem_bytes(bm, bn, itemsize)
    tiles_m, tiles_n = -(-m // rows), -(-cout // bn)
    if (bm, bn) not in CONV_TILES or smem > chip.smem_per_block or \
            THREADS > chip.max_threads_per_block or tiles_n > chip.max_grid_y:
        return None
    steps = -(-kh * kw * cin // BK)
    split = split_count(tiles_m * tiles_n, steps, chip.sms)
    pad_top = pad_left = 0
    if padding == "SAME":
        pad_top, pad_left = _ref.same_pads(h, kh, stride)[0], _ref.same_pads(w, kw, stride)[0]
    return Geometry(oh, ow, pad_top, pad_left, bm, rows, tiles_m, tiles_n, steps,
                    split, smem)


def default_config(n, h, w, cin, cout, kh, kw, stride, padding) -> dict:
    """A valid configuration for a conv the plan did not tune: the
    narrowest bn that covers Cout up to 64, with the fewest output rows per
    tile that the tile takes; bn 64 at row_block 1 is valid for every
    shape."""
    first = next(b for b in BN_CHOICES if b >= min(cout, 64))
    for bn in (first,) + tuple(b for b in BN_CHOICES if b > first):
        for rb in ROW_BLOCKS:
            if geometry(n, h, w, cin, cout, kh, kw, stride, padding, bn, rb):
                return {"bn": bn, "row_block": rb}
    return {"bn": 64, "row_block": 1}


@build.counted
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
    limits = (f"conv2d_direct: bn={bn} row_block={row_block} is outside the "
              f"kernel's limits for x {tuple(x.shape)} w {tuple(w.shape)} "
              f"stride {stride} {padding} (see kernels.conv2d.geometry)")
    if bn not in BN_CHOICES or row_block not in ROW_BLOCKS:
        raise ValueError(limits)
    for t in (x, w):
        if t.device.type != "cuda" or t.dtype != x.dtype or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("conv2d_direct: x and w must be contiguous, 16-byte "
                             "aligned GPU tensors of one dtype")
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    geo = geometry(n, h, wd, cin, cout, kh, kw, stride, padding, bn, row_block,
                   itemsize=x.element_size())
    if geo is None:
        raise ValueError(limits)
    if bias is not None:
        if bias.shape != (cout,) or bias.device != x.device:
            raise ValueError("conv2d_direct: bias must be (Cout,) on x's device")
        bias = bias.float().contiguous()       # added in f32, as in Pallas
    out = torch.empty((n, geo.oh, geo.ow, cout), dtype=x.dtype, device=x.device)
    ws = counters = None
    if geo.split > 1:
        ws = torch.empty((geo.split, out.numel()), dtype=torch.float32, device=x.device)
        counters = build.counters("conv2d", x.device, geo.tiles_m * geo.tiles_n)
    fn = build.load("conv2d")
    err = fn(x.data_ptr(), w.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             n, h, wd, cin, cout, kh, kw, stride, geo.pad_top, geo.pad_left,
             geo.oh, geo.ow, geo.bm, bn, geo.rows, geo.split,
             ACTIVATIONS[activation], _DTYPES[x.dtype],
             ws.data_ptr() if ws is not None else None,
             counters.data_ptr() if counters is not None else None,
             torch._C._cuda_getCurrentRawStream(x.device.index))
    build.check(err, "conv2d_direct")
    conv2d_direct.launches += 1
    return out
