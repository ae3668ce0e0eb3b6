"""Wrapper of the tiled GEMM with fused epilogue (`csrc/matmul.cu`), the
Hopper counterpart of `repro.kernels.matmul.matmul_padded`.

The kernel masks ragged M/N/K edges itself, so nothing is padded here.  A
CPU tensor takes `repro_torch.kernels.ref.matmul_ref`; a CUDA tensor
launches the kernel or raises.  Launches are counted in the plain int
attribute `matmul_fused.launches` (`build.counted`; a replayed CUDA graph
adds the launches it captured).

The launch geometry — the tile and the split-K count — is a function of
host integers alone, so a call reads nothing back from the device and
stays capturable in a CUDA graph: by default of (M, N, K) and the dtype
(`gemm_geometry`); a tuned plan's (tile_m, split_k) pair goes through
`geometry`, which returns None for a pair the kernel cannot launch.  A
split launch takes an f32 workspace (`torch.empty` per call) and one
int32 counter per output tile from a per-device buffer that is zeroed
once when it is allocated: the kernel leaves every counter at zero.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch import hw
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

ACTIVATIONS = {None: 0, "none": 0, "identity": 0, "relu": 1, "silu": 2,
               "gelu": 3, "tanh": 4, "sigmoid": 5}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The tiles `csrc/matmul.cu` is built with (its BF16_TILES and F_BM / F_BN /
# F_BK): tile height -> (bm, bn, bk, stages).
GEMM_TILES = {16: (16, 128, 64, 4), 64: (64, 128, 64, 4), 128: (128, 128, 64, 3)}
GEMM_TILE_F32 = (64, 64, 16, 1)
# threads per CTA: WM x WN warps of the bf16 tiles (BF16_TILES), F_THREADS
GEMM_THREADS = {16: 128, 64: 256, 128: 256}
GEMM_THREADS_F32 = 256
SMALL_M = 16             # M <= SMALL_M takes the 16-row tile
LARGE_BM = 64            # the tile height for larger M, unless 128 fills the chip
SPLIT_WAVES = 2          # CTAs per SM a grid aims at (two fit: one resident wave)


class GemmGeometry(NamedTuple):
    bm: int              # output rows per CTA
    bn: int              # output columns per CTA
    bk: int              # K per pipeline step
    stages: int          # cp.async ring slots (1: the f32 tile, unpipelined)
    split: int           # split-K count S

    def ctas(self, m: int, n: int) -> int:
        return -(-m // self.bm) * -(-n // self.bn) * self.split

    def steps_per_split(self, k: int) -> int:
        steps = -(-k // self.bk)
        return -(-steps // self.split)


@functools.lru_cache(maxsize=4096)
def gemm_geometry(m: int, n: int, k: int, dtype: torch.dtype) -> GemmGeometry:
    """The launch geometry of an (M, K) @ (K, N) product on the H100, from
    the shape alone.

    The tile (bf16): 16 rows for M <= 16; for larger M, 128 rows when that
    grid alone gives SPLIT_WAVES CTAs per SM (fewer re-reads of the weight
    tiles), else 64.  f32 has one tile.

    The split S: 1 when the tile grid alone fills the 132 SMs; otherwise as
    many splits as keep the grid within SPLIT_WAVES CTAs per SM (two CTAs
    of every tile fit an SM, so that is one resident wave: a grid past it
    leaves a tail of CTAs running on a few SMs), capped so that the f32
    partials (S x M x N x 4 bytes) take no more than the weights (K x N x
    itemsize); each split is a whole number of k-steps and none is
    empty."""
    sms = hw.H100.sms
    if dtype.itemsize == 2:
        big = -(-m // 128) * -(-n // GEMM_TILES[128][1])
        bm = SMALL_M if m <= SMALL_M else (128 if big >= SPLIT_WAVES * sms
                                           else LARGE_BM)
        bm, bn, bk, stages = GEMM_TILES[bm]
    else:
        bm, bn, bk, stages = GEMM_TILE_F32
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // bk)
    split = 1
    if tiles < sms:
        split = max(1, SPLIT_WAVES * sms // tiles)
        split = max(1, min(split, (k * dtype.itemsize) // (4 * m), steps))
        split = -(-steps // -(-steps // split))      # none empty
    return GemmGeometry(bm, bn, bk, stages, split)


def tile_smem_bytes(geo: GemmGeometry, itemsize: int) -> int:
    """Shared memory of one CTA: `bf16_smem` of `csrc/matmul.cu` (the
    ring of `stages` (x, w) slots, rows padded by 8, which the f32 output
    tile reuses) for bf16; the f32 tile's static F_BM x (F_BN + 4) floats."""
    if itemsize == 4:
        return geo.bm * (geo.bn + 4) * 4
    ring = geo.stages * (geo.bm * (geo.bk + 8) + geo.bk * (geo.bn + 8)) * 2
    return max(ring, geo.bm * (geo.bn + 4) * 4)


def tile_threads(geo: GemmGeometry, itemsize: int) -> int:
    return GEMM_THREADS_F32 if itemsize == 4 else GEMM_THREADS[geo.bm]


def tile_heights(dtype: torch.dtype) -> tuple:
    """The tile heights the library is built with for `dtype`."""
    return tuple(sorted(GEMM_TILES)) if dtype.itemsize == 2 else (GEMM_TILE_F32[0],)


def geometry(m: int, n: int, k: int, dtype: torch.dtype, tile_m: int,
             split_k: int) -> Optional[GemmGeometry]:
    """The launch geometry of an (M, K) @ (K, N) product at a chosen tile
    height and split count, or None where the kernel cannot launch the
    pair: a height the library is not built with for `dtype`, a split
    outside 1 .. the k-steps of that tile, an empty split, f32 partials
    (S x M x N x 4 bytes) past the weights' K x N x itemsize (the cap
    `gemm_geometry` applies), or more column tiles than a grid's y
    dimension holds."""
    if tile_m not in tile_heights(dtype):
        return None
    bm, bn, bk, stages = GEMM_TILES[tile_m] if dtype.itemsize == 2 else GEMM_TILE_F32
    steps = -(-k // bk)
    if not 1 <= split_k <= steps or -(-steps // -(-steps // split_k)) != split_k:
        return None
    if split_k > 1 and split_k * m * 4 > k * dtype.itemsize:
        return None
    if -(-n // bn) > hw.H100.max_grid_y:
        return None
    return GemmGeometry(bm, bn, bk, stages, split_k)


@build.counted
def matmul_fused(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None,
                 geometry: Optional[GemmGeometry] = None) -> torch.Tensor:
    """act(x (M, K) @ w (K, N) + bias (N,)) with an f32 accumulator and one
    rounding to `out_dtype` (default, and on the GPU the only choice:
    x's dtype).  `geometry` (from `geometry`) launches that tile and
    split; without it, `gemm_geometry`'s."""
    if x.device.type == "cpu":
        return _ref.matmul_ref(x, w, bias, activation, out_dtype)
    if x.dtype not in _DTYPES:
        raise TypeError(f"matmul_fused: dtype {x.dtype} not supported")
    if out_dtype not in (None, x.dtype):
        raise TypeError("matmul_fused: the kernel writes x's dtype")
    if activation not in ACTIVATIONS:
        raise KeyError(activation)
    operands = [x, w] + ([bias] if bias is not None else [])
    for t in operands:
        if t.device.type != "cuda" or t.dtype != x.dtype:
            raise ValueError("matmul_fused: operands must be GPU tensors of one dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("matmul_fused: operands must be contiguous and "
                             "16-byte aligned")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_fused: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and bias.shape != (n,):
        raise ValueError("matmul_fused: bias must be (N,)")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    geo = geometry or gemm_geometry(m, n, k, x.dtype)
    ws = counters = None
    if geo.split > 1:
        ws = torch.empty((geo.split, m, n), dtype=torch.float32, device=x.device)
        counters = build.counters("matmul", x.device, -(-m // geo.bm) * -(-n // geo.bn))
    fn = build.load("matmul")
    err = fn(x.data_ptr(), w.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             m, n, k, ACTIVATIONS[activation], _DTYPES[x.dtype], *geo,
             ws.data_ptr() if ws is not None else None,
             counters.data_ptr() if counters is not None else None,
             torch._C._cuda_getCurrentRawStream(x.device.index))
    build.check(err, "matmul_fused")
    matmul_fused.launches += 1
    return out
