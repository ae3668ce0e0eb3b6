"""Wrapper of the tiled GEMM with fused epilogue (`csrc/matmul.cu`), the
Hopper counterpart of `repro.kernels.matmul.matmul_padded`.

The kernel masks ragged M/N/K edges itself, so nothing is padded here.  A
CPU tensor takes `repro_torch.kernels.ref.matmul_ref`; a CUDA tensor
launches the kernel or raises.  Launches are counted in the plain int
attribute `matmul_fused.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

ACTIVATIONS = {None: 0, "none": 0, "identity": 0, "relu": 1, "silu": 2,
               "gelu": 3, "tanh": 4, "sigmoid": 5}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_fused(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """act(x (M, K) @ w (K, N) + bias (N,)) with an f32 accumulator and one
    rounding to `out_dtype` (default, and on the GPU the only choice:
    x's dtype)."""
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
    fn = build.load("matmul")
    err = fn(x.data_ptr(), w.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             m, n, k, ACTIVATIONS[activation], _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "matmul_fused")
    matmul_fused.launches += 1
    return out


matmul_fused.launches = 0
