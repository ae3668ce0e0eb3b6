"""Shared model building blocks (the port of `repro.models.common`).

Parameters are plain dicts of tensors laid out as the JAX package lays
them out (`dense` weights (d_in, d_out) used as `x @ w`), so a JAX params
tree converts leaf for leaf (`repro_torch.bridge`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    return {"w": w}


def dense(p: Params, x: torch.Tensor, role: Optional[str] = None,
          activation: Optional[str] = None) -> torch.Tensor:
    """Projection `x @ w`, routable through the plan's matmul lanes by
    `role` ('qkv_proj' / 'mlp_up' / 'mlp_down' / 'lm_head'); `activation`
    rides in the hand-written GEMM's epilogue (applied after the product on
    the torch lane).  With no role and no activation this is `x @ w`."""
    w = p["w"].to(x.dtype)
    if role is None and activation is None:
        return x @ w
    from repro_torch.kernels.dispatch import dispatch_dense
    return dispatch_dense(role, x, w, activation=activation)


def norm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, -1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a device tensor built from it would be a
    # host-to-device copy that waits for the GPU at every layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  Rotates the
    two halves of the head dim (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    angles = angles[..., None, :]                              # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> Params:
    return {"emb": torch.randn((vocab, d), generator=gen, device=gen.device) * 0.01}


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["emb"].to(dtype)[tokens.long()]


def lm_head_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """LM head projection `x @ w` (w: (d_model, vocab)), role-tagged so the
    plan's `lm_head` choice dispatches it."""
    return dense(p, x, role="lm_head")
