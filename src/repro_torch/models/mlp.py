"""Dense (gated) MLP — the port of `repro.models.mlp.mlp_init` / `mlp_apply`.
The mixture-of-experts layer is a later slice."""

from __future__ import annotations

import torch

from repro_torch.models.common import Params, dense, dense_init


def mlp_init(gen: torch.Generator, d: int, f: int, gated: bool = True) -> Params:
    p = {"w_in": dense_init(gen, d, f), "w_out": dense_init(gen, f, d)}
    if gated:
        p["w_gate"] = dense_init(gen, d, f)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    # role-tagged for the plan's stage matmul dispatch; the gate's
    # activation rides in the hand-written GEMM's epilogue (the torch lane
    # applies it after the product)
    if "w_gate" in p:
        h = dense(p["w_in"], x, role="mlp_up")
        h = dense(p["w_gate"], x, role="mlp_up", activation=act) * h
    else:
        h = dense(p["w_in"], x, role="mlp_up", activation=act)
    return dense(p["w_out"], h, role="mlp_down")
