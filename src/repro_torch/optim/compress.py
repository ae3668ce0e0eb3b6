"""int8 gradient compression for cross-pod reductions — the port of
`repro.optim.compress`.

`int8_compress` / `int8_decompress` are the reference's per-tensor
symmetric quantisation (round half to even, clip to ±127, scale = max|x| /
127 + 1e-12).  `compressed_allgather_mean` is a collective over a mesh
axis; the port has no mesh yet, so it raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

COLLECTIVES_NOT_PORTED = ("compressed_allgather_mean needs a collective over "
                          "a mesh axis, which is not ported yet: ROADMAP.md "
                          "queue 1, item 8c (TP training)")


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_allgather_mean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Mean over `axis_name` by an int8 all-gather (not ported)."""
    raise NotImplementedError(COLLECTIVES_NOT_PORTED)
