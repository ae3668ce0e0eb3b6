"""int8 gradient compression for cross-pod reductions — the port of
`repro.optim.compress`.

`int8_compress` / `int8_decompress` are the reference's per-tensor
symmetric quantisation (round half to even, clip to ±127, scale = max|x| /
127 + 1e-12).  `compressed_allgather_mean(x, axis_name)` is the mean over
a mesh axis with int8 on the wire: every rank's int8 payload and f32
scale are all-gathered over the axis (exact bytes), dequantised and
averaged, as the reference computes under `shard_map`.  The axis name is
bound by `distributed.collectives.mesh_axes` (the train step binds its
mesh's axes); an unbound name raises NameError.  As in the reference,
nothing in the train step calls it (`TrainConfig.compress_pod_grads` is a
field no step reads).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.collectives import axis_group


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_allgather_mean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Mean over mesh axis `axis_name` using an int8 all-gather: (the
    ranks' int8 payloads, (P, *x.shape), and scales, (P,)) gathered in rank
    order, dequantised in f32, averaged over the P ranks, cast to x's
    dtype.  On a 1-wide axis the rank's own dequantised tensor."""
    q, scale = int8_compress(x)
    group = axis_group(axis_name)
    if group is None:
        qs, ss = q[None], scale.reshape(1)
    else:
        qs, ss = group._gather(q), group._gather(scale.reshape(1))
    deq = qs.float() * ss.reshape((-1,) + (1,) * x.dim())
    return torch.mean(deq, dim=0).to(x.dtype)
