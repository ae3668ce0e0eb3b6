"""Device selection for the port.

Entry points take `device=None` to mean "the GPU": `default_device()`
returns CUDA or raises — it never carries on silently on the CPU.  Callers
that want the CPU (the tests, which run the kernels' plain versions) pass
`device="cpu"` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA device, or RuntimeError when no GPU is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch defaults to the GPU and torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run the plain "
            "PyTorch versions of the kernels")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `default_device()`; anything else is taken as given (a
    CUDA device still requires a GPU)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no GPU is visible")
    return dev


def require_sm90(device: Optional[torch.device] = None) -> tuple:
    """Check that the CUDA device is a Hopper part (compute capability
    9.0, the `sm_90a` target the kernels are built for); returns the
    capability."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a; device capability is {cap}")
    return tuple(cap)
