"""Token selection at the end of the serving step (the port of
`repro.kernels.sampling.sample_tokens`).

Conventions are the JAX package's: `sampling` is (rows, 3) float32
[temperature, top_k, top_p] and `keys` is (rows, 3) int32 [seed, rid,
token_index].  A temperature <= 0 row is greedy: `argmax`, the first index
on ties, exactly the reference's.  Keyed sampling (temperature > 0) needs
jax.random's threefry2x32 key derivation and categorical draw ported bit
for bit; until then such rows raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

KEYED_SAMPLING_TODO = ("keyed sampling (temperature > 0) is not ported yet: "
                       "see the 'Keyed sampling' item of ROADMAP.md, queue 1 "
                       "(port threefry2x32 PRNGKey/fold_in and categorical)")


def check_sampling(sampling) -> None:
    """The host half: raise NotImplementedError(KEYED_SAMPLING_TODO) when a
    row of the (rows, 3) `sampling` array asks for keyed sampling
    (temperature > 0).  The serving adapter calls it on the host arrays
    before every step, since a replayed CUDA graph runs no Python."""
    temps = np.asarray(sampling.cpu() if isinstance(sampling, torch.Tensor)
                       else sampling, np.float32)[:, 0]
    if (temps > 0).any():
        raise NotImplementedError(KEYED_SAMPLING_TODO)


def greedy_tokens(logits: torch.Tensor, sampling, keys) -> torch.Tensor:
    """The device half: (rows, V) logits -> (rows,) int32 argmax, reading
    nothing back to the host, so a captured step program can run it.
    `sampling` and `keys` are the step's inputs that keyed sampling will
    read; greedy rows need neither."""
    del sampling, keys
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, sampling, keys) -> torch.Tensor:
    """(rows, V) logits + (rows, 3) sampling + (rows, 3) keys -> (rows,)
    int32 next tokens: `check_sampling`, then `greedy_tokens`."""
    check_sampling(sampling)
    return greedy_tokens(logits, sampling, keys)
