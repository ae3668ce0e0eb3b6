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


def sample_tokens(logits: torch.Tensor, sampling, keys) -> torch.Tensor:
    """(rows, V) logits + (rows, 3) sampling + (rows, 3) keys -> (rows,)
    int32 next tokens."""
    del keys
    temps = np.asarray(sampling.cpu() if isinstance(sampling, torch.Tensor)
                       else sampling, np.float32)[:, 0]
    if (temps > 0).any():
        raise NotImplementedError(KEYED_SAMPLING_TODO)
    return torch.argmax(logits, dim=-1).to(torch.int32)
