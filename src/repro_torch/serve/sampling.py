"""Per-request sampling policy: `SamplingParams` and the host-side packing
(the port of `repro.serve.sampling`).

  * `SamplingParams` — the submit-time knobs a request carries through its
    whole life.  temperature=0 (the default) is greedy argmax.
  * array builders — pack per-slot / per-segment / per-batch (rows, 3)
    float32 sampling and (rows, 3) int32 [seed, rid, token_index] key
    arrays, the conventions of `repro_torch.kernels.sampling`.  Rows
    without an active sampled request are greedy.
  * `sample_host` — the step programs' sampler called on its own, for
    `FixedBatchEngine`: the same routine, so its tokens equal the
    programs' on equal logits.
  * `truncate_at_eos` — the one stop-at-first-eos definition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.sampling import sample_tokens

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Submit-time sampling knobs for one request.

    temperature: 0 (default) = greedy argmax; > 0 scales the logits before
        the draw.
    top_k: keep only the k largest logits (0 = off).
    top_p: keep the minimal nucleus of tokens covering probability mass
        top_p (1.0 = off).
    seed: the request's stream seed; token i is drawn under the key
        (seed, rid, i).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def invalid_reason(self) -> Optional[str]:
        """Reject reason, or None when the params are servable."""
        if not math.isfinite(self.temperature) or self.temperature < 0:
            return f"temperature must be finite and >= 0, got {self.temperature}"
        if self.top_k < 0:
            return f"top_k must be >= 0, got {self.top_k}"
        if not (0.0 < self.top_p <= 1.0):
            return f"top_p must be in (0, 1], got {self.top_p}"
        if not (0 <= self.seed <= _INT32_MAX):
            return f"seed must fit int32 (0 <= seed < 2**31), got {self.seed}"
        return None


GREEDY = SamplingParams()


# ------------------------------------------------------------ array packing
def _greedy_arrays(rows: int) -> Tuple[np.ndarray, np.ndarray]:
    sp = np.zeros((rows, 3), np.float32)
    sp[:, 2] = 1.0                        # top_p off
    ks = np.zeros((rows, 3), np.int32)
    return sp, ks


def _fill_row(sp: np.ndarray, ks: np.ndarray, i: int, s: SamplingParams,
              rid: int, token_index: int) -> None:
    sp[i, 0] = s.temperature
    sp[i, 1] = float(s.top_k)
    sp[i, 2] = s.top_p
    ks[i, 0] = s.seed
    ks[i, 1] = rid
    ks[i, 2] = token_index


def slot_sampling_arrays(slots) -> Tuple[np.ndarray, np.ndarray]:
    """Decode-lane arrays for the continuous engine: one row per slot.
    Empty and still-prefilling slots stay greedy with a zero key.  The token
    index is the request's current output length."""
    sp, ks = _greedy_arrays(len(slots))
    for i, req in enumerate(slots):
        if req is None or req.prefilling:
            continue
        _fill_row(sp, ks, i, req.sampling, req.rid, len(req.output))
    return sp, ks


def segment_sampling_arrays(chunks: Sequence[tuple],
                            n_segments: int) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk-lane arrays: one row per packed segment slot, token index 0
    (a segment's sample is its request's first token).  Idle segment slots
    are greedy."""
    sp, ks = _greedy_arrays(n_segments)
    for i, (req, _start, _n) in enumerate(chunks):
        _fill_row(sp, ks, i, req.sampling, req.rid, 0)
    return sp, ks


def batch_sampling_arrays(reqs, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-batch arrays at token index 0 (the prefill sample); the drain
    loop advances column 2 in place per decode iteration.  Padding rows
    past len(reqs) are greedy."""
    sp, ks = _greedy_arrays(width)
    for i, r in enumerate(reqs):
        _fill_row(sp, ks, i, r.sampling, r.rid, 0)
    return sp, ks


# ------------------------------------------------------------- host sampler
def sample_host(logits: torch.Tensor, sampling: np.ndarray,
                keys: np.ndarray) -> torch.Tensor:
    """The keyed sampler for the fixed-batch engine: `sample_tokens` on the
    logits' device, (rows,) int32 tokens there."""
    return sample_tokens(logits, sampling, keys)


# ------------------------------------------------------------ eos semantics
def truncate_at_eos(seq: Sequence[int], eos_id: int) -> List[int]:
    """Stop-at-first-eos: tokens past the first eos are dropped (the eos
    itself stays); eos_id < 0 disables early stopping."""
    seq = list(seq)
    if eos_id < 0 or eos_id not in seq:
        return seq
    return seq[: seq.index(eos_id) + 1]
