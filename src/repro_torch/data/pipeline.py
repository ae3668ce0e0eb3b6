"""Deterministic, index-based synthetic LM data pipeline — a numpy copy of
`repro.data.pipeline`, equal to it bit for bit.

Fault-tolerance contract: the pipeline is STATELESS given the step index —
`batch(step)` is a pure function, so restoring a job means restoring one
integer.  Sharding contract: `batch(step, shard, n_shards)` returns only this
host's rows, identical to slicing the global batch — elastic restarts with a
different host count re-shard without skipping or repeating data.

The token stream is a counter-based hash (splitmix-style), which is both
reproducible and cheap; a next-token structure (label = cyclic function of
token) gives training a learnable signal so convergence tests are
meaningful.  Batches are numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    learnable: bool = True   # labels follow a fixed next-token rule


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


class SyntheticLMData:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"into {n_shards} shards")
        rows = cfg.global_batch // n_shards
        row0 = shard * rows
        # counter grid: (row, position) -> token
        r = (np.arange(rows) + row0 + step * cfg.global_batch).astype(np.uint64)
        p = np.arange(cfg.seq_len + 1, dtype=np.uint64)
        ctr = r[:, None] * np.uint64(1_000_003) + p[None, :] + np.uint64(cfg.seed) * np.uint64(7_919)
        toks = (_splitmix(ctr) % np.uint64(cfg.vocab)).astype(np.int64)
        if cfg.learnable:
            # next token is a fixed affine function of the current one:
            # perfectly learnable structure -> loss must fall.
            base = toks[:, :1]
            offs = np.arange(cfg.seq_len + 1, dtype=np.int64)
            toks = (base + offs * 17) % cfg.vocab
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def state_dict(self, step: int) -> Dict[str, int]:
        return {"step": int(step), "seed": self.cfg.seed}

    @staticmethod
    def restore_step(state: Dict[str, int]) -> int:
        return int(state["step"])
