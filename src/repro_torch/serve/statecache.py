"""Slot-pooled state cache for continuous batching of the state-cache
family — the port of `repro.serve.statecache`.

Mamba2's per-request state does not grow: one depthwise-conv window
(W-1, conv_dim) and one SSM state (nh, hd, n) per layer, the same size at
token 1 and token 10k.  So the cache is a fixed grid of *state rows*; a
request owns exactly one row for its whole residency, and allocation is a
free-list pop.  The rest mirrors `BlockAllocator`:

  * row 0 is the reserved NULL row — idle decode rows point at it, so the
    device-side gathers and scatters need no mask (colliding writes land
    in garbage nobody reads);
  * a preempted request's state is copied to host buffers and its row
    returns to the free list (`swap_out`); resume claims a fresh row —
    possibly another physical id, the index array is the only indirection
    — and the resume commit scatters the host state back;
  * `check_invariants` after every mutation in the property suite, and the
    same trace taxonomy: a row claim / release emits `block_alloc` /
    `block_free` with n=1, so the traceview pool-conservation replay
    audits a slot pool unchanged.

`SlotCapacity` is the family's admission model for the scheduler's
capacity seam: fresh admission reserves nothing — the row is claimed when
the request's first prompt chunk dispatches — so a state pool smaller than
the slot count drives the engine's preemption path instead of blocking
admission.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.platform import DeviceLike, resolve_device
from repro_torch.serve.trace import NULL_RECORDER

NULL_SLOT = 0  # reserved sink row — never allocated to a request


@dataclasses.dataclass(frozen=True)
class StateCacheConfig:
    num_slots: int = 8  # physical pool rows (incl. the null row)

    @property
    def usable(self) -> int:
        return self.num_slots - 1


class SlotAllocator:
    """Free-list allocation of state rows, one per resident request: the
    `BlockAllocator` of a pool whose block is a whole request."""

    def __init__(self, cfg: StateCacheConfig):
        if cfg.num_slots < 2:
            raise ValueError("need at least 2 slots (one is the null row)")
        self.cfg = cfg
        self._free: List[int] = list(range(cfg.num_slots - 1, NULL_SLOT, -1))
        self.owners: Dict[int, int] = {}
        # rid -> rows held at swap-out (always 1; a count, so the
        # scheduler's resume gate reads it as it reads the paged `swapped`)
        self.swapped: Dict[int, int] = {}
        self.trace = NULL_RECORDER

    # ------------------------------------------------------------ queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.cfg.usable - len(self._free)

    def occupancy(self) -> float:
        return self.num_used / self.cfg.usable if self.cfg.usable else 0.0

    def can_allocate(self, n_slots: int = 1) -> bool:
        return n_slots <= len(self._free)

    def holds(self, rid: int) -> bool:
        return rid in self.owners

    def slot_of(self, rid: int) -> int:
        return self.owners[rid]

    # -------------------------------------------------------- alloc / free
    def allocate(self, rid: int) -> int:
        """Claim one state row for request `rid`; returns the row id."""
        if rid in self.owners:
            raise ValueError(f"request {rid} already holds a state slot")
        if rid in self.swapped:
            raise ValueError(f"request {rid} is swapped out; use swap_in")
        if not self._free:
            raise MemoryError(
                f"state pool exhausted: want 1, free {len(self._free)}")
        row = self._free.pop()
        self.owners[rid] = row
        self.trace.emit("block_alloc", rid=rid, n=1, free_after=len(self._free))
        return row

    def free(self, rid: int) -> int:
        """Return rid's state row to the free list."""
        row = self.owners.pop(rid)
        self._free.append(row)
        self.trace.emit("block_free", rid=rid, n=1, free_after=len(self._free))
        return 1

    # ------------------------------------------------------------- swapping
    def swap_out(self, rid: int) -> int:
        """Release rid's row, remembering it held one; the caller saves the
        row's contents first (`SlotStateCache.swap_out`)."""
        if rid in self.swapped:
            raise ValueError(f"request {rid} already swapped out")
        n = self.free(rid)
        self.swapped[rid] = n
        return n

    def swap_in(self, rid: int) -> int:
        """Re-claim a row for a swapped-out request (a fresh physical id);
        raises MemoryError if the pool is dry."""
        if not self.can_allocate(self.swapped[rid]):
            raise MemoryError(
                f"state pool exhausted on swap-in: want "
                f"{self.swapped[rid]}, free {len(self._free)}")
        del self.swapped[rid]
        return self.allocate(rid)

    def check_invariants(self) -> None:
        """Every usable row is either free or owned by exactly one request."""
        owned = list(self.owners.values())
        assert NULL_SLOT not in owned, "null slot leaked into ownership"
        assert NULL_SLOT not in self._free, "null slot leaked into free list"
        combined = sorted(owned + self._free)
        assert combined == list(range(1, self.cfg.num_slots)), (
            f"slot accounting broken: {combined}")
        assert len(set(owned)) == len(owned), "slot double-owned"
        assert not (set(self.swapped) & set(self.owners)), (
            "request both active and swapped out")
        assert all(n == 1 for n in self.swapped.values())


class SlotStateCache:
    """The device pools and the allocator.

    `conv` is (n_layers, num_slots, conv_width-1, conv_dim) and `ssm`
    (n_layers, num_slots, nheads, head_dim, d_state), both f32 on the
    engine's device — the dtype the fixed-batch decode carries, so
    continuous serving compares bitwise with its drain.  The step programs
    update them in place."""

    def __init__(self, cfg: StateCacheConfig, n_layers: int, conv_width: int,
                 conv_dim: int, nheads: int, head_dim: int, d_state: int,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.alloc = SlotAllocator(cfg)
        device = resolve_device(device)
        self.conv = torch.zeros((n_layers, cfg.num_slots, conv_width - 1, conv_dim),
                                device=device)
        self.ssm = torch.zeros((n_layers, cfg.num_slots, nheads, head_dim, d_state),
                               device=device)
        # rid -> (conv_host, ssm_host): a preempted request's state, off
        # the device until its resume commit
        self._swapped: Dict[int, tuple] = {}

    @classmethod
    def for_model(cls, cfg: StateCacheConfig, model_cfg,
                  device: DeviceLike = None, tp=None) -> "SlotStateCache":
        """The pools of a Mamba2 model; under tensor parallelism (`tp`, a
        `distributed.collectives.TensorParallel`) the rank's widths,
        `models.mamba.tp_dims`: conv (L, rows, W-1, d_in / tp + 2n) and
        ssm (L, rows, nh / tp, hd, n)."""
        from repro_torch.models.mamba import tp_dims
        _, nh, conv_dim = tp_dims(model_cfg, tp)
        return cls(cfg, model_cfg.n_layers, model_cfg.conv_width, conv_dim, nh,
                   model_cfg.ssm_head_dim, model_cfg.ssm_state, device=device)

    # ------------------------------------------------------------- swapping
    def is_swapped(self, rid: int) -> bool:
        return rid in self._swapped

    def swap_out(self, rid: int) -> int:
        """Copy rid's state row to host buffers (pinned from a GPU, so the
        resume commit's copies back are asynchronous) and release the row;
        returns the bytes moved."""
        row = self.alloc.owners[rid]
        pin = self.conv.device.type == "cuda"
        conv_host, ssm_host = (torch.empty(pool[:, row].shape, dtype=pool.dtype,
                                           pin_memory=pin).copy_(pool[:, row])
                               for pool in (self.conv, self.ssm))
        self._swapped[rid] = (conv_host, ssm_host)
        nbytes = (conv_host.numel() * conv_host.element_size()
                  + ssm_host.numel() * ssm_host.element_size())
        self.alloc.trace.emit("swap_out", rid=rid, nbytes=nbytes, n_blocks=1)
        self.alloc.swap_out(rid)
        return nbytes

    def take_swapped(self, rid: int):
        """Pop rid's host (conv, ssm) buffers for swap-in; the caller
        scatters them at the freshly claimed row."""
        return self._swapped.pop(rid)

    def index_array(self, slot_rids: List[Optional[int]]) -> np.ndarray:
        """Dense (max_slots,) int32 state-row array for the decode step;
        slots without a resident row-holding request point at the null
        row."""
        out = np.full((len(slot_rids),), NULL_SLOT, np.int32)
        for s, rid in enumerate(slot_rids):
            if rid is not None and rid in self.alloc.owners:
                out[s] = self.alloc.owners[rid]
        return out


class SlotCapacity:
    """The state-cache family's admission model for the scheduler's
    capacity seam.  Fresh admission reserves nothing (the row is claimed
    at the first chunk's dispatch, through the grow-or-preempt path);
    resume re-claims a row up front, gated on the free list as the paged
    resume is gated on blocks."""

    def __init__(self, alloc: SlotAllocator):
        self.alloc = alloc

    def submit_reason(self, req) -> Optional[str]:
        # any single request fits: one row, and the pool has >= 1 usable row
        return None

    def can_admit_fresh(self, req) -> bool:
        return True

    def admit_fresh(self, req) -> None:
        pass

    def can_admit_resume(self, req) -> bool:
        return self.alloc.can_allocate(self.alloc.swapped[req.rid])

    def admit_resume(self, req) -> None:
        self.alloc.swap_in(req.rid)

    def release(self, req) -> None:
        self.alloc.free(req.rid)

    def occupancy(self) -> float:
        return self.alloc.occupancy()
