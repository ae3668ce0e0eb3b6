"""The engine/model-family seam — the port of `resolve_family_adapter` and
`DecoderFamilyAdapter` from `repro.serve.family`.

`ContinuousEngine` is family-agnostic orchestration; the adapter owns what
the family's per-request device state is.  For attention decoders that is
the paged KV pool (`PagedKVCache`), its block tables, the two step
programs (`_unified` / `_decode_only`, from `steps.graph_unified_step` /
`steps.graph_decode_only_step`) and the resume-commit and copy-on-write
programs (`_commit` / `_cow`): on a CUDA device each is captured in a CUDA
graph at its first call and replayed by every later one.  Given a
tensor-parallel context (`tp`), the pool holds the rank's KV heads and the
programs run the rank's shards eagerly.  The adapter
protocol is the JAX package's (see `repro.serve.family`): `family`,
`chunk_width`, `chunk_segments`, `resume_segments`, `cache`, `alloc`,
`capacity()`, `victim_eligible`, `grow_for_decode`, `claim_chunk`,
`register_prefix`, `is_swapped`, `swap_out`, `resume_commit`, `dispatch`,
`occupancy`.

`SSMFamilyAdapter` serves the state-cache family (`zoo.MambaLM`): the pool
is a `SlotStateCache` grid of fixed-size state rows, the block table
degenerates to one row index per slot, nothing grows during decode, and a
request's row is claimed when its first prompt chunk dispatches — so a
state pool smaller than the slot count drives the engine's preemption
path.  Its three programs (`steps.graph_ssm_unified_step`,
`graph_ssm_decode_only_step`, `graph_ssm_commit_state`) are captured and
replayed like the decoder's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.collectives import TensorParallel
from repro_torch.launch import steps
from repro_torch.models.common import torch_dtype
from repro_torch.serve.kvcache import NULL_BLOCK, PagedKVCache
from repro_torch.serve.router import PlanRouter, serve_stages
from repro_torch.serve.sampling import segment_sampling_arrays
from repro_torch.serve.scheduler import PagedCapacity, ServeRequest
from repro_torch.serve.statecache import SlotCapacity, SlotStateCache


def resolve_family_adapter(model):
    """The adapter class serving `model`, by capability probe: the ssm
    slot-pooled entry points first (`decode_step_slots`), then the paged
    decode path.  Raises TypeError for families with neither — they serve
    through the fixed-batch `ServeEngine`."""
    if getattr(model.cfg, "family", None) == "ssm" and hasattr(
            model, "decode_step_slots"):
        return SSMFamilyAdapter
    if hasattr(model, "decode_step_paged"):
        return DecoderFamilyAdapter
    raise TypeError(
        f"{type(model).__name__} has no paged decode path; use the "
        "fixed-batch ServeEngine for this family")


def _graph_pool(cfg, device: torch.device):
    """One CUDA graph memory pool for an adapter's programs (they never run
    at the same time), or None where nothing is captured."""
    return (torch.cuda.graph_pool_handle()
            if cfg.cuda_graphs and device.type == "cuda" else None)


class DecoderFamilyAdapter:
    """Paged-KV family: block-table bookkeeping + the paged step functions."""

    family = "decoder"

    def __init__(self, model, cfg, router: PlanRouter, device: torch.device,
                 tp: Optional[TensorParallel] = None):
        mcfg = model.cfg
        self.model = model
        self.device = device
        self.kv_cfg = cfg.kv_config()
        # born sharded: under tensor parallelism the rank's pool holds the
        # KV heads of its own projections (`DecoderLM.tp_kv_heads`); the
        # block tables, allocator and scheduler are the same on every rank
        n_kv = mcfg.n_kv_heads if tp is None else model.tp_kv_heads(tp)[1]
        self.cache = PagedKVCache(self.kv_cfg, mcfg.n_layers, n_kv,
                                  mcfg.hd, torch_dtype(mcfg.dtype), device=device)
        # the prefill lane's token budget and its packed-segment height: the
        # engine's packing width narrowed by the plan's tuned max_segments
        self.chunk_width = cfg.chunk_width
        self.chunk_segments = max(1, min(
            cfg.chunk_segments,
            router.chunk_segments(default=cfg.chunk_segments)))
        self.resume_segments = self.chunk_segments
        # per-lane backends and matmul tables from the plan's stage choices
        decode_backend, _ = router.attention_backend("decode")
        chunk_backend, chunk_config = router.attention_backend("prefill_chunk")
        self._decode_kw = dict(
            decode_attn_backend=decode_backend,
            decode_matmul_table=router.matmul_table("decode"))
        self._chunk_kw = dict(
            chunk_attn_backend=chunk_backend, chunk_attn_config=chunk_config,
            chunk_matmul_table=router.matmul_table("prefill_chunk"))
        # THE two step programs, with the lanes baked in; they never run at
        # the same time, so their graphs share one memory pool.  Under
        # tensor parallelism the steps run eagerly (see launch/steps.py)
        graphed = cfg.cuda_graphs and tp is None
        pool = _graph_pool(cfg, device) if graphed else None
        self._unified = steps.graph_unified_step(
            model, device, graphed=graphed, pool=pool, tp=tp,
            **self._decode_kw, **self._chunk_kw)
        self._decode_only = steps.graph_decode_only_step(
            model, device, graphed=graphed, pool=pool, tp=tp, **self._decode_kw)
        # the resume commit, at one padded shape (see `resume_commit`), and
        # the copy-on-write: two more programs, captured at their first
        # call, never at admission
        self._commit = steps.graph_commit_prefill(
            device, graphed=graphed, pool=pool)
        self._cow = steps.graph_cow_block(device, graphed=graphed, pool=pool)
        # the commit program's K / V inputs (L, resume_segments,
        # max_blocks_per_seq * block_size, Hkv, hd), allocated at the first
        # commit and filled in place; and the bytes the last commit copied
        # from the host
        self._commit_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.last_commit_h2d_bytes = 0
        # the last unified step's per-segment logits (S, V), for callers
        # that inspect the first-token margins: the unified program's
        # output buffer, valid until its next step
        self.last_seg_logits: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- capacity
    @property
    def alloc(self):
        return self.cache.alloc

    def capacity(self) -> PagedCapacity:
        return PagedCapacity(self.kv_cfg, self.cache.alloc)

    # every resident holds blocks from admission: any victim frees capacity
    victim_eligible = None

    def _cow_rows(self, req: ServeRequest, lo_row: int, hi_row: int) -> bool:
        """Copy-on-write every shared block whose rows intersect
        [lo_row, hi_row) before a write lands there.  False when the pool
        runs dry mid-way (the engine preempts a victim and retries)."""
        if not self.kv_cfg.prefix_sharing or hi_row <= lo_row:
            return True
        bs = self.kv_cfg.block_size
        for bi in range(lo_row // bs, (hi_row - 1) // bs + 1):
            try:
                copied = self.cache.alloc.cow(req.rid, bi)
            except MemoryError:
                return False
            if copied is not None:
                src, dst = copied
                self._cow((self.cache.k, self.cache.v),
                          (np.array([src], np.int32), np.array([dst], np.int32)))
        return True

    def grow_for_decode(self, req: ServeRequest, need_rows: int) -> bool:
        """Extend req's table to cover its next decode write (row
        need_rows - 1), privatizing that block if it is shared."""
        if not self.cache.alloc.extend(req.rid, need_rows):
            return False
        return self._cow_rows(req, need_rows - 1, need_rows)

    def claim_chunk(self, req: ServeRequest, start: int, n: int) -> bool:
        """Copy-on-write any adopted block the chunk's rows would land in."""
        return self._cow_rows(req, start, start + n)

    def register_prefix(self, req: ServeRequest) -> None:
        if self.kv_cfg.prefix_sharing:
            self.cache.alloc.register_prefix(
                req.rid, req.prompt, min(req.prefilled, req.prompt_len))

    # ------------------------------------------------------------- swapping
    def is_swapped(self, rid: int) -> bool:
        return self.cache.is_swapped(rid)

    def swap_out(self, rid: int) -> int:
        return self.cache.swap_out(rid)

    def resume_commit(self, group: List[ServeRequest]) -> List[int]:
        """Swap up to `resume_segments` re-admitted requests' KV back in with
        one commit: every segment padded to the full table width and the
        group to the full segment count, as the reference pads, so the
        commit program has one signature.  Only the swapped blocks cross
        the bus: each request's pinned host buffers are copied into its
        segment's rows of the program's K / V inputs, and the padding rows
        keep whatever an earlier commit left there — their block ids point
        at the null sink, whose contents are unspecified.  Returns the
        bytes moved per request."""
        assert 0 < len(group) <= self.resume_segments
        bs = self.kv_cfg.block_size
        nb_pad = self.kv_cfg.max_blocks_per_seq
        n_seg = self.resume_segments
        hosts = [self.cache.take_swapped(r.rid) for r in group]
        pool = self.cache.k
        n_layers = pool.shape[0]
        if self._commit_kv is None:
            shape = (n_layers, n_seg, nb_pad * bs, *pool.shape[3:])
            self._commit_kv = tuple(torch.zeros(shape, dtype=pool.dtype,
                                                device=self.device)
                                    for _ in range(2))
        ks, vs = self._commit_kv
        ids = np.full((n_seg, nb_pad), NULL_BLOCK, np.int32)
        nbytes: List[int] = []
        for i, (req, (k_host, v_host)) in enumerate(zip(group, hosts)):
            table = self.cache.alloc.tables[req.rid]
            nb = k_host.shape[1]
            assert nb == len(table)
            for buf, host in ((ks, k_host), (vs, v_host)):
                buf[:, i, :nb * bs].copy_(
                    host.reshape(n_layers, nb * bs, *host.shape[3:]),
                    non_blocking=True)
            nbytes.append(k_host.numel() * k_host.element_size()
                          + v_host.numel() * v_host.element_size())
            ids[i, :nb] = table
        self._commit((self.cache.k, self.cache.v, ks, vs), (ids,))
        self.last_commit_h2d_bytes = sum(nbytes) + ids.nbytes
        return nbytes

    # ------------------------------------------------------------- dispatch
    def _chunk_inputs(self, chunks: List[Tuple[ServeRequest, int, int]]):
        """Host-side prefill-lane arrays for a packed chunk: the segments'
        prompt slices concatenated from row 0 (fixed `chunk_width`,
        zero-padded), each segment's block table, and the (S, 3) descriptor
        array [row_offset, seg_len, kv_start] (idle segment slots: seg_len
        0 at the fill level, all-null table)."""
        c = self.chunk_width
        ns = self.chunk_segments
        toks = np.zeros((1, c), np.int32)
        tables = np.full((ns, self.kv_cfg.max_blocks_per_seq),
                         NULL_BLOCK, np.int32)
        info = np.zeros((ns, 3), np.int32)
        q0 = 0
        for i, (req, start, n) in enumerate(chunks):
            toks[0, q0:q0 + n] = req.prompt[start:start + n]
            held = self.cache.alloc.tables[req.rid]
            tables[i, :len(held)] = held
            info[i] = (q0, n, start)
            q0 += n
        info[len(chunks):, 0] = q0            # idle slots: empty span at fill
        return toks, tables, info

    def dispatch(self, params, dec_rids: List[Optional[int]],
                 lengths: np.ndarray, last_tok: np.ndarray,
                 chunks: List[Tuple[ServeRequest, int, int]],
                 dec_sampling: np.ndarray, dec_keys: np.ndarray):
        """Run one step: the unified program when `chunks` carries prompt
        work, else the decode-only program; both draw their tokens on the
        device.  Returns the decode lane's next tokens (host, (slots,)) and
        the chunk segments' next tokens ((segments,) or None); the `.cpu()`
        copies, outside the programs, synchronize with the device."""
        pools = (params, self.cache.k, self.cache.v)
        dec = (self.cache.table_array(dec_rids), lengths, last_tok[:, None])
        if chunks:
            seg_sp, seg_ks = segment_sampling_arrays(chunks, self.chunk_segments)
            nxt, seg_next, self.last_seg_logits = self._unified(
                pools, (*dec, *self._chunk_inputs(chunks), dec_sampling,
                        dec_keys, seg_sp, seg_ks))
            return nxt.cpu().numpy(), seg_next.cpu().numpy()
        nxt = self._decode_only(pools, (*dec, dec_sampling, dec_keys))
        return nxt.cpu().numpy(), None

    def occupancy(self) -> float:
        return self.cache.alloc.occupancy()


class SSMFamilyAdapter:
    """State-cache family: slot-pooled conv / SSM state + the ssm programs.

    The lane width is `cfg.chunk_width` rounded up to a multiple of the
    model's SSD chunk (`ssm_chunk`), so every non-final prompt chunk cuts
    the scan on a chunk boundary — the condition under which chunked
    prefill equals the whole-prompt prefill.  Packing is 1: the SSD
    recurrence threads one request's carry through the lane."""

    family = "ssm"

    def __init__(self, model, cfg, router: PlanRouter, device: torch.device):
        mcfg = model.cfg
        self.model = model
        self.device = device
        q = max(1, mcfg.ssm_chunk)
        self.chunk_width = -(-cfg.chunk_width // q) * q
        self.chunk_segments = 1
        # state rows are disjoint scatter targets, so one commit carries
        # several swap-ins although the chunk lane packs one segment
        self.resume_segments = max(1, cfg.chunk_segments)
        self.state_cfg = cfg.state_config()
        self.cache = SlotStateCache.for_model(self.state_cfg, mcfg, device=device)
        chunk_stage, decode_stage = "ssm_prefill_chunk", "ssm_decode"
        assert chunk_stage in serve_stages(self.family)
        self._decode_kw = dict(decode_matmul_table=router.matmul_table(decode_stage))
        self._chunk_kw = dict(chunk_matmul_table=router.matmul_table(chunk_stage))
        pool = _graph_pool(cfg, device)
        self._unified = steps.graph_ssm_unified_step(
            model, device, graphed=cfg.cuda_graphs, pool=pool,
            **self._decode_kw, **self._chunk_kw)
        self._decode_only = steps.graph_ssm_decode_only_step(
            model, device, graphed=cfg.cuda_graphs, pool=pool, **self._decode_kw)
        self._commit = steps.graph_ssm_commit_state(
            device, graphed=cfg.cuda_graphs, pool=pool)
        # the commit program's inputs, (resume_segments, L, ...) device
        # buffers allocated at the first commit and filled in place (one
        # request's rows contiguous), bound as (L, resume_segments, ...)
        # views; and the bytes the last commit copied from the host
        self._commit_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.last_commit_h2d_bytes = 0
        # the last unified step's chunk logits (1, V): the program's output
        # buffer, valid until its next step
        self.last_seg_logits: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- capacity
    @property
    def alloc(self):
        return self.cache.alloc

    def capacity(self) -> SlotCapacity:
        return SlotCapacity(self.cache.alloc)

    @property
    def victim_eligible(self):
        # a resident that has not dispatched its first chunk owns no row:
        # evicting it frees nothing, so victims are row holders only
        return lambda r: self.cache.alloc.holds(r.rid)

    def grow_for_decode(self, req: ServeRequest, need_rows: int) -> bool:
        # fixed-size state: nothing grows during decode
        return True

    def claim_chunk(self, req: ServeRequest, start: int, n: int) -> bool:
        """Claim req's state row at its first chunk's dispatch; False when
        the pool is dry (the engine preempts a row holder and retries)."""
        if self.cache.alloc.holds(req.rid):
            return True
        if not self.cache.alloc.can_allocate(1):
            return False
        self.cache.alloc.allocate(req.rid)
        return True

    def register_prefix(self, req: ServeRequest) -> None:
        # a recurrent state summarises its whole prefix and is owned by one
        # request: there is no prefix index to feed
        return None

    # ------------------------------------------------------------- swapping
    def is_swapped(self, rid: int) -> bool:
        return self.cache.is_swapped(rid)

    def swap_out(self, rid: int) -> int:
        return self.cache.swap_out(rid)

    def resume_commit(self, group: List[ServeRequest]) -> List[int]:
        """Scatter up to `resume_segments` re-admitted requests' host
        (conv, ssm) states into their freshly claimed rows with one commit
        of one signature.  Only the swapped rows cross the bus: each
        request's pinned buffers are copied into its segment of the
        program's inputs; padding segments keep what an earlier commit
        left there and their rows point at the null row.  Returns the
        bytes moved per request."""
        assert 0 < len(group) <= self.resume_segments
        n_seg = self.resume_segments
        hosts = [self.cache.take_swapped(r.rid) for r in group]
        if self._commit_state is None:
            self._commit_state = tuple(
                torch.zeros((n_seg, pool.shape[0], *pool.shape[2:]), dtype=pool.dtype,
                            device=self.device).transpose(0, 1)
                for pool in (self.cache.conv, self.cache.ssm))
        conv_in, ssm_in = self._commit_state
        rows = np.zeros((n_seg,), np.int32)            # padding: the null row
        nbytes: List[int] = []
        for i, (req, (conv_host, ssm_host)) in enumerate(zip(group, hosts)):
            for buf, host in ((conv_in, conv_host), (ssm_in, ssm_host)):
                buf[:, i].copy_(host, non_blocking=True)
            nbytes.append(conv_host.numel() * conv_host.element_size()
                          + ssm_host.numel() * ssm_host.element_size())
            rows[i] = self.cache.alloc.slot_of(req.rid)
        self._commit((self.cache.conv, self.cache.ssm, conv_in, ssm_in), (rows,))
        self.last_commit_h2d_bytes = sum(nbytes) + rows.nbytes
        return nbytes

    # ------------------------------------------------------------- dispatch
    def dispatch(self, params, dec_rids: List[Optional[int]],
                 lengths: np.ndarray, last_tok: np.ndarray,
                 chunks: List[Tuple[ServeRequest, int, int]],
                 dec_sampling: np.ndarray, dec_keys: np.ndarray):
        """One ssm step: the decode lane maps each slot to its state row
        (`index_array`; idle and prefilling slots hit the null row), the
        chunk lane carries at most one segment.  The scalars go in as
        int32 arrays, so the program keeps one signature.  Returns the
        decode lane's next tokens (host, (slots,)) and the segment's next
        token ((1,) or None)."""
        del lengths                          # fixed-size state: no positions
        pools = (params, self.cache.conv, self.cache.ssm)
        dec = (self.cache.index_array(dec_rids), last_tok[:, None])
        if chunks:
            req, start, n = chunks[0]
            ch_toks = np.zeros((1, self.chunk_width), np.int32)
            ch_toks[0, :n] = req.prompt[start:start + n]
            row = self.cache.alloc.slot_of(req.rid)
            ch_sp, ch_ks = segment_sampling_arrays(chunks, 1)
            scalars = [np.array([v], np.int32) for v in (row, n, start)]
            nxt, ch_next, self.last_seg_logits = self._unified(
                pools, (*dec, ch_toks, *scalars, dec_sampling, dec_keys, ch_sp, ch_ks))
            return nxt.cpu().numpy(), ch_next.cpu().numpy()
        nxt = self._decode_only(pools, (*dec, dec_sampling, dec_keys))
        return nxt.cpu().numpy(), None

    def occupancy(self) -> float:
        return self.cache.alloc.occupancy()
