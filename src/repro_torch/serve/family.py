"""The engine/model-family seam — the port of `resolve_family_adapter` and
`DecoderFamilyAdapter` from `repro.serve.family`.

`ContinuousEngine` is family-agnostic orchestration; the adapter owns what
the family's per-request device state is.  For attention decoders that is
the paged KV pool (`PagedKVCache`), its block tables, and the two step
functions (`steps.unified_step` / `steps.decode_only_step`).  The adapter
protocol is the JAX package's (see `repro.serve.family`): `family`,
`chunk_width`, `chunk_segments`, `resume_segments`, `cache`, `alloc`,
`capacity()`, `victim_eligible`, `grow_for_decode`, `claim_chunk`,
`register_prefix`, `is_swapped`, `swap_out`, `resume_commit`, `dispatch`,
`occupancy`.  The state-cache (ssm) family is a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import steps
from repro_torch.models.common import torch_dtype
from repro_torch.serve.kvcache import NULL_BLOCK, PagedKVCache
from repro_torch.serve.router import PlanRouter
from repro_torch.serve.sampling import segment_sampling_arrays
from repro_torch.serve.scheduler import PagedCapacity, ServeRequest


def resolve_family_adapter(model):
    """The adapter class serving `model`, by capability probe.  Raises
    TypeError for models without a paged decode path (the state-cache
    family is not ported yet)."""
    if getattr(model.cfg, "family", None) == "ssm":
        raise TypeError("the ssm family's slot-pooled serving path is a later "
                        "slice of the port")
    if hasattr(model, "decode_step_paged"):
        return DecoderFamilyAdapter
    raise TypeError(f"{type(model).__name__} has no paged decode path")


class DecoderFamilyAdapter:
    """Paged-KV family: block-table bookkeeping + the paged step functions."""

    family = "decoder"

    def __init__(self, model, cfg, router: PlanRouter, device: torch.device):
        mcfg = model.cfg
        self.model = model
        self.device = device
        self.kv_cfg = cfg.kv_config()
        self.cache = PagedKVCache(self.kv_cfg, mcfg.n_layers, mcfg.n_kv_heads,
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
        # the last unified step's per-segment logits (S, V), for callers
        # that inspect the first-token margins
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
                steps.cow_block(self.cache.k, self.cache.v, *copied)
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
        one commit: each host buffer scatters into its freshly allocated
        blocks, padded to the group's widest table (padding ids point at
        the null sink with zero payloads).  Returns the bytes moved per
        request."""
        assert 0 < len(group) <= self.resume_segments
        bs = self.kv_cfg.block_size
        hosts = [self.cache.take_swapped(r.rid) for r in group]
        nb_pad = max(k.shape[1] for k, _ in hosts)
        k0 = hosts[0][0]
        L = k0.shape[0]
        ks = torch.zeros((L, len(group), nb_pad * bs, *k0.shape[3:]), dtype=k0.dtype)
        vs = torch.zeros_like(ks)
        ids = np.full((len(group), nb_pad), NULL_BLOCK, np.int32)
        nbytes: List[int] = []
        for i, (req, (k_host, v_host)) in enumerate(zip(group, hosts)):
            nbytes.append(k_host.numel() * k_host.element_size()
                          + v_host.numel() * v_host.element_size())
            table = self.cache.alloc.tables[req.rid]
            nb = k_host.shape[1]
            assert nb == len(table)
            ks[:, i, :nb * bs] = k_host.reshape(L, nb * bs, *k_host.shape[3:])
            vs[:, i, :nb * bs] = v_host.reshape(L, nb * bs, *v_host.shape[3:])
            ids[i, :nb] = table
        steps.commit_prefill(self.cache.k, self.cache.v, ks.to(self.device),
                             vs.to(self.device),
                             torch.as_tensor(ids, device=self.device))
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

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def dispatch(self, params, dec_rids: List[Optional[int]],
                 lengths: np.ndarray, last_tok: np.ndarray,
                 chunks: List[Tuple[ServeRequest, int, int]],
                 dec_sampling: np.ndarray, dec_keys: np.ndarray):
        """Run one step: the unified step when `chunks` carries prompt work,
        else the decode-only step.  Returns the decode lane's next tokens
        (host, (slots,)) and the chunk segments' next tokens ((segments,)
        or None); the `.cpu()` copies synchronize with the device."""
        bt = self._dev(self.cache.table_array(dec_rids))
        lens = self._dev(lengths)
        tokens = self._dev(last_tok[:, None])
        if chunks:
            ch_toks, seg_tables, seg_info = self._chunk_inputs(chunks)
            seg_sp, seg_ks = segment_sampling_arrays(chunks, self.chunk_segments)
            nxt, seg_next, self.last_seg_logits = steps.unified_step(
                self.model, params, self.cache.k, self.cache.v, bt, lens,
                tokens, self._dev(ch_toks), self._dev(seg_tables),
                self._dev(seg_info), dec_sampling, dec_keys, seg_sp, seg_ks,
                **self._decode_kw, **self._chunk_kw)
            return nxt.cpu().numpy(), seg_next.cpu().numpy()
        nxt = steps.decode_only_step(
            self.model, params, self.cache.k, self.cache.v, bt, lens, tokens,
            dec_sampling, dec_keys, **self._decode_kw)
        return nxt.cpu().numpy(), None

    def occupancy(self) -> float:
        return self.cache.alloc.occupancy()
