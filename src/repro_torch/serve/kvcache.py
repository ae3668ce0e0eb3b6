"""Paged KV-cache manager for the continuous-batching runtime.

The monolithic `(B, max_seq, Hkv, hd)` cache of the fixed-batch engine wastes
HBM proportional to (longest sequence x batch): a 12-token request in a slot
sized for 4k tokens pins 4k rows.  Here the cache is a pool of fixed-size
*blocks* (`block_size` token rows each); a request owns a chain of physical
block ids (its *block table*) and blocks return to the free list the moment
the request completes — the vLLM PagedAttention layout, sized for the paper's
serve path.

Two layers of responsibility:

  * `BlockAllocator` — pure host-side bookkeeping: free-list, per-request
    block tables, alloc/free invariants.  Physical block 0 is reserved as the
    *null sink*: slot-table entries of inactive slots and padding positions
    point at it, so device-side scatters never need a mask branch.  A request
    can be *swapped out* (its blocks return to the pool while the allocator
    remembers how many it held) and later *swapped in* (fresh blocks of the
    same count, possibly different physical ids — the block table is the only
    indirection, so ids are free to change across a swap).
  * `PagedKVCache`  — the device tensors: torch `k`/`v` pools shaped
    `(n_layers, num_blocks, block_size, n_kv_heads, hd)` on the engine's
    device, host-side swap buffers for preempted requests, and a helper to
    build the dense `(max_slots, blocks_per_seq)` block-table array the
    decode step consumes.

PREFIX SHARING (`KVCacheConfig.prefix_sharing`).  Blocks are REFCOUNTED: a
block may appear in many tables at once, `free` only returns it to the free
list when the last owner lets go.  A *prefix index* keys each registered
block on the exact token string `tokens[0 : (k+1) * block_size]` whose KV it
holds — position-dependent (RoPE) KV means the key must be the whole prefix,
not the block's own tokens.  Admission matches a new prompt's full-block
prefixes against the index and *adopts* the hits (refcount + 1), so a hot
system prompt is prefilled once, ever.  Freed registered blocks stay in the
index while they sit on the free list (inserted at the FRONT, so unregistered
blocks are reused first) and are *revived* on a later match; physically
reallocating a registered block invalidates its index entry.  A write landing
in a block with refcount > 1 must COPY-ON-WRITE first (`cow`): the writer
swaps a fresh private block into its own table and the device copies the
rows across — other owners keep reading the original.  Everything here is
host bookkeeping; the device copy is the caller's (`steps.cow_block`).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.trace import NULL_RECORDER

NULL_BLOCK = 0  # reserved sink block — never allocated to a request


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_blocks: int = 64          # physical pool size (incl. the null block)
    block_size: int = 16          # token rows per block
    max_blocks_per_seq: int = 16  # bounds the per-slot block table width
    # prefix sharing: admission may map a prompt's full-block prefixes onto
    # blocks other requests already committed (refcount + copy-on-write).
    # Off by default: sharing is a scheduling optimization the byte-identity
    # differentials toggle explicitly.
    prefix_sharing: bool = False

    @property
    def max_seq(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)


def _prefix_key(tokens: np.ndarray, n_tokens: int) -> bytes:
    """Index key of the block covering tokens [n_tokens - block_size,
    n_tokens): the EXACT byte string of the whole prefix.  KV rows are a
    function of every token before them (positions, attention), so two
    blocks are interchangeable iff their full prefixes match."""
    return np.ascontiguousarray(tokens[:n_tokens], np.int32).tobytes()


class BlockAllocator:
    """Free-list allocation of physical blocks with per-request block tables,
    block refcounts and a token-keyed prefix index (copy-on-write sharing)."""

    def __init__(self, cfg: KVCacheConfig):
        if cfg.num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null sink)")
        self.cfg = cfg
        # block 0 reserved as the null sink.  The free list doubles as the
        # prefix-cache eviction queue: `_pop_free` takes from the TAIL, and
        # `free` returns registered blocks to the FRONT, so cached KV
        # survives on the free list until the pool actually needs the block.
        self._free: List[int] = list(range(cfg.num_blocks - 1, NULL_BLOCK, -1))
        self.tables: Dict[int, List[int]] = {}
        # owners per block: a block is in `refcount` iff some table holds it,
        # with the value equal to the number of tables containing it
        self.refcount: Dict[int, int] = {}
        # prefix index: full-prefix key -> block id, plus the reverse map so
        # reallocating a block can invalidate its entry in O(1)
        self._index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        # rid -> block count held at swap-out (no physical blocks owned)
        self.swapped: Dict[int, int] = {}
        # CoW copies since the engine last drained the counter (metrics)
        self._cow_copies = 0
        # structured event recorder (`repro.serve.trace`); the serving
        # engine rebinds it, the default no-op has near-zero cost and every
        # accounting event carries `free_after` so a trace audit can replay
        # pool conservation event by event
        self.trace = NULL_RECORDER

    # ------------------------------------------------------------ queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.cfg.num_blocks - 1) - len(self._free)

    def occupancy(self) -> float:
        usable = self.cfg.num_blocks - 1
        return self.num_used / usable if usable else 0.0

    def can_allocate(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    def drain_cow_copies(self) -> int:
        """Copy-on-write copies performed since the last drain (metrics)."""
        n, self._cow_copies = self._cow_copies, 0
        return n

    # -------------------------------------------------------- alloc / free
    def _pop_free(self) -> int:
        """Take one block off the free list for a FRESH allocation.  Popping
        a registered block is the prefix cache's eviction: its index entry
        dies here, before the block is rewritten."""
        b = self._free.pop()
        key = self._block_key.pop(b, None)
        if key is not None:
            del self._index[key]
        return b

    def allocate(self, rid: int, n_blocks: int) -> List[int]:
        """Claim `n_blocks` physical blocks for request `rid`."""
        if rid in self.tables:
            raise ValueError(f"request {rid} already holds blocks")
        if rid in self.swapped:
            raise ValueError(f"request {rid} is swapped out; use swap_in")
        if not self.can_allocate(n_blocks):
            raise MemoryError(
                f"KV pool exhausted: want {n_blocks}, free {len(self._free)}")
        blocks = [self._pop_free() for _ in range(n_blocks)]
        for b in blocks:
            self.refcount[b] = 1
        self.tables[rid] = blocks
        self.trace.emit("block_alloc", rid=rid, n=n_blocks,
                        free_after=len(self._free))
        return blocks

    def extend(self, rid: int, n_tokens_total: int) -> bool:
        """Grow rid's table to cover `n_tokens_total`; False if the pool is
        dry OR the request would exceed its table bound
        (`max_blocks_per_seq` — the dense `table_array` row width; growing
        past it would silently corrupt the dispatch-side scatter)."""
        if rid in self.swapped:
            raise ValueError(
                f"request {rid} is swapped out; swap_in before extending")
        table = self.tables[rid]
        target = self.cfg.blocks_for(n_tokens_total)
        if target > self.cfg.max_blocks_per_seq:
            return False
        need = target - len(table)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            b = self._pop_free()
            self.refcount[b] = 1
            table.append(b)
        self.trace.emit("block_extend", rid=rid, n=need,
                        free_after=len(self._free))
        return True

    def free(self, rid: int) -> int:
        """Drop rid's ownership of its blocks; a block returns to the free
        list only when its refcount hits zero (`released` on the event).
        Registered (prefix-indexed) blocks go to the FRONT of the free list
        — still matchable, evicted only after every unregistered block."""
        blocks = self.tables.pop(rid)
        released = 0
        for b in reversed(blocks):
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                del self.refcount[b]
                released += 1
                if b in self._block_key:
                    self._free.insert(0, b)
                else:
                    self._free.append(b)
        self.trace.emit("block_free", rid=rid, n=len(blocks),
                        released=released, free_after=len(self._free))
        return len(blocks)

    # ------------------------------------------------- prefix sharing / CoW
    def match_prefix(self, tokens: np.ndarray) -> List[int]:
        """The longest chain of indexed blocks covering `tokens`' full-block
        prefixes: block k matches iff the index holds the exact prefix
        tokens[0:(k+1)*block_size].  Walks in order and stops at the first
        miss (a later hit without its predecessors is unusable — the KV of
        block k embeds the whole prefix before it)."""
        if not self.cfg.prefix_sharing or not self._index:
            return []
        tokens = np.asarray(tokens, np.int32)
        bs = self.cfg.block_size
        matched: List[int] = []
        for k in range(len(tokens) // bs):
            b = self._index.get(_prefix_key(tokens, (k + 1) * bs))
            if b is None:
                break
            matched.append(b)
        return matched

    def share(self, rid: int, blocks: List[int]) -> None:
        """Adopt `blocks` (a `match_prefix` result) as the head of rid's
        table: live blocks gain an owner (refcount + 1); refcount-0 blocks
        still sitting on the free list are REVIVED (removed from the free
        list, refcount 1) — their KV was never overwritten, so the cached
        prefix outlives its original owner."""
        if rid in self.tables:
            raise ValueError(f"request {rid} already holds blocks")
        if rid in self.swapped:
            raise ValueError(f"request {rid} is swapped out; use swap_in")
        revived = 0
        for b in blocks:
            if b in self.refcount:
                self.refcount[b] += 1
            else:
                self._free.remove(b)
                self.refcount[b] = 1
                revived += 1
        self.tables[rid] = list(blocks)
        self.trace.emit("block_share", rid=rid, n=len(blocks),
                        revived=revived, free_after=len(self._free))

    def register_prefix(self, rid: int, tokens: np.ndarray,
                        n_tokens: int) -> None:
        """Index rid's blocks covering `tokens`' committed full-block
        prefixes (`n_tokens` of them are committed).  First registration
        wins: if a key is already indexed — a concurrent identical prompt
        that could not match at admission — the existing entry stands."""
        if not self.cfg.prefix_sharing:
            return
        tokens = np.asarray(tokens, np.int32)
        bs = self.cfg.block_size
        table = self.tables[rid]
        upto = min(int(n_tokens), len(tokens)) // bs
        for k in range(upto):
            b = table[k]
            if b in self._block_key:
                continue        # already indexed (adopted shared block)
            key = _prefix_key(tokens, (k + 1) * bs)
            if key in self._index:
                continue        # first registration wins
            self._index[key] = b
            self._block_key[b] = key

    def cow(self, rid: int, block_index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write rid's table entry `block_index` if it is shared:
        returns (src, dst) block ids for the caller's device copy, or None
        when the block is private (no copy needed).  Raises MemoryError on
        a dry pool — the engine preempts a victim and retries, exactly like
        `extend`.  The old block keeps its other owners (refcount >= 1
        afterwards), so a CoW never releases anything."""
        table = self.tables[rid]
        src = table[block_index]
        if self.refcount[src] <= 1:
            return None
        if not self._free:
            raise MemoryError(
                f"KV pool exhausted for copy-on-write (rid {rid})")
        dst = self._pop_free()
        self.refcount[src] -= 1
        self.refcount[dst] = 1
        table[block_index] = dst
        self._cow_copies += 1
        self.trace.emit("cow_copy", rid=rid, n=1,
                        free_after=len(self._free))
        return src, dst

    # ------------------------------------------------------------- swapping
    def swap_out(self, rid: int) -> int:
        """Release rid's physical blocks while remembering how many it held;
        returns the block count.  The caller is responsible for saving the
        block *contents* first (see `PagedKVCache.swap_out`)."""
        if rid in self.swapped:
            raise ValueError(f"request {rid} already swapped out")
        n = self.free(rid)
        self.swapped[rid] = n
        return n

    def swap_in(self, rid: int) -> List[int]:
        """Re-claim as many blocks as rid held at swap-out (fresh physical
        ids); raises MemoryError if the pool cannot cover them."""
        n = self.swapped[rid]
        if not self.can_allocate(n):
            raise MemoryError(
                f"KV pool exhausted on swap-in: want {n}, free "
                f"{len(self._free)}")
        del self.swapped[rid]
        return self.allocate(rid, n)

    def check_invariants(self) -> None:
        """Every block is free xor owned; an owned block's refcount equals
        the number of tables containing it; the prefix index is a bijection
        over blocks that still physically exist."""
        owned = Counter(b for t in self.tables.values() for b in t)
        assert NULL_BLOCK not in owned, "null block leaked into a table"
        assert NULL_BLOCK not in self._free, "null block leaked into free list"
        assert len(set(self._free)) == len(self._free), "free list duplicate"
        assert not (set(self._free) & set(owned)), "block both free and owned"
        assert sorted(set(self._free) | set(owned)) == \
            list(range(1, self.cfg.num_blocks)), (
                f"block accounting broken: free={sorted(self._free)} "
                f"owned={sorted(owned)}")
        assert self.refcount == dict(owned), (
            f"refcounts {self.refcount} != table occurrences {dict(owned)}")
        for rid, t in self.tables.items():
            assert len(set(t)) == len(t), f"table {rid} repeats a block"
        for key, b in self._index.items():
            assert self._block_key.get(b) == key, "index/reverse-map skew"
        for b, key in self._block_key.items():
            assert self._index.get(key) == b, "reverse-map/index skew"
            assert b in owned or b in self._free, (
                f"indexed block {b} neither owned nor free")
        assert not (set(self.swapped) & set(self.tables)), (
            "request both active and swapped out")
        assert all(n >= 0 for n in self.swapped.values())


class PagedKVCache:
    """Device-side paged K/V pools plus the allocator."""

    def __init__(self, cfg: KVCacheConfig, n_layers: int, n_kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, device="cpu"):
        self.cfg = cfg
        self.alloc = BlockAllocator(cfg)
        shape = (n_layers, cfg.num_blocks, cfg.block_size, n_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        # rid -> (k_host, v_host) CPU tensors of shape (L, n_blocks, bs, Hkv,
        # hd): preempted requests' KV lives here, off-device, until swap-in
        self._swapped: Dict[int, tuple] = {}

    # ------------------------------------------------------------- swapping
    def is_swapped(self, rid: int) -> bool:
        return rid in self._swapped

    def swap_out(self, rid: int) -> int:
        """Copy rid's KV blocks to host buffers and release the physical
        blocks; returns the bytes moved.  A later `take_swapped` + commit
        scatters them back into (possibly different) physical blocks.
        Shared blocks are saved too; co-owners keep the originals live."""
        ids = torch.as_tensor(self.alloc.tables[rid], dtype=torch.long,
                              device=self.k.device)
        k_host = self.k[:, ids].cpu()
        v_host = self.v[:, ids].cpu()
        self._swapped[rid] = (k_host, v_host)
        nbytes = (k_host.numel() * k_host.element_size()
                  + v_host.numel() * v_host.element_size())
        self.alloc.trace.emit("swap_out", rid=rid, nbytes=nbytes,
                              n_blocks=len(self.alloc.tables[rid]))
        self.alloc.swap_out(rid)
        return nbytes

    def take_swapped(self, rid: int):
        """Pop rid's host-side (k, v) buffers for swap-in; the caller
        scatters them at the freshly allocated block table."""
        return self._swapped.pop(rid)

    def table_array(self, slot_rids: List[Optional[int]]) -> np.ndarray:
        """Dense (max_slots, max_blocks_per_seq) int32 block-table array for
        the decode step; unused entries point at the null sink."""
        out = np.full((len(slot_rids), self.cfg.max_blocks_per_seq),
                      NULL_BLOCK, np.int32)
        for s, rid in enumerate(slot_rids):
            if rid is None:
                continue
            table = self.alloc.tables[rid]
            out[s, : len(table)] = table
        return out
