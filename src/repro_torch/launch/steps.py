"""The paged serving step functions — the port of the continuous-serving
builders of `repro.launch.steps` (`jit_unified_step`,
`jit_decode_only_step`, `jit_commit_prefill`, `jit_cow_block`).

PyTorch runs eagerly, so these are plain functions: no jit, no mesh, no
donation.  The KV pools (L, num_blocks, block_size, Hkv, hd) are updated
in place.  The attention backends and the per-stage matmul tables are
passed per call (JAX closes them over at trace time).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.dispatch import MatmulTable, matmul_dispatch
from repro_torch.kernels.sampling import sample_tokens


def unified_step(model, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 dec_tables, dec_lengths, dec_tokens, ch_tokens, seg_tables,
                 seg_info, dec_sampling, dec_keys, seg_sampling, seg_keys, *,
                 decode_attn_backend: str = "torch",
                 chunk_attn_backend: str = "torch",
                 chunk_attn_config: Optional[Dict[str, Any]] = None,
                 decode_matmul_table: Optional[MatmulTable] = None,
                 chunk_matmul_table: Optional[MatmulTable] = None):
    """-> (dec_next (slots,), seg_next (S,), seg_logits (S, V))

    The serving step for steps that carry prompt work: the prefill lane
    runs a packed chunk of prompt segments (K/V committed to each segment's
    blocks), then the decode lane advances every slot (the lanes touch
    disjoint blocks — a request never prefills and decodes in one step).
    seg_next[s] is segment s's first token, valid only for segments that
    complete their prompt this step; `seg_logits` are the logits it was
    drawn from, returned for callers that inspect them."""
    with matmul_dispatch(chunk_matmul_table):
        ch_logits = model.prefill_packed_paged(
            params, k_pool, v_pool, seg_tables, ch_tokens, seg_info,
            attn_backend=chunk_attn_backend, attn_config=chunk_attn_config)
    with matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_paged(
            params, k_pool, v_pool, dec_tables, dec_lengths, dec_tokens,
            attn_backend=decode_attn_backend)
    nxt = sample_tokens(logits[:, -1], dec_sampling, dec_keys)
    seg_next = sample_tokens(ch_logits[0], seg_sampling, seg_keys)
    return nxt, seg_next, ch_logits[0]


def decode_only_step(model, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     dec_tables, dec_lengths, dec_tokens, dec_sampling,
                     dec_keys, *, decode_attn_backend: str = "torch",
                     decode_matmul_table: Optional[MatmulTable] = None):
    """-> dec_next (slots,): the unified step's decode lane without the
    chunk lane, for steps with no prompt work."""
    with matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_paged(
            params, k_pool, v_pool, dec_tables, dec_lengths, dec_tokens,
            attn_backend=decode_attn_backend)
    return sample_tokens(logits[:, -1], dec_sampling, dec_keys)


def commit_prefill(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   ks: torch.Tensor, vs: torch.Tensor,
                   block_ids: torch.Tensor) -> None:
    """Scatter S resuming requests' K/V (L, S, S_pad, Hkv, hd) into the
    pools at `block_ids` (S, S_pad / block_size), in place.  Padding
    entries point at the null sink block with zero payloads."""
    n_layers, block_size = k_pool.shape[0], k_pool.shape[2]
    n_seg, s_pad = ks.shape[1], ks.shape[2]
    nb = s_pad // block_size
    kb = ks.reshape(n_layers, n_seg * nb, block_size, *ks.shape[3:])
    vb = vs.reshape(n_layers, n_seg * nb, block_size, *vs.shape[3:])
    flat_ids = block_ids.reshape(-1).long()
    k_pool[:, flat_ids] = kb.to(k_pool.dtype)
    v_pool[:, flat_ids] = vb.to(v_pool.dtype)


def cow_block(k_pool: torch.Tensor, v_pool: torch.Tensor, src: int,
              dst: int) -> None:
    """Copy-on-write: duplicate physical block `src` into `dst` in both
    pools, in place (the allocator has already repointed the writer's
    table at `dst`)."""
    k_pool[:, dst] = k_pool[:, src]
    v_pool[:, dst] = v_pool[:, src]
