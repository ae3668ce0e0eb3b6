"""The serving step functions and their step programs — the port of the
serving builders of `repro.launch.steps`.

`unified_step` and `decode_only_step` are the paged step bodies; both end
in keyed sampling (`kernels.sampling.sample_tokens`) on each lane, as
`repro/launch/steps.py` does.  `graph_unified_step` and
`graph_decode_only_step`, the counterparts of `jit_unified_step` and
`jit_decode_only_step`, wrap them in a `launch.program.Program`: on a CUDA
device each is captured in a CUDA graph once, at the engine's fixed
shapes, and every later step replays it (on the CPU, or with graphs off,
the body runs eagerly).  The attention backends and per-stage matmul
tables are fixed per program, baked in at capture as JAX closes them over
at trace time.  A program is called as `program((params, k_pool, v_pool),
host_arrays)`; the KV pools (L, num_blocks, block_size, Hkv, hd) are
updated in place, where JAX donates them.

Tensor-parallel serving runs the same two programs on every rank, each
over the rank's local parameter shards and KV pools (`tp`, a
`distributed.collectives.TensorParallel`, installed around the model
calls): one signature each at every width.  At tp > 1 they run eagerly:
an NCCL world of two ranks cannot share one card, so capturing its
collectives in a CUDA graph waits for a machine with more cards.

`graph_commit_prefill` and `graph_cow_block` (`jit_commit_prefill`,
`jit_cow_block`) are two more programs, each with one signature: the
resume commit's scatter of swapped-in K/V into the pools, at one padded
shape, and the copy-on-write of one block.

`ssm_unified_step` / `ssm_decode_only_step` and `ssm_commit_state` are
the state-cache family's counterparts (`jit_ssm_unified_step`,
`jit_ssm_decode_only_step`, `jit_ssm_commit_state`) over the slot-pooled
conv / SSM pools (L, rows, ...); `graph_ssm_unified_step`,
`graph_ssm_decode_only_step` and `graph_ssm_commit_state` are their
programs, one signature each.  Every row index and segment scalar is a
program input, so admission, chunk progress, preemption and resume
capture nothing.

`prefill_step` and `serve_step` (`make_prefill_step`, `make_serve_step`)
are the fixed-batch engine's dense-cache steps.  They run eagerly: the
reference retraces them per prompt length.

`TrainConfig` and `make_train_step` are the training step (`jit_train_step`
in the reference, which jits it with sharded, donated state): value and
gradient of `model.loss` with microbatched accumulation
(`loss_and_grads`), then `optim.adamw_update` in place.  It runs eagerly
on one device; ZeRO-1 sharding of the moments waits for tensor-parallel
training (ROADMAP.md queue 1, item 8c), as it changes nothing on one
device.

The shardings (`batch_logical_axes`, `rules_for_shape`,
`make_batch_shardings`, `cache_shardings`, `paged_pool_sharding`,
`slot_state_shardings`) are the reference's: the shape- and config-aware
rule table, and one `distributed.sharding.NamedSharding` (mesh, spec,
DTensor placements) per leaf.  A mesh is a DeviceMesh, or for the tables
alone anything with the reference's `shape` mapping.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.collectives import TensorParallel, tensor_parallel
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              axis_sizes, map_axes, named_sharding)
from repro_torch.kernels.dispatch import MatmulTable, matmul_dispatch
from repro_torch.kernels.sampling import sample_tokens
from repro_torch.launch.program import Program
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    zero1: bool = True
    compress_pod_grads: bool = False
    opt: AdamWConfig = AdamWConfig()


# ---------------------------------------------------------------- shardings
def batch_logical_axes(batch_specs: Dict[str, Any]) -> Dict[str, Any]:
    """("batch", None, ...) for each entry of a batch (anything with a
    `shape`)."""
    return {k: ("batch",) + (None,) * (len(v.shape) - 1)
            for k, v in batch_specs.items()}


def rules_for_shape(cfg: ModelConfig, shape: ShapeSpec, mesh) -> ShardingRules:
    """The reference's shape- and config-aware rule overrides (the baseline
    sharding scheme).  Each sharded dim must divide its mesh axis:
      * heads / kv_heads / ffn indivisible by |model| -> replicated;
      * vocab indivisible -> the LM head's d_model dim ('embed_vec') takes
        the model axis instead;
      * n_experts indivisible -> TP inside the experts ('expert_ffn');
      * mamba heads / conv channels indivisible -> replicated.
    Decode with KV heads indivisible by |model| shards the cache's
    sequence dim over 'model'; a batch that does not split over data x pod
    is replicated and the sequence / state dims take 'data' (SP); training
    at 16k tokens and more shards the sequence over 'data'."""
    rules = DEFAULT_RULES
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)

    if cfg.n_heads and cfg.n_heads % m:
        rules = rules.replace(heads=None)
    if cfg.n_kv_heads and cfg.n_kv_heads % m:
        rules = rules.replace(kv_heads=None)
    if cfg.d_ff and cfg.d_ff % m:
        rules = rules.replace(ffn=None)
    if cfg.vocab % m:
        rules = rules.replace(vocab=None)
        if cfg.d_model % m == 0:
            rules = rules.replace(embed_vec="model")
    if cfg.n_experts:
        if cfg.n_experts % m:
            rules = rules.replace(experts=None)
            if cfg.d_expert % m == 0:
                rules = rules.replace(expert_ffn="model")
    if cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        conv_dim = d_in + 2 * cfg.ssm_state
        if nh % m:
            rules = rules.replace(ssm_heads=None)
        if conv_dim % m:
            rules = rules.replace(conv_dim=None)

    if (shape.kind == "decode" and cfg.n_kv_heads and cfg.n_kv_heads % m
            and shape.seq_len % m == 0):
        rules = rules.replace(kv_seq="model")

    if shape.global_batch % dp != 0 or shape.global_batch < dp:
        d = sizes.get("data", 1)
        rules = rules.replace(
            batch=None,
            kv_seq="data" if shape.seq_len % d == 0 else None,
            ssm_state="data" if (cfg.ssm_state and cfg.ssm_state % d == 0) else None,
            seq="data" if shape.seq_len % d == 0 else None,
        )
    if shape.kind == "train" and shape.seq_len >= 16_384:
        rules = rules.replace(seq="data")
    return rules


def make_batch_shardings(mesh, rules: ShardingRules, batch_specs):
    """One NamedSharding per batch entry: rows over the "batch" axes."""
    return {k: named_sharding(mesh, rules.spec(axes))
            for k, axes in batch_logical_axes(batch_specs).items()}


def cache_shardings(model, mesh, rules: ShardingRules, batch: int, max_seq: int):
    """The fixed-batch cache's NamedShardings, its shapes taken from
    `model.init_cache` on the meta device (no memory); axes past a leaf's
    logical tuple replicated."""
    shapes = model.init_cache(batch, max_seq, device="meta")

    def spec_of(axes, leaf):
        axes = tuple(axes) + (None,) * (leaf.dim() - len(axes))
        return named_sharding(mesh, rules.spec(axes))

    return map_axes(spec_of, model.cache_logical_axes(), shapes)


def paged_pool_sharding(model, mesh, rules: ShardingRules):
    """The paged KV pools' NamedSharding: blocks replicated, KV heads as
    the dense cache's head axis."""
    return named_sharding(mesh, rules.spec(model.paged_cache_logical_axes()["k"]))


def slot_state_shardings(model, mesh, rules: ShardingRules):
    """(conv, ssm) NamedShardings of the slot state pools: pool rows
    replicated, feature axes per `MambaLM.slot_state_logical_axes`."""
    axes = model.slot_state_logical_axes()
    return (named_sharding(mesh, rules.spec(axes["conv"])),
            named_sharding(mesh, rules.spec(axes["ssm"])))


def loss_and_grads(model, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1):
    """-> (loss, metrics, grads) of `model.loss` at `params` (a tree of f32
    master tensors, left without gradients afterwards).

    With k = `microbatches` > 1 the batch's rows split into k consecutive
    slices (microbatch i holds rows i*B/k ... (i+1)*B/k - 1, as the
    reference's reshape to (k, B/k, ...)); each backward adds into the
    leaves' `.grad` (0 + g_1 + g_2 + ..., the reference's f32 sum from
    zeros) and the sum is divided by k after; the loss is the sum of the
    k losses over k and the metrics {"loss"}.  With k = 1 the metrics are
    the model's own dict.  A leaf the loss does not reach gets zeros."""
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    try:
        if microbatches == 1:
            loss, metrics = model.loss(params, batch)
            loss.backward()
            metrics = {name: v.detach() for name, v in metrics.items()}
            loss = loss.detach()
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{microbatches} microbatches")
            n = rows // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(microbatches):
                l, _ = model.loss(params, {name: v[i * n:(i + 1) * n]
                                           for name, v in batch.items()})
                l.backward()
                loss = loss + l.detach()
            loss = loss / microbatches
            metrics = {"loss": loss}
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        if microbatches > 1:
            for g in tree_leaves(grads):
                g.div_(microbatches)
    finally:
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
    return loss, metrics, grads


def make_train_step(model, train_cfg: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradients of `loss_and_grads`, then AdamW (parameters and moments
    updated in place); metrics add "lr" and "grad_norm" (before
    clipping).  All tensors stay on the parameters' device."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch,
                                              train_cfg.microbatches)
        params, opt_state, om = adamw_update(params, grads, opt_state, train_cfg.opt)
        return params, opt_state, dict(metrics, **om)

    return train_step


def unified_step(model, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 dec_tables, dec_lengths, dec_tokens, ch_tokens, seg_tables,
                 seg_info, dec_sampling, dec_keys, seg_sampling, seg_keys, *,
                 decode_attn_backend: str = "torch",
                 chunk_attn_backend: str = "torch",
                 chunk_attn_config: Optional[Dict[str, Any]] = None,
                 decode_matmul_table: Optional[MatmulTable] = None,
                 chunk_matmul_table: Optional[MatmulTable] = None,
                 tp: Optional[TensorParallel] = None):
    """-> (dec_next (slots,), seg_next (S,), seg_logits (S, V))

    The serving step for steps that carry prompt work: the prefill lane
    runs a packed chunk of prompt segments (K/V committed to each segment's
    blocks), then the decode lane advances every slot (the lanes touch
    disjoint blocks — a request never prefills and decodes in one step).
    seg_next[s] is segment s's first token, valid only for segments that
    complete their prompt this step; `seg_logits` are the logits it was
    drawn from, returned for callers that inspect them.  Each lane's
    tokens are drawn on the device (`sample_tokens`) from its sampling and
    key arrays.  `tp`: the rank's tensor-parallel context (its local
    parameters and pools; the logits come out whole on every rank)."""
    with tensor_parallel(tp), matmul_dispatch(chunk_matmul_table):
        ch_logits = model.prefill_packed_paged(
            params, k_pool, v_pool, seg_tables, ch_tokens, seg_info,
            attn_backend=chunk_attn_backend, attn_config=chunk_attn_config)
    with tensor_parallel(tp), matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_paged(
            params, k_pool, v_pool, dec_tables, dec_lengths, dec_tokens,
            attn_backend=decode_attn_backend)
    nxt = sample_tokens(logits[:, -1], dec_sampling, dec_keys)
    seg_next = sample_tokens(ch_logits[0], seg_sampling, seg_keys)
    return nxt, seg_next, ch_logits[0]


def decode_only_step(model, params, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     dec_tables, dec_lengths, dec_tokens, dec_sampling,
                     dec_keys, *, decode_attn_backend: str = "torch",
                     decode_matmul_table: Optional[MatmulTable] = None,
                     tp: Optional[TensorParallel] = None):
    """-> dec_next (slots,): the unified step's decode lane without the
    chunk lane, for steps with no prompt work."""
    with tensor_parallel(tp), matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_paged(
            params, k_pool, v_pool, dec_tables, dec_lengths, dec_tokens,
            attn_backend=decode_attn_backend)
    return sample_tokens(logits[:, -1], dec_sampling, dec_keys)


def graph_unified_step(model, device, *, graphed: bool = True, pool=None,
                       **lanes) -> Program:
    """The unified step program: `unified_step` with the model and the
    lanes (`decode_attn_backend`, `chunk_attn_backend`,
    `chunk_attn_config`, `decode_matmul_table`, `chunk_matmul_table`,
    `tp`) fixed.  Inputs: dec_tables, dec_lengths, dec_tokens, ch_tokens,
    seg_tables, seg_info, dec_sampling, dec_keys, seg_sampling, seg_keys."""
    return Program(functools.partial(unified_step, model, **lanes), "unified",
                   device, graphed=graphed, pool=pool)


def graph_decode_only_step(model, device, *, graphed: bool = True, pool=None,
                           **lanes) -> Program:
    """The decode-only step program: `decode_only_step` with the model and
    the decode lane (`decode_attn_backend`, `decode_matmul_table`, `tp`)
    fixed.
    Inputs: dec_tables, dec_lengths, dec_tokens, dec_sampling, dec_keys."""
    return Program(functools.partial(decode_only_step, model, **lanes),
                   "decode_only", device, graphed=graphed, pool=pool)


def graph_commit_prefill(device, *, graphed: bool = True, pool=None) -> Program:
    """The resume-commit program: `commit_prefill`, called as
    `program((k_pool, v_pool, ks, vs), (block_ids,))` where ks / vs are the
    caller's fixed (L, S, S_pad, Hkv, hd) device buffers (bound: the
    caller fills them in place before each call) and block_ids is the
    (S, S_pad / block_size) int32 host array, so it has one signature."""
    return Program(commit_prefill, "commit", device, graphed=graphed, pool=pool)


def graph_cow_block(device, *, graphed: bool = True, pool=None) -> Program:
    """The copy-on-write program: `cow_block`, called as
    `program((k_pool, v_pool), (src, dst))` with (1,) int32 block ids."""
    return Program(cow_block, "cow", device, graphed=graphed, pool=pool)


def commit_prefill(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   ks: torch.Tensor, vs: torch.Tensor,
                   block_ids: torch.Tensor) -> None:
    """Scatter S resuming requests' K/V (L, S, S_pad, Hkv, hd) into the
    pools at `block_ids` (S, S_pad / block_size), in place.  Padding
    entries point at the null sink block, whose contents are unspecified."""
    n_layers, block_size = k_pool.shape[0], k_pool.shape[2]
    n_seg, s_pad = ks.shape[1], ks.shape[2]
    nb = s_pad // block_size
    kb = ks.reshape(n_layers, n_seg * nb, block_size, *ks.shape[3:])
    vb = vs.reshape(n_layers, n_seg * nb, block_size, *vs.shape[3:])
    flat_ids = block_ids.reshape(-1).long()
    k_pool[:, flat_ids] = kb.to(k_pool.dtype)
    v_pool[:, flat_ids] = vb.to(v_pool.dtype)


def cow_block(k_pool: torch.Tensor, v_pool: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> None:
    """Copy-on-write: duplicate physical block `src` into `dst` ((1,) int
    tensors) in both pools, in place (the allocator has already repointed
    the writer's table at `dst`)."""
    src, dst = src.long(), dst.long()
    k_pool.index_copy_(1, dst, k_pool.index_select(1, src))
    v_pool.index_copy_(1, dst, v_pool.index_select(1, src))


# ------------------------------------------- slot-pooled (ssm) serving
def ssm_unified_step(model, params, conv_pool: torch.Tensor,
                     ssm_pool: torch.Tensor, dec_state_idx, dec_tokens,
                     ch_tokens, ch_state_idx, ch_seg_len, ch_seg_start,
                     dec_sampling, dec_keys, ch_sampling, ch_keys, *,
                     decode_matmul_table: Optional[MatmulTable] = None,
                     chunk_matmul_table: Optional[MatmulTable] = None):
    """-> (dec_next (slots,), ch_next (1,), ch_logits (1, V))

    The ssm step for steps that carry prompt work: one C-token prompt
    segment (rows past `ch_seg_len` made exact identities) committed into
    the chunk request's state row `ch_state_idx` — `ch_seg_start == 0`
    selects zero carries on the device — then a decode token for every
    slot (`dec_state_idx` maps slot -> pool row; idle and prefilling slots
    point at the null row).  The lanes touch disjoint rows.  ch_next is
    the segment's next-token draw, read by the host only when the segment
    completes its prompt; ch_logits are what it was drawn from."""
    with matmul_dispatch(chunk_matmul_table):
        ch_logits = model.prefill_chunk_slots(
            params, conv_pool, ssm_pool, ch_state_idx, ch_tokens, ch_seg_len,
            ch_seg_start)
    with matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_slots(params, conv_pool, ssm_pool,
                                         dec_state_idx, dec_tokens)
    nxt = sample_tokens(logits[:, -1], dec_sampling, dec_keys)
    ch_next = sample_tokens(ch_logits[:, -1], ch_sampling, ch_keys)
    return nxt, ch_next, ch_logits[:, -1]


def ssm_decode_only_step(model, params, conv_pool: torch.Tensor,
                         ssm_pool: torch.Tensor, dec_state_idx, dec_tokens,
                         dec_sampling, dec_keys, *,
                         decode_matmul_table: Optional[MatmulTable] = None):
    """-> dec_next (slots,): the ssm unified step's decode lane alone."""
    with matmul_dispatch(decode_matmul_table):
        logits = model.decode_step_slots(params, conv_pool, ssm_pool,
                                         dec_state_idx, dec_tokens)
    return sample_tokens(logits[:, -1], dec_sampling, dec_keys)


def ssm_commit_state(conv_pool: torch.Tensor, ssm_pool: torch.Tensor,
                     conv: torch.Tensor, ssm: torch.Tensor,
                     rows: torch.Tensor) -> None:
    """Scatter S resuming requests' state, conv (L, S, W-1, conv_dim) and
    ssm (L, S, nh, hd, n), into pool rows `rows` (S,), in place.  Padding
    entries point at the null row, whose contents are unspecified."""
    rows = rows.long()
    conv_pool.index_copy_(1, rows, conv.to(conv_pool.dtype))
    ssm_pool.index_copy_(1, rows, ssm.to(ssm_pool.dtype))


def graph_ssm_unified_step(model, device, *, graphed: bool = True, pool=None,
                           **lanes) -> Program:
    """The ssm unified step program (`decode_matmul_table`,
    `chunk_matmul_table` fixed), called as `program((params, conv_pool,
    ssm_pool), (dec_state_idx, dec_tokens, ch_tokens, ch_state_idx,
    ch_seg_len, ch_seg_start, dec_sampling, dec_keys, ch_sampling,
    ch_keys))`."""
    return Program(functools.partial(ssm_unified_step, model, **lanes), "unified",
                   device, graphed=graphed, pool=pool)


def graph_ssm_decode_only_step(model, device, *, graphed: bool = True, pool=None,
                               **lanes) -> Program:
    """The ssm decode-only program (`decode_matmul_table` fixed), called as
    `program((params, conv_pool, ssm_pool), (dec_state_idx, dec_tokens,
    dec_sampling, dec_keys))`."""
    return Program(functools.partial(ssm_decode_only_step, model, **lanes),
                   "decode_only", device, graphed=graphed, pool=pool)


def graph_ssm_commit_state(device, *, graphed: bool = True, pool=None) -> Program:
    """The ssm resume-commit program: `ssm_commit_state`, called as
    `program((conv_pool, ssm_pool, conv, ssm), (rows,))` with the caller's
    fixed device buffers conv / ssm (filled in place before each call) and
    the (S,) int32 host array of rows, so it has one signature."""
    return Program(ssm_commit_state, "commit", device, graphed=graphed, pool=pool)


def prefill_step(model, params, tokens: torch.Tensor, max_seq: int,
                 extras: Optional[Dict[str, torch.Tensor]] = None):
    """The fixed-batch prefill: tokens (B, S) and the batch's modality
    extras (`vision_embeds` / `audio_embeds`, (B, ...)) -> (last-position
    logits (B, 1, V), the model's fixed-batch cache: dense K/V of
    `max_seq` rows, Mamba2's carries, or both, and the encoder's cross
    K/V)."""
    return model.prefill(params, {"tokens": tokens, **(extras or {})}, max_seq)


def serve_step(model, params, cache, tokens: torch.Tensor):
    """The fixed-batch decode step: tokens (B, 1) -> (logits (B, 1, V),
    the cache advanced by one row, updated in place)."""
    return model.decode_step(params, cache, tokens)
