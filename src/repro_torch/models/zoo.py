"""Model assembly — the port of the serving halves of the six families of
`repro.models.zoo`: `DecoderLM` (dense, moe and vlm: the paged path of the
continuous engine and the dense-cache path, `init_cache` / `prefill` /
`decode_step`, of the fixed-batch engine; the vlm's M-RoPE positions and
its vision embeddings), `MambaLM` (ssm: the slot-pooled path of the
continuous engine and the same fixed-batch path over the conv / SSM
carries), `HybridLM` (hybrid: Mamba2 layers with one shared attention
block, fixed-batch path) and `EncDecLM` (encdec: an encoder over audio
embeddings and a cross-attending decoder, fixed-batch path), and
`build_model`.

Parameters keep the JAX package's tree: layer leaves are stacked over
layers (leading dim n_layers), `dense` weights are (d_in, d_out), the MoE's
expert stacks are bare (E, d, f) / (E, f, d) tensors.  `init` draws from
the same distributions as the JAX init (different numbers: the randomness
is an explicit `torch.Generator`).  JAX keeps f32 parameters and casts each
weight to `cfg.dtype` where it is used; `serving_params` casts the
projection weights, the expert stacks and the embedding once instead (the
same rounding) and keeps the norm scales and biases and the encoder's
position table in f32, where JAX multiplies or adds them.  `init_serving`
gives `serving_params(init(gen))` without ever holding the f32 model: one
layer is drawn in f32 at a time.

The training halves (`hidden` / `forward` / `loss` of every family) run
on the f32 parameters under autograd, casting each weight at use as JAX
does, with the layer bodies wrapped by `_remat` (`cfg.remat`: none, dots,
full).  Each stacked leaf is split into its layers by one `unbind`
(`unbind_layers`), whose backward is one `stack` per leaf.

Every family publishes the logical axes of its parameters
(`logical_axes`, one tuple of axis names per leaf, "layers" leading the
stacked leaves; `block_logical_axes` for one decoder block) and of its
fixed-batch cache (`cache_logical_axes`); `DecoderLM` also of its paged
pools (`paged_cache_logical_axes`) and `MambaLM` of its slot pools
(`slot_state_logical_axes`), the reference's trees entry for entry.  The
`distributed.sharding` rules turn them into placements, and
`DecoderLM.tp_local_params` into one rank's shards for tensor-parallel
serving.

The vision patches and audio frames are stubs, as in the reference: the
batch carries pre-computed `vision_embeds` (B, nv, d) / `audio_embeds`
(B, S_enc, d).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_params, map_axes
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F
from repro_torch.models.common import (Params, chunked_softmax_xent, dense,
                                       dense_init, embed, embed_init, layer_norm,
                                       layer_norm_init, lm_head_logits, norm_init,
                                       rms_norm, torch_dtype)
from repro_torch.tree import tree_leaves, tree_map

ATTN_BACKENDS = ("torch", "cuda_attention")

# the leaves `serving_params` casts to the serving dtype: dense weights,
# the embedding and the MoE's expert stacks (JAX casts each at use)
CAST_LEAVES = ("w", "emb", "w_in", "w_gate", "w_out")


def _check_backend(name: str) -> None:
    if name not in ATTN_BACKENDS:
        raise ValueError(f"attention backend {name!r} not in {ATTN_BACKENDS}")


def _norm_init(cfg: ModelConfig, d: int, device=None) -> Params:
    return layer_norm_init(d, device) if cfg.norm == "layer" else norm_init(d, device)


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(p, x) if cfg.norm == "layer" else rms_norm(p, x)


# `checkpoint_dots_with_no_batch_dims`: the plain products (x @ w) are
# saved, the batched ones (attention's and the experts' bmm) recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """`fn` under the config's rematerialisation policy, as
    `repro.models.zoo._remat`: none saves every activation, dots saves the
    plain products' outputs, full (any other value) saves nothing and
    recomputes the layer in backward.  Outside autograd `fn` runs as is."""
    if cfg.remat == "none":
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if cfg.remat == "dots" else None)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {"context_fn": context_fn} if context_fn else {}
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One decoder block (dense, moe and vlm families)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"no decoder block for the {cfg.family} family")
    p = {
        "attn_norm": _norm_init(cfg, cfg.d_model, gen.device),
        "attn": A.attn_init(gen, cfg),
        "mlp_norm": _norm_init(cfg, cfg.d_model, gen.device),
    }
    if cfg.family == "moe":
        p["moe"] = F.moe_init(gen, cfg)
    else:
        p["mlp"] = F.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.act == "silu")
    return p


def _norm_axes(cfg: ModelConfig) -> Params:
    return ({"scale": (None,)} if cfg.norm == "rms"
            else {"scale": (None,), "bias": (None,)})


def block_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes of one decoder block's parameters (`block_init`)."""
    p = {
        "attn_norm": _norm_axes(cfg),
        "attn": A.attn_logical_axes(cfg),
        "mlp_norm": _norm_axes(cfg),
    }
    if cfg.family == "moe":
        p["moe"] = F.moe_logical_axes(cfg)
    else:
        p["mlp"] = F.mlp_logical_axes(gated=cfg.act == "silu")
    return p


def _layers_axes(block: Params) -> Params:
    """A block's axes with the leading "layers" dim of the stacked tree."""
    return map_axes(lambda ax: ("layers",) + ax, block)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _copy_into(stacked: Params, layer: Params, i: int) -> None:
    """Write one layer's tree into row i of the layer-stacked tree."""
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            _copy_into(v, layer[k], i)
    else:
        stacked[i].copy_(layer)


def layer_params(blocks: Params, layer: int) -> Params:
    """One layer's view of the layer-stacked `blocks` tree."""
    return tree_map(lambda t: t[layer], blocks)


def unbind_layers(blocks: Params) -> list:
    """Every layer's view of the layer-stacked `blocks` tree, from one
    `unbind` per leaf: under autograd its backward is one `stack`, where a
    `t[i]` per layer would add each layer's gradient into a zero tensor of
    the whole stack."""
    parts = tree_map(lambda t: t.unbind(0), blocks)
    n = len(next(tree_leaves(parts)))
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(n)]


def _mamba_layer(cfg: ModelConfig, x: torch.Tensor, bp: Params) -> torch.Tensor:
    """A Mamba2 layer of the training path: x + mamba(norm(x))."""
    return x + M.mamba_forward(bp["mamba"], cfg, _norm(cfg, bp["norm"], x))


class _StackedLM:
    """What the families' models share: the config, parameters whose
    `blocks` leaves are stacked over layers, the serving dtypes and the
    two inits, which draw the embedding, each layer's block (the family's
    `_block_init`), the subtrees outside the stack (`_shared_init`) and
    the LM head in that order."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _block_init(self, gen: torch.Generator) -> Params:
        raise NotImplementedError

    def _shared_init(self, gen: torch.Generator) -> Params:
        """Top-level subtrees drawn after the blocks (HybridLM's shared
        attention block); none by default."""
        return {}

    def init(self, generator: torch.Generator) -> Params:
        """f32 parameters on `generator.device`."""
        cfg = self.cfg
        emb = embed_init(generator, cfg.vocab, cfg.d_model)
        blocks = _stack([self._block_init(generator) for _ in range(cfg.n_layers)])
        return {
            "embed": emb,
            "blocks": blocks,
            **self._shared_init(generator),
            "final_norm": _norm_init(cfg, cfg.d_model, generator.device),
            "lm_head": dense_init(generator, cfg.d_model, cfg.vocab),
        }

    def init_serving(self, generator: torch.Generator, device=None) -> Params:
        """`serving_params(init(generator), device)`, bit for bit (the same
        draws in the same order, each cast as `serving_params` casts it),
        without the f32 model: each layer is drawn in f32 on
        `generator.device`, cast, and written into its row of (L, ...)
        stacks preallocated on `device` (default: the generator's) before
        the next is drawn.  Peak memory is the served model plus one f32
        layer and the f32 embedding or LM head."""
        cfg = self.cfg
        device = generator.device if device is None else device
        emb = self.serving_params(
            {"embed": embed_init(generator, cfg.vocab, cfg.d_model)}, device)
        blocks = None
        for i in range(cfg.n_layers):
            layer = self.serving_params(self._block_init(generator), device)
            if blocks is None:
                blocks = tree_map(lambda t: torch.empty((cfg.n_layers, *t.shape),
                                                        dtype=t.dtype, device=device),
                                  layer)
            _copy_into(blocks, layer, i)
            del layer
        shared = self.serving_params(self._shared_init(generator), device)
        rest = self.serving_params(
            {"final_norm": _norm_init(cfg, cfg.d_model, generator.device),
             "lm_head": dense_init(generator, cfg.d_model, cfg.vocab)}, device)
        return {**emb, "blocks": blocks, **shared, **rest}

    def serving_params(self, params: Params, device) -> Params:
        """`params` on `device`: the leaves named in CAST_LEAVES
        (projection weights, the embedding, the expert stacks) cast to
        `cfg.dtype`, every other leaf (norm scales and biases, the SSM's
        conv weights, A_log, D, dt_bias, the encoder's position table) in
        f32, where JAX casts, multiplies or adds at use."""
        dtype = torch_dtype(self.cfg.dtype)

        def walk(key, tree):
            if isinstance(tree, dict):
                return {k: walk(k, v) for k, v in tree.items()}
            cast = dtype if key in CAST_LEAVES else torch.float32
            return tree.to(device=device, dtype=cast).contiguous()

        return walk(None, params)

    def _layers(self, params: Params):
        return unbind_layers(params["blocks"])

    # ------------------------------------------------------------ training
    # each family's `hidden` gives the final-normed states (B, S, d)
    def forward(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) of the training / prefill path."""
        return lm_head_logits(params["lm_head"], self.hidden(params, batch))

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """-> (mean next-token NLL over batch["labels"] (and batch["mask"]),
        {"loss": it}), through `chunked_softmax_xent`."""
        x = self.hidden(params, batch)
        l = chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                 batch.get("mask"))
        return l, {"loss": l}


class DecoderLM(_StackedLM):
    """dense, moe and vlm families (qwen3-style: GQA, optional qk-norm,
    RoPE, RMSNorm; a SiLU-gated MLP, or the capacity-dispatched mixture of
    experts with optional shared experts; the vlm's M-RoPE positions and
    vision embeddings)."""

    def _block_init(self, gen: torch.Generator) -> Params:
        return block_init(gen, self.cfg)

    def logical_axes(self) -> Params:
        """The parameter tree's logical axes, leaf for leaf."""
        return {
            "embed": {"emb": ("vocab", "embed_tbl")},
            "blocks": _layers_axes(block_logical_axes(self.cfg)),
            "final_norm": _norm_axes(self.cfg),
            "lm_head": {"w": ("embed_vec", "vocab")},
        }

    def _mlp(self, bp: Params, x: torch.Tensor) -> torch.Tensor:
        h = _norm(self.cfg, bp["mlp_norm"], x)
        if self.cfg.family == "moe":
            return x + F.moe_apply(bp["moe"], self.cfg, h, self.cfg.act)
        return x + F.mlp_apply(bp["mlp"], h, self.cfg.act)

    # ------------------------------------------------------------ inputs
    def _position_ids(self, b: int, idx: torch.Tensor) -> torch.Tensor:
        """RoPE positions of the sequence indices `idx` (S,): (B, S), or
        with M-RoPE (B, S, 3).  M-RoPE (qwen2-vl): the first nv indices
        are the vision tokens' (0, h, w) on a grid x grid raster, the text
        tokens' streams all run max(idx - nv, 0) + grid.  Pure device
        arithmetic on `idx` (a chunk passes its rows' own positions)."""
        cfg = self.cfg
        s = idx.shape[0]
        if not cfg.mrope_sections:
            return idx.expand(b, s)
        nv = cfg.n_vision_tokens
        grid = max(1, int(math.sqrt(nv)))
        is_vis = idx < nv
        t_text = torch.clamp(idx - nv, min=0) + grid
        pt = torch.where(is_vis, 0, t_text)
        ph = torch.where(is_vis, torch.clamp(idx // grid, 0, grid - 1), t_text)
        pw = torch.where(is_vis, idx % grid, t_text)
        return torch.stack([pt, ph, pw], -1).expand(b, s, 3)

    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]):
        """The token embeddings (B, S, d); for the vlm with
        batch["vision_embeds"] (B, nv, d) those replace the first nv rows
        (as the reference concatenates them: a batch shorter than nv comes
        out nv rows long)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        if cfg.family == "vlm" and "vision_embeds" in batch:
            vis = batch["vision_embeds"]
            x = torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], 1)
        return x

    # -------------------------------------------------------- training
    def _block(self, x: torch.Tensor, bp: Params, positions: torch.Tensor):
        h = _norm(self.cfg, bp["attn_norm"], x)
        x = x + A.attn_forward(bp["attn"], self.cfg, h, positions=positions,
                               causal=True)
        return self._mlp(bp, x)

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        b, s, _ = x.shape
        positions = self._position_ids(b, torch.arange(s, device=x.device))
        body = _remat(cfg, self._block)
        for bp in self._layers(params):
            x = body(x, bp, positions)
        return _norm(cfg, params["final_norm"], x)

    # -------------------------------------------- dense-cache serving path
    def init_cache(self, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
        """Zeroed dense caches (L, batch, max_seq, Hkv, hd) of `cfg.dtype`
        and (batch,) int32 lengths."""
        cfg = self.cfg
        cache = A.init_cache(cfg, batch, max_seq, cfg.n_layers,
                             torch_dtype(cfg.dtype), device)
        cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=device)
        return cache

    def cache_logical_axes(self) -> Dict[str, Any]:
        ax = A.cache_logical_axes()
        ax["lengths"] = ("batch",)
        return ax

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """Run the whole prompt batch["tokens"] (B, S) (with the vlm's
        batch["vision_embeds"]), build a cache of `max_seq` rows holding
        its K/V; -> (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        b, s, _ = x.shape
        positions = self._position_ids(b, torch.arange(s, device=x.device))
        cache = self.init_cache(b, max_seq, x.device)
        for i, bp in enumerate(self._layers(params)):
            h = _norm(cfg, bp["attn_norm"], x)
            y, (k, v) = A.attn_forward(bp["attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True)
            cache["k"][i, :, :s] = k.to(cache["k"].dtype)
            cache["v"][i, :, :s] = v.to(cache["v"].dtype)
            x = self._mlp(bp, x + y)
        x = _norm(cfg, params["final_norm"], x)
        cache["lengths"].fill_(s)
        return lm_head_logits(params["lm_head"], x[:, -1:]), cache

    def decode_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), the cache with this row
        written in place and lengths advanced by one)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        lengths = cache["lengths"]
        for i, bp in enumerate(self._layers(params)):
            h = _norm(cfg, bp["attn_norm"], x)
            x = x + A.attn_decode(bp["attn"], cfg, h, cache["k"][i],
                                  cache["v"][i], lengths)
            x = self._mlp(bp, x)
        x = _norm(cfg, params["final_norm"], x)
        return lm_head_logits(params["lm_head"], x), dict(cache, lengths=lengths + 1)

    # ------------------------------------------------- paged serving path
    def decode_step_paged(self, params: Params, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, tokens: torch.Tensor, *,
                          attn_backend: str = "torch") -> torch.Tensor:
        """One decode step over the slot batch against the paged KV pools.

        k_pool/v_pool: (L, num_blocks, block_size, Hkv, hd), written in
        place; tokens: (B, 1); lengths (B,) the new token's position.
        Returns logits (B, 1, V)."""
        _check_backend(attn_backend)
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        rows = A.decode_write_rows(block_tables, lengths, k_pool.shape[2])
        for i, bp in enumerate(self._layers(params)):
            h = _norm(cfg, bp["attn_norm"], x)
            x = x + A.attn_decode_paged(bp["attn"], cfg, h, k_pool[i], v_pool[i],
                                        block_tables, lengths,
                                        backend=attn_backend, rows=rows)
            x = self._mlp(bp, x)
        x = _norm(cfg, params["final_norm"], x)
        return lm_head_logits(params["lm_head"], x)

    def prefill_packed_paged(self, params: Params, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, seg_tables: torch.Tensor,
                             tokens: torch.Tensor, seg_info: torch.Tensor, *,
                             attn_backend: str = "torch",
                             attn_config: Optional[Dict[str, Any]] = None
                             ) -> torch.Tensor:
        """A segment-packed prompt chunk against the paged KV pools — the
        prefill lane of the unified serving step.

        tokens (1, C) carries contiguous prompt segments from up to S
        requests; `seg_info` (S, 3) is [row_offset, seg_len, kv_start] and
        `seg_tables` (S, nbt) each segment's block table (idle rows:
        seg_len 0, all-null table).  Every layer writes each row's K/V into
        its own segment's blocks (in place) and attends causally over what
        its request committed so far.  Returns logits (1, S, V) at each
        segment's last real row."""
        _check_backend(attn_backend)
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        _, c, _ = x.shape
        _, pos, _ = A.packed_row_map(seg_info, c)     # pos zeroed on padding
        positions = self._position_ids(1, pos)
        rows = A.packed_write_rows(seg_tables, seg_info, c, k_pool.shape[2])
        for i, bp in enumerate(self._layers(params)):
            h = _norm(cfg, bp["attn_norm"], x)
            x = x + A.attn_prefill_packed(bp["attn"], cfg, h, k_pool[i],
                                          v_pool[i], seg_tables, positions,
                                          seg_info, backend=attn_backend,
                                          backend_config=attn_config, rows=rows)
            x = self._mlp(bp, x)
        x = _norm(cfg, params["final_norm"], x)
        info = seg_info.long()
        last = torch.clamp(info[:, 0] + info[:, 1] - 1, 0, c - 1)   # (S,)
        return lm_head_logits(params["lm_head"], x[:, last])

    @staticmethod
    def paged_cache_logical_axes() -> Dict[str, Any]:
        """Logical axes of the paged pools (L, num_blocks, block_size, Hkv,
        hd): blocks replicated, KV heads as the dense cache's."""
        ax = ("layers", None, None, "kv_heads", None)
        return {"k": ax, "v": ax}

    # ------------------------------------------------ tensor parallelism
    def tp_kv_heads(self, tp) -> tuple:
        """(first, count) of the KV heads the rank of `tp` (a
        `distributed.collectives.TensorParallel`) holds in its projections
        and its paged pools: `attention.tp_kv_heads`."""
        return A.tp_kv_heads(self.cfg, tp.rules, tp.rank, tp.size)

    def tp_local_params(self, params: Params, tp) -> Params:
        """The rank's shards of the serving parameters, plain tensors on
        their device: every leaf split by `tp.rules` over its logical axes
        (`distributed.sharding.local_params`); where "heads" is split and
        "kv_heads" is not, wk / wv keep only the KV heads the rank's query
        heads read (`tp_kv_heads`).  The dense family only: the MoE's
        expert parallelism and the vlm on a mesh are not ported."""
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"tensor-parallel serving of the {self.cfg.family} family is not "
                "ported yet: ROADMAP.md queue 1, item 8b-ii")
        local = local_params(params, self.logical_axes(), tp.rules,
                             {"model": tp.size}, {"model": tp.rank})
        if tp.sharded("heads") and not tp.sharded("kv_heads"):
            first, n = self.tp_kv_heads(tp)
            hd = self.cfg.hd
            attn = local["blocks"]["attn"]
            for name in ("wk", "wv"):
                attn[name]["w"] = attn[name]["w"][..., first * hd:(first + n) * hd].contiguous()
        return local


# ===================================================================== Mamba2
class MambaLM(_StackedLM):
    """ssm family (Mamba2: SSD scan, depthwise causal conv, gated RMSNorm;
    attention-free).  Per-request state is fixed-size — one conv window
    and one SSM state per layer — so the continuous engine keeps it in a
    slot-pooled cache (`serve.statecache`): each request owns one row of
    (L, num_slots, ...) pools for its residency, and every index the
    serving methods take may be a device tensor, so a captured step
    program serves every schedule."""

    def _block_init(self, gen: torch.Generator) -> Params:
        return {"norm": norm_init(self.cfg.d_model, gen.device),
                "mamba": M.mamba_init(gen, self.cfg)}

    def logical_axes(self) -> Params:
        block = {"norm": {"scale": (None,)}, "mamba": M.mamba_logical_axes(self.cfg)}
        return {
            "embed": {"emb": ("vocab", "embed_tbl")},
            "blocks": _layers_axes(block),
            "final_norm": {"scale": (None,)},
            "lm_head": {"w": ("embed_vec", "vocab")},
        }

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training path (S at most `ssm_chunk` or a multiple of it)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        body = _remat(cfg, functools.partial(_mamba_layer, cfg))
        for bp in self._layers(params):
            x = body(x, bp)
        return _norm(cfg, params["final_norm"], x)

    # ------------------------------------------------- fixed-batch serving
    def init_cache(self, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
        """Zeroed carries: conv (L, batch, W-1, conv_dim) and ssm (L, batch,
        nh, hd, n), both f32, and (batch,) int32 lengths; `max_seq` is
        unused (the state does not grow)."""
        del max_seq
        conv, h = M.mamba_init_state(self.cfg, batch, device)
        n_layers = self.cfg.n_layers
        return {"conv": conv.expand(n_layers, *conv.shape).clone(),
                "ssm": h.expand(n_layers, *h.shape).clone(),
                "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def cache_logical_axes(self) -> Dict[str, Any]:
        return {"conv": ("layers", "batch", None, "conv_dim"),
                "ssm": ("layers", "batch", "ssm_heads", None, "ssm_state"),
                "lengths": ("batch",)}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """The whole prompt batch["tokens"] (B, S) through the SSD scan (S
        at most `ssm_chunk` or a multiple of it); -> (last-position logits
        (B, 1, V), the carries after it)."""
        del max_seq
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        b, s, _ = x.shape
        convs, hs = [], []
        for bp in self._layers(params):
            h = rms_norm(bp["norm"], x)
            y, (conv, hstate) = M.mamba_forward(bp["mamba"], cfg, h,
                                                return_state=True)
            x = x + y
            convs.append(conv.float())
            hs.append(hstate)
        x = rms_norm(params["final_norm"], x)
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(hs),
                 "lengths": torch.full((b,), s, dtype=torch.int32, device=x.device)}
        return lm_head_logits(params["lm_head"], x[:, -1:]), cache

    def decode_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), the cache with its carries
        advanced in place and lengths advanced by one)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        for i, bp in enumerate(self._layers(params)):
            hin = rms_norm(bp["norm"], x)
            y, conv, h = M.mamba_decode(bp["mamba"], cfg, hin, cache["conv"][i],
                                        cache["ssm"][i])
            x = x + y
            cache["conv"][i] = conv
            cache["ssm"][i] = h
        x = rms_norm(params["final_norm"], x)
        return (lm_head_logits(params["lm_head"], x),
                dict(cache, lengths=cache["lengths"] + 1))

    # ------------------------------------------------- continuous serving
    # The slot-pooled counterparts of DecoderLM's paged methods: each
    # layer gathers its rows of the pools, runs, and scatters them back in
    # place, one layer at a time (the reference gathers every layer's rows
    # up front: the same values, without an (L, B, nh, hd, n) transient).

    def prefill_chunk_slots(self, params: Params, conv_pool: torch.Tensor,
                            ssm_pool: torch.Tensor, state_idx, tokens: torch.Tensor,
                            seg_len, seg_start) -> torch.Tensor:
        """One prompt segment against the slot-pooled state cache — the
        prefill lane of the ssm unified step.

        tokens (1, C) holds the segment's rows from offset 0 (rows past
        `seg_len` are padding, made exact identities); `state_idx` is the
        request's pool row, `seg_start` the prompt offset of row 0: 0
        selects zero carries instead of the row, so a freshly claimed row
        needs no zeroing.  The three scalars may be device tensors.  The
        pools conv (L, rows, W-1, conv_dim) / ssm (L, rows, nh, hd, n) are
        updated in place.  Returns the logits (1, 1, V) at the segment's
        last real row."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        dev = x.device
        idx = torch.as_tensor(state_idx, device=dev).reshape(1).long()
        seg_len = torch.as_tensor(seg_len, device=dev).reshape(())
        fresh = torch.as_tensor(seg_start, device=dev).reshape(()) == 0
        for i, bp in enumerate(self._layers(params)):
            cc = conv_pool[i].index_select(0, idx).masked_fill(fresh, 0.0)
            hc = ssm_pool[i].index_select(0, idx).masked_fill(fresh, 0.0)
            hin = rms_norm(bp["norm"], x)
            y, cc, hc = M.mamba_chunk_forward(bp["mamba"], cfg, hin, cc, hc, seg_len)
            x = x + y
            conv_pool[i].index_copy_(0, idx, cc)
            ssm_pool[i].index_copy_(0, idx, hc)
        x = rms_norm(params["final_norm"], x)
        last = torch.clamp(seg_len.long() - 1, 0, x.shape[1] - 1).reshape(1)
        return lm_head_logits(params["lm_head"], x.index_select(1, last))

    def decode_step_slots(self, params: Params, conv_pool: torch.Tensor,
                          ssm_pool: torch.Tensor, state_idx,
                          tokens: torch.Tensor) -> torch.Tensor:
        """One decode token for every slot against the slot-pooled state
        cache.  state_idx (B,): pool rows — idle and prefilling slots point
        at the null row 0, whose reads and colliding write-backs are
        garbage no request reads.  tokens (B, 1).  The pools are updated in
        place; returns logits (B, 1, V)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        idx = torch.as_tensor(state_idx, device=x.device).long()
        for i, bp in enumerate(self._layers(params)):
            hin = rms_norm(bp["norm"], x)
            y, cv, h = M.mamba_decode(bp["mamba"], cfg, hin,
                                      conv_pool[i].index_select(0, idx),
                                      ssm_pool[i].index_select(0, idx))
            x = x + y
            conv_pool[i].index_copy_(0, idx, cv)
            ssm_pool[i].index_copy_(0, idx, h)
        x = rms_norm(params["final_norm"], x)
        return lm_head_logits(params["lm_head"], x)

    @staticmethod
    def slot_state_logical_axes() -> Dict[str, Any]:
        """Logical axes of the slot pools conv (L, rows, W-1, conv_dim) and
        ssm (L, rows, nh, hd, n): pool rows replicated."""
        return {"conv": ("layers", None, None, "conv_dim"),
                "ssm": ("layers", None, "ssm_heads", None, "ssm_state")}


# ===================================================================== Zamba2
class HybridLM(_StackedLM):
    """hybrid family (Zamba2): Mamba2 layers in groups of `attn_every`,
    each full group followed by ONE shared attention block (its parameters
    used at every application) that sees concat(hidden, the original
    embeddings) through a down-projection.  A remainder group gets no
    shared block.  Served by the fixed-batch loop: per layer a conv / SSM
    carry, per shared-block use a dense K / V cache."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.n_shared_uses = cfg.n_layers // cfg.attn_every

    def _group_sizes(self):
        cfg = self.cfg
        sizes = [cfg.attn_every] * (cfg.n_layers // cfg.attn_every)
        if cfg.n_layers % cfg.attn_every:
            sizes.append(cfg.n_layers % cfg.attn_every)
        return sizes

    def _block_init(self, gen: torch.Generator) -> Params:
        return {"norm": _norm_init(self.cfg, self.cfg.d_model, gen.device),
                "mamba": M.mamba_init(gen, self.cfg)}

    def _shared_init(self, gen: torch.Generator) -> Params:
        cfg, d = self.cfg, self.cfg.d_model
        return {"shared": {
            "in_proj": dense_init(gen, 2 * d, d),
            "attn_norm": _norm_init(cfg, d, gen.device),
            "attn": A.attn_init(gen, cfg),
            "mlp_norm": _norm_init(cfg, d, gen.device),
            "mlp": F.mlp_init(gen, d, cfg.d_ff),
        }}

    def logical_axes(self) -> Params:
        cfg = self.cfg
        block = {"norm": {"scale": (None,)}, "mamba": M.mamba_logical_axes(cfg)}
        return {
            "embed": {"emb": ("vocab", "embed_tbl")},
            "blocks": _layers_axes(block),
            "shared": {
                "in_proj": {"w": ("embed", "embed")},
                "attn_norm": {"scale": (None,)},
                "attn": A.attn_logical_axes(cfg),
                "mlp_norm": {"scale": (None,)},
                "mlp": F.mlp_logical_axes(),
            },
            "final_norm": {"scale": (None,)},
            "lm_head": {"w": ("embed_vec", "vocab")},
        }

    def _shared_apply(self, sp: Params, x: torch.Tensor, x0: torch.Tensor,
                      attend) -> torch.Tensor:
        """x + xin + mlp(norm(xin)), xin = in_proj(concat(x, x0)) +
        attend(norm(in_proj(...))); `attend` is the attention call (the
        whole prompt's or one decode token's)."""
        cfg = self.cfg
        xin = dense(sp["in_proj"], torch.cat([x, x0], -1))
        xin = xin + attend(_norm(cfg, sp["attn_norm"], xin))
        h = _norm(cfg, sp["mlp_norm"], xin)
        return x + xin + F.mlp_apply(sp["mlp"], h, cfg.act)

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training path: each group's Mamba2 layers under `_remat`,
        the shared block after each full group (not rematerialised, as in
        the reference)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        x0 = x
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        layers, sp = self._layers(params), params["shared"]
        body = _remat(cfg, functools.partial(_mamba_layer, cfg))

        def attend(h):
            return A.attn_forward(sp["attn"], cfg, h, positions=positions, causal=True)

        off = 0
        for gsize in self._group_sizes():
            for bp in layers[off:off + gsize]:
                x = body(x, bp)
            off += gsize
            if gsize == cfg.attn_every:
                x = self._shared_apply(sp, x, x0, attend)
        return _norm(cfg, params["final_norm"], x)

    def init_cache(self, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
        """Zeroed carries conv (L, batch, W-1, conv_dim) / ssm (L, batch,
        nh, hd, n) f32, dense K / V caches (n_shared_uses, batch, max_seq,
        Hkv, hd) of `cfg.dtype`, and (batch,) int32 lengths."""
        cfg = self.cfg
        conv, h = M.mamba_init_state(cfg, batch, device)
        kv = A.init_cache(cfg, batch, max_seq, self.n_shared_uses,
                          torch_dtype(cfg.dtype), device)
        return {"conv": conv.expand(cfg.n_layers, *conv.shape).clone(),
                "ssm": h.expand(cfg.n_layers, *h.shape).clone(),
                "k": kv["k"], "v": kv["v"],
                "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def cache_logical_axes(self) -> Dict[str, Any]:
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"conv": ("layers", "batch", None, "conv_dim"),
                "ssm": ("layers", "batch", "ssm_heads", None, "ssm_state"),
                "k": kv, "v": kv, "lengths": ("batch",)}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """The whole prompt batch["tokens"] (B, S) (S at most `ssm_chunk` or
        a multiple of it); -> (last-position logits (B, 1, V), the carries
        and the shared block's K / V after it)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        x0 = x
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        kv = A.init_cache(cfg, b, max_seq, self.n_shared_uses,
                          torch_dtype(cfg.dtype), x.device)
        layers, sp = self._layers(params), params["shared"]
        convs, hs = [], []

        def attend(h):
            y, (k, v) = A.attn_forward(sp["attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True)
            kv["k"][use, :, :s] = k.to(kv["k"].dtype)
            kv["v"][use, :, :s] = v.to(kv["v"].dtype)
            return y

        off = use = 0
        for gsize in self._group_sizes():
            for bp in layers[off:off + gsize]:
                h = _norm(cfg, bp["norm"], x)
                y, (conv, hstate) = M.mamba_forward(bp["mamba"], cfg, h,
                                                    return_state=True)
                x = x + y
                convs.append(conv.float())
                hs.append(hstate)
            off += gsize
            if gsize == cfg.attn_every:
                x = self._shared_apply(sp, x, x0, attend)
                use += 1
        x = _norm(cfg, params["final_norm"], x)
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(hs),
                 "k": kv["k"], "v": kv["v"],
                 "lengths": torch.full((b,), s, dtype=torch.int32, device=x.device)}
        return lm_head_logits(params["lm_head"], x[:, -1:]), cache

    def decode_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), the cache with its carries
        and K / V rows written in place and lengths advanced by one)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        x0 = x
        lengths = cache["lengths"]
        layers, sp = self._layers(params), params["shared"]

        def attend(h):
            return A.attn_decode(sp["attn"], cfg, h, cache["k"][use],
                                 cache["v"][use], lengths)

        off = use = 0
        for gsize in self._group_sizes():
            for i in range(off, off + gsize):
                hin = _norm(cfg, layers[i]["norm"], x)
                y, conv, h = M.mamba_decode(layers[i]["mamba"], cfg, hin,
                                            cache["conv"][i], cache["ssm"][i])
                x = x + y
                cache["conv"][i] = conv
                cache["ssm"][i] = h
            off += gsize
            if gsize == cfg.attn_every:
                x = self._shared_apply(sp, x, x0, attend)
                use += 1
        x = _norm(cfg, params["final_norm"], x)
        return (lm_head_logits(params["lm_head"], x),
                dict(cache, lengths=lengths + 1))


# ===================================================================== Whisper
class EncDecLM(_StackedLM):
    """encdec family (Whisper): a non-causal encoder over
    batch["audio_embeds"] plus a learned position table, and a decoder
    whose layers attend causally to the tokens (dense K / V cache) and
    across to the encoder output (each layer's K / V computed once, at
    prefill).  Layer norms, ungated tanh-gelu MLPs.  Served by the
    fixed-batch loop."""

    def _enc_block_init(self, gen: torch.Generator) -> Params:
        cfg, d = self.cfg, self.cfg.d_model
        return {"attn_norm": _norm_init(cfg, d, gen.device),
                "attn": A.attn_init(gen, cfg),
                "mlp_norm": _norm_init(cfg, d, gen.device),
                "mlp": F.mlp_init(gen, d, cfg.d_ff, gated=False)}

    def _dec_block_init(self, gen: torch.Generator) -> Params:
        cfg, d = self.cfg, self.cfg.d_model
        return {"self_norm": _norm_init(cfg, d, gen.device),
                "self_attn": A.attn_init(gen, cfg),
                "cross_norm": _norm_init(cfg, d, gen.device),
                "cross_attn": A.attn_init(gen, cfg),
                "mlp_norm": _norm_init(cfg, d, gen.device),
                "mlp": F.mlp_init(gen, d, cfg.d_ff, gated=False)}

    def init(self, generator: torch.Generator) -> Params:
        """f32 parameters on `generator.device` (the reference's tree)."""
        cfg, d, dev = self.cfg, self.cfg.d_model, generator.device
        return {
            "embed": embed_init(generator, cfg.vocab, d),
            "enc_pos": torch.randn((cfg.enc_seq, d), generator=generator,
                                   device=dev) * 0.01,
            "encoder": _stack([self._enc_block_init(generator)
                               for _ in range(cfg.n_enc_layers)]),
            "enc_norm": _norm_init(cfg, d, dev),
            "decoder": _stack([self._dec_block_init(generator)
                               for _ in range(cfg.n_layers)]),
            "final_norm": _norm_init(cfg, d, dev),
            "lm_head": dense_init(generator, d, cfg.vocab),
        }

    def logical_axes(self) -> Params:
        cfg = self.cfg
        enc_block = {
            "attn_norm": _norm_axes(cfg), "attn": A.attn_logical_axes(cfg),
            "mlp_norm": _norm_axes(cfg), "mlp": F.mlp_logical_axes(gated=False),
        }
        dec_block = {
            "self_norm": _norm_axes(cfg), "self_attn": A.attn_logical_axes(cfg),
            "cross_norm": _norm_axes(cfg), "cross_attn": A.attn_logical_axes(cfg),
            "mlp_norm": _norm_axes(cfg), "mlp": F.mlp_logical_axes(gated=False),
        }
        return {
            "embed": {"emb": ("vocab", "embed_tbl")},
            "enc_pos": (None, "embed"),
            "encoder": _layers_axes(enc_block),
            "enc_norm": _norm_axes(cfg),
            "decoder": _layers_axes(dec_block),
            "final_norm": _norm_axes(cfg),
            "lm_head": {"w": ("embed_vec", "vocab")},
        }

    def init_serving(self, generator: torch.Generator, device=None) -> Params:
        """`serving_params(init(generator), device)` (the f32 model is
        small enough to hold: whisper-base is ~0.3 GB)."""
        device = generator.device if device is None else device
        return self.serving_params(self.init(generator), device)

    def _enc_block(self, x: torch.Tensor, bp: Params) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(cfg, bp["attn_norm"], x)
        x = x + A.attn_forward(bp["attn"], cfg, h, positions=None, causal=False)
        h = _norm(cfg, bp["mlp_norm"], x)
        return x + F.mlp_apply(bp["mlp"], h, "gelu")

    def encode(self, params: Params, audio_embeds: torch.Tensor) -> torch.Tensor:
        """audio_embeds (B, S_enc, d) -> the encoder output (B, S_enc, d)."""
        cfg = self.cfg
        x = audio_embeds.to(torch_dtype(cfg.dtype))
        x = x + params["enc_pos"].to(x.dtype)[None, :x.shape[1]]
        body = _remat(cfg, self._enc_block)
        for bp in unbind_layers(params["encoder"]):
            x = body(x, bp)
        return _norm(cfg, params["enc_norm"], x)

    def _dec_block(self, x: torch.Tensor, bp: Params, positions: torch.Tensor,
                   ek: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
        h = _norm(self.cfg, bp["self_norm"], x)
        x = x + A.attn_forward(bp["self_attn"], self.cfg, h, positions=positions,
                               causal=True)
        return self._cross_mlp(bp, x, ek, ev)

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training path: encode batch["audio_embeds"], every decoder
        layer's cross K / V from it (outside `_remat`, as the reference
        computes them before its layer scan), then the decoder layers."""
        cfg = self.cfg
        enc = self.encode(params, batch["audio_embeds"])
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        layers = unbind_layers(params["decoder"])
        enc_kv = [A.cross_kv(bp["cross_attn"], cfg, enc) for bp in layers]
        body = _remat(cfg, self._dec_block)
        for bp, (ek, ev) in zip(layers, enc_kv):
            x = body(x, bp, positions, ek, ev)
        return _norm(cfg, params["final_norm"], x)

    def _cross_mlp(self, bp: Params, x: torch.Tensor, ek: torch.Tensor,
                   ev: torch.Tensor) -> torch.Tensor:
        """A decoder layer after its self-attention: cross-attention over
        (ek, ev), then the MLP."""
        cfg = self.cfg
        h = _norm(cfg, bp["cross_norm"], x)
        x = x + A.attn_forward(bp["cross_attn"], cfg, h, kv_override=(ek, ev))
        h = _norm(cfg, bp["mlp_norm"], x)
        return x + F.mlp_apply(bp["mlp"], h, "gelu")

    def init_cache(self, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
        """Zeroed self-attention caches k / v (L, batch, max_seq, Hkv, hd),
        cross-attention K / V ek / ev (L, batch, enc_seq, Hkv, hd), both of
        `cfg.dtype`, and (batch,) int32 lengths."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        kv = A.init_cache(cfg, batch, max_seq, cfg.n_layers, dtype, device)
        enc = A.init_cache(cfg, batch, cfg.enc_seq, cfg.n_layers, dtype, device)
        return {"k": kv["k"], "v": kv["v"], "ek": enc["k"], "ev": enc["v"],
                "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def cache_logical_axes(self) -> Dict[str, Any]:
        ax = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"k": ax, "v": ax, "ek": ax, "ev": ax, "lengths": ("batch",)}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """Encode batch["audio_embeds"], then run the whole prompt
        batch["tokens"] (B, S); -> (last-position logits (B, 1, V), a cache
        of `max_seq` self-attention rows and each layer's cross K / V)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        enc = self.encode(params, batch["audio_embeds"])
        x = embed(params["embed"], batch["tokens"], dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        kv = A.init_cache(cfg, b, max_seq, cfg.n_layers, dtype, x.device)
        eks, evs = [], []
        for i, bp in enumerate(unbind_layers(params["decoder"])):
            ek, ev = A.cross_kv(bp["cross_attn"], cfg, enc)
            eks.append(ek.to(dtype))
            evs.append(ev.to(dtype))
            h = _norm(cfg, bp["self_norm"], x)
            y, (k, v) = A.attn_forward(bp["self_attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True)
            kv["k"][i, :, :s] = k.to(dtype)
            kv["v"][i, :, :s] = v.to(dtype)
            x = self._cross_mlp(bp, x + y, ek, ev)
        x = _norm(cfg, params["final_norm"], x)
        cache = {"k": kv["k"], "v": kv["v"], "ek": torch.stack(eks),
                 "ev": torch.stack(evs),
                 "lengths": torch.full((b,), s, dtype=torch.int32, device=x.device)}
        return lm_head_logits(params["lm_head"], x[:, -1:]), cache

    def decode_step(self, params: Params, cache: Dict[str, Any],
                    tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), the cache with this row
        written in place and lengths advanced by one)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
        lengths = cache["lengths"]
        for i, bp in enumerate(unbind_layers(params["decoder"])):
            h = _norm(cfg, bp["self_norm"], x)
            x = x + A.attn_decode(bp["self_attn"], cfg, h, cache["k"][i],
                                  cache["v"][i], lengths)
            x = self._cross_mlp(bp, x, cache["ek"][i], cache["ev"][i])
        x = _norm(cfg, params["final_norm"], x)
        return lm_head_logits(params["lm_head"], x), dict(cache, lengths=lengths + 1)


# ===================================================================== factory
def build_model(cfg: ModelConfig):
    """The model class of `cfg.family`, as `repro.models.build_model`
    dispatches: dense, moe and vlm to DecoderLM, ssm to MambaLM, hybrid to
    HybridLM, encdec to EncDecLM."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    raise ValueError(f"unknown family {cfg.family}")
