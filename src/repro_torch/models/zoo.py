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
(`unbind_layers`), whose backward is one `stack` per leaf; in the train
step each layer's gradient goes straight into its row of the leaf's
`.grad` (`common.grads_into_grad`).

Every family publishes the logical axes of its parameters
(`logical_axes`, one tuple of axis names per leaf, "layers" leading the
stacked leaves; `block_logical_axes` for one decoder block) and of its
fixed-batch cache (`cache_logical_axes`); `DecoderLM` also of its paged
pools (`paged_cache_logical_axes`) and `MambaLM` of its slot pools
(`slot_state_logical_axes`), the reference's trees entry for entry.  The
`distributed.sharding` rules turn them into placements, and
`tp_layout` into one rank's tensor-parallel cut, leaf by leaf, as
positions of the whole leaf (`distributed.sharding.LeafCut`): each
family's `tp_local_params` applies it to the serving parameters
(`init_serving(..., tp=)` draws the model straight into them), the train
step to its state (its gradients summed where several ranks hold a
position), and `gather_cut` is its inverse, back to the reference's
layout for checkpoints and comparisons.  The training halves run on a
rank's f32 master shards inside its `tensor_parallel` context; `_remat`
bodies recompute their collectives in backward in the same order on
every rank.
On those shards the fixed-batch path (`init_cache` / `prefill` /
`decode_step`, under the rank's `TensorParallel` context) runs every
family with its caches at the rank's widths: K / V at its KV heads, the
conv window at its head-aligned channels, the SSM state at its heads.
Under the serving layouts of the production meshes
(`distributed.collectives.split_groups`) the caches also hold the rank's
rows of the batch ("batch"), its block of the KV positions ("kv_seq") and
of the SSM state's columns ("ssm_state"): `init_cache(batch, max_seq)`
takes the whole batch and sequence and gives the rank's cut of them,
prefill writes the rank's part of what it computes, and the decode steps
merge attention and C · h over the groups (`attention`, `mamba`).  Where
"seq" is split (the sequence-parallel prefill of a replicated batch) each
prefill runs the rank's block of the prompt at its global positions
(`distributed.collectives.SeqSplit`): the SSD's state folded across the
ranks and the conv's halo (`mamba`), attention over every rank's K / V
(`attention`), the MoE's sequence groups across the ranks (`mlp`), and
the last position's logits from the rank that holds it, the same bits on
every rank.

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
from repro_torch.distributed.collectives import bind, current, seq_split, split_group
from repro_torch.distributed.sharding import LeafCut, is_axes, local_rows, map_axes
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F
from repro_torch.models.common import (Params, chunked_softmax_xent, dense,
                                       dense_init, embed, embed_init,
                                       grads_into_grad_active, layer_into_grad,
                                       layer_norm, layer_norm_init, lm_head_logits,
                                       norm_init, rms_norm, torch_dtype)
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
        # the recompute sees the tensor-parallel context of this forward
        return checkpoint(bind(fn), *args, use_reentrant=False, preserve_rng_state=False,
                          **kw)

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


class _LayersIntoGrad:
    """The layers of a layer-stacked tree within `common.grads_into_grad`:
    layer i's views (`common.layer_into_grad`) made when it is read, so
    each layer's gradients go into the leaves' `.grad` as soon as its
    backward has run."""

    def __init__(self, blocks: Params):
        self.blocks = blocks
        self.n = next(tree_leaves(blocks)).shape[0]

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.n))]
        if not -self.n <= i < self.n:
            raise IndexError(i)
        return tree_map(lambda t: layer_into_grad(t, i % self.n), self.blocks)

    def __iter__(self):
        return (self[i] for i in range(self.n))


def unbind_layers(blocks: Params):
    """Every layer's view of the layer-stacked `blocks` tree, from one
    `unbind` per leaf (under autograd its backward is one `stack`, after
    every layer's backward has run; a `t[i]` per layer would add each
    layer's gradient into a zero tensor of the whole stack), or within
    `common.grads_into_grad` a sequence whose layer i is made when read
    (`_LayersIntoGrad`)."""
    if grads_into_grad_active():
        return _LayersIntoGrad(blocks)
    parts = tree_map(lambda t: t.unbind(0), blocks)
    n = len(next(tree_leaves(parts)))
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(n)]


def _mamba_layer(cfg: ModelConfig, x: torch.Tensor, bp: Params, seq=None) -> torch.Tensor:
    """A Mamba2 layer of the training path: x + mamba(norm(x)) (with `seq`,
    on the rank's block of the sequence)."""
    return x + M.mamba_forward(bp["mamba"], cfg, _norm(cfg, bp["norm"], x), seq=seq)


def _draw_layers(key: str, block_init, n: int, draw, device) -> Params:
    """The layer-stacked tree `key` of `n` layers, each drawn by
    `block_init()`, passed through `draw` as {key: the layer with a leading
    dim of 1} (`draw` cuts and casts a top-level subtree) and written into
    its row of (n, ...) stacks preallocated on `device` before the next is
    drawn."""
    stack = None
    for i in range(n):
        layer = tree_map(lambda t: t[0], draw(
            {key: tree_map(lambda t: t[None], block_init())})[key])
        if stack is None:
            stack = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                                   device=device), layer)
        _copy_into(stack, layer, i)
        del layer
    return stack


class MetaGenerator(torch.Generator):
    """A generator whose `device` is "meta": `model.init(MetaGenerator())`
    gives the parameter tree's shapes and dtypes without drawing or
    allocating anything (the reference's `jax.eval_shape`)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


_ATTN_KEYS = ("attn", "self_attn", "cross_attn")


def _cut_index(cfg: ModelConfig, path, axes, shape, rules, rank: int, size: int):
    """(dim, positions along it) of a leaf that rank `rank` of a
    `size`-wide model axis holds under `rules` (see `tp_layout`), or None
    where it holds the whole leaf."""
    ar = torch.arange
    heads = size > 1 and rules.lookup("heads") == "model"
    kv = size > 1 and rules.lookup("kv_heads") == "model"
    if (len(path) >= 3 and path[-2] in ("wk", "wv") and path[-3] in _ATTN_KEYS
            and heads and not kv):
        first, n = A.tp_kv_heads(cfg, rules, rank, size)
        if n == cfg.n_kv_heads:                  # every rank holds every KV head
            return None
        return len(shape) - 1, ar(first * cfg.hd, (first + n) * cfg.hd)
    mamba = "mamba" in path[-3:]
    if mamba and size > 1 and rules.lookup("ssm_heads") == "model" and (
            path[-2:] == ("in_proj", "w") or path[-1] in ("conv_w", "conv_b")):
        cols, chans = M.tp_columns(cfg, rank, size)
        return len(shape) - 1, (cols if path[-1] == "w" else chans)
    if (mamba and path[-2:] == ("out_proj", "w") and size > 1
            and rules.lookup("conv_dim") == "model"):
        n = shape[-2] // size
        return len(shape) - 2, ar(rank * n, (rank + 1) * n)
    spec = rules.replace(conv_dim=None).spec(tuple(axes) + (None,) * (len(shape) - len(axes)))
    for i, entry in enumerate(spec):
        if size > 1 and (entry == "model" or (isinstance(entry, tuple) and "model" in entry)):
            if shape[i] % size:
                raise ValueError(f"logical axes {tuple(axes)}: dim {i} of {tuple(shape)} "
                                 f"does not split into {size} blocks")
            n = shape[i] // size
            return i, ar(rank * n, (rank + 1) * n)
    return None


def _rows(batch: int) -> int:
    """The rank's rows of a whole batch of `batch` (`split_group("batch")`)."""
    return local_rows(batch, split_group("batch"))[1]


def _whole(rows: int) -> int:
    """The whole batch of which the rank holds `rows` rows."""
    group = split_group("batch")
    return rows * (1 if group is None else group.size)


def _block_tokens(tokens: torch.Tensor, seq) -> torch.Tensor:
    """The rank's block of a prompt's tokens (B, S) (all of them with no
    `seq`, a `distributed.collectives.SeqSplit`)."""
    return tokens if seq is None else tokens[:, seq.start:seq.start + seq.count]


def _block_positions(b: int, s: int, seq, device) -> torch.Tensor:
    """The global positions (B, s) of the rank's block of a prompt."""
    start = 0 if seq is None else seq.start
    return torch.arange(start, start + s, device=device).expand(b, s)


def _last_normed(norm, x: torch.Tensor, seq) -> torch.Tensor:
    """`norm` of the prompt's last position (B, 1, d): from the rank whose
    block holds it, the same bits on every rank, where `seq` splits it."""
    if seq is None:
        return norm(x)[:, -1:]
    return norm(seq.last(x))


def gather_cut(cut: LeafCut, local: torch.Tensor, tp) -> torch.Tensor:
    """The whole leaf from every rank's model-axis shard `local` under
    `cut` (collective over `tp`'s group): equal blocks concatenated in rank
    order, other cuts (shards padded to the longest) placed position by
    position from each position's owner; a leaf no rank splits is `local`
    itself."""
    if cut.dim is None:
        return local
    if cut.blocks:
        return tp.all_gather(local.detach(), cut.dim)
    pad = list(local.shape)
    pad[cut.dim] = max(len(i) for i in cut.indices) - local.shape[cut.dim]
    parts = tp._gather(torch.cat([local.detach(), local.new_zeros(pad)], cut.dim))
    shape = list(local.shape)
    shape[cut.dim] = cut.full
    whole = local.new_empty(shape)
    for r, part in enumerate(parts):
        own = cut.owned(r).to(local.device)
        whole.index_copy_(cut.dim, cut.indices[r].to(local.device)[own],
                          part.index_select(cut.dim, own))
    return whole


@functools.lru_cache(maxsize=None)
def _param_shapes(cls, cfg: ModelConfig) -> Params:
    return cls(cfg).init(MetaGenerator())


@functools.lru_cache(maxsize=64)
def _tp_layout(cls, cfg: ModelConfig, rules, rank: int, size: int) -> Params:
    """`_StackedLM.tp_layout`, once per (family, config, rules, rank, size)."""
    heads = size > 1 and rules.lookup("heads") == "model"

    def walk(axes, shape, path):
        if not is_axes(axes):
            return {k: walk(axes[k], shape[k], path + (k,)) for k in axes}
        shape = tuple(shape.shape)
        cuts = [_cut_index(cfg, path, axes, shape, rules, r, size) for r in range(size)]
        partial = heads and len(path) >= 2 and path[-2] in ("q_norm", "k_norm")
        if cuts[0] is None:
            return LeafCut(rank=rank, partial=partial)
        return LeafCut.split(cuts[0][0], [c[1] for c in cuts], shape[cuts[0][0]], rank)

    model = cls(cfg)
    return walk(model.logical_axes(), model.param_shapes(), ())


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

    def init_serving(self, generator: torch.Generator, device=None,
                     tp=None) -> Params:
        """`serving_params(init(generator), device)`, bit for bit (the same
        draws in the same order, each cast as `serving_params` casts it),
        without the f32 model: each layer is drawn in f32 on
        `generator.device`, cast, and written into its row of (L, ...)
        stacks preallocated on `device` (default: the generator's) before
        the next is drawn.  Peak memory is the served model plus one f32
        layer and the f32 embedding or LM head.

        With `tp` (a `distributed.collectives.TensorParallel`), the rank's
        shards of those parameters, `tp_local_params(init_serving(...))`
        bit for bit: each part is cut to the rank's blocks as soon as it is
        drawn, so the rank holds its shards plus one f32 layer (or the f32
        embedding or LM head) and its f32 shard, never the whole model."""
        cfg = self.cfg
        device = generator.device if device is None else device

        def draw(tree):
            # cut in f32, then cast: the same bits as the cast cut
            if tp is not None:
                tree = self.tp_local_params(tree, tp)
            return self.serving_params(tree, device)

        emb = draw({"embed": embed_init(generator, cfg.vocab, cfg.d_model)})
        blocks = _draw_layers("blocks", lambda: self._block_init(generator),
                              cfg.n_layers, draw, device)
        shared = draw(self._shared_init(generator))
        rest = draw({"final_norm": _norm_init(cfg, cfg.d_model, generator.device),
                     "lm_head": dense_init(generator, cfg.d_model, cfg.vocab)})
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

    # ------------------------------------------------ tensor parallelism
    def param_shapes(self) -> Params:
        """The parameter tree as meta tensors (shapes and dtypes, nothing
        drawn or allocated: the reference's `jax.eval_shape` of `init`),
        built once per config; not to be modified."""
        return _param_shapes(type(self), self.cfg)

    def _tp_cut(self, params: Params, tp) -> Params:
        """The rank's shards of `params` (the whole tree or some of its
        top-level subtrees, a leaf's layers dim of any length): each leaf
        cut as `tp_layout` says (`LeafCut.model_local`), plain tensors on
        their device."""
        layout = self.tp_layout(tp)
        return tree_map(lambda t, cut: cut.model_local(t), params,
                        {k: layout[k] for k in params})

    def tp_local_params(self, params: Params, tp) -> Params:
        """The rank's shards of the serving parameters: each family defines
        its own (`DecoderLM`, `MambaLM`, `HybridLM`, `EncDecLM`)."""
        raise NotImplementedError(
            f"{type(self).__name__} ({self.cfg.family} family) defines no "
            "tensor-parallel shards; the six families are served on a mesh by "
            "FixedBatchEngine / ServeEngine(mesh=, rules=), and dense / moe / vlm / "
            "ssm also by ContinuousEngine(mesh=, rules=)")

    def tp_layout(self, tp) -> Params:
        """The parameter tree's `distributed.sharding.LeafCut`s for the
        rank of `tp` (anything with `rules`, `rank` and `size`): the one
        tensor-parallel cut of the model, which `tp_local_params` applies
        to serving and the train step to its state.  Each leaf is cut along
        at most one dim, given as the whole leaf's positions there for
        every rank, so each position's owner and the positions several
        ranks hold are known: the logical axes' contiguous blocks, wk / wv
        at the KV heads the rank's query heads read where "heads" is split
        and "kv_heads" is not (`attention.tp_kv_heads`), mamba's in_proj
        columns and conv channels head-aligned where "ssm_heads" is split
        (`mamba.tp_columns`: B and C on every rank) and its out_proj's d_in
        rows in blocks where "conv_dim" is.  `partial` marks the whole
        leaves read inside a split region, whose gradient is a partial on
        each rank: the q / k norms of split attention heads.  A split dim
        that does not divide raises ValueError naming the leaf's axes."""
        return _tp_layout(type(self), self.cfg, tp.rules, tp.rank, tp.size)

    # ------------------------------------------------------------ training
    # each family's `hidden` gives the final-normed states (B, S, d)
    def forward(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) of the training / prefill path."""
        return lm_head_logits(params["lm_head"], self.hidden(params, batch))

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """-> (mean next-token NLL over batch["labels"] (and batch["mask"]),
        {"loss": it}), through `chunked_softmax_xent`.  Where the "seq"
        group splits the sequence (sequence-parallel training) `hidden`
        gives the rank's block of positions and the loss reads the block's
        labels and mask; its sums are reduced over the group installed by
        `collectives.data_parallel`."""
        x = self.hidden(params, batch)
        labels, mask = batch["labels"], batch.get("mask")
        seq = seq_split(labels.shape[1])
        labels = _block_tokens(labels, seq)
        mask = None if mask is None else _block_tokens(mask, seq)
        l = chunked_softmax_xent(x, params["lm_head"]["w"], labels, mask)
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

    def _mlp(self, bp: Params, x: torch.Tensor, seq=None) -> torch.Tensor:
        h = _norm(self.cfg, bp["mlp_norm"], x)
        if self.cfg.family == "moe":
            return x + F.moe_apply(bp["moe"], self.cfg, h, self.cfg.act, seq)
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

    def _vision(self, batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        return batch.get("vision_embeds") if self.cfg.family == "vlm" else None

    def _seq_len(self, batch: Dict[str, torch.Tensor]) -> int:
        """The length of the embedded sequence (`_embed_inputs`)."""
        vis = self._vision(batch)
        s = batch["tokens"].shape[1]
        return s if vis is None else max(s, vis.shape[1])

    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor], seq=None):
        """The token embeddings (B, S, d); for the vlm with
        batch["vision_embeds"] (B, nv, d) those replace the first nv rows
        (as the reference concatenates them: a batch shorter than nv comes
        out nv rows long).  With `seq` (a `distributed.collectives.SeqSplit`
        of `_seq_len`) the rank's block of those rows: the vision rows of
        global positions 0..nv-1 that fall in it, then its tokens'."""
        vis = self._vision(batch)
        lo, hi = (0, self._seq_len(batch)) if seq is None else (seq.start,
                                                                seq.start + seq.count)
        nv = 0 if vis is None else vis.shape[1]
        x = embed(params["embed"], batch["tokens"][:, max(lo, nv):max(hi, nv)],
                  torch_dtype(self.cfg.dtype))
        if nv:
            x = torch.cat([vis[:, lo:min(hi, nv)].to(x.dtype), x], 1)
        return x

    # -------------------------------------------------------- training
    def _block(self, x: torch.Tensor, bp: Params, positions: torch.Tensor, seq=None):
        h = _norm(self.cfg, bp["attn_norm"], x)
        x = x + A.attn_forward(bp["attn"], self.cfg, h, positions=positions,
                               causal=True, seq=seq)
        return self._mlp(bp, x, seq)

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training path's final-normed states (B, S, d); where the
        "seq" group splits the sequence, those of the rank's block
        (`SeqSplit`: attention over every rank's K / V, the MoE's groups
        across the ranks)."""
        cfg = self.cfg
        seq = seq_split(self._seq_len(batch))
        x = self._embed_inputs(params, batch, seq)
        b, s, _ = x.shape
        start = 0 if seq is None else seq.start
        positions = self._position_ids(b, torch.arange(start, start + s, device=x.device))
        body = _remat(cfg, self._block)
        for bp in self._layers(params):
            x = body(x, bp, positions, seq)
        return _norm(cfg, params["final_norm"], x)

    # -------------------------------------------- dense-cache serving path
    def init_cache(self, batch: int, max_seq: int, device=None,
                   tp=None) -> Dict[str, Any]:
        """Zeroed dense caches (L, batch, max_seq, Hkv, hd) of `cfg.dtype`
        and (batch,) int32 lengths, as the rank holds them: Hkv its own
        under `tp`, its rows and positions where the groups installed
        split them."""
        cfg = self.cfg
        rows = _rows(batch)
        cache = A.init_cache(cfg, rows, max_seq, cfg.n_layers,
                             torch_dtype(cfg.dtype), device, tp)
        cache["lengths"] = torch.zeros((rows,), dtype=torch.int32, device=device)
        return cache

    def cache_logical_axes(self) -> Dict[str, Any]:
        ax = A.cache_logical_axes()
        ax["lengths"] = ("batch",)
        return ax

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """Run the whole prompt batch["tokens"] (B, S) (with the vlm's
        batch["vision_embeds"]), build a cache of `max_seq` rows holding
        its K/V; -> (last-position logits (B, 1, V), cache).  Where the
        "seq" group splits the prompt (the sequence-parallel prefill) the
        rank runs its block of it (`SeqSplit`), the logits and the cache
        those of the whole prompt."""
        cfg = self.cfg
        total = self._seq_len(batch)
        seq = seq_split(total)
        x = self._embed_inputs(params, batch, seq)
        b, s, _ = x.shape
        start = 0 if seq is None else seq.start
        positions = self._position_ids(b, torch.arange(start, start + s, device=x.device))
        cache = self.init_cache(_whole(b), max_seq, x.device, current())
        for i, bp in enumerate(self._layers(params)):
            h = _norm(cfg, bp["attn_norm"], x)
            y, (k, v) = A.attn_forward(bp["attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True, seq=seq)
            A.cache_write(cache["k"][i], k)
            A.cache_write(cache["v"][i], v)
            x = self._mlp(bp, x + y, seq)
        x = _last_normed(functools.partial(_norm, cfg, params["final_norm"]), x, seq)
        cache["lengths"].fill_(total)
        return lm_head_logits(params["lm_head"], x), cache

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
        """The rank's shards of the serving parameters (the whole tree or
        some of its top-level subtrees), plain tensors on their device,
        cut as `tp_layout` says: every leaf split by `tp.rules` over its
        logical axes, the MoE's expert stacks on E (expert parallelism),
        its shared expert as an MLP on "ffn"; where "heads" is split and
        "kv_heads" is not (the vlm's 2 KV heads at tp = 4), wk / wv keep
        only the KV heads the rank's query heads read (`tp_kv_heads`).
        Where "expert_ffn" is split instead (TP inside the experts), every
        expert's w_in / w_gate columns and w_out rows of the rank's block
        of the expert width.  Where "kv_seq" takes the model axis, wk / wv
        are whole (`tp_kv_heads`).  Where "experts" is split but n_experts
        does not divide the axis, raises ValueError, as the reference's
        engine does when it places such a stack."""
        cfg = self.cfg
        if cfg.family == "moe" and tp.sharded("experts") and cfg.n_experts % tp.size:
            raise ValueError(
                f"'experts' is split over the model axis but n_experts "
                f"{cfg.n_experts} does not divide its {tp.size} ranks")
        return self._tp_cut(params, tp)


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
        """The training path (S at most `ssm_chunk` or a multiple of it);
        where the "seq" group splits the sequence, the rank's block (the
        conv's halo and the SSD's fold across the ranks)."""
        cfg = self.cfg
        seq = seq_split(batch["tokens"].shape[1])
        x = embed(params["embed"], _block_tokens(batch["tokens"], seq),
                  torch_dtype(cfg.dtype))
        body = _remat(cfg, functools.partial(_mamba_layer, cfg))
        for bp in self._layers(params):
            x = body(x, bp, seq)
        return _norm(cfg, params["final_norm"], x)

    # ------------------------------------------------- fixed-batch serving
    def init_cache(self, batch: int, max_seq: int, device=None,
                   tp=None) -> Dict[str, Any]:
        """Zeroed carries: conv (L, batch, W-1, conv channels) and ssm (L,
        batch, nh, hd, n), both f32 at the rank's widths under `tp`
        (`mamba.tp_dims`), and (batch,) int32 lengths, at the rank's rows
        and state columns where the groups installed split them;
        `max_seq` is unused (the state does not grow)."""
        del max_seq
        rows = _rows(batch)
        conv, h = M.mamba_init_state(self.cfg, rows, device, tp)
        n_layers = self.cfg.n_layers
        return {"conv": conv.expand(n_layers, *conv.shape).clone(),
                "ssm": h.expand(n_layers, *h.shape).clone(),
                "lengths": torch.zeros((rows,), dtype=torch.int32, device=device)}

    def cache_logical_axes(self) -> Dict[str, Any]:
        return {"conv": ("layers", "batch", None, "conv_dim"),
                "ssm": ("layers", "batch", "ssm_heads", None, "ssm_state"),
                "lengths": ("batch",)}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """The whole prompt batch["tokens"] (B, S) through the SSD scan (S
        at most `ssm_chunk` or a multiple of it); -> (last-position logits
        (B, 1, V), the carries after it).  Where the "seq" group splits the
        prompt the rank runs its block (`mamba.mamba_forward(..., seq=)`),
        the logits and the carries those of the whole prompt."""
        del max_seq
        cfg = self.cfg
        total = batch["tokens"].shape[1]
        seq = seq_split(total)
        x = embed(params["embed"], _block_tokens(batch["tokens"], seq),
                  torch_dtype(cfg.dtype))
        b = x.shape[0]
        convs, hs = [], []
        for bp in self._layers(params):
            h = rms_norm(bp["norm"], x)
            y, (conv, hstate) = M.mamba_forward(bp["mamba"], cfg, h,
                                                return_state=True, seq=seq)
            x = x + y
            convs.append(conv.float())
            hs.append(M.local_state(cfg, hstate))
        x = _last_normed(functools.partial(rms_norm, params["final_norm"]), x, seq)
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(hs),
                 "lengths": torch.full((b,), total, dtype=torch.int32, device=x.device)}
        return lm_head_logits(params["lm_head"], x), cache

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
        ssm (L, rows, nh, hd, n): pool rows replicated.  Under tensor
        parallelism a rank's conv pool holds its own channels,
        `mamba.tp_dims`: not a contiguous 1/tp block of conv_dim."""
        return {"conv": ("layers", None, None, "conv_dim"),
                "ssm": ("layers", None, "ssm_heads", None, "ssm_state")}

    def tp_local_params(self, params: Params, tp) -> Params:
        """The rank's shards of the serving parameters (the whole tree or
        some of its top-level subtrees), cut as `tp_layout` says: the
        embedding and LM head, A_log, D and dt_bias on their logical axes,
        in_proj's columns and the conv weights' channels head-aligned
        (`mamba.tp_columns`), out_proj's d_in rows in blocks."""
        return self._tp_cut(params, tp)


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

    def tp_local_params(self, params: Params, tp) -> Params:
        """The rank's shards of the serving parameters (the whole tree or
        some of its top-level subtrees), cut as `tp_layout` says: the
        Mamba2 blocks as
        `MambaLM.tp_local_params` cuts them, the shared block's attention
        on the heads (wk / wv at the KV heads its query heads read) and its
        MLP on "ffn", its in_proj ("embed", "embed") replicated, the
        embedding and LM head on the vocabulary."""
        return self._tp_cut(params, tp)

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
        the reference); where the "seq" group splits the sequence, the
        rank's block, as `prefill` runs it."""
        cfg = self.cfg
        seq = seq_split(batch["tokens"].shape[1])
        x = embed(params["embed"], _block_tokens(batch["tokens"], seq),
                  torch_dtype(cfg.dtype))
        x0 = x
        b, s, _ = x.shape
        positions = _block_positions(b, s, seq, x.device)
        layers, sp = self._layers(params), params["shared"]
        body = _remat(cfg, functools.partial(_mamba_layer, cfg))

        def attend(h):
            return A.attn_forward(sp["attn"], cfg, h, positions=positions, causal=True,
                                  seq=seq)

        off = 0
        for gsize in self._group_sizes():
            for bp in layers[off:off + gsize]:
                x = body(x, bp, seq)
            off += gsize
            if gsize == cfg.attn_every:
                x = self._shared_apply(sp, x, x0, attend)
        return _norm(cfg, params["final_norm"], x)

    def init_cache(self, batch: int, max_seq: int, device=None,
                   tp=None) -> Dict[str, Any]:
        """Zeroed carries conv (L, batch, W-1, conv channels) / ssm (L,
        batch, nh, hd, n) f32, dense K / V caches (n_shared_uses, batch,
        max_seq, Hkv, hd) of `cfg.dtype`, all at the rank's widths under
        `tp`, and (batch,) int32 lengths, at the rank's rows, positions and
        state columns where the groups installed split them."""
        cfg = self.cfg
        rows = _rows(batch)
        conv, h = M.mamba_init_state(cfg, rows, device, tp)
        kv = A.init_cache(cfg, rows, max_seq, self.n_shared_uses,
                          torch_dtype(cfg.dtype), device, tp)
        return {"conv": conv.expand(cfg.n_layers, *conv.shape).clone(),
                "ssm": h.expand(cfg.n_layers, *h.shape).clone(),
                "k": kv["k"], "v": kv["v"],
                "lengths": torch.zeros((rows,), dtype=torch.int32, device=device)}

    def cache_logical_axes(self) -> Dict[str, Any]:
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"conv": ("layers", "batch", None, "conv_dim"),
                "ssm": ("layers", "batch", "ssm_heads", None, "ssm_state"),
                "k": kv, "v": kv, "lengths": ("batch",)}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """The whole prompt batch["tokens"] (B, S) (S at most `ssm_chunk` or
        a multiple of it); -> (last-position logits (B, 1, V), the carries
        and the shared block's K / V after it).  Where the "seq" group
        splits the prompt the rank runs its block: the Mamba2 layers as
        `MambaLM.prefill` runs them, the shared block's attention over every
        rank's K / V at the block's global positions."""
        cfg = self.cfg
        total = batch["tokens"].shape[1]
        seq = seq_split(total)
        x = embed(params["embed"], _block_tokens(batch["tokens"], seq),
                  torch_dtype(cfg.dtype))
        x0 = x
        b, s, _ = x.shape
        positions = _block_positions(b, s, seq, x.device)
        kv = A.init_cache(cfg, b, max_seq, self.n_shared_uses,
                          torch_dtype(cfg.dtype), x.device, current())
        layers, sp = self._layers(params), params["shared"]
        convs, hs = [], []

        def attend(h):
            y, (k, v) = A.attn_forward(sp["attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True, seq=seq)
            A.cache_write(kv["k"][use], k)
            A.cache_write(kv["v"][use], v)
            return y

        off = use = 0
        for gsize in self._group_sizes():
            for bp in layers[off:off + gsize]:
                h = _norm(cfg, bp["norm"], x)
                y, (conv, hstate) = M.mamba_forward(bp["mamba"], cfg, h,
                                                    return_state=True, seq=seq)
                x = x + y
                convs.append(conv.float())
                hs.append(M.local_state(cfg, hstate))
            off += gsize
            if gsize == cfg.attn_every:
                x = self._shared_apply(sp, x, x0, attend)
                use += 1
        x = _last_normed(functools.partial(_norm, cfg, params["final_norm"]), x, seq)
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(hs),
                 "k": kv["k"], "v": kv["v"],
                 "lengths": torch.full((b,), total, dtype=torch.int32, device=x.device)}
        return lm_head_logits(params["lm_head"], x), cache

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

    def init_serving(self, generator: torch.Generator, device=None,
                     tp=None) -> Params:
        """`serving_params(init(generator), device)`, bit for bit, drawn
        part by part in `init`'s order (each encoder and decoder layer
        alone, as `_StackedLM.init_serving` draws its blocks).  With `tp`
        (a `distributed.collectives.TensorParallel`), the rank's shards,
        `tp_local_params(init_serving(...))` bit for bit: each part is cut
        to the rank's blocks as soon as it is drawn."""
        cfg, d, gdev = self.cfg, self.cfg.d_model, generator.device
        device = gdev if device is None else device

        def draw(tree):
            # cut in f32, then cast: the same bits as the cast cut
            if tp is not None:
                tree = self.tp_local_params(tree, tp)
            return self.serving_params(tree, device)

        out = draw({"embed": embed_init(generator, cfg.vocab, d)})
        out.update(draw({"enc_pos": torch.randn((cfg.enc_seq, d), generator=generator,
                                                device=gdev) * 0.01}))
        out["encoder"] = _draw_layers("encoder", lambda: self._enc_block_init(generator),
                                      cfg.n_enc_layers, draw, device)
        out.update(draw({"enc_norm": _norm_init(cfg, d, gdev)}))
        out["decoder"] = _draw_layers("decoder", lambda: self._dec_block_init(generator),
                                      cfg.n_layers, draw, device)
        out.update(draw({"final_norm": _norm_init(cfg, d, gdev),
                         "lm_head": dense_init(generator, d, cfg.vocab)}))
        return out

    def tp_local_params(self, params: Params, tp) -> Params:
        """The rank's shards of the serving parameters (the whole tree or
        some of its top-level subtrees), cut as `tp_layout` says: the
        encoder's attention, the
        decoder's self- and cross-attention on the heads (wk / wv at the KV
        heads their query heads read), both MLPs on "ffn", the embedding
        and LM head by the rules (whisper's odd vocabulary: the LM head's
        rows on "embed_vec" under guarded rules), `enc_pos` replicated."""
        return self._tp_cut(params, tp)

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
                   ek: torch.Tensor, ev: torch.Tensor, seq=None) -> torch.Tensor:
        h = _norm(self.cfg, bp["self_norm"], x)
        x = x + A.attn_forward(bp["self_attn"], self.cfg, h, positions=positions,
                               causal=True, seq=seq)
        return self._cross_mlp(bp, x, ek, ev)

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training path: encode batch["audio_embeds"], every decoder
        layer's cross K / V from it (outside `_remat`, as the reference
        computes them before its layer scan), then the decoder layers.
        Where the "seq" group splits the sequence the rank runs its block
        of the decoder; the encoder is whole on every rank (each rank's
        gradient of it is its own positions' part, summed with the
        rest)."""
        cfg = self.cfg
        enc = self.encode(params, batch["audio_embeds"])
        seq = seq_split(batch["tokens"].shape[1])
        x = embed(params["embed"], _block_tokens(batch["tokens"], seq),
                  torch_dtype(cfg.dtype))
        b, s, _ = x.shape
        positions = _block_positions(b, s, seq, x.device)
        layers = unbind_layers(params["decoder"])
        enc_kv = [A.cross_kv(bp["cross_attn"], cfg, enc) for bp in layers]
        body = _remat(cfg, self._dec_block)
        for bp, (ek, ev) in zip(layers, enc_kv):
            x = body(x, bp, positions, ek, ev, seq)
        return _norm(cfg, params["final_norm"], x)

    def _cross_mlp(self, bp: Params, x: torch.Tensor, ek: torch.Tensor,
                   ev: torch.Tensor, decode: bool = False) -> torch.Tensor:
        """A decoder layer after its self-attention: cross-attention over
        (ek, ev) (at `decode`, the cached ones: `attention.cross_attn_decode`),
        then the MLP."""
        cfg = self.cfg
        h = _norm(cfg, bp["cross_norm"], x)
        if decode:
            x = x + A.cross_attn_decode(bp["cross_attn"], cfg, h, ek, ev)
        else:
            x = x + A.attn_forward(bp["cross_attn"], cfg, h, kv_override=(ek, ev))
        h = _norm(cfg, bp["mlp_norm"], x)
        return x + F.mlp_apply(bp["mlp"], h, "gelu")

    def init_cache(self, batch: int, max_seq: int, device=None,
                   tp=None) -> Dict[str, Any]:
        """Zeroed self-attention caches k / v (L, batch, max_seq, Hkv, hd),
        cross-attention K / V ek / ev (L, batch, enc_seq, Hkv, hd), both of
        `cfg.dtype` at the rank's KV heads under `tp`, and (batch,) int32
        lengths."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        rows = _rows(batch)
        kv = A.init_cache(cfg, rows, max_seq, cfg.n_layers, dtype, device, tp)
        enc = A.init_cache(cfg, rows, cfg.enc_seq, cfg.n_layers, dtype, device, tp)
        return {"k": kv["k"], "v": kv["v"], "ek": enc["k"], "ev": enc["v"],
                "lengths": torch.zeros((rows,), dtype=torch.int32, device=device)}

    def cache_logical_axes(self) -> Dict[str, Any]:
        ax = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"k": ax, "v": ax, "ek": ax, "ev": ax, "lengths": ("batch",)}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """Encode batch["audio_embeds"], then run the whole prompt
        batch["tokens"] (B, S); -> (last-position logits (B, 1, V), a cache
        of `max_seq` self-attention rows and each layer's cross K / V).
        Where the "seq" group splits the prompt the rank runs its block of
        the decoder (self-attention over every rank's K / V); the encoder
        and the cross K / V stay whole on every rank, as the reference
        splits no encoder activation."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        enc = self.encode(params, batch["audio_embeds"])
        total = batch["tokens"].shape[1]
        seq = seq_split(total)
        x = embed(params["embed"], _block_tokens(batch["tokens"], seq), dtype)
        b, s, _ = x.shape
        positions = _block_positions(b, s, seq, x.device)
        kv = A.init_cache(cfg, b, max_seq, cfg.n_layers, dtype, x.device, current())
        eks, evs = [], []
        for i, bp in enumerate(unbind_layers(params["decoder"])):
            ek, ev = A.cross_kv(bp["cross_attn"], cfg, enc)
            eks.append(A.local_positions(ek.to(dtype)))
            evs.append(A.local_positions(ev.to(dtype)))
            h = _norm(cfg, bp["self_norm"], x)
            y, (k, v) = A.attn_forward(bp["self_attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True, seq=seq)
            A.cache_write(kv["k"][i], k)
            A.cache_write(kv["v"][i], v)
            x = self._cross_mlp(bp, x + y, ek, ev)
        x = _last_normed(functools.partial(_norm, cfg, params["final_norm"]), x, seq)
        cache = {"k": kv["k"], "v": kv["v"], "ek": torch.stack(eks),
                 "ev": torch.stack(evs),
                 "lengths": torch.full((b,), total, dtype=torch.int32, device=x.device)}
        return lm_head_logits(params["lm_head"], x), cache

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
            x = self._cross_mlp(bp, x, cache["ek"][i], cache["ev"][i], decode=True)
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
