"""Model assembly — the port of the serving halves of
`repro.models.zoo.DecoderLM` (dense family: the paged path of the
continuous engine and the dense-cache path, `init_cache` / `prefill` /
`decode_step`, of the fixed-batch engine) and `repro.models.zoo.MambaLM`
(ssm family: the slot-pooled path of the continuous engine and the same
fixed-batch path over the conv / SSM carries).

Parameters keep the JAX package's tree: `blocks` leaves are stacked over
layers (leading dim n_layers), `dense` weights are (d_in, d_out).  `init`
draws from the same distributions as the JAX init (different numbers: the
randomness is an explicit `torch.Generator`).  JAX keeps f32 parameters and
casts each weight to `cfg.dtype` where it is used; `serving_params` casts
the projection weights and the embedding once instead (the same rounding)
and keeps the norm scales in f32, where JAX multiplies by them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F
from repro_torch.models.common import (Params, dense_init, embed, embed_init,
                                       lm_head_logits, norm_init, rms_norm,
                                       torch_dtype)

ATTN_BACKENDS = ("torch", "cuda_attention")


def _check_backend(name: str) -> None:
    if name not in ATTN_BACKENDS:
        raise ValueError(f"attention backend {name!r} not in {ATTN_BACKENDS}")


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    if cfg.family != "dense" or cfg.norm != "rms":
        raise NotImplementedError(
            f"{cfg.family} family / {cfg.norm} norm is a later slice of the port")
    return {
        "attn_norm": norm_init(cfg.d_model, gen.device),
        "attn": A.attn_init(gen, cfg),
        "mlp_norm": norm_init(cfg.d_model, gen.device),
        "mlp": F.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.act == "silu"),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(blocks: Params, layer: int) -> Params:
    """One layer's view of the layer-stacked `blocks` tree."""
    return _map(lambda t: t[layer], blocks)


class _StackedLM:
    """What the families' models share: the config, parameters whose
    `blocks` leaves are stacked over layers, and the serving dtypes."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def serving_params(self, params: Params, device) -> Params:
        """`params` on `device`: projection weights and the embedding cast
        to `cfg.dtype`, every other leaf (norm scales, the SSM's conv
        weights, A_log, D, dt_bias) in f32, where JAX casts or multiplies
        at use."""
        dtype = torch_dtype(self.cfg.dtype)

        def conv(path, t):
            cast = dtype if path[-1] in ("w", "emb") else torch.float32
            return t.to(device=device, dtype=cast).contiguous()

        def walk(path, tree):
            if isinstance(tree, dict):
                return {k: walk(path + (k,), v) for k, v in tree.items()}
            return conv(path, tree)

        return walk((), params)

    def _layers(self, params: Params):
        blocks = params["blocks"]
        return [layer_params(blocks, i) for i in range(self.cfg.n_layers)]


class DecoderLM(_StackedLM):
    """dense family (qwen3-style: GQA, qk-norm, RoPE, RMSNorm, SiLU-gated
    MLP)."""

    def init(self, generator: torch.Generator) -> Params:
        """f32 parameters on `generator.device`."""
        cfg = self.cfg
        emb = embed_init(generator, cfg.vocab, cfg.d_model)
        blocks = _stack([block_init(generator, cfg) for _ in range(cfg.n_layers)])
        return {
            "embed": emb,
            "blocks": blocks,
            "final_norm": norm_init(cfg.d_model, generator.device),
            "lm_head": dense_init(generator, cfg.d_model, cfg.vocab),
        }


    def _mlp(self, bp: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(bp["mlp_norm"], x)
        return x + F.mlp_apply(bp["mlp"], h, self.cfg.act)

    # -------------------------------------------- dense-cache serving path
    def init_cache(self, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
        """Zeroed dense caches (L, batch, max_seq, Hkv, hd) of `cfg.dtype`
        and (batch,) int32 lengths."""
        cfg = self.cfg
        cache = A.init_cache(cfg, batch, max_seq, cfg.n_layers,
                             torch_dtype(cfg.dtype), device)
        cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=device)
        return cache

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """Run the whole prompt batch["tokens"] (B, S), build a cache of
        `max_seq` rows holding its K/V; -> (last-position logits (B, 1, V),
        cache)."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = self.init_cache(b, max_seq, x.device)
        for i, bp in enumerate(self._layers(params)):
            h = rms_norm(bp["attn_norm"], x)
            y, (k, v) = A.attn_forward(bp["attn"], cfg, h, positions=positions,
                                       causal=True, return_kv=True)
            cache["k"][i, :, :s] = k.to(cache["k"].dtype)
            cache["v"][i, :, :s] = v.to(cache["v"].dtype)
            x = self._mlp(bp, x + y)
        x = rms_norm(params["final_norm"], x)
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
            h = rms_norm(bp["attn_norm"], x)
            x = x + A.attn_decode(bp["attn"], cfg, h, cache["k"][i],
                                  cache["v"][i], lengths)
            x = self._mlp(bp, x)
        x = rms_norm(params["final_norm"], x)
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
        for i, bp in enumerate(self._layers(params)):
            h = rms_norm(bp["attn_norm"], x)
            x = x + A.attn_decode_paged(bp["attn"], cfg, h, k_pool[i], v_pool[i],
                                        block_tables, lengths,
                                        backend=attn_backend)
            x = self._mlp(bp, x)
        x = rms_norm(params["final_norm"], x)
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
        positions = pos[None]
        for i, bp in enumerate(self._layers(params)):
            h = rms_norm(bp["attn_norm"], x)
            x = x + A.attn_prefill_packed(bp["attn"], cfg, h, k_pool[i],
                                          v_pool[i], seg_tables, positions,
                                          seg_info, backend=attn_backend,
                                          backend_config=attn_config)
            x = self._mlp(bp, x)
        x = rms_norm(params["final_norm"], x)
        info = seg_info.long()
        last = torch.clamp(info[:, 0] + info[:, 1] - 1, 0, c - 1)   # (S,)
        return lm_head_logits(params["lm_head"], x[:, last])


# ===================================================================== Mamba2
class MambaLM(_StackedLM):
    """ssm family (Mamba2: SSD scan, depthwise causal conv, gated RMSNorm;
    attention-free).  Per-request state is fixed-size — one conv window
    and one SSM state per layer — so the continuous engine keeps it in a
    slot-pooled cache (`serve.statecache`): each request owns one row of
    (L, num_slots, ...) pools for its residency, and every index the
    serving methods take may be a device tensor, so a captured step
    program serves every schedule."""

    def init(self, generator: torch.Generator) -> Params:
        """f32 parameters on `generator.device`."""
        cfg = self.cfg
        dev = generator.device
        emb = embed_init(generator, cfg.vocab, cfg.d_model)
        blocks = _stack([{"norm": norm_init(cfg.d_model, dev),
                          "mamba": M.mamba_init(generator, cfg)}
                         for _ in range(cfg.n_layers)])
        return {
            "embed": emb,
            "blocks": blocks,
            "final_norm": norm_init(cfg.d_model, dev),
            "lm_head": dense_init(generator, cfg.d_model, cfg.vocab),
        }


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
