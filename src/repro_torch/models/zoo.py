"""Decoder-only LM (dense family) — the port of `repro.models.zoo.block_init`
and the paged serving half of `repro.models.zoo.DecoderLM`.

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


class DecoderLM:
    """dense family (qwen3-style: GQA, qk-norm, RoPE, RMSNorm, SiLU-gated
    MLP)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

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

    def serving_params(self, params: Params, device) -> Params:
        """`params` on `device`, projection weights and the embedding cast
        to `cfg.dtype`, norm scales in f32."""
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

    def _mlp(self, bp: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(bp["mlp_norm"], x)
        return x + F.mlp_apply(bp["mlp"], h, self.cfg.act)

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
