"""Plain PyTorch versions of the port's kernels.

Each function computes what one hand-written CUDA kernel computes, in the
most obvious way: CPU tensors take these instead of the kernel, the tests
hold them against the JAX package, and `chip_smoke.py` holds the kernels
against them on the card.

Rounding points follow the JAX package's default lanes:

  * `matmul_ref` is `repro.kernels.ref.matmul_ref`: an f32 product of the
    inputs, bias and activation in f32, one rounding to the output dtype —
    the arithmetic of the tiled GEMM kernel.
  * the two paged attention references are the XLA *gather* lanes of
    `repro.models.attention` (`attn_decode_paged`, `attn_prefill_packed`):
    Q·Kᵀ is computed in the working dtype and only then cast to f32 and
    scaled; the softmax runs in f32 and the probabilities are rounded to
    the value dtype before the P·V product (also in the working dtype).
    The CUDA kernels accumulate Q·Kᵀ and P·V in f32 instead, as the Pallas
    kernels do, so in bf16 the two agree only to a tolerance; in f32 they
    agree to rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """`repro.kernels.ref.apply_activation`; `jax.nn.gelu` defaults to the
    tanh approximation, so "gelu" here is `approximate="tanh"`."""
    if activation in (None, "none", "identity"):
        return x
    if activation == "relu":
        return F.relu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    raise KeyError(activation)


def matmul_ref(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., K) @ (K, N) with an f32 accumulator, bias + activation in f32,
    rounded once to `out_dtype` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return apply_activation(out, activation).to(out_dtype)


def _softmax_pv(logits: torch.Tensor, v_dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits, dim=-1).to(v_dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, lengths: torch.Tensor,
                               block_tables: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention, the gather lane of `attn_decode_paged`.

    q (B, H, D); pools (num_blocks, block_size, Hkv, D); lengths (B,) valid
    context lengths INCLUDING the new token (positions >= length masked);
    block_tables (B, nbt).  Returns (B, H, D) in q's dtype.  A row with
    length 0 has no valid key; the kernel returns zeros for it and the
    serving path never consumes it (inactive slots pass length 1)."""
    b, h, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    nbt = block_tables.shape[1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = block_tables.long()
    k_ctx = k_pool[tables].reshape(b, nbt * bs, hkv, d)
    v_ctx = v_pool[tables].reshape(b, nbt * bs, hkv, d)
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_ctx).float() * scale
    pos = torch.arange(nbt * bs, device=q.device)[None, None, None, :]
    logits = torch.where(pos < lengths.long()[:, None, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = _softmax_pv(logits, v_ctx.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_ctx)
    return out.reshape(b, h, d).to(q.dtype)


def packed_row_map(seg_info: torch.Tensor, c: int):
    """Per-row segment assignment of a packed chunk
    (`repro.models.attention.packed_row_map`): returns (sid, pos, valid),
    each (C,) — the row's segment (clamped), its absolute position in its
    own request (0 on padding rows) and whether it carries a prompt token."""
    info = seg_info.long()
    ns = info.shape[0]
    q0, qn, kv0 = info[:, 0], info[:, 1], info[:, 2]
    r = torch.arange(c, device=info.device)
    seg_end = q0 + qn
    sid = torch.clamp((r[:, None] >= seg_end[None, :]).long().sum(1), max=ns - 1)
    valid = (r >= q0[sid]) & (r < seg_end[sid])
    pos = kv0[sid] + (r - q0[sid])
    return sid, torch.where(valid, pos, torch.zeros_like(pos)), valid


def packed_prefill_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, seg_tables: torch.Tensor,
                                 seg_info: torch.Tensor,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Segment-packed paged prefill attention, the gather lane of
    `attn_prefill_packed`.

    q (1, C, H, D) packed chunk; pools (num_blocks, block_size, Hkv, D);
    seg_tables (S, nbt); seg_info (S, 3) [row_offset, seg_len, kv_start].
    Each row gathers its own segment's full table and attends to key
    positions <= its own absolute position.  Returns (1, C, H, D); rows past
    the packed fill hold finite values the caller discards."""
    _, c, h, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    nbt = seg_tables.shape[1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    sid, pos, _ = packed_row_map(seg_info, c)
    row_tables = seg_tables.long()[sid]                          # (C, nbt)
    k_ctx = k_pool[row_tables].reshape(c, nbt * bs, hkv, d)
    v_ctx = v_pool[row_tables].reshape(c, nbt * bs, hkv, d)
    qg = q[0].reshape(c, hkv, g, d)
    logits = torch.einsum("qhgd,qkhd->hgqk", qg, k_ctx).float() * scale
    kpos = torch.arange(nbt * bs, device=q.device)[None, None, None, :]
    logits = torch.where(kpos <= pos[None, None, :, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = _softmax_pv(logits, v_ctx.dtype)
    out = torch.einsum("hgqk,qkhd->qhgd", probs, v_ctx)
    return out.reshape(1, c, h, d).to(q.dtype)
