"""Public wrappers over the port's kernels, with the signatures of
`repro.kernels.ops` (`matmul`, `conv2d`, `fused_elementwise`, `attention`,
`attention_decode`, `attention_decode_paged`, `attention_prefill_packed`,
`attention_prefill_paged`).

A CPU tensor goes to the kernel's plain version; a CUDA tensor goes to the
kernel or the call raises — there is no fallback.  The tuned `config` dicts
of the JAX plans are accepted: `block_q` sizes the prefill and flash
kernels' query tiles, `block_kv` the flash kernel's key tiles (TPU-sized
blocks are clamped to the largest Hopper tile that fits), `bn` /
`row_block` the conv kernel's tile, and the port's own GEMM knobs
`tile_m` / `split_k` the GEMM's tile height and split-K count (both or
neither: without them the GEMM takes `gemm_geometry`'s rule from the
shape).  Keys the Hopper kernels do not read (the matmul's TPU tile bm /
bn / bk / order / k_unroll, the conv's bm / bk / order / k_unroll, the
dense and paged decode kernels' block_kv — both run the split-KV body,
whose splits and chunks follow from the cache's shape — the elementwise
chain's block_rows, the chunk lane's max_segments, which the scheduler
reads) are ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.kernels.attention import (dense_decode_attention,
                                           flash_attention,
                                           paged_decode_attention,
                                           paged_prefill_attention)
from repro_torch.kernels import conv2d as _conv
from repro_torch.kernels.fused import fused_elementwise as _fused_elementwise
from repro_torch.kernels import matmul as _mm

Config = Optional[Dict[str, Any]]

# the GEMM's tuned knobs, named apart from the JAX plans' TPU tile keys
GEMM_KNOBS = ("tile_m", "split_k")


def _tuned_geometry(m: int, n: int, k: int, dtype: torch.dtype,
                    config: Config) -> Optional[_mm.GemmGeometry]:
    """The geometry a matmul config asks for: None (the default rule)
    without the GEMM knobs; ValueError for one knob alone or a pair the
    kernel cannot launch."""
    cfg = config or {}
    given = [key for key in GEMM_KNOBS if key in cfg]
    if not given:
        return None
    if len(given) == 1:
        raise ValueError(f"matmul config {cfg}: tile_m and split_k come together")
    geo = _mm.geometry(m, n, k, dtype, cfg["tile_m"], cfg["split_k"])
    if geo is None:
        raise ValueError(f"matmul config {cfg}: the GEMM cannot launch tile_m "
                         f"{cfg['tile_m']}, split_k {cfg['split_k']} at M={m} "
                         f"N={n} K={k} {dtype}")
    return geo


# the dtypes a plan is tuned at (`select(dtype=)`) that the GEMM runs
_PLAN_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, config: Config = None,
           activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None,
           any_dtype: bool = False) -> torch.Tensor:
    """(..., K) @ (K, N) [+ bias] -> activation, f32 accumulation, at the
    config's (tile_m, split_k) where it gives them.  `any_dtype` (a plan's
    engine): a pair tuned at another dtype that x's dtype cannot launch
    runs on the default geometry."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m, n, k = x2.shape[0], w.shape[-1], x2.shape[1]
    cfg = config or {}
    if any_dtype and all(key in cfg for key in GEMM_KNOBS):
        launches = [_mm.geometry(m, n, k, dtype, cfg["tile_m"], cfg["split_k"]) is not None
                    for dtype in (x.dtype,) + _PLAN_DTYPES]
        if not launches[0] and any(launches):
            # tuned at another dtype: the default geometry, as the JAX
            # engine runs a plan's tiles at any dtype (a pair no dtype
            # launches still raises)
            config = {key: v for key, v in cfg.items() if key not in GEMM_KNOBS}
    geo = _tuned_geometry(m, n, k, x.dtype, config)
    out = _mm.matmul_fused(x2.contiguous(), w, bias, activation, out_dtype,
                           geometry=geo)
    return out.reshape(*lead, w.shape[-1])


def conv2d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: str = "SAME", layout: str = "NHWC",
           activation: Optional[str] = None, config: Config = None) -> torch.Tensor:
    """Convolution in NCHW (OIHW weights) or NHWC (HWIO weights) [+ bias]
    -> activation, on the conv kernel at any image size: it gathers its
    k-steps from the unpadded image, so the JAX wrapper's whole-image VMEM
    threshold has no counterpart.  A config without bn / row_block takes
    `kernels.conv2d.default_config`.  On the GPU a configuration or shape
    outside the kernel's limits (`kernels.conv2d.geometry`) raises
    ValueError from `conv2d_direct`, which names them."""
    if layout == "NCHW":
        x = x.permute(0, 2, 3, 1)
        w = w.permute(2, 3, 1, 0)
    x, w = x.contiguous(), w.contiguous()
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    shape = (n, h, wd, cin, cout, kh, kw, stride, padding)
    cfg = config or {}
    if "bn" not in cfg or "row_block" not in cfg:
        cfg = {**_conv.default_config(*shape), **cfg}
    out = _conv.conv2d_direct(x, w, bias, stride=stride, padding=padding,
                              bn=cfg["bn"], row_block=cfg["row_block"],
                              activation=activation)
    if layout == "NCHW":
        out = out.permute(0, 3, 1, 2).contiguous()
    return out


def fused_elementwise(x: torch.Tensor, chain: Sequence[Dict[str, Any]],
                      extras: Sequence[torch.Tensor] = (), *,
                      config: Config = None) -> torch.Tensor:
    """Apply the elementwise `chain` to x in one kernel; binary stages
    consume `extras` (same shape as x) in order."""
    del config  # one flat pass: no block_rows to tune
    return _fused_elementwise(x, chain, extras)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              config: Config = None) -> torch.Tensor:
    """Dense flash attention: q (B, Sq, H, D), k / v (B, Skv, Hkv, D) ->
    (B, Sq, H, D); GQA by KV-head index; a causal mask aligned at the top
    left (query row i sees keys 0..i), as the Pallas kernel's."""
    cfg = config or {}
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale,
                           block_q=cfg.get("block_q"), block_kv=cfg.get("block_kv"))


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     config: Config = None) -> torch.Tensor:
    """Single-token decode over dense caches: q (B, H, D), caches (B, S,
    Hkv, D), lengths (B,) -> (B, H, D); positions >= lengths[b] masked."""
    del config  # the split-KV body's splits and chunks follow from S
    return dense_decode_attention(q.contiguous(), k_cache.contiguous(),
                                  v_cache.contiguous(), lengths, scale=scale)


def attention_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, lengths: torch.Tensor,
                           block_tables: torch.Tensor, *,
                           scale: Optional[float] = None,
                           config: Config = None) -> torch.Tensor:
    """Paged decode attention: q (B, H, D), pools (num_blocks, block_size,
    Hkv, D), lengths (B,) valid context lengths including the new token,
    block_tables (B, nbt) -> (B, H, D)."""
    del config  # block geometry is fixed by the pool; nothing to tune yet
    return paged_decode_attention(q.contiguous(), k_pool, v_pool, lengths,
                                  block_tables, scale)


def attention_prefill_packed(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, seg_tables: torch.Tensor,
                             seg_info: torch.Tensor, *,
                             scale: Optional[float] = None,
                             config: Config = None) -> torch.Tensor:
    """Segment-packed paged prefill attention: q (1, C, H, D), seg_tables
    (S, nbt), seg_info (S, 3) [row_offset, seg_len, kv_start] ->
    (1, C, H, D).  The tuned `block_q` is the query tile height."""
    block_q = (config or {}).get("block_q")
    return paged_prefill_attention(q.contiguous(), k_pool, v_pool, seg_tables,
                                   seg_info, block_q=block_q, scale=scale)


def attention_prefill_paged(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            chunk_start, chunk_len, *,
                            scale: Optional[float] = None,
                            config: Config = None) -> torch.Tensor:
    """One request's chunk prefill: q (1, C, H, D) against the rows its
    table (1, nbt) holds, `chunk_start` rows committed before the chunk and
    `chunk_len` real rows in it (ints or scalar tensors) -> (1, C, H, D).
    The S = 1 case of `attention_prefill_packed`, through the one-row
    descriptor [0, chunk_len, chunk_start]."""
    as_int = lambda x: torch.as_tensor(x, dtype=torch.int32, device=q.device)
    seg_info = torch.stack([as_int(0), as_int(chunk_len), as_int(chunk_start)])[None]
    return attention_prefill_packed(q, k_pool, v_pool, block_tables, seg_info,
                                    scale=scale, config=config)
