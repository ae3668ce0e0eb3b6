"""Keyed token selection at the end of the serving step (the port of
`repro.kernels.sampling.sample_tokens`).

Conventions are the JAX package's: `sampling` is (rows, 3) float32
[temperature, top_k, top_p] and `keys` is (rows, 3) int32 [seed, rid,
token_index].  A row's token is drawn under the key fold_in(fold_in(
PRNGKey(seed), rid), token_index), jax.random's threefry2x32 bit for bit,
so sampled streams equal the JAX engine's and replay across batch
packings, chunk schedules and preemption.  A temperature <= 0 row is
greedy: `argmax` of the raw logits, the first index on ties; its draw is
computed all the same and thrown away, as the reference's `where` does.

`sample_tokens` reads nothing back to the host, so a captured step program
runs it whole.  The temperature scaling and the top-k / top-p masks
(`mask_top_k`, `mask_top_p`, sort-based, with the reference's tie rules)
are PyTorch ops on both devices; the draw — threefry bits, uniform,
Gumbel, argmax and the greedy argmax — is `sample_draw`, the hand-written
kernel of `csrc/sampling.cu` on a CUDA tensor and `ref.sample_draw_ref` on
a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import hw
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# temperature floor of the sampled lane (the reference's _TEMP_EPS): a
# temperature <= 0 row never uses the scaled logits, the floor keeps them
# finite
TEMP_EPS = 1e-6
# threads per CTA of the draw kernel, and the CTAs a row is split over:
# enough that rows x splits covers every SM about `_WAVES` times
DRAW_THREADS = 256
_WAVES = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mask_top_k(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep each row's k largest entries of x (rows, V), mask the rest to
    -inf.  k (rows,) int; k < 1 or k >= V disables a row's mask.  Ties at
    the k-th value are all kept."""
    v = x.shape[-1]
    k = k.long()
    kk = torch.where((k < 1) | (k >= v), torch.full_like(k, v), k)
    thr = torch.sort(x, dim=-1).values.gather(-1, (v - kk)[:, None])
    return torch.where(x < thr, torch.full_like(x, -torch.inf), x)


def mask_top_p(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask over each row of logits x (rows, V): keep the minimal
    set of highest-probability tokens whose total probability reaches
    p (rows,), mask the rest to -inf; p >= 1 disables a row's mask.  Ties
    at the smallest kept probability are all kept."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum_before = torch.cumsum(sp, -1) - sp       # mass strictly above each
    keep = csum_before < p[:, None]                # minimal covering prefix
    thr = torch.where(keep, sp, torch.full_like(sp, torch.inf)).amin(-1, keepdim=True)
    masked = torch.where(probs < thr, torch.full_like(x, -torch.inf), x)
    return torch.where((p >= 1.0)[:, None], x, masked)


def draw_splits(rows: int, v: int) -> int:
    """CTAs per row of the draw kernel: the vocabulary split so that rows
    x splits fill every SM `_WAVES` times over, each CTA at least one
    element per thread."""
    want = -(-_WAVES * hw.H100.sms // max(rows, 1))
    return max(1, min(want, -(-v // DRAW_THREADS)))


@build.counted
def sample_draw(x: torch.Tensor, logits: torch.Tensor, temps: torch.Tensor,
                keys: torch.Tensor, *,
                uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The draw (`ref.sample_draw_ref`): x (rows, V) f32 masked and scaled,
    logits (rows, V) f32 or bf16, temps (rows,) f32, keys (rows, 3) int32
    -> (rows,) int32 tokens.  `uniforms`: a (rows, V) f32 tensor the
    kernel also writes each element's uniform draw into (for checking the
    bits; the plain version does not take it)."""
    if x.device.type == "cpu":
        if uniforms is not None:
            raise ValueError("sample_draw: `uniforms` is the kernel's output only")
        return _ref.sample_draw_ref(x, logits, temps, keys)
    if x.device.type != "cuda":
        raise ValueError("sample_draw: x must be a GPU tensor")
    rows, v = x.shape
    if (x.dtype != torch.float32 or logits.dtype not in _DTYPES
            or logits.shape != x.shape or temps.dtype != torch.float32
            or temps.shape != (rows,) or keys.dtype != torch.int32
            or keys.shape != (rows, 3)):
        raise ValueError("sample_draw: want x (rows, V) f32, logits (rows, V) "
                         "f32/bf16, temps (rows,) f32, keys (rows, 3) int32")
    for t in (logits, temps, keys):
        if t.device != x.device:
            raise ValueError("sample_draw: every input on x's GPU device")
    if uniforms is not None and (uniforms.shape != x.shape or uniforms.dtype !=
                                 torch.float32 or not uniforms.is_contiguous()
                                 or uniforms.device != x.device):
        raise ValueError("sample_draw: uniforms must be a contiguous (rows, V) "
                         "f32 tensor on x's device")
    x, logits, temps, keys = (t.contiguous() for t in (x, logits, temps, keys))
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    if rows == 0:
        return out
    splits = draw_splits(rows, v)
    # per (row, split): the sampled and the greedy partial (value, index)
    ws = torch.empty((rows, splits, 4), dtype=torch.float32, device=x.device)
    counters = build.counters("sampling", x.device, rows)
    fn = build.load("sampling")
    err = fn(x.data_ptr(), logits.data_ptr(), temps.data_ptr(), keys.data_ptr(),
             out.data_ptr(), 0 if uniforms is None else uniforms.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), rows, v, splits,
             _DTYPES[logits.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "sample_draw")
    sample_draw.launches += 1
    return out


def sample_tokens(logits: torch.Tensor, sampling: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """(rows, V) logits + (rows, 3) sampling + (rows, 3) keys -> (rows,)
    int32 next tokens, on the logits' device with no host sync: scale by
    the temperature, mask top-k then top-p, then `sample_draw`."""
    sampling = torch.as_tensor(sampling, device=logits.device)
    keys = torch.as_tensor(keys, device=logits.device)
    temps = sampling[:, 0].float().contiguous()
    x = logits.float() / torch.clamp(temps, min=TEMP_EPS)[:, None]
    x = mask_top_k(x, sampling[:, 1].to(torch.int64))
    x = mask_top_p(x, sampling[:, 2])
    return sample_draw(x, logits, temps, keys)
