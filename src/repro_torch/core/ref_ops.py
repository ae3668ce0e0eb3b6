"""Plain PyTorch semantics for every graph op (the port of
`repro.core.ref_ops`).

This is at the same time:
  * the vendor-library lane of the backend race (cuDNN / cuBLAS through
    `F.conv2d` and `torch.matmul` on the GPU);
  * the oracle every plan that runs the port's kernels is held against;
  * the evaluator of constant folding (on CPU tensors).

Every function takes (list of input tensors, attrs dict) -> output tensor,
so the engine dispatches uniformly.

Where the JAX semantics differ from PyTorch's habits:
  * SAME padding is TensorFlow's (`jax.lax`): the total pad of a dim is
    max(0, (ceil(n/s) - 1)·s + k - n), split low = total // 2 and the extra
    element on the HIGH side (a 7×7/s2 conv on 224 pads 2 above and 3
    below).  `F.conv2d(padding=...)` is symmetric and `padding="same"`
    refuses stride > 1, so an asymmetric pad is applied with `F.pad` and the
    op runs VALID; a symmetric one goes to the op's own `padding=`.
  * max pool pads with -inf, avg pool with 0 and divides by k·k
    (`reduce_window` with those inits), whatever the window covers.
  * `gelu` is the tanh approximation (`jax.nn.gelu`'s default).
  * `matmul` accumulates in f32 and rounds to x's dtype BEFORE the bias add.
  * a float32 convolution on the GPU runs in TF32 while
    `torch.backends.cudnn.allow_tf32` is True (PyTorch's default); callers
    that hold results to f32 tolerances turn it off.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import same_pads

_UNARY = {
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "neg": torch.neg,
    "exp": torch.exp,
}
_BINARY = {"add": torch.add, "mul": torch.mul, "sub": torch.sub, "div": torch.div}


def _act(x, kind):
    if kind in (None, "none", "identity", "dropout"):
        return x
    return _UNARY[kind](x)


def _nchw_window_op(x, kh, kw, s, padding, fill, op):
    """Run `op(x_padded, pad)` on an NCHW tensor with a kh x kw window: a
    symmetric SAME pad goes to `op` itself, an asymmetric one is applied
    first with `fill`."""
    if padding == "VALID":
        return op(x, (0, 0))
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}")
    (pt, pb), (pl, pr) = same_pads(x.shape[2], kh, s), same_pads(x.shape[3], kw, s)
    if pt == pb and pl == pr:
        return op(x, (pt, pl))
    return op(F.pad(x, (pl, pr, pt, pb), value=fill), (0, 0))


def conv2d(inputs: List[torch.Tensor], attrs: Dict[str, Any]) -> torch.Tensor:
    """2-D convolution.  attrs: stride, padding ('SAME'|'VALID'), layout
    ('NCHW'|'NHWC').  Weights are (O, I, Kh, Kw) for NCHW and (Kh, Kw, I, O)
    for NHWC."""
    x, w = inputs[0], inputs[1]
    layout = attrs.get("layout", "NCHW")
    stride = attrs.get("stride", 1)
    if not isinstance(stride, int):
        if len(set(stride)) != 1:
            raise ValueError(f"unequal strides {stride}")
        stride = stride[0]
    padding = attrs.get("padding", "SAME")
    if layout == "NHWC":
        # channels-last views.  x's is channels_last as it is; w's is only
        # when w is stored as `nhwc_conv_weight` leaves it, else PyTorch
        # copies the weight to channels_last on every call.  (The f32
        # engine cuDNN picks may still transpose both to NCHW inside the
        # call; PERF.md measures it.)
        x, w = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    out = _nchw_window_op(x, w.shape[2], w.shape[3], stride, padding, 0.0,
                          lambda xp, pad: F.conv2d(xp, w, stride=stride, padding=pad))
    if len(inputs) > 2:  # fused bias
        out = out + inputs[2].reshape(1, -1, 1, 1)
    out = _act(out, attrs.get("activation"))
    if layout == "NHWC":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out


def nhwc_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """The HWIO weight `w` with the same values, stored O-H-W-I: the
    (O, I, Kh, Kw) view `conv2d` takes of it in NHWC is then a
    channels_last weight, which PyTorch hands cuDNN with no copy.  A
    deployment lays a constant weight out once: the Engine does it for the
    convs on the vendor lane, WallClockFitness for the vendor lane's
    inputs."""
    return w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def matmul(inputs: List[torch.Tensor], attrs: Dict[str, Any]) -> torch.Tensor:
    """x @ w with an f32 accumulator rounded to x's dtype, then bias and
    activation in that dtype (`jnp.matmul(preferred_element_type=f32)`
    followed by `astype(x.dtype)`).

    On the GPU a bf16 product is one cuBLAS call, `x @ w`: the call the
    serving path's vendor lane makes (`kernels.dispatch.torch_lane`), so a
    plan's race times the lane that serving then runs.  cuBLAS accumulates
    it in f32 and rounds once while
    `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` is
    False (`chip_smoke.py` sets it so).  `torch.mm(x, w,
    out_dtype=torch.float32).to(x.dtype)` would give the same function in
    two kernels, an f32 product and a cast, which serving never runs.  On
    the CPU the operands are upcast to an f32 product."""
    x, w = inputs[0], inputs[1]
    if x.dtype == torch.float32 or x.device.type == "cuda":
        out = torch.matmul(x, w)
    else:
        out = torch.matmul(x.float(), w.float()).to(x.dtype)
    if len(inputs) > 2:
        out = out + inputs[2]
    return _act(out, attrs.get("activation"))


def attention(inputs: List[torch.Tensor], attrs: Dict[str, Any]) -> torch.Tensor:
    q, k, v = inputs[0], inputs[1], inputs[2]
    causal = attrs.get("causal", True)
    scale = attrs.get("scale") or (1.0 / np.sqrt(q.shape[-1]))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qlen, klen = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((qlen, klen), dtype=torch.bool,
                                     device=q.device), diagonal=klen - qlen)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def bias_add(inputs, attrs):
    x, b = inputs
    if x.dim() == 4 and attrs.get("layout", "NCHW") == "NCHW":
        return x + b.reshape(1, -1, 1, 1)
    return x + b


def batch_norm(inputs, attrs):
    """Inference batch norm: pre-folded scale/shift per channel."""
    x, scale, shift = inputs
    if x.dim() == 4 and attrs.get("layout", "NCHW") == "NCHW":
        return x * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
    return x * scale + shift


def layer_norm(inputs, attrs):
    x = inputs[0]
    eps = attrs.get("eps", 1e-5)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if len(inputs) > 1:
        y = y * inputs[1]
    if len(inputs) > 2:
        y = y + inputs[2]
    return y


def softmax(inputs, attrs):
    return torch.softmax(inputs[0], dim=attrs.get("axis", -1))


def _pool(x, attrs, fill, op):
    layout = attrs.get("layout", "NCHW")
    k = attrs.get("kernel", 2)
    s = attrs.get("stride", k)
    if layout == "NHWC":
        x = x.permute(0, 3, 1, 2)
    out = _nchw_window_op(x, k, k, s, attrs.get("padding", "VALID"), fill,
                          lambda xp, pad: op(xp, k, s, pad))
    return out.permute(0, 2, 3, 1).contiguous() if layout == "NHWC" else out


def max_pool(inputs, attrs):
    return _pool(inputs[0], attrs, float("-inf"), F.max_pool2d)


def avg_pool(inputs, attrs):
    # zero padding counted in the k·k divisor, as reduce_window(add) / (k·k)
    return _pool(inputs[0], attrs, 0.0,
                 lambda xp, k, s, pad: F.avg_pool2d(xp, k, s, pad,
                                                    count_include_pad=True))


def global_avg_pool(inputs, attrs):
    x = inputs[0]
    dims = (2, 3) if attrs.get("layout", "NCHW") == "NCHW" else (1, 2)
    return x.mean(dim=dims)


def reshape(inputs, attrs):
    return inputs[0].reshape(tuple(attrs["shape"]))


def transpose(inputs, attrs):
    return inputs[0].permute(tuple(attrs["perm"])).contiguous()


def flatten(inputs, attrs):
    x = inputs[0]
    return x.reshape(x.shape[0], -1)


def concat(inputs, attrs):
    return torch.cat(inputs, dim=attrs.get("axis", -1))


def fused_elementwise(inputs, attrs):
    """A chain of elementwise ops produced by the fusion pass.

    attrs['chain'] is a list of {op} stages; a binary stage consumes the
    running value plus the next extra input (taken in order from
    `inputs[1:]`)."""
    x = inputs[0]
    extra = list(inputs[1:])
    for stage in attrs["chain"]:
        op = stage["op"]
        x = _BINARY[op](x, extra.pop(0)) if op in _BINARY else _act(x, op)
    return x


def _unary(kind):
    return lambda inputs, attrs: _act(inputs[0], kind)


def _binary(fn):
    return lambda inputs, attrs: fn(inputs[0], inputs[1])


REF_OPS = {
    "conv2d": conv2d,
    "fused_conv2d": conv2d,
    "matmul": matmul,
    "fused_matmul": matmul,
    "attention": attention,
    "bias_add": bias_add,
    "batch_norm": batch_norm,
    "layer_norm": layer_norm,
    "softmax": softmax,
    "max_pool": max_pool,
    "avg_pool": avg_pool,
    "global_avg_pool": global_avg_pool,
    "reshape": reshape,
    "transpose": transpose,
    "flatten": flatten,
    "concat": concat,
    "fused_elementwise": fused_elementwise,
    **{name: _binary(fn) for name, fn in _BINARY.items()},
    **{name: _unary(name) for name in
       ("relu", "gelu", "silu", "tanh", "sigmoid", "identity", "dropout",
        "neg", "exp")},
}


def run_op(op: str, inputs, attrs):
    return REF_OPS[op](inputs, attrs)
