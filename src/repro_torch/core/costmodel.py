"""Search fitness on the card: measured wall-clock time (paper §2.3 Step2:
"compile the generated codes just-in-time ... execute them to get the
runtime").

The JAX package's default fitness is an analytical model of a TPU, which
means nothing on Hopper; it names `WallClockFitness` as what a real
deployment plugs in.  The port uses that, on the GPU: one
`WallClockFitness` object times both lanes of the backend race — a tuned
kernel configuration (`__call__`) and the vendor lane, the port's
`ref_ops` on cuDNN / cuBLAS (`vendor_time`) — on the same inputs, with the
same warm-up and repeats, so the race compares like with like.  Each call
is timed between two CUDA events and the median of the repeats is kept; a
configuration is measured once and its time reused when the search
revisits it.  (The JAX version times with `perf_counter` and no
synchronisation, which on CUDA would time only the launch.)

An analytical Hopper model (`ModelFitness`) waits for ROADMAP queue 1.
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch import hw
from repro_torch.core import ref_ops
from repro_torch.core.schedules import Config, OpDesc
from repro_torch.platform import DeviceLike, resolve_device

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# config keys no kernel reads at launch: `max_segments` is the chunk lane's
# packing width, read by the scheduler (`PlanRouter.chunk_segments`); one
# kernel launch cannot price it
UNPRICED_KEYS = ("max_segments",)


def roofline_bound(op: OpDesc, chip: hw.Chip = hw.H100) -> float:
    """The least time the chip could take for `op` (seconds): the larger of
    its flops over the peak for its dtype (f32 CUDA cores for f32, bf16
    tensor cores for bf16) and its bytes (each input read once, the output
    written once) over the HBM rate."""
    return max(op.flops() / chip.peak_flops(op.dtype), op.io_bytes() / chip.hbm_bw)


class Fitness:
    """Maps a candidate config to a runtime (lower is better).  The genetic
    search turns this into the paper's fitness f(a_i) = 1/runtime.

    `kind` tags what the returned number *is* — the search cache keys on it,
    because a runtime measured under one fitness is meaningless under
    another.  `vendor_time` prices the vendor lane of the backend race under
    the same fitness."""

    kind: str = "model"

    def __call__(self, op: OpDesc, cfg: Config) -> float:
        raise NotImplementedError

    def vendor_time(self, op: OpDesc) -> float:
        raise NotImplementedError(
            f"{type(self).__name__} does not time the vendor lane")


class WallClockFitness(Fitness):
    """Measured fitness: run the kernel at the operator's shape and time it.

    A configuration runs the port's kernel lane (`kernels.ops.conv2d` /
    `kernels.ops.matmul` / `kernels.ops.attention` with `cfg`) on inputs
    made once per operator from seed 0.  On a CPU device (an explicit
    choice) the host clock times the plain versions.

    An attention node races unequal work where Sq < Skv: the kernel lane
    masks causally at the top left, as the Pallas kernel does, and skips
    the key tiles past each query tile's diagonal, while the vendor lane
    (`ref_ops.attention`) aligns the mask at the bottom right and reads the
    whole context."""

    kind = "wallclock"

    def __init__(self, repeats: int = 10, warmup: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.repeats = repeats
        self.warmup = warmup
        self.evals = 0          # calls, as the JAX fitness counts them
        self.measured = 0       # distinct measurements
        self._inputs: Dict[str, Tuple] = {}
        self._times: Dict[Tuple[str, str], float] = {}

    # ---------------------------------------------------------- inputs
    def inputs(self, op: OpDesc):
        """The operands of `op` on the device, made once per operator:
        conv2d (NHWC x, HWIO w, f32 bias), matmul ((M, K) x, (K, N) w, f32
        bias), attention (q, k, v) in (B, S, H, D)."""
        key = op.signature()
        if key not in self._inputs:
            gen = torch.Generator(device="cpu").manual_seed(0)
            dtype = _TORCH_DTYPES[op.dtype]
            d = op.d
            if op.kind == "conv2d":
                xs = (d["n"], d["h"], d["w"], d["cin"])
                ws = (d["kh"], d["kw"], d["cin"], d["cout"])
                fan_in = d["kh"] * d["kw"] * d["cin"]
                nout = d["cout"]
            elif op.kind == "matmul":
                xs, ws, fan_in, nout = (d["m"], d["k"]), (d["k"], d["n"]), d["k"], d["n"]
            else:
                qkv = [torch.randn((d["b"], s, d["h"], d["d"]), generator=gen)
                       for s in (d["q"], d["kv"], d["kv"])]
                self._inputs[key] = tuple(t.to(self.device, dtype) for t in qkv)
                return self._inputs[key]
            x = torch.randn(xs, generator=gen)
            w = torch.randn(ws, generator=gen) / fan_in ** 0.5
            b = torch.randn((nout,), generator=gen) * 0.1
            self._inputs[key] = (x.to(self.device, dtype), w.to(self.device, dtype),
                                 b.to(self.device))
        return self._inputs[key]

    def kernel_runner(self, op: OpDesc, cfg: Config) -> Callable:
        from repro_torch.kernels import ops as kops

        x, w, b = self.inputs(op)
        if op.kind == "attention":
            # what the engine's pallas_attention lane runs for the node
            return lambda: kops.attention(x, w, b, causal=True, config=cfg)
        if op.kind == "conv2d":
            padding = "SAME" if op.d["pad"] else "VALID"
            return lambda: kops.conv2d(x, w, b, stride=op.d["stride"],
                                       padding=padding, layout="NHWC",
                                       activation=op.activation, config=cfg)
        return lambda: kops.matmul(x, w, b.to(x.dtype), config=cfg,
                                   activation=op.activation)

    def vendor_runner(self, op: OpDesc) -> Callable:
        x, w, b = self.inputs(op)
        if op.kind == "attention":
            return lambda: ref_ops.run_op("attention", [x, w, b], {"causal": True})
        if op.kind == "conv2d":
            attrs = {"stride": op.d["stride"], "layout": "NHWC",
                     "padding": "SAME" if op.d["pad"] else "VALID",
                     "activation": op.activation}
            wv = ref_ops.nhwc_conv_weight(w)     # laid out once, as the Engine does
            return lambda: ref_ops.run_op("fused_conv2d", [x, wv, b], attrs)
        attrs = {"activation": op.activation}
        return lambda: ref_ops.run_op("fused_matmul", [x, w, b.to(x.dtype)], attrs)

    # ---------------------------------------------------------- timing
    def time(self, fn: Callable) -> float:
        """Median seconds of one call after `warmup` calls: CUDA events
        around each call on the GPU, the host clock on the CPU."""
        for _ in range(self.warmup):
            fn()
        samples = []
        if self.device.type == "cuda":
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(self.repeats)]
            torch.cuda.synchronize(self.device)
            for start, end in events:
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize(self.device)
            samples = [start.elapsed_time(end) / 1e3 for start, end in events]
        else:
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                fn()
                samples.append(time.perf_counter() - t0)
        return statistics.median(samples)

    def _measure(self, op: OpDesc, lane: str, cfg: Config, make) -> float:
        key = (op.signature(), lane + json.dumps(cfg, sort_keys=True))
        if key not in self._times:
            self._times[key] = self.time(make())
            self.measured += 1
        return self._times[key]

    def __call__(self, op: OpDesc, cfg: Config) -> float:
        self.evals += 1
        # keyed on the knobs the kernel reads: configs that differ only in
        # a scheduler knob share one measurement and tie exactly
        read = {k: v for k, v in cfg.items() if k not in UNPRICED_KEYS}
        return self._measure(op, "kernel", read, lambda: self.kernel_runner(op, read))

    def vendor_time(self, op: OpDesc) -> float:
        return self._measure(op, "vendor", {}, lambda: self.vendor_runner(op))
