"""Schedule templates (paper §2.2), respaced for the port's Hopper kernels.

The paper's semi-automatic approach: "pre-defines one or more schedule
templates for a given algorithm, then exposes a set of tunable
hyper-parameters ... and finally exploits automated search in the tunable
parameter space".  A template here names the knobs one hand-written CUDA
kernel reads at launch, and nothing else: the paper's CUDA thread-block
and per-thread tile dims become the conv kernel's output-channel tile `bn`
and its output rows per tile `row_block`, and the GEMM's tile height
`tile_m` and split-K count `split_k`.

The validity constraint is the paper's own kind ("total threads per block
<= 1024"): `Template.validate` checks a configuration against the kernel's
launch geometry and the chip's limits from `repro_torch.hw.H100` — shared
memory per block and threads per block; registers are fixed at compile
time by the kernel's launch bounds (`kernels.conv2d.geometry`) — and the
searches only ever propose valid configurations (§2.3 Step1 "any randomly
generated configuration will be verified first").

`OpDesc` and the `Template` base are copies of `repro.core.schedules`, so
an operator's `signature()` — the search cache's and the plan's key — is
the same in both packages.  The templates keep the JAX names
(`pallas_matmul`, `pallas_conv2d`, `pallas_attention`), so a plan tuned by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import hw
from repro_torch.kernels import attention as attn_kernel
from repro_torch.kernels import conv2d as conv_kernel
from repro_torch.kernels import matmul as mm_kernel


@dataclasses.dataclass(frozen=True)
class OpDesc:
    """Hardware-relevant description of one operator instance.

    kind: 'matmul' | 'conv2d' | 'attention' | 'attention_decode'
    dims: kind-specific dims dict (see the templates below)
    dtype: compute dtype
    """

    kind: str
    dims: Tuple[Tuple[str, int], ...]
    dtype: str = "bfloat16"
    activation: Optional[str] = None
    label: str = ""

    @staticmethod
    def make(kind: str, dims: Dict[str, int], dtype: str = "bfloat16",
             activation: Optional[str] = None, label: str = "") -> "OpDesc":
        return OpDesc(kind, tuple(sorted(dims.items())), dtype, activation, label)

    @property
    def d(self) -> Dict[str, int]:
        return dict(self.dims)

    def signature(self) -> str:
        return json.dumps(
            [self.kind, list(self.dims), self.dtype, self.activation], sort_keys=True
        )

    @staticmethod
    def matmul(m: int, n: int, k: int, dtype="bfloat16", activation=None, label="") -> "OpDesc":
        return OpDesc.make("matmul", {"m": m, "n": n, "k": k}, dtype, activation, label)

    @staticmethod
    def conv2d(n, h, w, cin, cout, kh, kw, stride=1, padding="SAME",
               dtype="bfloat16", activation=None, label="") -> "OpDesc":
        pad = 1 if padding == "SAME" else 0
        oh = h // stride if pad else (h - kh) // stride + 1
        ow = w // stride if pad else (w - kw) // stride + 1
        return OpDesc.make(
            "conv2d",
            {"n": n, "h": h, "w": w, "cin": cin, "cout": cout, "kh": kh,
             "kw": kw, "stride": stride, "pad": pad, "oh": oh, "ow": ow},
            dtype, activation, label)

    @staticmethod
    def attention(b, q, kv, heads, head_dim, dtype="bfloat16", label="") -> "OpDesc":
        return OpDesc.make(
            "attention", {"b": b, "q": q, "kv": kv, "h": heads, "d": head_dim},
            dtype, None, label)

    def gemm_view(self) -> Tuple[int, int, int]:
        """(M, N, K) of the underlying GEMM (implicit GEMM for conv)."""
        d = self.d
        if self.kind == "matmul":
            return d["m"], d["n"], d["k"]
        if self.kind == "conv2d":
            return d["n"] * d["oh"] * d["ow"], d["cout"], d["kh"] * d["kw"] * d["cin"]
        if self.kind == "attention":
            # dominant GEMM: (b*h) batched q x kv
            return d["b"] * d["h"] * d["q"], d["kv"], d["d"]
        raise ValueError(self.kind)

    def flops(self) -> float:
        d = self.d
        if self.kind == "attention":
            return 4.0 * d["b"] * d["h"] * d["q"] * d["kv"] * d["d"]
        m, n, k = self.gemm_view()
        return 2.0 * m * n * k

    def io_bytes(self) -> int:
        """Minimum HBM traffic: read inputs once + write output once."""
        d = self.d
        item = hw.itemsize(self.dtype)
        if self.kind == "matmul":
            return item * (d["m"] * d["k"] + d["k"] * d["n"] + d["m"] * d["n"])
        if self.kind == "conv2d":
            return item * (
                d["n"] * d["h"] * d["w"] * d["cin"]
                + d["kh"] * d["kw"] * d["cin"] * d["cout"]
                + d["n"] * d["oh"] * d["ow"] * d["cout"]
            )
        if self.kind == "attention":
            return item * (
                3 * d["b"] * d["q"] * d["h"] * d["d"]  # q + out (+v-ish)
                + 2 * d["b"] * d["kv"] * d["h"] * d["d"]
            )
        raise ValueError(self.kind)

    def arithmetic_intensity(self) -> float:
        return self.flops() / max(1, self.io_bytes())


Config = Dict[str, Any]


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Template:
    """Base schedule template: a named, finite tunable-parameter space."""

    name: str = "base"
    kinds: Tuple[str, ...] = ()

    def space(self, op: OpDesc) -> Dict[str, List[Any]]:
        raise NotImplementedError

    def validate(self, op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> bool:
        raise NotImplementedError

    # ---- encoding helpers shared by GA / RL / random searches ----------
    def axes(self, op: OpDesc) -> List[Tuple[str, List[Any]]]:
        return sorted(self.space(op).items())

    def encode(self, op: OpDesc, cfg: Config) -> List[int]:
        return [choices.index(cfg[k]) for k, choices in self.axes(op)]

    def decode(self, op: OpDesc, vec: Sequence[int]) -> Config:
        return {k: choices[v % len(choices)] for (k, choices), v in zip(self.axes(op), vec)}

    def random_config(self, op: OpDesc, rng: np.random.Generator,
                      chip: hw.Chip = hw.H100, max_tries: int = 200) -> Config:
        axes = self.axes(op)
        for _ in range(max_tries):
            cfg = {k: choices[rng.integers(len(choices))] for k, choices in axes}
            if self.validate(op, cfg, chip):
                return cfg
        # Fall back to the smallest (always-valid) config.
        cfg = {k: choices[0] for k, choices in axes}
        assert self.validate(op, cfg, chip), "template has no valid config"
        return cfg

    def enumerate_configs(self, op: OpDesc, chip: hw.Chip = hw.H100):
        axes = self.axes(op)
        names = [k for k, _ in axes]
        for combo in itertools.product(*[c for _, c in axes]):
            cfg = dict(zip(names, combo))
            if self.validate(op, cfg, chip):
                yield cfg

    def space_size(self, op: OpDesc) -> int:
        return int(np.prod([len(c) for _, c in self.axes(op)]))


class MatmulTemplate(Template):
    """The tiled GEMM with fused epilogue (`kernels/csrc/matmul.cu`):
    `tile_m` output rows per CTA — one of the heights the library is built
    with for the op's dtype (bf16 16 / 64 / 128, f32 64) — and `split_k`,
    the number of CTAs that split K, from SPLIT_K_LADDER plus the split
    `kernels.matmul.gemm_geometry` picks for the op, so its default
    geometry is always in the space.  Valid when `kernels.matmul.geometry`
    can launch the pair.

    The knobs are named apart from the reference template's TPU tile (bm /
    bn / bk / order / k_unroll, VMEM-sized blocks): a plan tuned by the JAX
    package keeps those keys, which the GEMM ignores and runs on its
    default geometry."""

    name = "pallas_matmul"
    kinds = ("matmul",)

    SPLIT_K_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)

    def space(self, op: OpDesc) -> Dict[str, List[Any]]:
        m, n, k = op.gemm_view()
        dtype = _torch_dtype(op.dtype)
        default = mm_kernel.gemm_geometry(m, n, k, dtype).split
        return {
            "tile_m": list(mm_kernel.tile_heights(dtype)),
            "split_k": sorted(set(self.SPLIT_K_LADDER) | {default}),
        }

    def validate(self, op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> bool:
        if "tile_m" not in cfg or "split_k" not in cfg:
            return False
        m, n, k = op.gemm_view()
        return mm_kernel.geometry(m, n, k, _torch_dtype(op.dtype), cfg["tile_m"],
                                  cfg["split_k"]) is not None


class Conv2dTemplate(Template):
    """The implicit-GEMM NHWC convolution (`kernels/csrc/conv2d.cu`): `bn`
    output channels × `row_block` whole output rows per tile.  Valid when
    `kernels.conv2d.geometry` can launch it, in the op's dtype, within the
    chip's limits."""

    name = "pallas_conv2d"
    kinds = ("conv2d",)

    def space(self, op: OpDesc) -> Dict[str, List[Any]]:
        cout = op.d["cout"]
        return {
            "bn": [b for b in conv_kernel.BN_CHOICES if b <= max(16, 2 * cout)],
            "row_block": list(conv_kernel.ROW_BLOCKS),
        }

    def validate(self, op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> bool:
        d = op.d
        padding = "SAME" if d["pad"] else "VALID"
        return conv_kernel.geometry(
            d["n"], d["h"], d["w"], d["cin"], d["cout"], d["kh"], d["kw"],
            d["stride"], padding, cfg["bn"], cfg["row_block"], chip,
            itemsize=hw.itemsize(op.dtype)) is not None


class AttentionTemplate(Template):
    """The dense flash-attention kernel (`kernels/csrc/flash_attention.cu`):
    `block_q` query rows per CTA × `block_kv` keys per shared-memory tile,
    sized for a Hopper block (the TPU template's 128–2048 are VMEM-sized).
    Valid when `kernels.attention.flash_geometry` launches it within the
    chip's limits in the tile the op's dtype runs (bf16: the tensor-core
    tile, whose two-stage K/V ring must fit shared memory).  An `OpDesc`
    carries no KV-head count, and the race times
    the kernel on MHA-shaped K/V, so the geometry is checked at one query
    head per KV head; a GQA call clamps `block_q` to its group
    (`flash_blocks`).

    Serve-graph `prefill_chunk` ops additionally race `max_segments`, the
    packing width of the segment-packed chunk lane, which the scheduler
    reads as its per-step packing cap (`PlanRouter.chunk_segments`).  The
    flash kernel does not read it, so the wall-clock fitness gives every
    `max_segments` of one tile the same time."""

    name = "pallas_attention"
    kinds = ("attention",)

    MAX_SEGMENTS = [1, 2, 4, 8]

    def space(self, op: OpDesc) -> Dict[str, List[Any]]:
        d = op.d
        bq, bkv = attn_kernel.FLASH_BLOCK_Q, attn_kernel.FLASH_BLOCK_KV
        s = {
            "block_q": [b for b in bq if b <= max(bq[0], d["q"])],
            "block_kv": [b for b in bkv if b <= max(bkv[0], d["kv"])],
        }
        if op.label.startswith("prefill_chunk"):
            # packing can't exceed one request per query row
            s["max_segments"] = [m for m in self.MAX_SEGMENTS
                                 if m <= max(1, d["q"])]
        return s

    def validate(self, op: OpDesc, cfg: Config, chip: hw.Chip = hw.H100) -> bool:
        return attn_kernel.flash_geometry(
            cfg["block_q"], cfg["block_kv"], 1, op.d["d"], hw.itemsize(op.dtype),
            chip) is not None


TEMPLATES: Dict[str, Template] = {
    t.name: t for t in (MatmulTemplate(), Conv2dTemplate(), AttentionTemplate())
}


def templates_for(op: OpDesc) -> List[Template]:
    return [t for t in TEMPLATES.values() if op.kind in t.kinds]
