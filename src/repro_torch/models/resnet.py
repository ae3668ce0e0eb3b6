"""ResNet-18 as a WPK computational graph — the paper's evaluation model
(the port's copy of `repro.models.resnet`: the same numpy RNG draws, so the
graph and its constants are bitwise the JAX package's).

The paper's §3 inputs: Caffe-trained ResNet-18, NCHW layout, N=1, C=3,
H=224, W=224 (the text says W=244 once; the canonical 224 is used — noted
as a likely typo).  Weights are randomly initialised (inference *speed* is
weight-independent); BN is in inference form (folded scale/shift).

`resnet18_graph()` returns the Graph the WPK pipeline optimizes;
`conv_groups()` returns the deduplicated convolution set of Figure 2b under
the paper's identity criterion (same input/output shape, filter size,
stride, padding).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.schedules import OpDesc

STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def _conv(g: Graph, rng, x: str, cin: int, cout: int, k: int, stride: int,
          in_hw: int, relu: bool = True, bn: bool = True) -> Tuple[str, int]:
    out_hw = -(-in_hw // stride)
    n = g.tensors[x].shape[0]
    w = g.add_constant(g.fresh("w"),
                       (rng.standard_normal((cout, cin, k, k)) *
                        np.sqrt(2.0 / (cin * k * k))).astype(np.float32))
    y = g.add_node("conv2d", [x, w], (n, cout, out_hw, out_hw),
                   {"stride": stride, "padding": "SAME", "layout": "NCHW"})
    if bn:
        sc = g.add_constant(g.fresh("bn_s"),
                            (rng.random(cout) * 0.5 + 0.75).astype(np.float32))
        sh = g.add_constant(g.fresh("bn_b"),
                            (rng.standard_normal(cout) * 0.1).astype(np.float32))
        y = g.add_node("batch_norm", [y, sc, sh], (n, cout, out_hw, out_hw),
                       {"layout": "NCHW"})
    if relu:
        y = g.add_node("relu", [y], (n, cout, out_hw, out_hw))
    return y, out_hw


def resnet18_graph(batch: int = 1, image: int = 224, n_classes: int = 1000,
                   seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    g = Graph("resnet18")
    x = g.add_input("image", (batch, 3, image, image))

    # stem: 7x7/64 s2 + maxpool 3x3 s2
    y, hw = _conv(g, rng, x, 3, 64, 7, 2, image)
    hw = hw // 2
    y = g.add_node("max_pool", [y], (batch, 64, hw, hw),
                   {"kernel": 3, "stride": 2, "padding": "SAME", "layout": "NCHW"})

    cin = 64
    for cout, blocks, first_stride in STAGES:
        for b in range(blocks):
            stride = first_stride if b == 0 else 1
            identity = y
            out_hw = -(-hw // stride)
            y1, _ = _conv(g, rng, y, cin, cout, 3, stride, hw)
            y2, _ = _conv(g, rng, y1, cout, cout, 3, 1, out_hw, relu=False)
            if stride != 1 or cin != cout:  # projection shortcut
                identity, _ = _conv(g, rng, identity, cin, cout, 1, stride, hw,
                                    relu=False)
            y = g.add_node("add", [y2, identity], (batch, cout, out_hw, out_hw))
            y = g.add_node("relu", [y], (batch, cout, out_hw, out_hw))
            hw, cin = out_hw, cout

    y = g.add_node("global_avg_pool", [y], (batch, 512), {"layout": "NCHW"})
    wf = g.add_constant("fc_w", (rng.standard_normal((512, n_classes)) *
                                 np.sqrt(1.0 / 512)).astype(np.float32))
    bf = g.add_constant("fc_b", np.zeros(n_classes, np.float32))
    y = g.add_node("matmul", [y, wf], (batch, n_classes))
    y = g.add_node("bias_add", [y, bf], (batch, n_classes))
    g.set_outputs([y])
    g.validate()
    return g


def conv_groups(batch: int = 1, image: int = 224) -> List[Tuple[str, OpDesc]]:
    """Deduplicated convolution groups of ResNet-18 (Figure 2b's c1..cN),
    using the paper's computational-identity criterion."""
    convs: List[Tuple[int, int, int, int]] = []  # (hw, cin, cout, k, stride)
    hw = image
    convs.append((hw, 3, 64, 7, 2))
    hw = -(-hw // 2) // 2
    cin = 64
    for cout, blocks, first_stride in STAGES:
        for b in range(blocks):
            stride = first_stride if b == 0 else 1
            out_hw = -(-hw // stride)
            convs.append((hw, cin, cout, 3, stride))
            convs.append((out_hw, cout, cout, 3, 1))
            if stride != 1 or cin != cout:
                convs.append((hw, cin, cout, 1, stride))
            hw, cin = out_hw, cout

    seen: Dict[str, str] = {}
    groups: List[Tuple[str, OpDesc]] = []
    for (h, ci, co, k, s) in convs:
        op = OpDesc.conv2d(batch, h, h, ci, co, k, k, stride=s,
                           padding="SAME", dtype="bfloat16")
        key = op.signature()
        if key not in seen:
            name = f"c{len(groups) + 1}"
            seen[key] = name
            groups.append((name, op))
    return groups
