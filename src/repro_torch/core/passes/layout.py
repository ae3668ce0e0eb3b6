"""Data-layout transformation (paper §2.1), the port's copy of
`repro.core.passes.layout`.

The paper transforms layouts "to get faster execution on the target
hardware"; its ResNet-18 input is NCHW (Caffe).  The port's conv kernel
(`kernels/csrc/conv2d.cu`) reads NHWC, channels minor, as the TPU kernel
did, so the pass is kept as it is: it rewrites every conv/pool subgraph
from NCHW to NHWC:

  * graph/activation edges: insert `transpose` at the NCHW->NHWC boundary and
    back at the NHWC->NCHW boundary, then cancel adjacent inverse pairs;
  * constant weights: transpose OIHW -> HWIO (folded immediately since they
    are constants);
  * conv/pool node attrs: layout="NHWC".

Adjacent transpose-transpose cancellation means an all-conv pipeline pays for
exactly one transpose at the graph input and one at the output.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, Node

_NCHW2NHWC = (0, 2, 3, 1)
_NHWC2NCHW = (0, 3, 1, 2)
_LAYOUT_OPS = ("conv2d", "fused_conv2d", "max_pool", "avg_pool",
               "global_avg_pool", "batch_norm", "bias_add")


def _perm_shape(shape, perm):
    return tuple(shape[p] for p in perm)


def transform_layout(graph: Graph, target: str = "NHWC") -> Graph:
    if target != "NHWC":
        raise ValueError("only the NHWC target is supported")
    g = graph.copy()

    for node in list(g.nodes):
        if node.op not in _LAYOUT_OPS:
            continue
        if node.attrs.get("layout", "NCHW") != "NCHW":
            continue
        x_name = node.inputs[0]
        x_spec = g.tensors[x_name]
        if len(x_spec.shape) != 4 and node.op != "global_avg_pool":
            continue

        # -- input side: NCHW -> NHWC ------------------------------------
        if len(x_spec.shape) == 4:
            t_in = g.fresh("nhwc")
            g.tensors[t_in] = type(x_spec)(t_in, _perm_shape(x_spec.shape, _NCHW2NHWC), x_spec.dtype)
            g.nodes.insert(
                g.nodes.index(node),
                Node("transpose", f"to_nhwc_{t_in}", [x_name], [t_in], {"perm": list(_NCHW2NHWC)}),
            )
            node.inputs[0] = t_in

        # -- weights: OIHW -> HWIO (constants fold; activations transpose)
        if node.op in ("conv2d", "fused_conv2d"):
            w_name = node.inputs[1]
            if w_name in g.constants:
                w = g.constants[w_name]
                new_w = g.add_constant(g.fresh("w_hwio"), np.transpose(w, (2, 3, 1, 0)))
                node.inputs[1] = new_w
            else:
                w_spec = g.tensors[w_name]
                t_w = g.fresh("w_hwio")
                g.tensors[t_w] = type(w_spec)(t_w, _perm_shape(w_spec.shape, (2, 3, 1, 0)), w_spec.dtype)
                g.nodes.insert(
                    g.nodes.index(node),
                    Node("transpose", f"w_to_hwio_{t_w}", [w_name], [t_w], {"perm": [2, 3, 1, 0]}),
                )
                node.inputs[1] = t_w

        node.attrs["layout"] = "NHWC"

        # -- output side: NHWC -> NCHW back-transpose ---------------------
        out_name = node.outputs[0]
        out_spec = g.tensors[out_name]
        if len(out_spec.shape) == 4:
            nhwc_out = g.fresh("o_nhwc")
            g.tensors[nhwc_out] = type(out_spec)(nhwc_out, _perm_shape(out_spec.shape, _NCHW2NHWC), out_spec.dtype)
            back = Node("transpose", f"to_nchw_{nhwc_out}", [nhwc_out], [out_name], {"perm": list(_NHWC2NCHW)})
            node.outputs = [nhwc_out]
            g.nodes.insert(g.nodes.index(node) + 1, back)

    g = _cancel_transposes(g)
    g.prune_tensors()
    return g


def _cancel_transposes(g: Graph) -> Graph:
    """Remove transpose pairs that compose to the identity permutation."""
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op != "transpose":
                continue
            producer = g.producer(node.inputs[0])
            if producer is None or producer.op != "transpose":
                continue
            if len(g.consumers(producer.outputs[0])) != 1 or producer.outputs[0] in g.outputs:
                continue
            p1 = producer.attrs["perm"]
            p2 = node.attrs["perm"]
            composed = [p1[i] for i in p2]
            if composed == list(range(len(composed))):
                g.rewire(node.outputs[0], producer.inputs[0])
                g.remove_node(node)
                g.remove_node(producer)
                changed = True
    return g
