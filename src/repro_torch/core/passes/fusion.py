"""Operator fusion (paper §2.1).

"Operator fusion aims to compress the computation within a sub-graph into one
equivalent novel operator in order to reduce the communication overhead
between operators ... as well as improve hardware usage efficiency due to the
increase of compute intensiveness within the novel operator."

Patterns implemented (all classic inference patterns on CNN/transformer
graphs; the elementwise chains have a single-kernel implementation in
`repro_torch.kernels.fused`):

  conv2d  -> batch_norm                      => fused_conv2d (BN folded into
                                                weights/bias — constants only)
  conv2d  -> bias_add -> [activation]        => fused_conv2d
  matmul  -> bias_add/add -> [activation]    => fused_matmul
  elementwise chain (unary / binary-with-1-producer) => fused_elementwise

A tensor is fusable only if it has exactly one consumer and is not a graph
output — fusing it away must not change the graph's observable behaviour.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.graph import (
    ELEMENTWISE_BINARY,
    ELEMENTWISE_UNARY,
    Graph,
    Node,
)

_ACTS = ("relu", "gelu", "silu", "tanh", "sigmoid")


def _sole_consumer(g: Graph, tensor: str) -> Optional[Node]:
    if tensor in g.outputs:
        return None
    consumers = g.consumers(tensor)
    return consumers[0] if len(consumers) == 1 else None


def _fold_bn_into_conv(g: Graph, conv: Node, bn: Node) -> bool:
    """conv2d -> batch_norm with constant scale/shift: fold into weights."""
    w_name = conv.inputs[1]
    scale_n, shift_n = bn.inputs[1], bn.inputs[2]
    if w_name not in g.constants or scale_n not in g.constants or shift_n not in g.constants:
        return False
    w = g.constants[w_name]
    scale = g.constants[scale_n]
    shift = g.constants[shift_n]
    layout = conv.attrs.get("layout", "NCHW")
    if layout == "NCHW":  # w: (O, I, Kh, Kw)
        w2 = w * scale.reshape(-1, 1, 1, 1)
    else:  # w: (Kh, Kw, I, O)
        w2 = w * scale.reshape(1, 1, 1, -1)
    new_w = g.add_constant(g.fresh("wfold"), w2.astype(w.dtype))
    bias = shift.astype(np.float32)
    if len(conv.inputs) > 2 and conv.inputs[2] in g.constants:
        bias = bias + g.constants[conv.inputs[2]] * scale
    new_b = g.add_constant(g.fresh("bfold"), bias.astype(np.float32))
    conv.op = "fused_conv2d"
    conv.inputs = [conv.inputs[0], new_w, new_b]
    g.rewire(bn.outputs[0], conv.outputs[0])
    g.remove_node(bn)
    return True


def fuse_operators(graph: Graph) -> Graph:
    g = graph.copy()
    changed = True
    while changed:
        changed = False

        for node in list(g.nodes):
            if node not in g.nodes:
                continue

            # --- conv2d -> batch_norm -----------------------------------
            if node.op in ("conv2d", "fused_conv2d") and not node.attrs.get("activation"):
                nxt = _sole_consumer(g, node.outputs[0])
                if nxt is not None and nxt.op == "batch_norm" and nxt.inputs[0] == node.outputs[0]:
                    if _fold_bn_into_conv(g, node, nxt):
                        changed = True
                        continue

            # --- conv2d/matmul -> bias_add ------------------------------
            if node.op in ("conv2d", "matmul", "fused_conv2d", "fused_matmul") and len(node.inputs) == 2:
                nxt = _sole_consumer(g, node.outputs[0])
                is_bias = nxt is not None and (
                    nxt.op == "bias_add"
                    or (nxt.op == "add" and nxt.inputs[0] == node.outputs[0]
                        and g.tensors[nxt.inputs[1]].shape
                        == (g.tensors[node.outputs[0]].shape[-1],))
                )
                if is_bias and nxt.inputs[0] == node.outputs[0]:
                    node.op = "fused_conv2d" if "conv" in node.op else "fused_matmul"
                    node.inputs = list(node.inputs) + [nxt.inputs[1]]
                    g.rewire(nxt.outputs[0], node.outputs[0])
                    g.remove_node(nxt)
                    changed = True
                    continue

            # --- fused compute -> activation ----------------------------
            if node.op in ("conv2d", "matmul", "fused_conv2d", "fused_matmul") and not node.attrs.get("activation"):
                nxt = _sole_consumer(g, node.outputs[0])
                if nxt is not None and nxt.op in _ACTS:
                    node.op = "fused_conv2d" if "conv" in node.op else "fused_matmul"
                    node.attrs["activation"] = nxt.op
                    g.rewire(nxt.outputs[0], node.outputs[0])
                    g.remove_node(nxt)
                    changed = True
                    continue

            # --- elementwise chains --------------------------------------
            if node.op in ELEMENTWISE_UNARY + ELEMENTWISE_BINARY or node.op == "fused_elementwise":
                nxt = _sole_consumer(g, node.outputs[0])
                if nxt is None or nxt.inputs[0] != node.outputs[0]:
                    continue
                if nxt.op not in ELEMENTWISE_UNARY + ELEMENTWISE_BINARY:
                    continue
                # shape-preserving only (no broadcasting surprises)
                if g.tensors[nxt.outputs[0]].shape != g.tensors[node.outputs[0]].shape:
                    continue
                # e.g. add(t, t): t feeds nxt twice — fusing would dangle it
                if node.outputs[0] in nxt.inputs[1:]:
                    continue
                if node.op == "fused_elementwise":
                    chain = list(node.attrs["chain"])
                    extra = list(node.inputs[1:])
                else:
                    chain = [{"op": node.op}]
                    extra = list(node.inputs[1:])
                chain.append({"op": nxt.op})
                extra += list(nxt.inputs[1:])
                node.op = "fused_elementwise"
                node.attrs = {"chain": chain}
                node.inputs = [node.inputs[0]] + extra
                g.rewire(nxt.outputs[0], node.outputs[0])
                g.remove_node(nxt)
                changed = True
                continue

    g.prune_tensors()
    return g
