"""Identity/dropout removal, dead-code elimination, CSE.

The paper explicitly lists "removing redundant operations (e.g. identity and
dropout)" as a graph optimization (§1); CSE/DCE are the standard companions
that keep the graph canonical between passes.
"""

from __future__ import annotations

from repro_torch.core.graph import Graph


def remove_identities(graph: Graph) -> Graph:
    """Drop `identity` and inference-mode `dropout` nodes by rewiring their
    consumers directly to the producer tensor."""
    g = graph.copy()
    changed = True
    while changed:
        changed = False
        for node in list(g.nodes):
            if node.op in ("identity", "dropout"):
                src, dst = node.inputs[0], node.outputs[0]
                g.rewire(dst, src)
                g.remove_node(node)
                changed = True
    g.prune_tensors()
    return g


def dead_code_elimination(graph: Graph) -> Graph:
    """Remove nodes whose outputs can never reach a graph output."""
    g = graph.copy()
    live = set(g.outputs)
    # Walk nodes in reverse topological order, marking live inputs.
    order = g.toposort()
    keep = []
    for node in reversed(order):
        if any(o in live for o in node.outputs):
            keep.append(node)
            live.update(node.inputs)
    keep.reverse()
    g.nodes = keep
    g.prune_tensors()
    return g


def common_subexpression_elimination(graph: Graph) -> Graph:
    """Merge nodes with identical (op, inputs, attrs)."""
    g = graph.copy()
    changed = True
    while changed:
        changed = False
        seen = {}
        for node in list(g.nodes):
            key = (node.op, tuple(node.inputs), node.signature(g))
            if key in seen:
                canonical = seen[key]
                for old, new in zip(node.outputs, canonical.outputs):
                    g.rewire(old, new)
                g.remove_node(node)
                changed = True
            else:
                seen[key] = node
    g.prune_tensors()
    return g
