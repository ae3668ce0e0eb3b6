"""Graph-optimization passes (paper §2.1).

`optimize_graph` is the standard pipeline: simplify → constant folding →
layout transformation → fusion → simplify.  Each pass is a pure function
Graph -> Graph and is individually tested against the reference executor.
"""

from repro_torch.core.passes.simplify import (
    remove_identities,
    dead_code_elimination,
    common_subexpression_elimination,
)
from repro_torch.core.passes.constant_folding import constant_folding
from repro_torch.core.passes.fusion import fuse_operators
from repro_torch.core.passes.layout import transform_layout

__all__ = [
    "remove_identities",
    "dead_code_elimination",
    "common_subexpression_elimination",
    "constant_folding",
    "fuse_operators",
    "transform_layout",
    "optimize_graph",
]


def optimize_graph(graph, *, layout: str | None = "NHWC", fuse: bool = True):
    """The full §2.1 pipeline.  Returns a new Graph."""
    g = remove_identities(graph)
    g = common_subexpression_elimination(g)
    g = constant_folding(g)
    if fuse:  # fuse before layout so conv+bn+act chains are adjacent
        g = fuse_operators(g)
    if layout is not None:
        g = transform_layout(g, target=layout)
        g = constant_folding(g)  # fold the constant-side transposes we inserted
    if fuse:
        g = fuse_operators(g)    # fuse residual elementwise chains post-layout
    g = dead_code_elimination(g)
    g.validate()
    return g
