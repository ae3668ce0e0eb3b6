"""WPK core of the port: the paper's pipeline in PyTorch for one H100.

Typical usage (the paper's Figure 1a pipeline):

    from repro_torch.core import Graph, optimize_graph, select, Engine

    g = build_graph(...)                      # model import
    g_opt = optimize_graph(g)                 # §2.1 graph optimization
    plan = select(g_opt, tuner=Tuner())       # §2.2-2.5 search + selection
    # (Tuner(fitness=ModelFitness()) tunes on the host, with no GPU)
    engine = Engine(g_opt, plan, default_registry())
    outputs = engine(*inputs)                 # runtime engine
"""

from repro_torch.core.graph import Graph, Node, TensorSpec
from repro_torch.core.passes import optimize_graph
from repro_torch.core.schedules import OpDesc, TEMPLATES, templates_for
from repro_torch.core.costmodel import ModelFitness, WallClockFitness, roofline_bound
from repro_torch.core.search import (
    GeneticSearch,
    RLSearch,
    SearchCache,
    SearchTask,
    Tuner,
    genetic_search,
    random_search,
    rl_search,
)
from repro_torch.core.selection import select, op_desc_of
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.core.engine import Engine, default_registry

__all__ = [
    "Graph", "Node", "TensorSpec", "optimize_graph",
    "OpDesc", "TEMPLATES", "templates_for",
    "ModelFitness", "WallClockFitness", "roofline_bound",
    "GeneticSearch", "RLSearch", "SearchCache", "SearchTask", "Tuner",
    "genetic_search", "random_search", "rl_search",
    "select", "op_desc_of", "InferencePlan", "OpChoice",
    "Engine", "default_registry",
]
