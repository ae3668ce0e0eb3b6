"""Runtime engine (paper §2), the port of `repro.core.engine`: "collects
the operator functions generated by automated searches, and drives the
data flow expressed by the optimized graph to complete inference."

`Engine(graph, plan, registry, device)` runs the toposorted graph on one
device; the graph's constants move there once, at construction.  On a
CUDA device `__call__` captures the forward in a CUDA graph once per input
signature and replays it after (`launch.program.Program`), the
counterpart of the JAX engine's `jax.jit`; `cuda_graph=False` runs every
forward eagerly, kept only to compare against (the reference's
`jit=False`).  `run_env`, which returns every intermediate, stays eager.
Backends, as the JAX registry routes them:

  'xla'            -> repro_torch.core.ref_ops (the vendor lane: PyTorch,
                      cuDNN / cuBLAS on the GPU)
  'pallas_matmul'  -> kernels.ops.matmul (csrc/matmul.cu)
  'pallas_conv2d'  -> kernels.ops.conv2d (csrc/conv2d.cu)
  'pallas_attention' -> kernels.ops.attention (csrc/flash_attention.cu)

A `fused_elementwise` node is no plan choice: it is not a tunable op in
either package.  With a registry the engine runs it on the registry's
'fused_elementwise' entry, kernels.ops.fused_elementwise
(csrc/fused_elementwise.cu), one launch per chain: the counterpart of XLA
fusing each chain inside the JAX engine's `jit`, as `Program` is the
counterpart of `jit` itself.  An engine without a registry (the vendor
lane, `verify_against_reference`'s reference) runs it through ref_ops,
one PyTorch op per stage.  A plan is tuned at one dtype (`select(dtype=)`,
bf16 by default) and runs on whatever dtype the graph holds, as the JAX
engine's does: a GEMM tile tuned at another dtype that the data's cannot
launch runs on the GEMM's default geometry (`ops.matmul`'s `any_dtype`).
The weight of an NHWC conv on the vendor lane is laid out once, at
construction, as cuDNN reads it (`ref_ops.nhwc_conv_weight`), not on every
call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import ref_ops
from repro_torch.core.graph import Graph
from repro_torch.core.plan import InferencePlan
from repro_torch.launch.program import Program
from repro_torch.platform import DeviceLike, resolve_device

# backend -> fn(inputs: list[Tensor], attrs, config) -> Tensor
BackendRegistry = Dict[str, Callable]


def default_registry() -> BackendRegistry:
    """Registry with the vendor lane plus every ported kernel template."""
    from repro_torch.kernels import ops as kops

    return {
        "xla": None,  # resolved per op via ref_ops
        "pallas_matmul": lambda inputs, attrs, config: kops.matmul(
            *inputs, config=config, activation=attrs.get("activation"),
            any_dtype=True),
        "pallas_conv2d": lambda inputs, attrs, config: kops.conv2d(
            *inputs, stride=attrs.get("stride", 1),
            padding=attrs.get("padding", "SAME"),
            layout=attrs.get("layout", "NCHW"),
            activation=attrs.get("activation"), config=config),
        "pallas_attention": lambda inputs, attrs, config: kops.attention(
            *inputs, causal=attrs.get("causal", True), config=config),
        "fused_elementwise": lambda inputs, attrs, config: kops.fused_elementwise(
            inputs[0], attrs["chain"], inputs[1:]),
    }


class Engine:
    def __init__(
        self,
        graph: Graph,
        plan: Optional[InferencePlan] = None,
        registry: Optional[BackendRegistry] = None,
        device: DeviceLike = None,
        cuda_graph: bool = True,
    ):
        graph.validate()
        self.graph = graph
        self.plan = plan
        self.registry = registry
        self.device = resolve_device(device)
        self._order = graph.toposort()
        self._consts = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                        for k, v in graph.constants.items()}
        vendor_w, other = set(), set()
        for node in self._order:
            vendor_conv = (node.op in ("conv2d", "fused_conv2d")
                           and node.attrs.get("layout") == "NHWC"
                           and self._lane(node) is None)
            for i, t in enumerate(node.inputs):
                (vendor_w if vendor_conv and i == 1 else other).add(t)
        for name in (vendor_w - other) & self._consts.keys():
            self._consts[name] = ref_ops.nhwc_conv_weight(self._consts[name])
        self._program = Program(self._forward, "engine", self.device,
                                graphed=cuda_graph)

    def _choice(self, node):
        return self.plan.choice(node.name) if self.plan else None

    def _lane(self, node):
        """The registry function that runs `node`, or None for ref_ops: the
        plan's backend where it routes the node, else the registry's
        `fused_elementwise` entry for a fused chain."""
        if not self.registry:
            return None
        choice = self._choice(node)
        if choice is not None and choice.backend != "xla":
            return self.registry[choice.backend]
        if node.op == "fused_elementwise":
            return self.registry.get("fused_elementwise")
        return None

    def run_env(self, *args) -> Dict[str, torch.Tensor]:
        """Run the graph; returns every tensor it computed, by name (inputs
        may be tensors or numpy arrays; they are moved to the device)."""
        names = self.graph.inputs
        if len(args) != len(names):
            raise ValueError(f"expected {len(names)} inputs {names}")
        env: Dict[str, Any] = dict(self._consts)
        env.update((n, torch.as_tensor(a, device=self.device))
                   for n, a in zip(names, args))
        for node in self._order:
            ins = [env[t] for t in node.inputs]
            lane = self._lane(node)
            if lane is not None:
                choice = self._choice(node)
                out = lane(ins, node.attrs, choice.config if choice else None)
            else:
                out = ref_ops.run_op(node.op, ins, node.attrs)
            env[node.outputs[0]] = out
        return env

    def _forward(self, *args) -> List[torch.Tensor]:
        env = self.run_env(*args)
        return [env[o] for o in self.graph.outputs]

    def __call__(self, *args) -> List[torch.Tensor]:
        """The graph's outputs, fresh tensors that later calls leave alone
        (the captured forward's outputs are copied out of its buffers)."""
        if len(args) != len(self.graph.inputs):
            raise ValueError(f"expected {len(self.graph.inputs)} inputs "
                             f"{self.graph.inputs}")
        return [t.clone() for t in self._program((), args)]

    def verify_against_reference(self, *args, rtol=2e-2, atol=2e-2) -> float:
        """Every optimized plan must be numerically equivalent to the same
        graph on the vendor lane.  Returns the max abs error; raises
        AssertionError past the tolerance."""
        ref = Engine(self.graph, device=self.device, cuda_graph=False)(*args)
        got = self(*args)
        max_err = 0.0
        for r, g in zip(ref, got):
            r, g = r.float().cpu().numpy(), g.float().cpu().numpy()
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)
            max_err = max(max_err, float(np.max(np.abs(g - r))))
        return max_err
