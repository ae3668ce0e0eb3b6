"""Plan-aware backend routing for the serving runtime — the port of
`repro.serve.router` (everything but the layouts-as-sharding half).

The WPK `InferencePlan` is per-operator *and per-shape*: the matmuls and
attention of a prefill (long query, batch 1) live at a very different point
of the roofline than the decode step (query length 1, batch = slot count),
and the unified step's chunked prefill (a `chunk_tokens`-wide query against
a growing paged cache) at a third.  `build_serve_graph` builds each shape
family as distinct stage-qualified nodes —

    prefill.attention   decode.attention   prefill_chunk.attention
    prefill.qkv_proj    decode.qkv_proj    prefill_chunk.qkv_proj
    prefill.mlp_up      decode.mlp_up      prefill_chunk.mlp_up
    prefill.mlp_down    decode.mlp_down    prefill_chunk.mlp_down
    prefill.lm_head     decode.lm_head     prefill_chunk.lm_head

(the ssm family's graph: `ssm_prefill_chunk` and `ssm_decode`, each with
`in_proj`, `out_proj` and `lm_head`) — node for node, name for name and shape for shape the JAX graph, and
`build_serve_plan` has `selection.select` race the vendor lane against
every applicable kernel template for each of them, measured on the card.
An attention node's kernel lane is the dense flash kernel, which the race
times on MHA-shaped K/V with its causal mask aligned at the top left; the
serving runtime runs the paged kernels, which read the tuned `block_q` and
`max_segments` of the `prefill_chunk` choice.

`PlanRouter` answers the runtime's dispatch questions from such a plan:
which attention backend each lane runs, how many segments one chunk may
pack, and each stage's matmul lane table (over the stage family's roles).  Vendor choices (`xla` in plans
tuned by either package, `torch` in hand-built ones) map to the port's
torch lanes; any other choice maps to the hand-written CUDA lane
(`cuda_attention` / `cuda_matmul`), so a plan tuned by the JAX package
selects the same lanes here.  With no plan every query answers the torch
lane.  Layout verdicts answer `replicated`: the tensor-parallel half
(`serve_rules`, `model_parallel > 1`) waits for TP serving (ROADMAP.md
queue 1, item 8b).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch import hw
from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Graph
from repro_torch.core.plan import InferencePlan, OpChoice
from repro_torch.core.search.tuner import Tuner
from repro_torch.core.selection import select

# the serve stages per model family: the ssm family has no attention op
# and its own matmul roles, so its stages are distinct nodes and a plan
# may tune both families side by side
FAMILY_STAGES = {
    "decoder": ("prefill", "decode", "prefill_chunk"),
    "ssm": ("ssm_prefill_chunk", "ssm_decode"),
}
STAGES = FAMILY_STAGES["decoder"] + FAMILY_STAGES["ssm"]

# the ssm family's routable matmul roles (the decoder's four are
# kernels.dispatch.MATMUL_ROLES)
SSM_MATMUL_ROLES = ("in_proj", "out_proj", "lm_head")

# the prefill lane's default width, shared by RuntimeConfig and the plans
DEFAULT_CHUNK_TOKENS = 32

VENDOR_BACKENDS = ("xla", "torch")

TP_NOT_PORTED = ("serve_rules (layouts as sharding) is not ported yet: "
                 "ROADMAP.md queue 1, item 8b (TP serving)")


def serve_stages(family: str):
    """The serve-plan stages a family's engine dispatches through."""
    return FAMILY_STAGES.get(family, FAMILY_STAGES["decoder"])


def _build_ssm_serve_graph(cfg: ModelConfig, *, slots: int,
                           chunk_tokens: Optional[int], dtype: str) -> Graph:
    """The ssm family's serve-time operator set: no attention op (the SSD
    scan is not a raced template), the three projections of each stage at
    the shapes the slot-pooled step programs run — a chunk-wide prefill
    segment and a slots-wide decode token.  The chunk width is rounded up
    to a multiple of `cfg.ssm_chunk`, as `SSMFamilyAdapter` rounds it."""
    g = Graph("serve_ssm")
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_head_dim
    proj = 2 * d_in + 2 * cfg.ssm_state + nh
    q = max(1, cfg.ssm_chunk)
    ct = min(chunk_tokens or DEFAULT_CHUNK_TOKENS, 4096)
    ct = -(-ct // q) * q

    xc = g.add_input("x_ssm_chunk", (1, ct, d), dtype)
    wi = g.add_input("w_in_proj", (d, proj), dtype)
    in_c = g.add_node("matmul", [xc, wi], (1, ct, proj), out_dtype=dtype,
                      name="ssm_prefill_chunk.in_proj")
    yc = g.add_input("y_ssm_chunk", (1, ct, d_in), dtype)
    wo = g.add_input("w_out_proj", (d_in, d), dtype)
    out_c = g.add_node("matmul", [yc, wo], (1, ct, d), out_dtype=dtype,
                       name="ssm_prefill_chunk.out_proj")
    wl = g.add_input("w_lm_ssm", (d, cfg.vocab), dtype)
    xl = g.add_input("x_ssm_last", (1, 1, d), dtype)
    lm_c = g.add_node("matmul", [xl, wl], (1, 1, cfg.vocab), out_dtype=dtype,
                      name="ssm_prefill_chunk.lm_head")

    xd = g.add_input("x_ssm_decode", (slots, 1, d), dtype)
    in_d = g.add_node("matmul", [xd, wi], (slots, 1, proj), out_dtype=dtype,
                      name="ssm_decode.in_proj")
    yd = g.add_input("y_ssm_decode", (slots, 1, d_in), dtype)
    out_d = g.add_node("matmul", [yd, wo], (slots, 1, d), out_dtype=dtype,
                       name="ssm_decode.out_proj")
    lm_d = g.add_node("matmul", [xd, wl], (slots, 1, cfg.vocab),
                      out_dtype=dtype, name="ssm_decode.lm_head")

    g.set_outputs([in_c, out_c, lm_c, in_d, out_d, lm_d])
    return g


def build_serve_graph(cfg: ModelConfig, *, prefill_len: int, slots: int,
                      max_seq: int, chunk_tokens: Optional[int] = None,
                      dtype: str = "float32",
                      family: str = "decoder") -> Graph:
    """The serve-time operator set as a Graph with stage-qualified names,
    the JAX graph's nodes, tensors, shapes and dtypes exactly.

    `chunk_tokens` is the unified step's per-step prompt-token budget (the
    width of the prefill_chunk stage's query); pass the engine's resolved
    `RuntimeConfig.chunk_width`.  None falls back to DEFAULT_CHUNK_TOKENS,
    the width of an engine built with a default RuntimeConfig.
    `family="ssm"` builds the state-cache family's stages instead
    (`ssm_prefill_chunk` / `ssm_decode`; see `FAMILY_STAGES`)."""
    if family == "ssm":
        return _build_ssm_serve_graph(cfg, slots=slots,
                                      chunk_tokens=chunk_tokens, dtype=dtype)
    g = Graph("serve")
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ct = min(chunk_tokens or DEFAULT_CHUNK_TOKENS, max_seq)

    # ---- prefill stage: one request, `prefill_len` query tokens
    xp = g.add_input("x_prefill", (1, prefill_len, d), dtype)
    wq = g.add_input("w_qkv", (d, (h + 2 * hkv) * hd), dtype)
    qkv_p = g.add_node("matmul", [xp, wq], (1, prefill_len, (h + 2 * hkv) * hd),
                       out_dtype=dtype, name="prefill.qkv_proj")
    qp = g.add_input("q_prefill", (1, prefill_len, h, hd), dtype)
    kp = g.add_input("k_prefill", (1, prefill_len, hkv, hd), dtype)
    att_p = g.add_node("attention", [qp, kp, kp], (1, prefill_len, h, hd),
                       out_dtype=dtype, name="prefill.attention")
    wu = g.add_input("w_up", (d, cfg.d_ff), dtype)
    mlp_p = g.add_node("matmul", [xp, wu], (1, prefill_len, cfg.d_ff),
                       out_dtype=dtype, name="prefill.mlp_up")
    wd = g.add_input("w_down", (cfg.d_ff, d), dtype)
    hp = g.add_input("h_prefill", (1, prefill_len, cfg.d_ff), dtype)
    mlpd_p = g.add_node("matmul", [hp, wd], (1, prefill_len, d),
                        out_dtype=dtype, name="prefill.mlp_down")
    wl = g.add_input("w_lm", (d, cfg.vocab), dtype)
    lm_p = g.add_node("matmul", [xp, wl], (1, prefill_len, cfg.vocab),
                      out_dtype=dtype, name="prefill.lm_head")

    # ---- decode stage: `slots` requests, one query token each, long cache
    xd = g.add_input("x_decode", (slots, 1, d), dtype)
    qkv_d = g.add_node("matmul", [xd, wq], (slots, 1, (h + 2 * hkv) * hd),
                       out_dtype=dtype, name="decode.qkv_proj")
    qd = g.add_input("q_decode", (slots, 1, h, hd), dtype)
    kd = g.add_input("k_decode", (slots, max_seq, hkv, hd), dtype)
    att_d = g.add_node("attention", [qd, kd, kd], (slots, 1, h, hd),
                       out_dtype=dtype, name="decode.attention")
    mlp_d = g.add_node("matmul", [xd, wu], (slots, 1, cfg.d_ff),
                       out_dtype=dtype, name="decode.mlp_up")
    hd_ = g.add_input("h_decode", (slots, 1, cfg.d_ff), dtype)
    mlpd_d = g.add_node("matmul", [hd_, wd], (slots, 1, d),
                        out_dtype=dtype, name="decode.mlp_down")
    lm_d = g.add_node("matmul", [xd, wl], (slots, 1, cfg.vocab),
                      out_dtype=dtype, name="decode.lm_head")

    # ---- prefill_chunk stage: one request, a `chunk_tokens`-wide slice of
    # its prompt attending to the (up to max_seq) committed paged cache
    xc = g.add_input("x_chunk", (1, ct, d), dtype)
    qkv_c = g.add_node("matmul", [xc, wq], (1, ct, (h + 2 * hkv) * hd),
                       out_dtype=dtype, name="prefill_chunk.qkv_proj")
    qc = g.add_input("q_chunk", (1, ct, h, hd), dtype)
    kc = g.add_input("k_chunk", (1, max_seq, hkv, hd), dtype)
    att_c = g.add_node("attention", [qc, kc, kc], (1, ct, h, hd),
                       out_dtype=dtype, name="prefill_chunk.attention")
    mlp_c = g.add_node("matmul", [xc, wu], (1, ct, cfg.d_ff),
                       out_dtype=dtype, name="prefill_chunk.mlp_up")
    hc = g.add_input("h_chunk", (1, ct, cfg.d_ff), dtype)
    mlpd_c = g.add_node("matmul", [hc, wd], (1, ct, d),
                        out_dtype=dtype, name="prefill_chunk.mlp_down")
    lm_c = g.add_node("matmul", [xc, wl], (1, ct, cfg.vocab),
                      out_dtype=dtype, name="prefill_chunk.lm_head")

    g.set_outputs([qkv_p, att_p, mlp_p, mlpd_p, lm_p,
                   qkv_d, att_d, mlp_d, mlpd_d, lm_d,
                   qkv_c, att_c, mlp_c, mlpd_c, lm_c])
    return g


def build_serve_plan(cfg: ModelConfig, *, prefill_len: int, slots: int,
                     max_seq: int, chunk_tokens: Optional[int] = None,
                     chip: hw.Chip = hw.H100,
                     tuner: Optional[Tuner] = None,
                     dtype: str = "bfloat16",
                     family: str = "decoder",
                     model_parallel: int = 1) -> InferencePlan:
    """Tune the serve graph and return its stage-qualified InferencePlan.
    With no `tuner`, the genetic search and RL-search on device time on
    the GPU (`Tuner()`), which raises where there is none;
    `tuner=Tuner(fitness=ModelFitness())` tunes on the analytic model of
    the H100 on any host.  `model_parallel` > 1 (the layout race) raises,
    as `select` does."""
    g = build_serve_graph(cfg, prefill_len=prefill_len, slots=slots,
                          max_seq=max_seq, chunk_tokens=chunk_tokens,
                          dtype=dtype, family=family)
    return select(g, tuner=tuner, chip=chip, dtype=dtype,
                  model_parallel=model_parallel)


def _roles(stage: str) -> Tuple[str, ...]:
    """The routable matmul roles of a stage's family."""
    from repro_torch.kernels.dispatch import MATMUL_ROLES
    return SSM_MATMUL_ROLES if stage.startswith("ssm_") else tuple(MATMUL_ROLES)


class PlanRouter:
    """Answers serve-time dispatch questions from a stage-qualified plan."""

    def __init__(self, plan: Optional[InferencePlan] = None):
        self.plan = plan

    def _lookup(self, stage: str, op: str) -> Optional[OpChoice]:
        if self.plan is None:
            return None
        choice = self.plan.choice(f"{stage}.{op}")
        if choice is not None:
            return choice
        for name, c in self.plan.choices.items():
            if name.startswith(f"{stage}.") and name.split(".", 1)[1].startswith(op):
                return c
        if stage == "prefill_chunk":
            # plans tuned before the chunk stage existed: the whole-prompt
            # prefill choice is the closest shape family
            return self._lookup("prefill", op)
        return None

    def attention_backend(self, stage: str) -> Tuple[str, Dict[str, Any]]:
        """-> ('torch' | 'cuda_attention', tuned config)."""
        assert stage in STAGES, stage
        c = self._lookup(stage, "attention")
        if c is None or c.backend in VENDOR_BACKENDS:
            return "torch", {}
        return "cuda_attention", dict(c.config)

    def chunk_segments(self, default: int = 1) -> int:
        """Packing width of the prefill lane.  A kernel choice carrying a
        tuned `max_segments` returns it; kernel choices tuned before the
        segmented kernel (no `max_segments`) pack one segment; a vendor
        choice or no plan defers to the engine's default."""
        if self.plan is None:
            return max(1, default)
        c = self._lookup("prefill_chunk", "attention")
        if c is None or c.backend in VENDOR_BACKENDS:
            return max(1, default)
        if "max_segments" in c.config:
            return max(1, int(c.config["max_segments"]))
        return 1

    def matmul_config(self, stage: str,
                      which: str = "qkv_proj") -> Tuple[str, Dict[str, Any]]:
        """-> ('torch' | 'cuda_matmul', tuned config) for a stage matmul."""
        assert stage in STAGES, stage
        c = self._lookup(stage, which)
        if c is None or c.backend in VENDOR_BACKENDS:
            return "torch", {}
        return "cuda_matmul", dict(c.config)

    def matmul_table(self, stage: str) -> Dict[str, Tuple[str, Dict[str, Any]]]:
        """Every stage matmul's (backend, config) keyed by role — the table
        `kernels.dispatch.matmul_dispatch` installs around the stage's
        lane.  ssm stages take the ssm family's roles."""
        return {role: self.matmul_config(stage, role) for role in _roles(stage)}

    # -------------------------------------------------------------- layouts
    def layout(self, stage: str, which: str) -> str:
        """The plan's layout verdict for one stage op: 'replicated' |
        'model_parallel'.  No plan, no choice and pre-layout plans answer
        'replicated' — the single-device semantics they were tuned under."""
        c = self._lookup(stage, which)
        if c is None:
            return "replicated"
        return getattr(c, "layout", "replicated")

    def layout_table(self, stage: str) -> Dict[str, str]:
        """Every stage op's layout verdict keyed by role (the matmul roles,
        plus 'attention' for decoder stages)."""
        roles = _roles(stage)
        if not stage.startswith("ssm_"):
            roles = roles + ("attention",)
        return {role: self.layout(stage, role) for role in roles}

    def serve_rules(self, *args, **kwargs):
        """Folding layout verdicts into sharding rules needs TP serving
        (item 8b), which does not exist yet."""
        raise NotImplementedError(TP_NOT_PORTED)

    def describe(self) -> Dict[str, str]:
        """Stage-qualified op -> chosen backend (for logs and benches)."""
        if self.plan is None:
            return {}
        return {name: c.backend for name, c in sorted(self.plan.choices.items())}
