"""The fixed-batch engines on a mesh: the hybrid (zamba2) and encdec
(whisper) families, which only the fixed-batch loop serves, against the
JAX package.

  * (a) the rank shards with a stub TensorParallel: `HybridLM` /
    `EncDecLM.tp_local_params` at tp = 2 / 4 are the logical-axis slices
    bit for bit (mamba's in_proj columns and conv channels head-aligned,
    the shared block's in_proj and whisper's `enc_pos` replicated, the KV
    heads a rank's query heads read where they do not divide the axis,
    whisper's odd vocabulary moving the LM head's split to its rows),
    `init_serving(tp=)` equals cutting the whole model, the fixed-batch
    caches have the rank's shapes, and a split this path does not run
    raises naming the axis (the serving layouts it now runs, "kv_seq"
    over "model", "batch" over "data" and "seq" over "data" with the
    batch replicated, are served in the worlds below and give the JAX
    engine's streams);
  * (b) the layers on each rank's shards with the collectives, in gloo
    worlds of 2 and 4 CPU processes: `attn_forward` (causal, the encoder's
    non-causal form, cross-attention), `cross_kv`, `attn_decode`,
    `mamba_forward(return_state=True)` and one encoder layer at 1500
    frames (the chunked form, two chunks of 750), every rank's output
    bitwise equal, within 1e-6 x max of the tp = 1 module and 1e-5 x max
    of the JAX module, the carries and K / V the rank's slices;
  * (c) the cross-mesh differential: both tiny f32 models trained briefly
    in JAX (the encdec's batches carry `audio_embeds`), served by the JAX
    `FixedBatchEngine` on a 1-wide Auto-typed mesh and by the port's with
    no mesh, on tp_mesh(1) and in gloo worlds of 2 and 4 processes (one
    world per width serves both models): greedy and keyed-sampled streams
    equal to JAX's on every rank.

The hybrid has 5 layers (groups 2, 2 and a remainder of 1), 4 / 2 heads
and 16 SSM heads; the encdec 4 / 2 heads and an odd vocabulary (193), so
at tp = 4 both read replicated KV heads and whisper's LM head splits on
"embed_vec" as at full size.
"""

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig, SyntheticLMData
from repro.distributed.sharding import DEFAULT_RULES as JAX_RULES
from repro.distributed.sharding import prune_for_mesh as jax_prune_for_mesh
from repro.launch.steps import TrainConfig, jit_train_step, make_state_shardings
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import mlp as jax_mlp
from repro.models.zoo import _norm as jax_norm
from repro.optim import AdamWConfig, adamw_init
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.sampling import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.launch.steps import local_cache_shapes, train_rules
from repro_torch.models import attention as port_attention
from repro_torch.models import build_model
from repro_torch.models import mamba as port_mamba
from repro_torch.serve.engine import FixedBatchEngine, ServeConfig, ServeEngine
from repro_torch.serve.router import PlanRouter
from repro_torch.tree import tree_flatten_with_paths, tree_map
from test_torch_tp_serving import (LAYER_RTOL_JAX, LAYER_RTOL_PORT, FakeMesh, _auto_mesh,
                                   _close, _TP, _worlds)

TRAIN_STEPS = 40
SEED = 3
MODELS = {
    "hybrid": ("zamba2-1.2b", dict(n_layers=5, vocab=192, dtype="float32")),
    "encdec": ("whisper-base", dict(vocab=193, dtype="float32")),
}
SERVE = dict(batch_size=2, max_seq=48, max_new_tokens=8)
# prompt lengths: the hybrid's left-padded batches are 16 and 32 long (at
# most ssm_chunk, or a multiple of it)
LENS = {"hybrid": (16, 11, 32, 5, 16, 3), "encdec": (12, 5, 20, 9, 3, 7)}


def _cfg(name) -> ModelConfig:
    arch, red = MODELS[name]
    return get_config(arch).reduced(**red)


def _rules(cfg, tp):
    """The guarded rules the callers pass: DEFAULT_RULES with the
    divisibility guards (an indivisible vocabulary -> "embed_vec")."""
    return PlanRouter(None).serve_rules(DEFAULT_RULES, FakeMesh(model=tp), cfg, "decoder")


def _workload(name, vocab, seed, cls):
    rng = np.random.RandomState(seed)
    prompts, samp = [], []
    for i, n in enumerate(LENS[name]):
        start = int(rng.randint(0, vocab))
        prompts.append(((start + 17 * np.arange(n)) % vocab).astype(np.int32))
        samp.append([None, cls(temperature=0.7, top_k=8, seed=11 + seed), None,
                     cls(temperature=0.5, top_p=0.9, seed=5 + seed)][i % 4])
    return prompts, samp


def _audio(cfg):
    return np.random.default_rng(9).standard_normal((cfg.enc_seq, cfg.d_model)
                                                    ).astype(np.float32)


# --------------------------------------------------- (a) the rank shards
def _shards(name, tp, rules=None):
    cfg = _cfg(name)
    model = build_model(cfg)
    params = model.serving_params(model.init(torch.Generator().manual_seed(0)), "cpu")
    rules = rules or _rules(cfg, tp)
    return cfg, params, [model.tp_local_params(params, _TP(rules, r, tp))
                         for r in range(tp)]


def _check_attn(cfg, got, whole, r, tp):
    """An attention subtree (stacked or not) of rank r: its query heads'
    wq columns and wo rows, the KV heads they read (the KV heads' block
    where they divide the axis, head r // 2 alone at tp = 4)."""
    hd, hl = cfg.hd, cfg.n_heads // tp
    q = slice(r * hl * hd, (r + 1) * hl * hd)
    assert torch.equal(got["wq"]["w"], whole["wq"]["w"][..., q])
    assert torch.equal(got["wo"]["w"], whole["wo"]["w"][..., q, :])
    kv = r if tp == 2 else r // 2
    for n in ("wk", "wv"):
        assert torch.equal(got[n]["w"], whole[n]["w"][..., kv * hd:(kv + 1) * hd]), (r, n)


def _check_mlp(got, whole, r, tp):
    for n in got:
        w = whole[n]["w"]
        if n == "w_out":
            f = w.shape[-2] // tp
            assert torch.equal(got[n]["w"], w[..., r * f:(r + 1) * f, :]), n
        else:
            f = w.shape[-1] // tp
            assert torch.equal(got[n]["w"], w[..., r * f:(r + 1) * f]), n


@pytest.mark.parametrize("tp", [2, 4])
def test_hybrid_shards_are_the_logical_axis_slices(tp):
    cfg, params, shards = _shards("hybrid", tp)
    d_in = cfg.ssm_expand * cfg.d_model
    nh, n = d_in // cfg.ssm_head_dim, cfg.ssm_state
    dl, hl = d_in // tp, nh // tp
    whole = params["blocks"]["mamba"]
    for r, s in enumerate(shards):
        mp = s["blocks"]["mamba"]
        cols, chans = port_mamba.tp_columns(cfg, r, tp)
        assert torch.equal(mp["in_proj"]["w"], whole["in_proj"]["w"][..., cols])
        assert torch.equal(mp["conv_w"], whole["conv_w"][..., chans])
        assert torch.equal(mp["conv_b"], whole["conv_b"][..., chans])
        assert chans.numel() == dl + 2 * n
        for name in ("A_log", "D", "dt_bias"):
            assert torch.equal(mp[name], whole[name][:, r * hl:(r + 1) * hl]), name
        assert torch.equal(mp["out_proj"]["w"], whole["out_proj"]["w"][:, r * dl:(r + 1) * dl])
        sp = s["shared"]
        assert torch.equal(sp["in_proj"]["w"], params["shared"]["in_proj"]["w"])
        _check_attn(cfg, sp["attn"], params["shared"]["attn"], r, tp)
        _check_mlp(sp["mlp"], params["shared"]["mlp"], r, tp)
        assert torch.equal(s["embed"]["emb"], params["embed"]["emb"].chunk(tp, 0)[r])
        assert torch.equal(s["lm_head"]["w"], params["lm_head"]["w"].chunk(tp, 1)[r])
        assert torch.equal(s["final_norm"]["scale"], params["final_norm"]["scale"])


@pytest.mark.parametrize("tp", [2, 4])
def test_encdec_shards_are_the_logical_axis_slices(tp):
    """Every attention and MLP cut on the heads and "ffn"; the odd
    vocabulary leaves the embedding whole and splits the LM head's rows
    ("embed_vec"); `enc_pos` and the layer norms replicated."""
    cfg, params, shards = _shards("encdec", tp)
    rules = _rules(cfg, tp)
    assert rules.lookup("vocab") is None and rules.lookup("embed_vec") == "model"
    d = cfg.d_model // tp
    for r, s in enumerate(shards):
        _check_attn(cfg, s["encoder"]["attn"], params["encoder"]["attn"], r, tp)
        _check_mlp(s["encoder"]["mlp"], params["encoder"]["mlp"], r, tp)
        for name in ("self_attn", "cross_attn"):
            _check_attn(cfg, s["decoder"][name], params["decoder"][name], r, tp)
        _check_mlp(s["decoder"]["mlp"], params["decoder"]["mlp"], r, tp)
        assert torch.equal(s["lm_head"]["w"], params["lm_head"]["w"][r * d:(r + 1) * d])
        for key in ("enc_pos", "embed"):
            assert all(torch.equal(a, b) for a, b in zip(
                (v for _, v in tree_flatten_with_paths(s[key])),
                (v for _, v in tree_flatten_with_paths(params[key]))))
        assert torch.equal(s["decoder"]["self_norm"]["bias"],
                           params["decoder"]["self_norm"]["bias"])


@pytest.mark.parametrize("name", list(MODELS))
def test_init_serving_draws_the_rank_shards_directly(name):
    """`init_serving(gen)` is `serving_params(init(gen))` bit for bit, and
    `init_serving(gen, tp=)` the shards of it, each part cut as drawn."""
    cfg = _cfg(name)
    model = build_model(cfg)
    whole = model.init_serving(torch.Generator().manual_seed(3))
    want = dict(tree_flatten_with_paths(model.serving_params(
        model.init(torch.Generator().manual_seed(3)), "cpu")))
    got = dict(tree_flatten_with_paths(whole))
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    for tp in (2, 4):
        for r in (0, tp - 1):
            t = _TP(_rules(cfg, tp), r, tp)
            want = dict(tree_flatten_with_paths(model.tp_local_params(whole, t)))
            got = dict(tree_flatten_with_paths(
                model.init_serving(torch.Generator().manual_seed(3), tp=t)))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (tp, r, k)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_fixed_batch_caches_have_the_rank_shapes(name, tp):
    """K / V (and ek / ev) at the rank's KV heads; conv at its
    head-aligned channels d_in / tp + 2n (not conv_dim / tp); ssm at its
    heads."""
    cfg = _cfg(name)
    model = build_model(cfg)
    t = _TP(_rules(cfg, tp), tp - 1, tp) if tp > 1 else None
    got = local_cache_shapes(model, 2, 48, t)
    hkv = cfg.n_kv_heads // tp if tp <= cfg.n_kv_heads else 1
    b, s = 2, 48
    if name == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        n, nh = cfg.ssm_state, d_in // cfg.ssm_head_dim
        assert got["conv"] == (cfg.n_layers, b, cfg.conv_width - 1, d_in // tp + 2 * n)
        assert got["ssm"] == (cfg.n_layers, b, nh // tp, cfg.ssm_head_dim, n)
        assert got["k"] == got["v"] == (cfg.n_layers // cfg.attn_every, b, s, hkv, cfg.hd)
        if tp > 1:
            assert got["conv"][-1] != (d_in + 2 * n) // tp
    else:
        assert got["k"] == got["v"] == (cfg.n_layers, b, s, hkv, cfg.hd)
        assert got["ek"] == got["ev"] == (cfg.n_layers, b, cfg.enc_seq, hkv, cfg.hd)
    assert got["lengths"] == (b,)


# the serving layouts of the production meshes this path now runs: the
# split, the mesh that serves the hybrid under it (in the world of its
# ranks) and that run's key
SPLIT_RUNS = {"kv_seq": ({"data": 1, "model": 2}, "hybrid/kv_seq_model2"),
              "batch": ({"data": 2, "model": 2}, "hybrid/batch_data2_model2"),
              "seq": ({"data": 2, "model": 1}, "hybrid/seq_data2")}


@pytest.mark.parametrize("axis,mesh", [("kv_seq", FakeMesh(model=2)),
                                       ("ssm_state", FakeMesh(model=2)),
                                       ("seq", FakeMesh(model=2)),
                                       ("batch", FakeMesh(model=2, data=2)),
                                       ("seq", FakeMesh(model=1, data=2)),
                                       ("expert_ffn", FakeMesh(model=2))])
def test_a_split_this_path_does_not_run_raises_naming_the_axis(axis, mesh, request):
    """"kv_seq" over "model", "batch" over "data" and "seq" over "data"
    (the sequence-parallel prefill, the batch replicated) now run: the
    hybrid served under each (in the worlds of 2 and 4 ranks, on a (1, 2),
    a (2, 2) and a (2, 1) mesh) gives the JAX engine's streams on every
    rank.  What stays refused raises NotImplementedError naming the axis:
    "ssm_state" and "seq" over "model".  The "expert_ffn" case no longer
    raises: training takes "expert_ffn" over "model", and the case checks
    only that each rank's cut of the experts holds its block of their
    width; the training step itself runs in
    tests/test_torch_train_layouts.py's "efn14" world (6 experts on
    (data 1, model 4)), held against JAX there."""
    cfg = _cfg("hybrid")
    model = build_model(cfg)
    size = dict(mesh.shape)
    if axis in SPLIT_RUNS and size == SPLIT_RUNS[axis][0]:
        outs, streams, _ = request.getfixturevalue("worlds")
        key = SPLIT_RUNS[axis][1]
        for rank, res in enumerate(outs[size["data"] * size["model"]]):
            run = res["split_runs"][key]
            assert run["rules"][axis] in ("model", "data"), (key, run["rules"])
            assert run["streams"] == streams["hybrid"], f"{key} rank {rank}"
            assert run["requests"] == len(LENS["hybrid"])
        return
    if axis == "expert_ffn":
        # training takes it too: the step's cut holds the rank's slice of
        # the expert width (the step runs in test_torch_train_layouts.py's
        # efn14 world)
        moe = build_model(get_config("qwen2-moe-a2.7b").reduced())
        rules = train_rules(DEFAULT_RULES.replace(experts=None, expert_ffn="model"), mesh)
        for rank in range(2):
            cut = moe.tp_layout(_TP(rules, rank, 2))["blocks"]["moe"]["w_in"]
            assert cut.dim == 3 and cut.full == moe.cfg.d_expert
            assert cut.index.tolist() == list(range(rank * moe.cfg.d_expert // 2,
                                                    (rank + 1) * moe.cfg.d_expert // 2))
        return
    target = "data" if size.get("data", 1) > 1 else "model"
    rules = DEFAULT_RULES.replace(**{axis: target})
    for engine in (FixedBatchEngine, ServeEngine):
        with pytest.raises(NotImplementedError, match=f"'{axis}'"):
            engine(model, {}, ServeConfig(**SERVE), device="cpu", mesh=mesh, rules=rules)


def test_an_indivisible_split_raises_value_error_naming_the_axis():
    """whisper's odd vocabulary on the model axis (the unguarded default
    rules), as the reference's placement refuses it."""
    cfg = _cfg("encdec")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="'vocab'"):
        model.tp_local_params(model.init(torch.Generator().manual_seed(0)),
                              _TP(DEFAULT_RULES, 0, 2))


# ------------------------------------------------------ the cross-mesh worlds
# The child: one rank of a gloo world over a FileStore, torch only.  It
# serves both models' workloads through FixedBatchEngine (world 1: with no
# mesh and on tp_mesh(1); wider: on tp_mesh(world), the parameters drawn
# through the engine's params callable) and, in wider worlds, runs the
# layers on its shards and builds an engine under unguarded rules.
_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.distributed.collectives import TensorParallel, tensor_parallel
    from repro_torch.distributed.sharding import prune_for_mesh
    from repro_torch.launch.mesh import init_file_world, make_mesh, tp_mesh
    from repro_torch.launch.steps import local_cache_shapes, prefill_step
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    from repro_torch.models import mamba as M
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig
    from repro_torch.serve.router import PlanRouter
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.tree import tree_map

    rank, world, store, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    job = json.load(open(job_path))
    init_file_world(store, rank, world)

    def load(path):
        params = {}
        with np.load(path) as z:
            for key in z.files:
                node = params
                *path_, leaf = key.split("/")
                for k in path_:
                    node = node.setdefault(k, {})
                node[leaf] = torch.from_numpy(z[key])
        return params

    def workload(name, vocab, seed):
        rng = np.random.RandomState(seed)
        prompts, samp = [], []
        for i, n in enumerate(job["lens"][name]):
            start = int(rng.randint(0, vocab))
            prompts.append(((start + 17 * np.arange(n)) % vocab).astype(np.int32))
            samp.append([None, SamplingParams(temperature=0.7, top_k=8, seed=11 + seed),
                         None, SamplingParams(temperature=0.5, top_p=0.9,
                                              seed=5 + seed)][i % 4])
        return prompts, samp

    def rules_for(cfg, mesh):
        return PlanRouter(None).serve_rules(DEFAULT_RULES, mesh, cfg, "decoder")

    def serve(name, model, params, extras, mesh):
        scfg = ServeConfig(**job["serve"])
        if mesh is None:
            eng = FixedBatchEngine(model, params, scfg, extras, device="cpu")
        else:
            sp = model.serving_params(params, "cpu")
            eng = FixedBatchEngine(model, lambda tp: sp if tp is None else
                                   model.tp_local_params(sp, tp), scfg, extras,
                                   device="cpu", mesh=mesh, rules=rules_for(model.cfg, mesh))
        prompts, samp = workload(name, model.cfg.vocab, job["seed"])
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        done = eng.run()
        toks = torch.as_tensor(np.stack([prompts[0], prompts[0]]))[:, :4]
        ex = {k: v[:2] for k, v in eng.extras.items()}
        with tensor_parallel(eng.tp):
            _, cache = prefill_step(model, eng.params, toks, scfg.max_seq, ex)
        return {"streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "requests": eng.stats["requests"],
                "cache": {k: list(v.shape) for k, v in cache.items()},
                "want_cache": {k: list(v) for k, v in local_cache_shapes(
                    model, 2, scfg.max_seq, eng.tp).items()},
                "tp": None if eng.tp is None else [eng.tp.rank, eng.tp.size]}

    def layers(name, model, params, mesh, z):
        cfg = model.cfg
        rules = prune_for_mesh(rules_for(cfg, mesh), mesh)
        tp = TensorParallel.from_mesh(mesh, rules)
        local = model.tp_local_params(model.serving_params(params, "cpu"), tp)
        first = lambda tree: tree_map(lambda t: t[0], tree)
        t = lambda k: torch.from_numpy(z[k])
        f, n = A.tp_kv_heads(cfg, tp.rules, tp.rank, tp.size)
        kvs = lambda x: x[:, :, f:f + n].contiguous()
        res = {}
        with tensor_parallel(tp):
            if name == "hybrid":
                attn = local["shared"]["attn"]
                pos = torch.arange(z["x"].shape[1]).expand(z["x"].shape[0], -1)
                y, (k, v) = A.attn_forward(attn, cfg, t("x"), positions=pos, causal=True,
                                           return_kv=True)
                kc, vc = kvs(t("k_cache")), kvs(t("v_cache"))
                yd = A.attn_decode(attn, cfg, t("x_dec"), kc, vc, t("lengths"))
                ym, (conv, h) = M.mamba_forward(first(local["blocks"])["mamba"], cfg,
                                                t("x_ssm"), return_state=True)
                res.update(causal=y, causal_k=k, causal_v=v, decode=yd, decode_k=kc,
                           decode_v=vc, mamba=ym, mamba_conv=conv, mamba_h=h)
            else:
                enc, dec = first(local["encoder"]), first(local["decoder"])
                res["noncausal"] = A.attn_forward(enc["attn"], cfg, t("x"), causal=False)
                ek, ev = A.cross_kv(dec["cross_attn"], cfg, t("enc"))
                res.update(cross_k=ek, cross_v=ev, cross=A.attn_forward(
                    dec["cross_attn"], cfg, t("x"), kv_override=(ek, ev)))
                res["enc_layer"] = model._enc_block(t("x_long"), enc)
        return {k: v.float().numpy().tolist() for k, v in res.items()}

    def split_run(name, model, params, mesh, rules):
        scfg = ServeConfig(**job["serve"])
        sp = model.serving_params(params, "cpu")
        eng = FixedBatchEngine(model, lambda tp: model.tp_local_params(sp, tp) if tp else sp,
                               scfg, device="cpu", mesh=mesh, rules=rules)
        prompts, samp = workload(name, model.cfg.vocab, job["seed"])
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        done = eng.run()
        return {"streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "requests": eng.stats["requests"],
                "rules": {a: eng.rules.lookup(a) for a in ("batch", "kv_seq", "kv_heads",
                                                           "seq")}}

    out = {"runs": {}, "layers": {}, "split_runs": {}}
    for name, spec in job["models"].items():
        cfg = get_config(spec["arch"]).reduced(**spec["cfg"])
        model = build_model(cfg)
        params = load(spec["params"])
        extras = {"audio_embeds": np.load(spec["audio"])} if "audio" in spec else None
        if world == 1:
            out["runs"][f"{name}/none"] = serve(name, model, params, extras, None)
        mesh = tp_mesh(world, "cpu")
        out["runs"][f"{name}/tp{world}"] = serve(name, model, params, extras, mesh)
        if world > 1:
            out["layers"][name] = layers(name, model, params, mesh,
                                         dict(np.load(spec["layers"])))
        if name == "hybrid" and world == 2:
            # the KV cache's positions over "model" (its KV heads replicated)
            out["split_runs"]["hybrid/kv_seq_model2"] = split_run(
                name, model, params, mesh,
                rules_for(cfg, mesh).replace(kv_heads=None, kv_seq="model"))
        if name == "hybrid" and world == 2:
            # the sequence-parallel prefill: the prompt over "data" on a
            # (data 2, model 1) mesh, the batch replicated
            mesh21 = make_mesh((2, 1), device_type="cpu")
            out["split_runs"]["hybrid/seq_data2"] = split_run(
                name, model, params, mesh21,
                rules_for(cfg, mesh21).replace(batch=None, seq="data"))
        if name == "hybrid" and world == 4:
            # the batch over "data" on a (data 2, model 2) mesh
            mesh22 = make_mesh((2, 2), device_type="cpu")
            out["split_runs"]["hybrid/batch_data2_model2"] = split_run(
                name, model, params, mesh22, rules_for(cfg, mesh22))
        if world == 2 and name == "encdec":
            try:
                FixedBatchEngine(model, params, ServeConfig(**job["serve"]), extras,
                                 device="cpu", mesh=mesh, rules=DEFAULT_RULES)
                out["unguarded"] = None
            except ValueError as e:
                out["unguarded"] = str(e)
    json.dump(out, open(out_path, "w"))
""")


def _train(jcfg, mesh, audio=None):
    """jcfg's model trained TRAIN_STEPS steps in JAX on the learnable
    synthetic data (with `audio` broadcast over every batch) -> params."""
    model = jax_build_model(jcfg)
    data = SyntheticLMData(DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=8))
    train_cfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS))

    def batch(i):
        b = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        if audio is not None:
            b["audio_embeds"] = jnp.broadcast_to(jnp.asarray(audio), (8, *audio.shape))
        return b

    with mesh:
        params = model.init(jax.random.PRNGKey(0))
        opt = adamw_init(params)
        params, opt = jax.device_put((params, opt), make_state_shardings(
            model, mesh, jax_prune_for_mesh(JAX_RULES, mesh), train_cfg))
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch(0).items()}
        step = jit_train_step(model, mesh, JAX_RULES, train_cfg, specs)
        for i in range(TRAIN_STEPS):
            params, opt, _ = step(params, opt, batch(i))
    return model, params


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both tiny models (f32) trained in JAX and exported to .npz files of
    the port's tree; -> ({name: (jcfg, model, params, npz, audio)}, mesh)."""
    tmp = tmp_path_factory.mktemp("tp_fixed_trained")
    mesh = _auto_mesh()
    out = {}
    for name, (arch, red) in MODELS.items():
        jcfg = jax_get_config(arch).reduced(**red)
        audio = _audio(jcfg) if name == "encdec" else None
        model, params = _train(jcfg, mesh, audio)
        np.savez(tmp / f"{name}.npz",
                 **dict(tree_flatten_with_paths(jax.tree.map(np.asarray, params))))
        out[name] = (jcfg, model, params, str(tmp / f"{name}.npz"), audio)
    return out, mesh


def _jax_streams(trained, name):
    models, mesh = trained
    jcfg, model, params, _, audio = models[name]
    extras = {"audio_embeds": audio} if audio is not None else None
    eng = JaxFixedBatchEngine(model, params, mesh, JAX_RULES, JaxServeConfig(**SERVE), extras)
    prompts, samp = _workload(name, jcfg.vocab, SEED, JaxSampling)
    for p, s in zip(prompts, samp):
        eng.submit(p, sampling=s)
    with mesh:
        done = eng.run()
    return {str(r.rid): [int(t) for t in r.output] for r in done}


def _layer_inputs(jcfg, tmp, name):
    rng = np.random.default_rng(5)
    d = jcfg.d_model
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    z = {"x": f32(2, 9, d)}
    if name == "hybrid":
        z.update(x_dec=f32(2, 1, d), k_cache=f32(2, 12, jcfg.n_kv_heads, jcfg.hd),
                 v_cache=f32(2, 12, jcfg.n_kv_heads, jcfg.hd),
                 lengths=np.asarray([5, 11], np.int32), x_ssm=f32(2, 32, d))
    else:
        z.update(enc=f32(2, 20, d), x_long=f32(1, 1500, d))
    path = tmp / f"layers_{name}.npz"
    np.savez(path, **z)
    return str(path), z


def _reference_layers(trained, name, z):
    """The JAX modules' and the single-device port modules' outputs on the
    trained layers at the inputs `z`: -> (jax, port)."""
    models, _ = trained
    jcfg, _, params, _, _ = models[name]
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    model = build_model(cfg)
    sp = model.serving_params(params_from_jax(jax.tree.map(np.asarray, params)), "cpu")
    jfirst = lambda tree: jax.tree.map(lambda a: a[0], tree)   # noqa: E731
    first = lambda tree: tree_map(lambda t: t[0], tree)         # noqa: E731
    t = lambda k: torch.from_numpy(z[k].copy())                 # noqa: E731
    j = lambda k: jnp.asarray(z[k])                             # noqa: E731
    if name == "hybrid":
        b, s = z["x"].shape[:2]
        jpos, pos = jnp.broadcast_to(jnp.arange(s), (b, s)), torch.arange(s).expand(b, s)
        ja, pa = params["shared"]["attn"], sp["shared"]["attn"]
        y, (k, v) = jax_attention.attn_forward(ja, jcfg, j("x"), positions=jpos,
                                               causal=True, return_kv=True)
        yd, kc, vc = jax_attention.attn_decode(ja, jcfg, j("x_dec"), j("k_cache"),
                                               j("v_cache"), j("lengths"))
        ym, (conv, h) = jax_mamba.mamba_forward(jfirst(params["blocks"])["mamba"], jcfg,
                                                j("x_ssm"), return_state=True)
        want = dict(causal=y, causal_k=k, causal_v=v, decode=yd, decode_k=kc,
                    decode_v=vc, mamba=ym, mamba_conv=conv, mamba_h=h)
        y, (k, v) = port_attention.attn_forward(pa, cfg, t("x"), positions=pos,
                                                causal=True, return_kv=True)
        kc, vc = t("k_cache"), t("v_cache")
        yd = port_attention.attn_decode(pa, cfg, t("x_dec"), kc, vc, t("lengths"))
        ym, (conv, h) = port_mamba.mamba_forward(first(sp["blocks"])["mamba"], cfg,
                                                 t("x_ssm"), return_state=True)
        port = dict(causal=y, causal_k=k, causal_v=v, decode=yd, decode_k=kc,
                    decode_v=vc, mamba=ym, mamba_conv=conv, mamba_h=h)
    else:
        jenc, jdec = jfirst(params["encoder"]), jfirst(params["decoder"])
        enc, dec = first(sp["encoder"]), first(sp["decoder"])
        ek, ev = jax_attention.cross_kv(jdec["cross_attn"], jcfg, j("enc"))

        def jax_enc_layer(x):
            h = jax_norm(jcfg, jenc["attn_norm"], x)
            x = x + jax_attention.attn_forward(jenc["attn"], jcfg, h, causal=False)
            h = jax_norm(jcfg, jenc["mlp_norm"], x)
            return x + jax_mlp.mlp_apply(jenc["mlp"], h, "gelu")

        want = dict(noncausal=jax_attention.attn_forward(jenc["attn"], jcfg, j("x"),
                                                         causal=False),
                    cross_k=ek, cross_v=ev,
                    cross=jax_attention.attn_forward(jdec["cross_attn"], jcfg, j("x"),
                                                     kv_override=(ek, ev)),
                    enc_layer=jax.jit(jax_enc_layer)(j("x_long")))
        ek, ev = port_attention.cross_kv(dec["cross_attn"], cfg, t("enc"))
        port = dict(noncausal=port_attention.attn_forward(enc["attn"], cfg, t("x"),
                                                          causal=False),
                    cross_k=ek, cross_v=ev,
                    cross=port_attention.attn_forward(dec["cross_attn"], cfg, t("x"),
                                                      kv_override=(ek, ev)),
                    enc_layer=model._enc_block(t("x_long"), enc))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in port.items()})


@pytest.fixture(scope="module")
def worlds(trained, tmp_path_factory):
    """One gloo world of each width serves both models and runs the
    layers; the JAX engine's streams and the reference layers are
    computed while the worlds run."""
    tmp = tmp_path_factory.mktemp("tp_fixed_worlds")
    models, _ = trained
    job = {"seed": SEED, "serve": SERVE, "lens": LENS, "models": {}}
    inputs = {}
    for name, (arch, red) in MODELS.items():
        jcfg, _, _, npz, audio = models[name]
        spec = {"arch": arch, "cfg": red, "params": npz}
        if audio is not None:
            spec["audio"] = str(tmp / "audio.npy")
            np.save(spec["audio"], audio)
        spec["layers"], inputs[name] = _layer_inputs(jcfg, tmp, name)
        job["models"][name] = spec

    def meanwhile():
        return ({name: _jax_streams(trained, name) for name in MODELS},
                {name: _reference_layers(trained, name, z) for name, z in inputs.items()})

    outs, (streams, refs) = _worlds(tmp, job, meanwhile, child=_CHILD)
    return outs, streams, refs


@pytest.mark.parametrize("name", list(MODELS))
def test_cross_mesh_fixed_batch_streams_equal_the_jax_engine(worlds, name):
    """Greedy and keyed-sampled streams of the port's FixedBatchEngine
    with no mesh, on tp_mesh(1) and in gloo worlds of 2 and 4 ranks (the
    ranks' shards drawn through the params callable) equal the JAX
    FixedBatchEngine's at tp = 1 on every rank; each rank's prefill cache
    has `local_cache_shapes`' shapes."""
    outs, streams, _ = worlds
    for w, ranks in outs.items():
        for r in ranks[1:]:
            assert r["runs"][f"{name}/tp{w}"]["streams"] == \
                ranks[0]["runs"][f"{name}/tp{w}"]["streams"], f"world {w}: ranks differ"
    runs = {f"{k}@{i}": v for ranks in outs.values() for i, res in enumerate(ranks)
            for k, v in res["runs"].items() if k.startswith(name + "/")}
    assert {k.split("@")[0] for k in runs} == {f"{name}/{leg}"
                                               for leg in ("none", "tp1", "tp2", "tp4")}
    cfg = _cfg(name)
    for leg, info in runs.items():
        assert info["streams"] == streams[name], f"{leg}: stream differs from JAX"
        assert info["requests"] == len(LENS[name]), leg
        assert info["cache"] == info["want_cache"], (leg, info["cache"])
        size = int(leg.split("/tp")[1].split("@")[0]) if "/tp" in leg else 1
        if size > 1:
            assert info["tp"] == [int(leg.split("@")[1]), size], leg
            assert info["cache"]["k"][3] == (1 if size == 4 else cfg.n_kv_heads // 2), leg
        else:
            assert info["tp"] is None and info["cache"]["k"][3] == cfg.n_kv_heads, leg
    if name == "encdec":
        for res in outs[2]:
            assert res["unguarded"] is not None and "'vocab'" in res["unguarded"]


@pytest.mark.parametrize("name", list(MODELS))
def test_tp_layers_match_the_single_device_and_jax_modules(worlds, name):
    """The fixed-batch layers on every rank's shards at tp = 2 and 4:
    outputs after the collectives bitwise equal on every rank, within
    1e-6 x max of the tp = 1 module and 1e-5 x max of the JAX module; K /
    V, the conv window and the SSM state the rank's slices of the tp = 1
    ones (the KV heads its query heads read, its head-aligned channels,
    its heads)."""
    outs, _, refs = worlds
    jax_out, port = refs[name]
    cfg = _cfg(name)
    whole = ("causal", "decode", "mamba") if name == "hybrid" else (
        "noncausal", "cross", "enc_layer")
    for w in (2, 4):
        ranks = outs[w]
        for r, res in enumerate(ranks):
            got = res["layers"][name]
            for k in whole:
                assert got[k] == ranks[0]["layers"][name][k], f"world {w} rank {r} {k}"
                _close(got[k], port[k], LAYER_RTOL_PORT, f"tp{w} {k} vs tp=1")
                _close(got[k], jax_out[k], LAYER_RTOL_JAX, f"tp{w} {k} vs JAX")
            f, n = port_attention.tp_kv_heads(cfg, _rules(cfg, w), r, w)
            kv = [k for k in got if k.endswith(("_k", "_v"))]
            for k in kv:
                _close(got[k], port[k][:, :, f:f + n], LAYER_RTOL_PORT, f"tp{w} r{r} {k}")
                _close(got[k], jax_out[k][:, :, f:f + n], LAYER_RTOL_JAX, f"tp{w} r{r} {k}")
            if name == "hybrid":
                _, chans = port_mamba.tp_columns(cfg, r, w)
                hl = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim // w
                for want, tol in ((port, LAYER_RTOL_PORT), (jax_out, LAYER_RTOL_JAX)):
                    _close(got["mamba_conv"], want["mamba_conv"][..., chans.numpy()], tol,
                           f"tp{w} r{r} conv")
                    _close(got["mamba_h"], want["mamba_h"][:, r * hl:(r + 1) * hl], tol,
                           f"tp{w} r{r} ssm state")
