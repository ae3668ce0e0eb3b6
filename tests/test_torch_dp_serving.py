"""The serving layouts of the production meshes (the fixed-batch engine
with the batch over "data" / "pod" x "data", the KV cache's positions over
"model", TP inside the experts, the batch-1 decode with "kv_seq" /
"ssm_state" over "data", the sequence-parallel prefill) against the JAX
package, on the CPU.

  * two gloo worlds of 4 CPU processes side by side: (data 2, model 2)
    and (pod 2, data 2, model 1).  Six tiny f32 models (dense, moe, vlm,
    ssm, hybrid, encdec) trained briefly in JAX and served by the JAX
    `FixedBatchEngine` on a 1-wide Auto-typed mesh are the reference:
    - at (data 2, model 2) every family with the batch split over "data",
      the moe also with "expert_ffn" over "model" (its experts whole), the
      dense also with "kv_seq" over "model" (its KV heads whole): greedy
      and keyed-sampled streams equal to JAX's on every rank;
    - at (pod 2, data 2, model 1) the dense and the moe with the batch over
      "pod" x "data": the same;
    - the moe's dropped (token, choice) pairs of every decode step (the
      whole batch is one capacity group, its capacity factor small enough
      that pairs drop) equal to the reference's, pair for pair, recorded
      in JAX through `jax.debug.callback`;
    - the batch-1 decode step (ssm and hybrid) under `rules_for_shape`'s
      long_500k layout at data 2 (the batch replicated, "kv_seq" and
      "ssm_state" over "data"), on each rank's `local_cache` cut of the
      JAX prefill's whole cache: the logits of four steps within 1e-5 x
      max of `jax.jit(make_serve_step(...))` on the whole cache, and the
      rank's cache after them the cut of JAX's;
    - the (pod, data) group: one group of 4 ranked pod-major, its gather
      in that order;
    - the sequence-parallel prefill of every family under the long_500k
      layout at (data 2, model 2) (the batch replicated, "seq" / "kv_seq"
      / "ssm_state" over "data"): FixedBatchEngine at batch 1 and at a
      left-padded batch of 3 with the greedy streams of the JAX engine on
      one device (run in a JAX process of its own beside the worlds);
      `prefill_step` at SEQ_LENS, whose blocks are whole chunks of the
      ssd, 1.5 chunks, uneven (13 over 2) and shorter than the conv's
      W-1: the logits and each rank's cache within 1e-5 x max of the JAX
      prefill's (cut by `local_cache`); the moe's prefill drops pair for
      pair; the ssm's per-rank FLOPs at most SEQ_FLOPS_MAX of the same
      rules' with "seq" whole;
  * `local_rows` and `local_cache` against the reference's
    `NamedSharding` slices (`devices_indices_map` on forced host devices,
    in a JAX subprocess): the batch, KV positions, SSM state columns and
    split heads of every cache leaf, for every device of three meshes.

Budget: about 85 s alone (the children run with OMP_NUM_THREADS=1).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
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
from repro.launch.steps import (TrainConfig, jit_train_step, make_prefill_step,
                                make_serve_step, make_state_shardings)
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.optim import AdamWConfig, adamw_init
from repro.serve.engine import FixedBatchEngine as JaxFixedBatchEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.sampling import SamplingParams as JaxSampling
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import DEFAULT_RULES
from repro_torch.distributed.sharding import local_cache, local_rows
from repro_torch.launch.steps import rules_for_shape
from repro_torch.models import build_model
from repro_torch.tree import tree_flatten_with_paths
from test_torch_tp_serving import ROOT, _auto_mesh, _TP

TRAIN_STEPS = 30
SEED = 4
# family -> (arch, reduced config); vocab 193 gives whisper its odd
# vocabulary (the LM head's rows split, "embed_vec"); the moe's capacity
# factor drops pairs at decode
MODELS = {
    "dense": ("qwen3-1.7b", dict(n_layers=2, d_model=128, d_ff=256, vocab=192,
                                 dtype="float32")),
    "moe": ("qwen2-moe-a2.7b", dict(vocab=192, dtype="float32", capacity_factor=0.25)),
    "vlm": ("qwen2-vl-2b", dict(vocab=192, dtype="float32")),
    "ssm": ("mamba2-2.7b", dict(vocab=192, dtype="float32")),
    "hybrid": ("zamba2-1.2b", dict(vocab=192, dtype="float32")),
    "encdec": ("whisper-base", dict(vocab=193, dtype="float32")),
}
LENS = (16, 11, 32, 5, 16, 3, 9, 12)   # batches padded to 32 and 16 (the ssd's chunk 16)
SERVE = dict(batch_size=4, max_seq=64, max_new_tokens=8)
MOE_BATCH = 8                           # one capacity group of 16 pairs at decode
WORLDS = {"dm": (2, 2), "pdm": (2, 2, 1)}
# what each world serves: (family, variant); variant None is the guarded rules
RUNS = {"dm": [(f, None) for f in MODELS] + [("moe", "expert_ffn"), ("dense", "kv_seq")],
        "pdm": [("dense", None), ("moe", None)]}
BATCH1 = ("ssm", "hybrid")
BATCH1_PROMPT, BATCH1_SEQ, BATCH1_STEPS = 32, 64, 4
# the sequence-parallel prefill's prompts at data 2: blocks of 16 (one
# chunk of the ssd), 24 (1.5 chunks), 7 / 6 (uneven) and 3 / 2 (the second
# shorter than the conv's W-1 = 3; the vlm's 8 vision rows make it 4 / 4)
SEQ_LENS = (32, 48, 13, 5)
SEQ_FLOPS_MAX = 0.65                    # a rank's share of the whole prefill's FLOPs
LOGIT_RTOL = 1e-5                       # x max |logit|: f32, the reference's step
CHILD_TIMEOUT_S = 300


def _cfg(name, lib_get=get_config):
    arch, red = MODELS[name]
    return lib_get(arch).reduced(**red)


def _batch_size(name):
    return MOE_BATCH if name == "moe" else SERVE["batch_size"]


def _extras(name, cfg):
    rng = np.random.default_rng(9)
    if name == "vlm":
        return {"vision_embeds": rng.standard_normal((cfg.n_vision_tokens, cfg.d_model)
                                                     ).astype(np.float32)}
    if name == "encdec":
        return {"audio_embeds": rng.standard_normal((cfg.enc_seq, cfg.d_model)
                                                    ).astype(np.float32)}
    return None


def _workload(vocab, cls):
    rng = np.random.RandomState(SEED)
    prompts, samp = [], []
    for i, n in enumerate(LENS):
        prompts.append(((int(rng.randint(0, vocab)) + 17 * np.arange(n)) % vocab
                        ).astype(np.int32))
        samp.append([None, cls(temperature=0.7, top_k=8, seed=11 + SEED), None,
                     cls(temperature=0.5, top_p=0.9, seed=5 + SEED)][i % 4])
    return prompts, samp


def _batch1_rules(cfg, mesh):
    """`rules_for_shape`'s layout of a batch of one (long_500k at
    BATCH1_SEQ positions)."""
    return rules_for_shape(cfg, dataclasses.replace(SHAPES["long_500k"], seq_len=BATCH1_SEQ),
                           mesh)


# ------------------------------------------------------------- the children
_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.distributed.collectives import AxisGroup
    from repro_torch.distributed.sharding import local_cache
    from repro_torch.launch.mesh import init_file_world, make_mesh
    from repro_torch.launch.steps import (ServeMesh, fixed_batch_rules, prefill_step,
                                          rules_for_shape, serve_step)
    from repro_torch.configs import SHAPES
    from repro_torch.models import build_model
    from repro_torch.models.mlp import record_drops
    from repro_torch.serve.engine import FixedBatchEngine, ServeConfig
    from repro_torch.serve.router import PlanRouter
    from repro_torch.serve.sampling import SamplingParams
    import dataclasses

    rank, tag, store, job_path, out_path = sys.argv[1:6]
    rank = int(rank)
    job = json.load(open(job_path))
    init_file_world(store, rank, 4)
    mesh = make_mesh(tuple(job["worlds"][tag]), device_type="cpu")

    def load(path):
        tree = {}
        with np.load(path) as z:
            for key in z.files:
                node = tree
                *path_, leaf = key.split("/")
                for k in path_:
                    node = node.setdefault(k, {})
                node[leaf] = torch.from_numpy(z[key])
        return tree

    def model_of(name):
        arch, red = job["models"][name]
        model = build_model(get_config(arch).reduced(**red))
        return model, model.serving_params(load(job["params"][name]), "cpu")

    def workload(vocab):
        rng = np.random.RandomState(job["seed"])
        prompts, samp = [], []
        for i, n in enumerate(job["lens"]):
            prompts.append(((int(rng.randint(0, vocab)) + 17 * np.arange(n)) % vocab
                            ).astype(np.int32))
            samp.append([None, SamplingParams(temperature=0.7, top_k=8, seed=11 + job["seed"]),
                         None, SamplingParams(temperature=0.5, top_p=0.9,
                                              seed=5 + job["seed"])][i % 4])
        return prompts, samp

    def serve(name, variant):
        model, sp = model_of(name)
        cfg = model.cfg
        rules = PlanRouter(None).serve_rules(DEFAULT_RULES, mesh, cfg,
                                             "ssm" if name == "ssm" else "decoder")
        if variant == "expert_ffn":
            rules = rules.replace(experts=None, expert_ffn="model")
        elif variant == "kv_seq":
            rules = rules.replace(kv_heads=None, kv_seq="model")
        extras = job["extras"].get(name)
        extras = {k: np.load(v) for k, v in extras.items()} if extras else None
        scfg = ServeConfig(**dict(job["serve"], batch_size=job["batch_size"][name]))
        eng = FixedBatchEngine(model, lambda tp: model.tp_local_params(sp, tp) if tp else sp,
                               scfg, extras, device="cpu", mesh=mesh, rules=rules)
        prompts, samp = workload(cfg.vocab)
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        with record_drops() as drops:
            done = eng.run()
        return {"streams": {str(r.rid): [int(t) for t in r.output] for r in done},
                "requests": eng.stats["requests"], "tokens_out": eng.stats["tokens_out"],
                "rows": list(eng.rows),
                "rules": {a: eng.rules.lookup(a) for a in
                          ("batch", "experts", "expert_ffn", "kv_heads", "kv_seq")},
                "drops": [torch.nonzero(~k).flatten().tolist() for k in drops]}

    def batch1(name):
        model, sp = model_of(name)
        cfg = model.cfg
        shape = dataclasses.replace(SHAPES["long_500k"], seq_len=job["batch1_seq"])
        rules = fixed_batch_rules(rules_for_shape(cfg, shape, mesh), mesh)
        sm = ServeMesh(mesh, rules)
        params = model.tp_local_params(sp, sm.tp) if sm.tp else sp
        whole = {k: v for k, v in load(job["batch1"][name]).items()}
        cache = local_cache({k: v for k, v in whole.items() if not k.startswith("tok")},
                            model, rules, dict(sm.groups, model=sm.tp))
        logits = []
        for j in range(job["batch1_steps"]):
            with sm.contexts():
                out, cache = serve_step(model, params, cache, whole[f"tok{j}"])
            logits.append(out.reshape(-1).tolist())
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        return {"logits": logits, "coords": coords,
                "cache": {k: v.float().numpy().tolist() for k, v in cache.items()},
                "rules": {a: rules.lookup(a) for a in
                          ("batch", "kv_seq", "ssm_state", "seq", "heads", "kv_heads",
                           "ssm_heads", "conv_dim")}}

    def seq_prompts(vocab):
        return [((np.arange(n) * 7 + 3 + i) % vocab).astype(np.int32)
                for i, n in enumerate(job["seq_lens"])]

    def seq_run(name):
        # the sequence-parallel prefill: FixedBatchEngine at batch 1 and at
        # a replicated batch of 3 under the long_500k layout, prefill_step
        # at every prompt length, and (ssm) the prefill's FLOPs
        from torch.utils.flop_counter import FlopCounterMode

        model, sp = model_of(name)
        cfg = model.cfg
        extras = job["extras"].get(name)
        extras = {k: np.load(v) for k, v in extras.items()} if extras else None
        res = {"streams": {}, "drops": {}, "rules": {}}
        for b in (3, 1):
            shape = dataclasses.replace(SHAPES["long_500k"], seq_len=job["batch1_seq"],
                                        global_batch=b)
            scfg = ServeConfig(batch_size=b, max_seq=job["batch1_seq"],
                               max_new_tokens=job["serve"]["max_new_tokens"])
            eng = FixedBatchEngine(model, lambda tp: model.tp_local_params(sp, tp) if tp
                                   else sp, scfg, extras, device="cpu", mesh=mesh,
                                   rules=rules_for_shape(cfg, shape, mesh))
            for p in seq_prompts(cfg.vocab)[:b if b > 1 else None]:
                eng.submit(p)
            with record_drops(prefill=True) as drops:
                done = eng.run()
            res["streams"][b] = {str(r.rid): [int(t) for t in r.output] for r in done}
            res["drops"][b] = [k.tolist() for k in drops]
            res["rules"][b] = {a: eng.rules.lookup(a) for a in
                               ("batch", "seq", "kv_seq", "ssm_state")}
        res["prefill"] = []
        for p in seq_prompts(cfg.vocab):
            with eng.serve_mesh.contexts():
                logits, cache = prefill_step(model, eng.params, torch.as_tensor(p[None]),
                                             job["batch1_seq"], eng.extras)
            res["prefill"].append({"logits": logits.reshape(-1).tolist(),
                                   "cache": {k: v.float().tolist() for k, v in cache.items()}})
        res["coords"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        if name == "ssm":
            toks = torch.as_tensor(seq_prompts(cfg.vocab)[0][None]).repeat(1, 2)
            res["flops"] = {}
            for key, rules in (("seq", eng.rules), ("whole", eng.rules.replace(seq=None))):
                sm = ServeMesh(mesh, fixed_batch_rules(rules, mesh))
                with FlopCounterMode(display=False) as fc, sm.contexts():
                    prefill_step(model, eng.params, toks, job["batch1_seq"])
                res["flops"][key] = fc.get_total_flops()
        return res

    out = {"runs": {}, "batch1": {}, "seq": {}}
    for name, variant in job["runs"][tag]:
        out["runs"][f"{name}/{variant}"] = serve(name, variant)
    if tag == "dm":
        for name in job["batch1_models"]:
            out["batch1"][name] = batch1(name)
        for name in job["models"]:
            out["seq"][name] = seq_run(name)
    if tag == "pdm":
        g = AxisGroup.from_mesh(mesh, ("pod", "data"))
        out["group"] = {"rank": g.rank, "size": g.size,
                        "coords": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
                        "gathered": g._gather(torch.tensor([dist.get_rank()])).flatten().tolist(),
                        "global": dist.get_rank()}
    json.dump(out, open(out_path, "w"))
    dist.destroy_process_group()
""")

# the reference's NamedSharding slices of the fixed-batch caches, on forced
# host devices: {case: {leaf: [[mesh coordinates, [[start, stop], ...]], ...]}}
_JAX_SLICES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, itertools, json, sys
    import jax, numpy as np
    from jax.sharding import AxisType, Mesh
    from repro.configs import SHAPES, get_config
    from repro.distributed.sharding import DEFAULT_RULES, prune_for_mesh
    from repro.launch.steps import cache_shardings, rules_for_shape
    from repro.models import build_model

    cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
    out = {}
    for key, arch, red, mshape, rules_kind, batch, seq in cases:
        cfg = get_config(arch).reduced(**red)
        names = ("data", "model") if len(mshape) == 2 else ("pod", "data", "model")
        n = int(np.prod(mshape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mshape), names,
                    axis_types=(AxisType.Auto,) * len(names))
        if rules_kind == "batch1":
            rules = rules_for_shape(cfg, dataclasses.replace(SHAPES["long_500k"],
                                                             seq_len=seq), mesh)
        elif rules_kind == "kv_seq":
            rules = DEFAULT_RULES.replace(kv_heads=None, kv_seq="model")
        else:
            rules = DEFAULT_RULES
        rules = prune_for_mesh(rules, mesh)
        model = build_model(cfg)
        shapes = jax.eval_shape(lambda: model.init_cache(batch, seq))
        shard = cache_shardings(model, mesh, rules, batch, seq)
        leaves = {}
        for leaf, sh in shard.items():
            imap = sh.devices_indices_map(tuple(shapes[leaf].shape))
            rows = []
            for coords in itertools.product(*[range(s) for s in mshape]):
                dev = mesh.devices[coords]
                idx = imap[dev]
                rows.append([dict(zip(names, coords)),
                             [[s.start or 0, shapes[leaf].shape[i] if s.stop is None else s.stop]
                              for i, s in enumerate(idx)]])
            leaves[leaf] = rows
        out[key] = {"leaves": leaves, "rules": {k: v for k, v in rules.rules}}
    json.dump(out, open(out_path, "w"))
""")
# the sequence-parallel prefill's reference (`_jax_seq`, the JAX engine on
# one device) in a process of its own, beside the worlds: -> a pickle of
# {family: _jax_seq's result}
_JAX_SEQ = textwrap.dedent("""
    import json, os, pickle, sys
    sys.path.insert(0, os.path.join(sys.argv[3], "tests"))
    import jax.numpy as jnp
    import numpy as np
    import pytest
    import test_torch_dp_serving as T
    from repro.models import build_model

    job, out_path = json.load(open(sys.argv[1])), sys.argv[2]
    mesh = T._auto_mesh()
    trained = {}
    for name in T.MODELS:
        params = {}
        with np.load(job["params"][name]) as z:
            for key in z.files:
                node = params
                *path, leaf = key.split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(z[key])
        jcfg = T._cfg(name, T.jax_get_config)
        trained[name] = (jcfg, build_model(jcfg), params)
    patch = pytest.MonkeyPatch()
    out = {name: T._jax_seq(name, trained, mesh, patch) for name in T.MODELS}
    pickle.dump(out, open(out_path, "wb"))
""")
# (key, family, mesh, rules, batch, seq)
SLICE_CASES = [("dense_kv_seq", "dense", (2, 2), "kv_seq", 4, 64),
               ("hybrid_batch1", "hybrid", (2, 2), "batch1", 1, 64),
               ("moe_pod", "moe", (2, 2, 2), "default", 8, 64),
               ("encdec_pod", "encdec", (2, 2, 1), "default", 4, 64)]


def _env():
    src = os.path.join(ROOT, "src")
    return {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def _spawn(tmp, job, meanwhile):
    """Both worlds side by side, and the JAX slices' and the sequence
    split's reference subprocesses, while `meanwhile()` runs here; ->
    ({tag: each rank's JSON}, slices, the sequence split's reference,
    meanwhile's result)."""
    (tmp / "child.py").write_text(_CHILD)
    (tmp / "slices.py").write_text(_JAX_SLICES)
    (tmp / "seq_ref.py").write_text(_JAX_SEQ)
    (tmp / "job.json").write_text(json.dumps(job))
    procs = []
    for tag in WORLDS:
        for r in range(4):
            procs.append((f"{tag} rank {r}", tmp / f"{tag}.{r}.json", subprocess.Popen(
                [sys.executable, str(tmp / "child.py"), str(r), tag, str(tmp / f"store_{tag}"),
                 str(tmp / "job.json"), str(tmp / f"{tag}.{r}.json")], env=_env(),
                cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    cases = [(k, *MODELS[f], m, rk, b, s) for k, f, m, rk, b, s in SLICE_CASES]
    procs.append(("jax slices", tmp / "slices.json", subprocess.Popen(
        [sys.executable, str(tmp / "slices.py"), json.dumps(cases), str(tmp / "slices.json")],
        env={**_env(), "JAX_PLATFORMS": "cpu"}, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)))
    procs.append(("jax seq reference", tmp / "seq_ref.pkl", subprocess.Popen(
        [sys.executable, str(tmp / "seq_ref.py"), str(tmp / "job.json"),
         str(tmp / "seq_ref.pkl"), ROOT], env={**_env(), "JAX_PLATFORMS": "cpu"},
        cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    try:
        local = meanwhile()
        for label, _, p in procs:
            try:
                _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                failures.append(f"{label}: timed out")
                break
            if p.returncode != 0:
                failures.append(f"{label}: rc {p.returncode}\n{err[-3000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failures, "\n".join(failures)
    worlds = {tag: [json.loads((tmp / f"{tag}.{r}.json").read_text()) for r in range(4)]
              for tag in WORLDS}
    with open(tmp / "seq_ref.pkl", "rb") as f:
        seq = pickle.load(f)
    return worlds, json.loads((tmp / "slices.json").read_text()), seq, local


# ------------------------------------------------------------- the reference
def _train(name, mesh):
    """The family's tiny model trained TRAIN_STEPS steps in JAX on the
    learnable synthetic data (the encdec's batches carry its audio)."""
    jcfg = _cfg(name, jax_get_config)
    model = jax_build_model(jcfg)
    data = SyntheticLMData(DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=8))
    train_cfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS))
    audio = _extras(name, jcfg) if name == "encdec" else None

    def batch(i):
        b = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        if audio is not None:
            a = audio["audio_embeds"]
            b["audio_embeds"] = jnp.broadcast_to(jnp.asarray(a), (8, *a.shape))
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
    return jcfg, model, params


def _recording_moe(orig, sink, prefill=False):
    """`moe_apply` that also records, at decode (one token per row: the
    whole batch one capacity group), the (T,) mask of kept pairs, computed
    by the reference's own routing lines, through `jax.debug.callback`;
    with `prefill`, at prefill instead, the (B, S * k) masks of its
    sequence groups."""
    def moe_apply(p, cfg, x, act="silu"):
        if prefill and x.shape[1] > 1:
            b, s = x.shape[:2]
            probs = jax.nn.softmax(jax_common.dense(p["router"], x).astype(jnp.float32), -1)
            _, top_i = jax.lax.top_k(probs, cfg.top_k)
            flat_i = top_i.reshape(b, s * cfg.top_k)
            onehot = jax.nn.one_hot(flat_i, cfg.n_experts, dtype=jnp.int32)
            pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - onehot,
                                      flat_i[..., None], -1)[..., 0]
            keep = pos < jax_mlp.moe_capacity(cfg, s)
            jax.debug.callback(lambda k: sink.append(np.asarray(k)), keep, ordered=True)
        if not prefill and x.shape[1] == 1:
            b = x.shape[0]
            xg = x.reshape(1, b, x.shape[-1])
            probs = jax.nn.softmax(jax_common.dense(p["router"], xg).astype(jnp.float32), -1)
            _, top_i = jax.lax.top_k(probs, cfg.top_k)
            flat_i = top_i.reshape(1, b * cfg.top_k)
            onehot = jax.nn.one_hot(flat_i, cfg.n_experts, dtype=jnp.int32)
            pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - onehot,
                                      flat_i[..., None], -1)[..., 0]
            keep = pos < jax_mlp.moe_capacity(cfg, b)
            jax.debug.callback(lambda k: sink.append(np.asarray(k).reshape(-1)), keep,
                               ordered=True)
        return orig(p, cfg, x, act)

    return moe_apply


def _jax_serve(name, trained, mesh, monkeypatch):
    """The JAX FixedBatchEngine's streams (and, for the moe, each decode
    call's dropped pairs)."""
    jcfg, model, params = trained[name]
    drops = []
    if name == "moe":
        monkeypatch.setattr(jax_mlp, "moe_apply", _recording_moe(jax_mlp.moe_apply, drops))
    try:
        eng = JaxFixedBatchEngine(model, params, mesh, JAX_RULES,
                                  JaxServeConfig(**dict(SERVE, batch_size=_batch_size(name))),
                                  _extras(name, jcfg))
        prompts, samp = _workload(jcfg.vocab, JaxSampling)
        for p, s in zip(prompts, samp):
            eng.submit(p, sampling=s)
        with mesh:
            done = eng.run()
        jax.effects_barrier()
    finally:
        monkeypatch.undo()
    return ({str(r.rid): [int(t) for t in r.output] for r in done},
            [np.flatnonzero(~k).tolist() for k in drops])


def _jax_batch1(name, trained, mesh, path):
    """The JAX prefill of one prompt into a whole cache of BATCH1_SEQ
    positions, then BATCH1_STEPS `jax.jit(make_serve_step(...))` steps on
    the whole cache: the prefill's cache and each step's token are written
    to `path`; -> (each step's logits, the cache after the last)."""
    jcfg, model, params = trained[name]
    rules = jax_prune_for_mesh(JAX_RULES, mesh)
    toks = ((np.arange(BATCH1_PROMPT) * 7 + 3) % jcfg.vocab).astype(np.int32)[None]
    with mesh:
        logits, cache = jax.jit(make_prefill_step(model, rules, BATCH1_SEQ))(
            params, {"tokens": jnp.asarray(toks)})
        step = jax.jit(make_serve_step(model, rules))
        save = {k: np.asarray(v) for k, v in cache.items()}
        out = []
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        for j in range(BATCH1_STEPS):
            save[f"tok{j}"] = np.asarray(nxt)
            logits, cache = step(params, cache, nxt)
            out.append(np.asarray(logits).reshape(-1))
            nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    np.savez(path, **save)
    return out, {k: np.asarray(v) for k, v in cache.items()}


def _seq_prompts(vocab):
    return [((np.arange(n) * 7 + 3 + i) % vocab).astype(np.int32)
            for i, n in enumerate(SEQ_LENS)]


def _jax_seq(name, trained, mesh, monkeypatch):
    """The JAX FixedBatchEngine (the one-device reference), greedy, on the
    first three SEQ_LENS prompts at batch 3 (one batch, left-padded) and
    on all of them at batch 1: {b: (streams, the moe's prefill drops)},
    and at batch 1 each prefill's (logits, whole cache), captured as the
    engine runs them."""
    jcfg, model, params = trained[name]
    out, prefills = {}, []
    for b in (3, 1):
        drops = []
        if name == "moe":
            monkeypatch.setattr(jax_mlp, "moe_apply",
                                _recording_moe(jax_mlp.moe_apply, drops, prefill=True))
        try:
            eng = JaxFixedBatchEngine(model, params, mesh, JAX_RULES, JaxServeConfig(
                batch_size=b, max_seq=BATCH1_SEQ, max_new_tokens=SERVE["max_new_tokens"]),
                _extras(name, jcfg))
            if b == 1:
                build = eng._build

                def capture(plen, eng=eng, build=build):
                    build(plen)
                    run = eng._prefill

                    def prefill(p, batch):
                        logits, cache = run(p, batch)
                        prefills.append((np.asarray(logits).reshape(-1),
                                         {k: np.asarray(v) for k, v in cache.items()}))
                        return logits, cache
                    eng._prefill = prefill

                eng._build = capture
            for p in _seq_prompts(jcfg.vocab)[:b if b > 1 else None]:
                eng.submit(p)
            with mesh:
                done = eng.run()
            jax.effects_barrier()
        finally:
            monkeypatch.undo()
        out[b] = ({str(r.rid): [int(t) for t in r.output] for r in done}, drops)
    return out, prefills


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_serving")
    mesh = _auto_mesh()
    trained = {name: _train(name, mesh) for name in MODELS}
    job = {"seed": SEED, "lens": list(LENS), "serve": SERVE, "worlds": WORLDS,
           "runs": RUNS, "models": MODELS, "params": {}, "extras": {},
           "batch_size": {n: _batch_size(n) for n in MODELS}, "batch1": {},
           "batch1_models": list(BATCH1), "batch1_seq": BATCH1_SEQ,
           "batch1_steps": BATCH1_STEPS, "seq_lens": list(SEQ_LENS)}
    for name, (jcfg, _, params) in trained.items():
        job["params"][name] = str(tmp / f"{name}.npz")
        np.savez(job["params"][name],
                 **dict(tree_flatten_with_paths(jax.tree.map(np.asarray, params))))
        extras = _extras(name, jcfg)
        if extras:
            job["extras"][name] = {}
            for k, v in extras.items():
                job["extras"][name][k] = str(tmp / f"{name}_{k}.npy")
                np.save(job["extras"][name][k], v)
    batch1 = {}
    for name in BATCH1:
        job["batch1"][name] = str(tmp / f"batch1_{name}.npz")
        batch1[name] = _jax_batch1(name, trained, mesh, job["batch1"][name])

    def meanwhile():
        patch = pytest.MonkeyPatch()
        return {name: _jax_serve(name, trained, mesh, patch) for name in MODELS}

    worlds, slices, seq, reference = _spawn(tmp, job, meanwhile)
    return worlds, slices, reference, batch1, seq


# ------------------------------------------------------------------ the tests
@pytest.mark.parametrize("tag,name,variant",
                         [(t, n, v) for t in WORLDS for n, v in RUNS[t]])
def test_streams_equal_the_jax_engine_on_every_rank(served, tag, name, variant):
    """Greedy and keyed-sampled streams, the batch's rows split over the
    data axes (and the experts' width or the KV positions over "model" in
    the variants), equal the JAX engine's on every rank; every rank counts
    the whole batch and runs its own block of rows."""
    worlds, _, reference, _, _ = served
    want, _ = reference[name]
    key = f"{name}/{variant}"
    b = _batch_size(name)
    dp = int(np.prod(WORLDS[tag][:-1]))
    for rank, res in enumerate(worlds[tag]):
        run = res["runs"][key]
        assert run["streams"] == want, f"{tag} rank {rank} {key}"
        assert run["requests"] == len(LENS)
        assert run["tokens_out"] == len(LENS) * SERVE["max_new_tokens"]
        assert run["rows"][1] == b // dp
        assert run["rules"]["batch"] == ("data" if tag == "dm" else ["pod", "data"])
        if variant == "expert_ffn":
            assert run["rules"]["experts"] is None and run["rules"]["expert_ffn"] == "model"
        if variant == "kv_seq":
            assert run["rules"]["kv_heads"] is None and run["rules"]["kv_seq"] == "model"


@pytest.mark.parametrize("tag,variant", [("dm", None), ("dm", "expert_ffn"), ("pdm", None)])
def test_moe_decode_drops_equal_the_reference_pair_for_pair(served, tag, variant):
    """Each decode call's dropped (token, choice) pairs of the whole batch,
    every rank holding some of its rows, equal the reference's one-group
    routing's; pairs do drop."""
    worlds, _, reference, _, _ = served
    _, want = reference["moe"]
    n_calls = (len(LENS) // MOE_BATCH) * (SERVE["max_new_tokens"] - 1) * \
        _cfg("moe").n_layers
    assert len(want) == n_calls
    assert sum(map(len, want)) > 0, "no pair dropped: the check is vacuous"
    for rank, res in enumerate(worlds[tag]):
        assert res["runs"][f"moe/{variant}"]["drops"] == want, f"{tag} rank {rank}"


@pytest.mark.parametrize("name", BATCH1)
def test_batch1_decode_matches_the_reference_step_on_a_whole_cache(served, name):
    """The batch of one under `rules_for_shape`'s long_500k layout at data
    2 (the batch replicated, the KV positions and SSM state columns over
    "data", the heads over "model"): each rank's logits within 1e-5 x max
    of the reference's, and its cache after the steps the cut of the
    reference's whole cache."""
    worlds, _, _, batch1, _ = served
    want_logits, want_cache = batch1[name]
    cfg = _cfg(name)
    model = build_model(cfg)
    for rank, res in enumerate(worlds["dm"]):
        run = res["batch1"][name]
        assert run["rules"]["batch"] is None and run["rules"]["kv_seq"] == "data"
        assert run["rules"]["ssm_state"] == "data" and run["rules"]["seq"] == "data"
        for j, (got, want) in enumerate(zip(run["logits"], want_logits)):
            err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
            assert err <= LOGIT_RTOL, f"rank {rank} step {j}: {err:.3e}"
        coords = run["coords"]
        groups = {"batch": None, "kv_seq": _Stub(coords["data"], 2),
                  "ssm_state": _Stub(coords["data"], 2),
                  "model": _TP(_batch1_port_rules(cfg), coords["model"], 2)}
        cut = local_cache({k: torch.from_numpy(np.array(v))
                           for k, v in want_cache.items()}, model,
                          _batch1_port_rules(cfg), groups)
        for leaf, t in cut.items():
            got = np.asarray(run["cache"][leaf])
            assert got.shape == tuple(t.shape), (rank, leaf)
            scale = max(float(t.float().abs().max()), 1e-30)
            err = np.abs(got - t.float().numpy()).max() / scale
            assert err <= LOGIT_RTOL, f"rank {rank} {leaf}: {err:.3e}"


def test_the_pod_data_group_is_one_group_ranked_pod_major(served):
    worlds, slices, _, _, _ = served
    ranks = worlds["pdm"]
    order = sorted(ranks, key=lambda r: (r["group"]["coords"]["pod"],
                                         r["group"]["coords"]["data"]))
    for res in ranks:
        g = res["group"]
        assert g["size"] == 4
        assert g["rank"] == 2 * g["coords"]["pod"] + g["coords"]["data"]
        assert g["gathered"] == [r["group"]["global"] for r in order]
        # the block of the batch the reference's placement gives that device
        start, n = local_rows(4, _Stub(g["rank"], 4))
        ref = next(s for c, s in slices["encdec_pod"]["leaves"]["lengths"]
                   if c["pod"] == g["coords"]["pod"] and c["data"] == g["coords"]["data"])
        assert [start, start + n] == ref[0]


class _Stub:
    """A group's rank and size, without a process group."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def _batch1_port_rules(cfg):
    from repro_torch.distributed.sharding import prune_for_mesh

    class _Mesh:
        shape = {"data": 2, "model": 2}
    return prune_for_mesh(_batch1_rules(cfg, _Mesh()), _Mesh())


def _port_rules(case, cfg, mesh_shape):
    from repro_torch.distributed.sharding import prune_for_mesh

    names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")

    class _Mesh:
        shape = dict(zip(names, mesh_shape))
    kind = next(c[3] for c in SLICE_CASES if c[0] == case)
    if kind == "batch1":
        rules = _batch1_rules(cfg, _Mesh())
    elif kind == "kv_seq":
        rules = DEFAULT_RULES.replace(kv_heads=None, kv_seq="model")
    else:
        rules = DEFAULT_RULES
    return prune_for_mesh(rules, _Mesh()), _Mesh.shape


def _group(rules, name, sizes, coords):
    target = rules.lookup(name)
    axes = () if target is None else (target,) if isinstance(target, str) else target
    rank, size = 0, 1
    for a in axes:
        rank, size = rank * sizes[a] + coords.get(a, 0), size * sizes[a]
    return None if size == 1 else _Stub(rank, size)


@pytest.mark.parametrize("case", [c[0] for c in SLICE_CASES])
def test_local_cache_is_the_reference_placement_slice(served, case):
    """For every device of the mesh: each cache leaf's dims named "batch",
    "kv_seq", "ssm_state", "kv_heads" (split or, under "kv_seq" over
    "model", whole) and "ssm_heads" cut by `local_cache` to exactly the
    positions `NamedSharding.devices_indices_map` gives that device
    (`local_rows` for the batch); the conv window's head-aligned channels
    are the port's own cut (see `mamba.tp_columns`)."""
    _, slices, _, _, _ = served
    _, family, mesh_shape, _, batch, seq = next(c for c in SLICE_CASES if c[0] == case)
    cfg = _cfg(family)
    model = build_model(cfg)
    rules, sizes = _port_rules(case, cfg, mesh_shape)
    assert {k: v for k, v in rules.rules} == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in slices[case]["rules"].items()}
    whole = model.init_cache(batch, seq)
    axes = model.cache_logical_axes()
    compared = 0
    for leaf, rows in slices[case]["leaves"].items():
        for coords, ref in rows:
            groups = {n: _group(rules, n, sizes, coords) for n in ("batch", "kv_seq",
                                                                  "ssm_state")}
            groups["model"] = _TP(rules, coords["model"], sizes["model"])
            for i, name in enumerate(axes[leaf]):
                if name == "conv_dim":
                    continue
                shape = whole[leaf].shape
                idx = torch.arange(shape[i]).reshape(
                    [-1 if j == i else 1 for j in range(len(shape))]).expand(shape)
                tree = {k: (idx if k == leaf else v) for k, v in whole.items()}
                got = local_cache(tree, model, rules, groups)[leaf]
                along = got.movedim(i, 0).reshape(got.shape[i], -1)[:, 0].tolist()
                assert along == list(range(*ref[i])), (case, leaf, coords, name)
                compared += 1
            if leaf == "lengths":
                start, n = local_rows(batch, groups["batch"])
                assert [start, start + n] == ref[0], (case, coords)
    assert compared > 0


# ------------------------------------------- the sequence-parallel prefill
@pytest.mark.parametrize("name,b", [(n, b) for n in MODELS for b in (1, 3)])
def test_seq_prefill_streams_equal_the_jax_engine_on_every_rank(served, name, b):
    """FixedBatchEngine at batch 1 and at a replicated batch of 3 under
    `rules_for_shape`'s long_500k layout at (data 2, model 2): the prompt
    split over "data" in the prefill, the KV positions and the SSM
    state's columns at decode; greedy streams equal the JAX one-device
    engine's on every rank."""
    worlds, _, _, _, seq = served
    want, _ = seq[name][0][b]
    for rank, res in enumerate(worlds["dm"]):
        run = res["seq"][name]
        rules = run["rules"][str(b)]
        assert rules["batch"] is None and rules["seq"] == "data", rules
        assert rules["kv_seq"] == "data"
        assert run["streams"][str(b)] == want, f"rank {rank}"


@pytest.mark.parametrize("name", list(MODELS))
def test_seq_prefill_logits_and_cache_match_the_jax_prefill(served, name):
    """`prefill_step` of each SEQ_LENS prompt with the sequence split:
    every rank's last-position logits within 1e-5 x max of the JAX
    one-device prefill's (and the same bits on every rank), each rank's
    cache within 1e-5 x max of the JAX prefill's whole cache cut by
    `local_cache` (KV positions and SSM state columns over "data", heads
    over "model")."""
    worlds, _, _, _, seq = served
    _, want = seq[name]
    assert len(want) == len(SEQ_LENS)
    cfg = _cfg(name)
    model = build_model(cfg)
    rules = _batch1_port_rules(cfg)
    for rank, res in enumerate(worlds["dm"]):
        run = res["seq"][name]
        coords = run["coords"]
        groups = {"batch": None, "kv_seq": _Stub(coords["data"], 2),
                  "ssm_state": _Stub(coords["data"], 2) if cfg.ssm_state else None,
                  "model": _TP(rules, coords["model"], 2)}
        for n, got, (logits, cache) in zip(SEQ_LENS, run["prefill"], want):
            assert got["logits"] == worlds["dm"][0]["seq"][name]["prefill"][
                SEQ_LENS.index(n)]["logits"], f"rank {rank} S={n}: logits differ"
            err = np.abs(np.asarray(got["logits"]) - logits).max() / np.abs(logits).max()
            assert err <= LOGIT_RTOL, f"rank {rank} S={n}: {err:.3e}"
            cut = local_cache({k: torch.from_numpy(np.array(v)) for k, v in cache.items()},
                              model, rules, groups)
            for leaf, t in cut.items():
                g = np.asarray(got["cache"][leaf])
                assert g.shape == tuple(t.shape), (rank, n, leaf)
                scale = max(float(t.float().abs().max()), 1e-30)
                err = np.abs(g - t.float().numpy()).max() / scale
                assert err <= LOGIT_RTOL, f"rank {rank} S={n} {leaf}: {err:.3e}"


@pytest.mark.parametrize("b", (1, 3))
def test_moe_seq_prefill_drops_equal_the_reference_pair_for_pair(served, b):
    """Each prefill call's dropped (token, choice) pairs, every sequence
    one capacity group split over the two data ranks, equal the reference
    routing's, pair for pair; pairs do drop."""
    worlds, _, _, _, seq = served
    _, want = seq["moe"][0][b]
    n_calls = (1 if b > 1 else len(SEQ_LENS)) * _cfg("moe").n_layers
    assert len(want) == n_calls
    assert sum(int((~k).sum()) for k in want) > 0, "no pair dropped: the check is vacuous"
    for rank, res in enumerate(worlds["dm"]):
        got = res["seq"]["moe"]["drops"][str(b)]
        assert len(got) == n_calls
        for j, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(np.asarray(g), w), f"rank {rank} call {j}"


def test_ssm_seq_prefill_splits_the_work(served):
    """A rank's prefill FLOPs (`FlopCounterMode`) of a 64-token prompt with
    the sequence over "data" are at most SEQ_FLOPS_MAX of its FLOPs under
    the same rules with "seq" whole (the whole prompt on every rank): the
    sequence really splits."""
    worlds, _, _, _, _ = served
    for rank, res in enumerate(worlds["dm"]):
        flops = res["seq"]["ssm"]["flops"]
        assert flops["seq"] <= SEQ_FLOPS_MAX * flops["whole"], (rank, flops)
