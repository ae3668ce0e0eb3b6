"""The port's RL-search (PPO, paper §2.4) on the CPU, held against the JAX
package's `repro.core.search.ppo` and `rl_search`.

Below the random streams the two are the same functions: GAE, the policy
and value networks, the PPO loss (Eq. 7) and its gradients, one Adam
step, all on parameters carried across from the reference's
`init_params` (`bridge.load_ppo_params`) and on the dropout mask JAX
drew.  The random streams themselves (`jax.random.categorical`,
`permutation`, `bernoulli`) are not reproduced, so the search environment
is held step for step with a scripted agent patched into both modules,
and the real agent is held to determinism per seed.

Tolerances (f32): logits and values 1e-5 x max |reference| (reduction
order of the products through four layers of up to 1024, and the 1/0.15
dropout scale); the loss and every gradient 1e-4 relative, with an
absolute floor of 1e-6 x the leaf's largest magnitude for entries that
cancel to near zero; parameters after one Adam step on the same
gradients 1e-5 relative, with the same floor.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schedules import OpDesc as JOpDesc
from repro.core.schedules import Template as JTemplate
from repro.core.search import ppo as jppo
from repro.core.search.base import SearchTask as JSearchTask
from repro_torch.bridge import load_ppo_params
from repro_torch.core import TEMPLATES, OpDesc, RLSearch, SearchTask, Tuner
from repro_torch.core.costmodel import Fitness, roofline_bound
from repro_torch.core.schedules import Template
from repro_torch.core.search import ppo

# the packages export the function `rl_search`, which hides the module
jrl = importlib.import_module("repro.core.search.rl_search")
prl = importlib.import_module("repro_torch.core.search.rl_search")
OBS, ACTIONS = 17, 6


def _jax_params(seed):
    return jppo.init_params(jax.random.PRNGKey(seed), OBS, ACTIONS)


def _agent(seed=0, cfg=None):
    """A CPU agent carrying the reference's parameters for `seed`."""
    agent = ppo.PPOAgent(OBS, ACTIONS, cfg or ppo.PPOConfig(), seed=seed, device="cpu")
    load_ppo_params(agent.policy, agent.value, jax.tree.map(np.asarray, _jax_params(seed)))
    return agent


def _batch(t, seed):
    rng = np.random.default_rng(seed)
    return jppo.Batch(rng.standard_normal((t, OBS)).astype(np.float32),
                      rng.integers(0, ACTIONS, t).astype(np.int32),
                      (rng.standard_normal(t) - 2.0).astype(np.float32),
                      rng.standard_normal(t).astype(np.float32),
                      rng.standard_normal(t).astype(np.float32))


def _torch_batch(b):
    return ppo.Batch(torch.from_numpy(b.obs), torch.from_numpy(b.actions).long(),
                     torch.from_numpy(b.logp_old), torch.from_numpy(b.advantages),
                     torch.from_numpy(b.returns))


def _mask(key, t):
    """The keep mask the reference's `policy_logits` draws from `key`."""
    return torch.from_numpy(np.array(jax.random.bernoulli(
        key, jppo.DROPOUT_KEEP, (t, jppo.POLICY_WIDTHS[-1]))))


def _grads_like_jax(agent):
    """The agent's gradients in the reference's tree layout (w as
    (fan_in, fan_out))."""
    return {name: [{"w": lin.weight.grad.T.numpy(), "b": lin.bias.grad.numpy()}
                   for lin in module.layers]
            for name, module in (("policy", agent.policy), ("value", agent.value))}


def _close_tree(got, want, rtol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=1e-6 * max(1e-30, float(np.abs(w).max())))


# ------------------------------------------------------------------- PPO
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    t = 24
    r = rng.standard_normal(t).astype(np.float32)
    v = rng.standard_normal(t + 1).astype(np.float32)
    adv, ret = ppo.gae(r, v, 0.99, 0.95)
    j_adv, j_ret = jppo.gae(r, v, 0.99, 0.95)
    np.testing.assert_allclose(adv, j_adv, rtol=1e-6)
    np.testing.assert_allclose(ret, j_ret, rtol=1e-6)


def test_network_constants_and_config_defaults_are_the_reference():
    assert ppo.POLICY_WIDTHS == jppo.POLICY_WIDTHS == (512, 1024, 1024, 512)
    assert ppo.POLICY_ACTS == jppo.POLICY_ACTS == ("tanh", "tanh", "selu", "selu")
    assert ppo.DROPOUT_KEEP == jppo.DROPOUT_KEEP == 0.15
    assert ppo.VALUE_WIDTHS == jppo.VALUE_WIDTHS
    assert dataclasses.asdict(ppo.PPOConfig()) == dataclasses.asdict(jppo.PPOConfig())
    assert prl.OBS_DIM == jrl.OBS_DIM == 17
    agent = ppo.PPOAgent(OBS, ACTIONS, seed=0, device="cpu")
    jp = _jax_params(0)
    for name, module in (("policy", agent.policy), ("value", agent.value)):
        assert [tuple(lin.weight.shape[::-1]) for lin in module.layers] == \
            [layer["w"].shape for layer in jp[name]]
        # normal * sqrt(2 / fan_in), zero biases
        for lin in module.layers[:-1]:
            assert float(lin.bias.abs().max()) == 0.0
            std = float(lin.weight.std()) * np.sqrt(lin.weight.shape[1] / 2.0)
            assert 0.9 < std < 1.1


@pytest.mark.parametrize("seed", [0, 3])
def test_logits_and_values_on_the_reference_parameters(seed):
    agent = _agent(seed)
    params = _jax_params(seed)
    b = _batch(16, seed)
    obs = torch.from_numpy(b.obs)
    key = jax.random.PRNGKey(100 + seed)
    mask = _mask(key, 16)
    assert 0 < int(mask.sum()) < mask.numel()
    with torch.no_grad():
        pairs = [(agent.policy(obs), jppo.policy_logits(params, jnp.asarray(b.obs))),
                 (agent.policy(obs, mask),
                  jppo.policy_logits(params, jnp.asarray(b.obs), dropout_rng=key)),
                 (agent.value(obs), jppo.value_fn(params, jnp.asarray(b.obs))),
                 (torch.from_numpy(agent.values(b.obs)),
                  jppo.value_fn(params, jnp.asarray(b.obs)))]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("t", [2, 5, 24])
def test_ppo_loss_gradients_and_one_adam_step_are_the_reference(t):
    """A minibatch of 2 is where the population std (jnp.std) and the
    sample std (torch's default) differ by sqrt(2)."""
    cfg = ppo.PPOConfig()
    agent = _agent(1, cfg)
    params = _jax_params(1)
    b = _batch(t, 7 + t)
    key = jax.random.PRNGKey(t)
    jb = jppo.Batch(*(jnp.asarray(x) for x in b))
    j_loss, j_grads = jax.value_and_grad(jppo.ppo_loss)(params, jb, jppo.PPOConfig(), key)

    loss = ppo.ppo_loss(agent.policy, agent.value, _torch_batch(b), cfg,
                        _mask(key, t))
    agent.opt.zero_grad()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    _close_tree(_grads_like_jax(agent), j_grads, rtol=1e-4)
    # the sample std would have given another loss
    adv = torch.from_numpy(b.advantages)
    assert float(adv.std()) != pytest.approx(float(adv.std(correction=0)), rel=1e-3)

    # one Adam step on the same gradients (the port's: where a gradient
    # is at rounding level, the first step's m / sqrt(v) is its sign, so
    # two gradients that differ there would move the parameter both ways)
    grads = _grads_like_jax(agent)
    agent.opt.step()
    j_new, j_state = jppo.adam_update(params, grads, jppo.adam_init(params), cfg.lr)
    new = {name: [{"w": lin.weight.detach().T.numpy(), "b": lin.bias.detach().numpy()}
                  for lin in module.layers]
           for name, module in (("policy", agent.policy), ("value", agent.value))}
    _close_tree(new, j_new, rtol=1e-5)
    assert int(j_state["t"]) == 1


def test_the_agent_is_deterministic_per_seed_and_learns():
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((16, OBS)).astype(np.float32)
    rew = rng.standard_normal(16).astype(np.float32)
    runs = []
    for _ in range(2):
        agent = ppo.PPOAgent(OBS, ACTIONS, ppo.PPOConfig(epochs=2, minibatch=8),
                             seed=4, device="cpu")
        acts, logps = zip(*(agent.act(o) for o in obs))
        assert all(0 <= a < ACTIONS for a in acts) and all(lp <= 0 for lp in logps)
        before = agent.policy.layers[0].weight.detach().clone()
        loss = agent.update(obs, list(acts), list(logps), rew, obs[-1])
        assert np.isfinite(loss)
        assert not torch.equal(before, agent.policy.layers[0].weight)
        runs.append((acts, logps, loss, agent.policy.layers[0].weight.detach()))
    assert runs[0][:3] == runs[1][:3] and torch.equal(runs[0][3], runs[1][3])


# ------------------------------------------------ the search environment
def _toy(base):
    """The toy template of tests/test_torch_wpk.py: its `validate` rejects
    a corner, so invalid moves occur; six, four and three choices, so
    moves clamp at both ends."""
    class Toy(base):
        name = "toy"
        kinds = ("matmul",)

        def space(self, op):
            return {"a": [1, 2, 3, 4, 5, 6], "b": [8, 16, 32, 64],
                    "c": ["x", "y", "z"]}

        def validate(self, op, cfg, chip=None):
            return not (cfg["a"] == 6 and cfg["b"] == 64)

    return Toy()


def _toy_fitness(op, cfg):
    return 1e-6 * (1.0 + (cfg["a"] - 3.3) ** 2 + (np.log2(cfg["b"]) - 4.2) ** 2 +
                   {"x": 0.7, "y": 0.0, "z": 0.4}[cfg["c"]])


def _scripted(record):
    """A stand-in for PPOAgent: actions from a numpy seed, pushed up in one
    episode and down in the next, so the clamps at both ends and the
    rejected corner occur; it records what it sees and what `update` is
    given."""
    class Scripted:
        def __init__(self, obs_dim, n_actions, cfg=None, seed=0, device=None):
            self.rng = np.random.default_rng(seed + 11)
            self.n_actions = n_actions
            self.up = 0.85           # P(move up); flipped every episode

        def act(self, obs):
            a = 2 * int(self.rng.integers(self.n_actions // 2)) + \
                int(self.rng.random() < self.up)
            record["obs"].append(np.array(obs))
            record["actions"].append(a)
            return a, -float(a)

        def update(self, obs, actions, logp_old, rewards, last_obs):
            record["updates"].append((np.array(obs), list(actions), list(logp_old),
                                      list(rewards), np.array(last_obs)))
            self.up = 1.0 - self.up
            return 0.0

    return Scripted


def _run_scripted(monkeypatch, module, search, task, record):
    original = module._obs

    def obs(task, cfg, alpha_us):
        record["alpha"].append(alpha_us)
        record["configs"].append(dict(cfg))
        return original(task, cfg, alpha_us)

    monkeypatch.setattr(module, "PPOAgent", _scripted(record))
    monkeypatch.setattr(module, "_obs", obs)
    return search.run(task)


@pytest.mark.parametrize("seed", [0, 3])
def test_rl_environment_is_the_reference_step_for_step(monkeypatch, seed):
    records = [{k: [] for k in ("obs", "actions", "updates", "alpha", "configs")}
               for _ in range(2)]
    jres = _run_scripted(
        monkeypatch, jrl, jrl.RLSearch(episodes=3, steps_per_episode=40, seed=seed),
        JSearchTask(JOpDesc.matmul(8, 8, 8), _toy(JTemplate), _toy_fitness, seed=seed),
        records[0])
    pres = _run_scripted(
        monkeypatch, prl, prl.RLSearch(episodes=3, steps_per_episode=40, seed=seed,
                                       device="cpu"),
        SearchTask(OpDesc.matmul(8, 8, 8), _toy(Template), _toy_fitness, seed=seed),
        records[1])
    j, p = records
    assert p["actions"] == j["actions"] and len(p["actions"]) == 120
    assert len(p["obs"]) == len(j["obs"]) and all(
        np.array_equal(a, b) for a, b in zip(p["obs"], j["obs"]))
    assert p["alpha"] == j["alpha"] and p["configs"] == j["configs"]
    assert len(p["updates"]) == len(j["updates"]) == 3
    for (po, pa, pl, pr, plast), (jo, ja, jl, jr, jlast) in zip(p["updates"], j["updates"]):
        assert np.array_equal(po, jo) and pa == ja and pl == jl and pr == jr
        assert np.array_equal(plast, jlast)
    assert (pres.evals, pres.config, pres.runtime_s, pres.history) == \
        (jres.evals, jres.config, jres.runtime_s, jres.history)
    # the walk met the rejected corner (an unevaluated, penalised move) and
    # pushed against the ends of the choice lists
    rewards = [r for u in p["updates"] for r in u[3]]
    steps = len(p["actions"])
    assert pres.evals < steps + 3
    assert any(c["a"] == 6 and c["b"] == 32 for c in p["configs"])
    assert any(c["a"] == 1 for c in p["configs"]) and any(c["b"] == 64 for c in p["configs"])
    assert min(rewards) < 0 < max(rewards)


class _KnobFitness(Fitness):
    """A conv priced off the roofline by its distance from bn 64,
    row_block 2."""

    kind = "wallclock"

    def __call__(self, op, cfg):
        return roofline_bound(op) * (2.0 + abs(np.log2(cfg["bn"] / 64))
                                     + abs(np.log2(cfg["row_block"] / 2)))


def test_rl_search_runs_deterministically_and_improves_over_worst():
    from repro_torch.models.resnet import conv_groups

    op = OpDesc.make("conv2d", conv_groups(1, 56)[2][1].d, "float32")
    tmpl = TEMPLATES["pallas_conv2d"]
    results = [RLSearch(episodes=2, steps_per_episode=8, seed=5, device="cpu").run(
        SearchTask(op, tmpl, _KnobFitness(), seed=5)) for _ in range(2)]
    res = results[0]
    assert (res.config, res.runtime_s, res.evals, res.history) == \
        (results[1].config, results[1].runtime_s, results[1].evals, results[1].history)
    assert np.isfinite(res.runtime_s) and tmpl.validate(op, res.config)
    assert res.evals > 8 and res.method == "rl"
    worst = max(_KnobFitness()(op, c) for c in tmpl.enumerate_configs(op))
    assert res.runtime_s < worst


def test_the_default_tuner_runs_both_searches_on_the_fitness_device(monkeypatch):
    from repro_torch.core import WallClockFitness

    fit = WallClockFitness(device="cpu", repeats=1, warmup=0)
    tuner = Tuner(fitness=fit)
    assert tuner.methods == ("genetic", "rl") and tuner.rl.device == fit.device
    tuner.rl = RLSearch(episodes=2, steps_per_episode=6, device=fit.device)
    op = OpDesc.matmul(4, 8, 16, dtype="float32")
    best = tuner.tune(op)
    assert [r.method for r in tuner.log] == ["genetic", "rl"]
    assert TEMPLATES["pallas_matmul"].validate(op, best.config)
    # without a device the agent asks for the GPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        RLSearch().run(SearchTask(op, TEMPLATES["pallas_matmul"], fit))
