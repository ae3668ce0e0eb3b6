"""RL-search (paper §2.4): schedule-parameter tuning as an RL problem (the
port of `repro.core.search.rl_search`).

State (the paper's 17-d O_conv): operator dims + current schedule-parameter
values + the runtime moving average alpha_t.  For a conv that is exactly

  O_conv = (N, C_in, C_out, K_h, K_w, H, W, Stride, Padding,
            T_x, T_y, T_z, Tile_x, Tile_y, Tile_z, Tile_rz, alpha_t)

with the thread/tile slots holding the Hopper kernels' tunables (the
conv's bn / row_block, the GEMM's tile_m / split_k, the flash kernel's
block_q / block_kv / max_segments), zero-padded to seven.

Action: discrete; "an action updates one parameter at a time" — action
(i, ±1) moves tunable i one step along its ordered choice list.  Multiple
rounds of predictions perform multiple parameter updates (paper).  A move
the template rejects is not evaluated: it costs the worst-case penalty
runtime 2 * alpha.

Reward (Eq. 4):  r_t = alpha_{t-1} - min(beta_t, 2 * alpha_{t-1}), with the
moving average updated as the reference writes Eq. 3:
alpha_t = (alpha_{t-1} * 0.8 + beta_t) / t.  Runtimes are expressed in
microseconds so rewards are well-conditioned.  The environment is the
reference's step for step, so the two visit the same configurations given
the same actions.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from repro_torch.core.search.base import SearchResult, SearchTask
from repro_torch.core.search.ppo import PPOAgent, PPOConfig
from repro_torch.platform import DeviceLike

OBS_DIM = 17
_US = 1e6  # seconds -> microseconds


def _obs(task: SearchTask, cfg, alpha_us: float) -> np.ndarray:
    d = task.op.d
    if task.op.kind == "conv2d":
        dims = [d["n"], d["cin"], d["cout"], d["kh"], d["kw"], d["h"], d["w"],
                d["stride"], d["pad"]]
    elif task.op.kind == "matmul":
        dims = [d["m"], d["n"], d["k"], 0, 0, 0, 0, 0, 0]
    else:  # attention
        dims = [d["b"], d["q"], d["kv"], d["h"], d["d"], 0, 0, 0, 0]
    axes = task.template.axes(task.op)
    vals = []
    for name, choices in axes:
        v = cfg[name]
        vals.append(float(v) if isinstance(v, (int, float)) else float(choices.index(v)))
    vals = (vals + [0.0] * 7)[:7]
    obs = np.array([*dims, *vals, alpha_us], np.float32)
    return np.sign(obs) * np.log1p(np.abs(obs))  # log-scale conditioning


class RLSearch:
    """`device`: where the PPO agent runs (None: the GPU)."""

    def __init__(self, episodes: int = 6, steps_per_episode: int = 24,
                 ppo: PPOConfig = PPOConfig(), seed: int = 0,
                 device: DeviceLike = None):
        self.episodes = episodes
        self.steps = steps_per_episode
        self.ppo_cfg = ppo
        self.seed = seed
        self.device = device

    def run(self, task: SearchTask) -> SearchResult:
        t0 = time.perf_counter()
        axes = task.template.axes(task.op)
        n_actions = 2 * len(axes)
        agent = PPOAgent(OBS_DIM, n_actions, self.ppo_cfg, seed=self.seed,
                         device=self.device)

        for ep in range(self.episodes):
            cfg = task.random_config()
            beta0 = task.evaluate(cfg) * _US
            alpha, t_step = beta0, 1
            obs_l: List[np.ndarray] = []
            act_l: List[int] = []
            logp_l: List[float] = []
            rew_l: List[float] = []
            ob = _obs(task, cfg, alpha)

            for _ in range(self.steps):
                a, logp = agent.act(ob)
                pi, direction = divmod(a, 2)
                name, choices = axes[pi]
                idx = choices.index(cfg[name])
                nidx = int(np.clip(idx + (1 if direction else -1), 0, len(choices) - 1))
                new_cfg = dict(cfg)
                new_cfg[name] = choices[nidx]

                if task.template.validate(task.op, new_cfg, task.chip):
                    cfg = new_cfg
                    beta = task.evaluate(cfg) * _US
                else:  # invalid move: clamp to the worst-case penalty runtime
                    beta = 2.0 * alpha
                r = alpha - min(beta, 2.0 * alpha)        # Eq. 4
                t_step += 1
                alpha = (alpha * 0.8 + beta) / t_step     # Eq. 3

                obs_l.append(ob)
                act_l.append(a)
                logp_l.append(logp)
                rew_l.append(r)
                ob = _obs(task, cfg, alpha)

            agent.update(obs_l, act_l, logp_l, rew_l, ob)

        return task.result("rl", time.perf_counter() - t0)


def rl_search(task: SearchTask, **kw) -> SearchResult:
    return RLSearch(**kw).run(task)
