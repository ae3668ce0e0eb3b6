"""PPO in PyTorch, matching the paper's §2.4 description (the port of
`repro.core.search.ppo`).

Policy network (verbatim from the paper): four fully-connected layers with
hidden sizes 512, 1024, 1024, 512 and activations tanh, tanh, selu, selu,
followed by a dropout layer with keep probability 15%, and a final linear FC
layer.  The output feeds a multinomial (categorical) distribution over the
discrete action space.  The value function V(s) is a separate small MLP.

Loss (Eq. 7):  L_t = E[ L_clip - c1 * L_VF + c2 * S[pi] ],  c1 = 0.15,
c2 = 20 (paper's values), maximised by Adam ascent (we minimise -L).
Advantages use the generalized advantage estimator (Eq. 5-6).

The dropout is an explicit keep mask (`PolicyNet.forward(obs, mask)`):
the agent draws one per training minibatch from its generator, and acting
and the value function run without it.  The agent's random streams
(initialisation, action draws, minibatch permutations, dropout masks) are
torch's, from one `torch.Generator` seeded by `seed`, so a search is
deterministic per seed on one device but does not reproduce
`jax.random`'s draws.  The policy's products are `nn.Linear`s: the
reference computes them as ordinary XLA products, outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.platform import DeviceLike, resolve_device

POLICY_WIDTHS = (512, 1024, 1024, 512)
POLICY_ACTS = ("tanh", "tanh", "selu", "selu")
DROPOUT_KEEP = 0.15
VALUE_WIDTHS = (256, 256)

_ACTS = {"tanh": torch.tanh, "selu": F.selu}


def _mlp(sizes, generator: torch.Generator) -> nn.ModuleList:
    """Linear layers over `sizes`, weights normal * sqrt(2 / fan_in) drawn
    from `generator`, zero biases."""
    layers = nn.ModuleList()
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        layer = nn.Linear(fan_in, fan_out, device=generator.device)
        with torch.no_grad():
            layer.weight.copy_(torch.randn((fan_out, fan_in), generator=generator,
                                           device=generator.device)
                               * (2.0 / fan_in) ** 0.5)
            layer.bias.zero_()
        layers.append(layer)
    return layers


class PolicyNet(nn.Module):
    """obs (..., obs_dim) -> action logits (..., n_actions)."""

    def __init__(self, obs_dim: int, n_actions: int, generator: torch.Generator):
        super().__init__()
        self.layers = _mlp((obs_dim,) + POLICY_WIDTHS + (n_actions,), generator)

    def forward(self, obs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`mask`: the train-time dropout's keep mask over the last hidden
        layer (kept units scaled by 1 / DROPOUT_KEEP); None runs without
        dropout."""
        x = obs
        for layer, act in zip(self.layers[:-1], POLICY_ACTS):
            x = _ACTS[act](layer(x))
        if mask is not None:
            x = torch.where(mask, x / DROPOUT_KEEP, 0.0)
        return self.layers[-1](x)


class ValueNet(nn.Module):
    """obs (..., obs_dim) -> V(s) (...,)."""

    def __init__(self, obs_dim: int, generator: torch.Generator):
        super().__init__()
        self.layers = _mlp((obs_dim,) + VALUE_WIDTHS + (1,), generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)[..., 0]


class Batch(NamedTuple):
    obs: torch.Tensor         # (T, obs_dim)
    actions: torch.Tensor     # (T,) int64
    logp_old: torch.Tensor    # (T,)
    advantages: torch.Tensor
    returns: torch.Tensor


def gae(rewards: np.ndarray, values: np.ndarray, gamma: float, lam: float) -> Tuple[np.ndarray, np.ndarray]:
    """Eq. 5-6: delta_t = r_t + gamma*V(s_{t+1}) - V(s_t);
    A_t = sum (gamma*lam)^l delta_{t+l}.  `values` has length T+1."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    acc = 0.0
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * values[t + 1] - values[t]
        acc = delta + gamma * lam * acc
        adv[t] = acc
    returns = adv + values[:-1]
    return adv, returns


@dataclasses.dataclass
class PPOConfig:
    clip_eps: float = 0.2
    c1: float = 0.15      # value-loss coefficient (paper)
    c2: float = 20.0      # entropy coefficient (paper)
    gamma: float = 0.99
    lam: float = 0.95     # the paper's mu
    lr: float = 3e-4
    epochs: int = 4
    minibatch: int = 64


def ppo_loss(policy: PolicyNet, value: ValueNet, batch: Batch, cfg: PPOConfig,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """-(Eq. 7) on one minibatch; advantages normalised within it by their
    population std, as `jnp.std` computes it."""
    logits = policy(batch.obs, mask)
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(-1, batch.actions[:, None])[:, 0]
    ratio = torch.exp(logp - batch.logp_old)
    adv = batch.advantages
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    l_clip = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    ).mean()
    v = value(batch.obs)
    l_vf = torch.mean((v - batch.returns) ** 2)
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, -1).mean()
    # Eq. 7 (maximised) -> minimise the negation.
    return -(l_clip - cfg.c1 * l_vf + cfg.c2 * 1e-3 * entropy)


class PPOAgent:
    """Thin stateful wrapper used by `RLSearch`; on the GPU
    unless `device` says otherwise."""

    def __init__(self, obs_dim: int, n_actions: int, cfg: PPOConfig = PPOConfig(),
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.n_actions = n_actions
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.policy = PolicyNet(obs_dim, n_actions, self.gen)
        self.value = ValueNet(obs_dim, self.gen)
        self.opt = torch.optim.Adam(
            list(self.policy.parameters()) + list(self.value.parameters()),
            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def act(self, obs: np.ndarray) -> Tuple[int, float]:
        """Sample an action from the policy (no dropout): -> (action, its
        log-probability); one read back from the device."""
        with torch.no_grad():
            logp_all = F.log_softmax(self.policy(self._tensor(obs)[None])[0], -1)
            a = torch.multinomial(logp_all.exp(), 1, generator=self.gen)
            a_f, logp = torch.cat((a.to(logp_all.dtype), logp_all[a])).tolist()
        return int(a_f), logp

    def values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.value(self._tensor(obs)).cpu().numpy()

    def update(self, obs, actions, logp_old, rewards, last_obs) -> float:
        obs = np.asarray(obs, np.float32)
        values = self.values(np.concatenate([obs, np.asarray(last_obs, np.float32)[None]], 0))
        adv, rets = gae(np.asarray(rewards, np.float32), values, self.cfg.gamma, self.cfg.lam)
        batch = Batch(self._tensor(obs), self._tensor(actions, torch.int64),
                      self._tensor(logp_old), self._tensor(adv), self._tensor(rets))
        T = len(actions)
        losses: List[torch.Tensor] = []
        for _ in range(self.cfg.epochs):
            perm = torch.randperm(T, generator=self.gen, device=self.device)
            for s in range(0, T, self.cfg.minibatch):
                idx = perm[s: s + self.cfg.minibatch]
                mb = Batch(*(t[idx] for t in batch))
                mask = torch.rand((len(idx), POLICY_WIDTHS[-1]), generator=self.gen,
                                  device=self.device) < DROPOUT_KEEP
                loss = ppo_loss(self.policy, self.value, mb, self.cfg, mask)
                self.opt.zero_grad()
                loss.backward()
                self.opt.step()
                losses.append(loss.detach())
        return float(torch.stack(losses).mean()) if losses else 0.0
