"""Serving engines of the fixed-batch kind — the port of
`repro.serve.engine` (`ServeConfig`, `Request`, `FixedBatchEngine`,
`ServeEngine`).

`FixedBatchEngine` is the synchronous drain loop: fixed-size batches,
left-padded prompts, one whole-prompt prefill per batch into the model's
fixed-batch cache (a dense KV cache, Mamba2's conv / SSM carries, both
for the hybrid, and the encoder's cross K/V for the encoder-decoder;
`launch.steps.prefill_step`, with the modality extras — the VLM's
`vision_embeds`, the encoder-decoder's `audio_embeds` — broadcast over
the batch), then every request of the batch decodes the
full `max_new_tokens` (`launch.steps.serve_step`), each token drawn by the
step programs' own sampler (`serve.sampling.sample_host`).  It runs
eagerly: the reference retraces its programs per prompt length.  At
batch 1 its drain is the per-request ground truth the continuous engine's
streams, greedy and sampled, are held against.

`ServeEngine` keeps the historical API (`submit` / `run` / `stats` /
`throughput`): a model with a paged decode path and no modality extras is
served by `ContinuousEngine`, anything else by the fixed-batch loop — the
reference's routing predicate, so the VLM with images, `HybridLM`,
`EncDecLM` and `MambaLM` drain through the loop (the ssm family's
continuous serving is an explicit `ContinuousEngine`).

The engines take `device` (`None` means the GPU and raises without one)
and, as the JAX engines do, an optional mesh and sharding rules.  On a
mesh (`launch.mesh.tp_mesh(tp)`, or a (data, model) / (pod, data, model)
mesh from `make_mesh`, in a world of its ranks, each running the same
engine on the same requests) `FixedBatchEngine` serves every family from
the rank's parameter shards (`tp_local_params`, or drawn straight into
them through a `params(tp)` callable) and its caches at the rank's
widths, the steps inside its contexts (`launch.steps.ServeMesh`) under the
caller's rules pruned for the mesh (`launch.steps.fixed_batch_rules`).
With the batch split over "data" (or "pod" x "data") each rank pads the
whole batch and runs its contiguous block of rows (`local_rows`), draws
its rows' tokens with their keys in the whole batch, and all-gathers the
tokens over the batch group, so every rank returns every request's
stream; the ranks of one block of rows hold the same logits and draw the
same tokens.  The KV cache's positions may split over "model" at decode
("kv_seq") and the experts' width over "model" ("expert_ffn").  Where the
batch does not split over the data axes (`rules_for_shape`'s long_500k
layout: the batch replicated, "seq", "kv_seq" and "ssm_state" over
"data") the prefill is sequence-parallel: every rank passes the whole
padded batch, the model runs the rank's block of the prompt (uneven
blocks where "data" does not divide it), and every rank gets the whole
prompt's logits, the same bits, and its own part of the cache; the
decode steps then merge over the KV positions and SSM state columns.
`ServeEngine` passes the mesh and rules to whichever engine it routes to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import DEFAULT_RULES, ShardingRules, local_rows
from repro_torch.launch.steps import ServeMesh, fixed_batch_rules, prefill_step, serve_step
from repro_torch.platform import DeviceLike, resolve_device
from repro_torch.serve.sampling import (SamplingParams, batch_sampling_arrays,
                                        sample_host, truncate_at_eos)

@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 4
    max_seq: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1          # -1: never stop early (synthetic vocab)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (S,) int32
    output: List[int] = dataclasses.field(default_factory=list)
    latency_s: float = 0.0
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)


class FixedBatchEngine:
    """The fixed-batch drain loop (the baseline engine).  `params` is the
    model's tree, or a function of the rank's `TensorParallel` (None with
    no model axis) giving the rank's serving parameters, e.g. `lambda tp:
    model.init_serving(gen, tp=tp)`.  `rules` (DEFAULT_RULES when omitted)
    are taken as given and pruned for `mesh`, as the reference's engine
    takes them: an indivisible split (a batch that does not split over
    the data axes included) raises ValueError, a split the fixed-batch
    steps do not run NotImplementedError (`fixed_batch_rules`); the
    sequence over "data" runs the sequence-parallel prefill."""

    def __init__(self, model, params, cfg: ServeConfig,
                 extras: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None, *, mesh=None,
                 rules: Optional[ShardingRules] = None):
        self.device = resolve_device(device)
        self.model = model
        self.mesh = mesh
        self.rules = self.tp = self.serve_mesh = None
        rows = (0, cfg.batch_size)
        if mesh is not None:
            self.rules = fixed_batch_rules(DEFAULT_RULES if rules is None else rules, mesh)
            self.serve_mesh = ServeMesh(mesh, self.rules)
            self.tp = self.serve_mesh.tp
            rows = local_rows(cfg.batch_size, self.serve_mesh.batch)
        # this rank's rows of every batch: [start, start + count)
        self.rows = rows
        if callable(params):
            self.params = model.serving_params(params(self.tp), self.device)
        else:
            self.params = model.serving_params(params, self.device)
            if self.tp is not None:
                self.params = model.tp_local_params(self.params, self.tp)
        self.cfg = cfg
        # each extra (one request's, e.g. (nv, d)) broadcast over the rank's rows
        self.extras = {k: torch.as_tensor(v, device=self.device)
                      .expand(rows[1], *v.shape)
                      for k, v in (extras or {}).items()}
        self.queue: List[Request] = []
        self._rid = 0
        self.stats = {"requests": 0, "tokens_out": 0, "decode_s": 0.0,
                      "prefill_s": 0.0}

    def submit(self, prompt: np.ndarray,
               sampling: Optional[SamplingParams] = None) -> int:
        sampling = sampling if sampling is not None else SamplingParams()
        bad = sampling.invalid_reason()
        if bad is not None:
            raise ValueError(f"invalid sampling params: {bad}")
        self._rid += 1
        self.queue.append(Request(self._rid, np.asarray(prompt, np.int32),
                                  sampling=sampling))
        return self._rid

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _contexts(self):
        if self.serve_mesh is None:
            return contextlib.nullcontext()
        return self.serve_mesh.contexts()

    def _whole(self, nxt: torch.Tensor) -> torch.Tensor:
        """The whole batch's tokens from every rank's rows (an all-gather
        over the batch group; `nxt` itself where the batch is not split)."""
        group = None if self.serve_mesh is None else self.serve_mesh.batch
        return nxt if group is None else group._gather(nxt).reshape(-1)

    def run(self) -> List[Request]:
        """Drain the queue in fixed-size batches; returns completed requests."""
        done: List[Request] = []
        cfg = self.cfg
        while self.queue:
            batch_reqs = self.queue[: cfg.batch_size]
            self.queue = self.queue[cfg.batch_size:]
            n = len(batch_reqs)
            plen = max(len(r.prompt) for r in batch_reqs)
            toks = np.zeros((cfg.batch_size, plen), np.int32)
            for i, r in enumerate(batch_reqs):
                toks[i, plen - len(r.prompt):] = r.prompt  # left-pad

            # keyed sampling arrays at token index 0 (the prefill sample),
            # the whole batch's, of which the rank draws its rows
            sp, ks = batch_sampling_arrays(batch_reqs, cfg.batch_size)
            lo, hi = self.rows[0], self.rows[0] + self.rows[1]
            sp_r, ks_r = sp[lo:hi], ks[lo:hi]              # views: ks advances

            t_batch0 = time.perf_counter()
            with self._contexts():
                logits, cache = prefill_step(
                    self.model, self.params,
                    torch.as_tensor(toks[lo:hi], device=self.device), cfg.max_seq,
                    self.extras)
            nxt = sample_host(logits[:, -1], sp_r, ks_r)
            outs = [self._whole(nxt).cpu().numpy()]        # syncs
            tok_t = [time.perf_counter()]
            self.stats["prefill_s"] += tok_t[0] - t_batch0

            t0 = time.perf_counter()
            for j in range(1, cfg.max_new_tokens):
                with self._contexts():
                    logits, cache = serve_step(self.model, self.params, cache,
                                               nxt[:, None])
                ks[:, 2] = j                               # token index advances
                nxt = sample_host(logits[:, -1], sp_r, ks_r)
                outs.append(self._whole(nxt).cpu().numpy())
                tok_t.append(time.perf_counter())
            out_tokens = np.stack(outs, 1)
            self._sync()
            self.stats["decode_s"] += time.perf_counter() - t0

            for i, r in enumerate(batch_reqs):
                r.output = truncate_at_eos(out_tokens[i].tolist(), cfg.eos_id)
                # latency is this request's: batch start to the step that
                # emitted its last surviving token
                r.latency_s = tok_t[len(r.output) - 1] - t_batch0
                done.append(r)
                self.stats["tokens_out"] += len(r.output)
            self.stats["requests"] += n
        return done

    def throughput(self) -> float:
        return self.stats["tokens_out"] / max(1e-9, self.stats["decode_s"])


class ServeEngine:
    """Historical API over the continuous runtime: models with a paged
    decode path and no extras are served by `ContinuousEngine`, anything
    else by the fixed-batch loop, either on `mesh` under `rules`."""

    def __init__(self, model, params, cfg: ServeConfig,
                 extras: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None, *, mesh=None,
                 rules: Optional[ShardingRules] = None):
        self.cfg = cfg
        self._continuous = hasattr(model, "decode_step_paged") and not extras
        if self._continuous:
            from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
            block = 16
            rcfg = RuntimeConfig(
                max_slots=cfg.batch_size,
                block_size=block,
                max_blocks_per_seq=max(1, -(-cfg.max_seq // block)),
                max_new_tokens=cfg.max_new_tokens,
                eos_id=cfg.eos_id,
            )
            self._engine = ContinuousEngine(model, params, rcfg, device=device,
                                            mesh=mesh, rules=rules)
        else:
            self._engine = FixedBatchEngine(model, params, cfg, extras, device,
                                            mesh=mesh, rules=rules)
        self.stats = {"requests": 0, "tokens_out": 0, "decode_s": 0.0,
                      "prefill_s": 0.0}

    def submit(self, prompt: np.ndarray,
               sampling: Optional[SamplingParams] = None) -> int:
        return self._engine.submit(prompt, sampling=sampling)

    def run(self) -> List[Request]:
        if not self._continuous:
            done = self._engine.run()
            self.stats = self._engine.stats
            return done
        reqs = self._engine.run()
        m = self._engine.metrics
        self.stats["requests"] += m.requests_done
        self.stats["tokens_out"] += m.tokens_out
        # device-compute split, as FixedBatchEngine's stats
        self.stats["decode_s"] += m.decode_time_s
        self.stats["prefill_s"] += m.prefill_time_s
        self._engine.reset_metrics()  # the next run() accumulates afresh
        return [Request(r.rid, r.prompt, list(r.output), r.latency_s)
                for r in sorted(reqs, key=lambda r: r.rid)]

    def throughput(self) -> float:
        return self.stats["tokens_out"] / max(1e-9, self.stats["decode_s"])
