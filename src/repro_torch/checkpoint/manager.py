"""Atomic checkpointing — the port of `repro.checkpoint.manager`, in the
reference's on-disk format.

Fault-tolerance properties:
  * atomic commit — a checkpoint is written to `step_N.tmp/` and renamed to
    `step_N/` only after the leaves and the metadata have been fsync'd; a
    job killed mid-save never corrupts the latest valid checkpoint;
  * auto-resume — `latest_step` scans for the newest committed step;
  * bounded disk — `keep` newest checkpoints are retained;
  * async — `save_async` copies every leaf to the host before it returns
    and serialises in a worker thread, so the train loop (which updates
    the parameters in place) only blocks on the previous save.

Storage is one `state.npz` per checkpoint, keyed by the "/"-joined tree
paths (`params/blocks/attn/wq/w`, `opt/m/...`, `opt/step`), plus
`meta.json` — the files the JAX `CheckpointManager` writes, so either
package restores what the other saved, on any mesh.  A leaf numpy cannot
hold (bfloat16) raises, naming the leaf; the train state has only f32 and
int32 leaves.

Elastic restart, as the reference's reshard-on-restore: leaves are saved
whole, and `restore(step, template, shardings)` puts each leaf where its
sharding says — a device (the whole leaf there), a
`distributed.sharding.LeafCut` (the rank's cut of it, on the cut's
device) or a `NamedSharding` (its spec's block for this rank of its
mesh) — so a job saved on one mesh resumes on another.  On a mesh the
manager is built with `gather` (the collective that turns the rank's state
into the whole leaves, run by `save` / `save_async` in the calling thread
on every rank), `writer` (the one rank that writes, in the worker thread)
and `barrier` (every rank waits for the atomic rename before going on).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import LeafCut, axis_sizes, local_shard
from repro_torch.tree import tree_flatten_with_paths

_STEP_RE = re.compile(r"^step_(\d+)$")


def leaf_to_numpy(key: str, leaf) -> np.ndarray:
    """A host numpy copy of one leaf (a tensor on any device, or an
    array); bfloat16 raises ValueError naming the leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"leaf {key} is bfloat16, which numpy cannot hold")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: leaf_to_numpy(key, leaf) for key, leaf in tree_flatten_with_paths(tree)}


def place(whole: torch.Tensor, sharding) -> torch.Tensor:
    """A whole leaf put where `sharding` says: None (the CPU), a device, a
    `LeafCut` (the rank's cut, on its device) or a `NamedSharding` (the
    spec's block for this rank of its DeviceMesh)."""
    if sharding is None or isinstance(sharding, (str, torch.device)):
        return whole.to(sharding or "cpu")
    if isinstance(sharding, LeafCut):
        return sharding.local(whole).to(sharding.device or "cpu")
    mesh = sharding.mesh
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    spec = tuple(sharding.spec) + (None,) * (whole.dim() - len(sharding.spec))
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else mesh.device_type)
    return local_shard(whole, spec, axis_sizes(mesh), coords).to(device)


def _unflatten_into(template, flat, shardings=None, prefix=()):
    """The template's tree of tensors: each leaf read from `flat` (a dict
    of arrays or an open npz file, read leaf by leaf), cast to the
    template leaf's dtype and placed by its sharding (`place`; `shardings`
    one sharding for every leaf or a tree of them, matched by key); a leaf
    missing from `flat` raises KeyError naming it."""
    if isinstance(template, dict):
        return {k: _unflatten_into(
            v, flat, shardings[k] if isinstance(shardings, dict) else shardings,
            prefix + (str(k),)) for k, v in template.items()}
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    return place(torch.as_tensor(flat[key]).to(template.dtype), shardings)


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class CheckpointManager:
    """`gather` / `writer` / `barrier`: on a mesh (see the module
    docstring); by default the state is this process's own and it writes
    it."""

    def __init__(self, ckpt_dir: str, keep: int = 3, *,
                 gather: Optional[Callable[[Any], Dict[str, np.ndarray]]] = None,
                 writer: bool = True, barrier: Optional[Callable[[], None]] = None):
        self.dir = ckpt_dir
        self.keep = keep
        self.gather = gather
        self.writer = writer
        self.barrier = barrier
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    def _host(self, state) -> Dict[str, np.ndarray]:
        """The whole state as host copies (collective on a mesh)."""
        return self.gather(state) if self.gather is not None else _flatten(state)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any],
             extra_meta: Optional[Dict[str, Any]] = None) -> str:
        """Write `state` as step `step` (on a mesh: gathered on every rank,
        written by the writer, every rank returning after the rename)."""
        final = os.path.join(self.dir, f"step_{step}")
        flat = self._host(state)
        if self.writer:
            self._write(step, flat, extra_meta)
        if self.barrier is not None:
            self.barrier()
        return final

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra_meta: Optional[Dict[str, Any]]) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz = os.path.join(tmp, "state.npz")
        np.savez(npz, **flat)
        _fsync_file(npz)
        meta = {"step": step, "n_leaves": len(flat)}
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._gc()

    def save_async(self, step: int, state: Dict[str, Any],
                   extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # Snapshot to host copies *before* returning: the trainer updates
        # the parameters in place, and on the CPU `.cpu()` would share them.
        # On a mesh the gather is a collective: here, in the calling thread.
        host_state = self._host(state)
        if not self.writer:
            return

        def work():
            try:
                self._write(step, host_state, extra_meta)
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write (on a mesh every rank then waits for the
        writer's rename); its error, if any, is raised here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.barrier is not None:
            self.barrier()
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # -------------------------------------------------------------- restore
    def restore(self, step: int, template, shardings=None):
        """The checkpoint of `step` in the structure of `template` (a tree
        of anything with a `dtype`: tensors, meta tensors), each leaf cast
        to the template's dtype and put where `shardings` says: None (the
        CPU), a device, or a tree of per-leaf shardings (`place`).  Leaves
        are read one at a time, each cut and placed before the next is
        read, so the host holds one whole leaf at a time."""
        path = os.path.join(self.dir, f"step_{step}", "state.npz")
        with np.load(path) as z:
            return _unflatten_into(template, z, shardings)

    def restore_latest(self, template, shardings=None):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, self.restore(step, template, shardings)

    def meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)

    def _gc(self) -> None:
        if not self.writer:
            return
        steps = sorted(
            int(_STEP_RE.match(d).group(1))
            for d in os.listdir(self.dir) if _STEP_RE.match(d))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
