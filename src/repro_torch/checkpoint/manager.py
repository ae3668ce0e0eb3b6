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
package restores what the other saved.  A leaf numpy cannot hold
(bfloat16) raises, naming the leaf; the train state has only f32 and int32
leaves.  Restoring onto another sharding waits for TP training (ROADMAP.md
queue 1, item 8c).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

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


def _unflatten_into(template, flat: Dict[str, np.ndarray], device=None, prefix=()):
    """The template's tree of tensors: each leaf cast to the template
    leaf's dtype and put on `device` (default: the CPU); a leaf missing
    from `flat` raises KeyError naming it."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, prefix + (str(k),))
                for k, v in template.items()}
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    return torch.as_tensor(flat[key]).to(device=device or "cpu", dtype=template.dtype)


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
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any],
             extra_meta: Optional[Dict[str, Any]] = None) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(state)
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
        return final

    def save_async(self, step: int, state: Dict[str, Any],
                   extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # Snapshot to host copies *before* returning: the trainer updates
        # the parameters in place, and on the CPU `.cpu()` would share them.
        host_state = _flatten(state)

        def work():
            try:
                self.save(step, host_state, extra_meta)
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # -------------------------------------------------------------- restore
    def restore(self, step: int, template, device=None):
        """The checkpoint of `step` in the structure of `template` (a tree
        of anything with a `dtype`: tensors, meta tensors), each leaf cast
        to the template's dtype, on `device` (default: the CPU)."""
        path = os.path.join(self.dir, f"step_{step}", "state.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(template, flat, device)

    def restore_latest(self, template, device=None):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, self.restore(step, template, device)

    def meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)

    def _gc(self) -> None:
        steps = sorted(
            int(_STEP_RE.match(d).group(1))
            for d in os.listdir(self.dir) if _STEP_RE.match(d))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
