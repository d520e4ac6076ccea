"""Fault-tolerant checkpointing in the JAX package's layout
(``repro/ckpt/checkpointer.py``), so a checkpoint written by either
package restores in the other.

* **Atomic**: writes into ``step_XXXX.tmp/`` then ``os.rename`` — a crash
  mid-save never corrupts the latest checkpoint; :func:`latest_step` only
  sees complete directories (the rename is the commit point).
* **Layout**: one ``.npy`` per leaf, named by the leaf's tree path as the
  reference names it (:func:`repro_torch.tree.leaf_names`: ``params_embed``,
  ``opt_m_blocks_0_ln1``, ``opt_count``), and a ``manifest.json``.
* **Restore** loads into the *target* tree: each leaf is read host-side,
  checked against the target's shape, cast to its dtype and copied into
  it in place (the port updates in place where that saves memory: a
  restore of the full training state needs no second copy on the card).
* The manager's saves and keep-policy GC are guarded by the paper's
  LibASL mutex (saves are little-core/standby work; the training step's
  metadata read is the latency-critical path).  There are no shardings on
  one card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.libasl import LibASL
from repro_torch.tree import from_numpy, leaf_names, leaves, to_numpy, \
    tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


def save(directory, step: int, tree) -> Path:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step}.tmp"
    final = d / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for name, leaf in zip(leaf_names(tree), leaves(tree)):
        arr = to_numpy(leaf)
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)           # commit point
    return final


def latest_step(directory) -> int | None:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := _STEP_RE.match(p.name)) and (p / "manifest.json").exists()]
    return max(steps) if steps else None


@torch.no_grad()
def restore(directory, step: int, target_tree, shardings=None):
    """Load checkpoint ``step`` into the tensors of ``target_tree`` in
    place (each leaf cast to its target's dtype); -> the target tree."""
    if shardings is not None:
        raise NotImplementedError("the port runs on one card: no shardings")
    d = Path(directory) / f"step_{step}"
    for name, tgt in zip(leaf_names(target_tree), leaves(target_tree)):
        arr = np.load(d / f"{name}.npy")
        want_shape = tuple(tgt.shape)
        assert arr.shape == want_shape, (name, arr.shape, want_shape)
        tgt.copy_(from_numpy(arr).to(tgt.dtype))
    return target_tree


class CheckpointManager:
    """Keep-policy + async save thread + crash-safe latest()."""

    def __init__(self, directory, keep: int = 3, save_async: bool = True):
        self.dir = Path(directory)
        self.keep = keep
        self._async = save_async
        self._asl = LibASL(is_big_core=lambda: not _in_saver())
        self._mu = self._asl.mutex()
        self._pending: threading.Thread | None = None

    def save(self, step: int, tree):
        tree = tree_map(to_numpy, tree)
        if self._async:
            self.wait()
            t = threading.Thread(target=self._do_save, args=(step, tree),
                                 daemon=True)
            self._pending = t
            t.start()
        else:
            self._do_save(step, tree)

    def _do_save(self, step, tree):
        _SAVER.flag = True
        with self._mu:
            save(self.dir, step, tree)
            self._gc()

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for p in self.dir.iterdir()
            if (m := _STEP_RE.match(p.name)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest(self) -> int | None:
        with self._mu:
            return latest_step(self.dir)

    def restore(self, step, target_tree, shardings=None):
        self.wait()
        with self._mu:
            return restore(self.dir, step, target_tree, shardings)


_SAVER = threading.local()


def _in_saver() -> bool:
    return getattr(_SAVER, "flag", False)
