"""Checkpointing with async commit: the counterpart of
``repro.checkpoint.manager`` on tensor trees, in its on-disk format.

Layout per step:
    <dir>/step_<N>.tmp/   -> written first
        arrays.npz        -> flattened tree (key -> ndarray)
        manifest.json     -> step, sorted keys, extra state (data pipeline)
    <dir>/step_<N>/       -> atomic rename on completion (commit point)

A leaf's key is the reference's: the ``jax.tree_util.keystr`` of each
step of its path (``['a']`` for a dict key, ``[0]`` for a sequence
index) joined by ``||``, built here by hand; the two packages read each
other's checkpoints.  numpy has no bfloat16: such a leaf is written as
float32, which restores to bfloat16 exactly.

* a crash mid-write never corrupts the latest checkpoint (tmp + rename);
* ``save(..., blocking=False)`` copies the tree to the host first (a copy
  on every device, the CPU too), then commits on a background thread,
  overlapping the write with the next steps;
* ``restore`` places each array on the device and in the dtype of the
  target tree's leaf (the reference's shardings have no counterpart on
  one device).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_SEP = "||"


def _paths(tree, prefix=()):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s flattening order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _paths(tree[k],
                                                          prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _paths(t, prefix + (i,))]
    return [(prefix, tree)]


def _key(path) -> str:
    return _SEP.join(f"[{k!r}]" for k in path)


def _host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory.  Always a copy: a CPU tensor's
    ``.cpu()`` is the tensor itself, and ``AdamW.apply`` writes params and
    moments in place while an async commit may still be writing them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(p): _host(leaf) for p, leaf in _paths(tree)}


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         blocking: bool = True) -> threading.Thread | None:
    """Snapshot ``tree`` to the host and commit it atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(tree)  # the host snapshot happens HERE, synchronously
    manifest = {"step": int(step), "keys": sorted(arrays),
                "extra": extra or {}}

    def commit():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        commit()
        return None
    t = threading.Thread(target=commit, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree):
    """Restore into the structure of ``target_tree`` (a tree of tensors):
    each array in its leaf's dtype, on its leaf's device.  Returns
    ``(tree, extra)``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(p, leaf):
            key = _key(p)
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"target {tuple(leaf.shape)}")
            # into memory of torch's own allocation: a CPU matmul's sums
            # can depend on its operands' alignment, and a resumed run
            # must repeat the uninterrupted one bit for bit
            out = torch.empty(leaf.shape, dtype=leaf.dtype,
                              device=leaf.device)
            return out.copy_(torch.from_numpy(arr))

        tree = _unflatten(target_tree, load)
    return tree, manifest.get("extra", {})


def _unflatten(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, fn, prefix + (i,))
                          for i, t in enumerate(tree))
    return fn(prefix, tree)


class CheckpointManager:
    """keep_last-N manager with async commit and auto-resume."""

    def __init__(self, ckpt_dir: str, *, keep_last: int = 3,
                 save_every: int = 100):
        self.dir = ckpt_dir
        self.keep_last = keep_last
        self.save_every = save_every
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree, *, extra=None, force=False):
        if not force and (step == 0 or step % self.save_every):
            return False
        self.wait()
        self._pending = save(self.dir, step, tree, extra=extra,
                             blocking=False)
        self._gc(step)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self, newest: int):
        if not os.path.isdir(self.dir):
            return
        steps = {
            int(m.group(1)) for name in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", name))}
        steps.add(newest)  # the async commit may not have landed yet
        for s in sorted(steps)[:-self.keep_last]:
            if s != newest:
                shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                              ignore_errors=True)

    def restore_latest(self, target_tree):
        step = latest_step(self.dir)
        if step is None:
            return None, None, None
        tree, extra = restore(self.dir, step, target_tree)
        return step, tree, extra
