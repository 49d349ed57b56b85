"""Step-atomic checkpoints in the JAX package's on-disk layout::

    <dir>/step_000123/
        MANIFEST.json       # {"step", "leaves": [{path, file, shape, dtype}]}
        leaf_00000.npy ...
    <dir>/LATEST            # atomic pointer (written last)

A tree is nested dicts of tensors (or numpy arrays); a leaf's path is its
keys joined with ``/``, and leaves are numbered in sorted-key order, as the
reference's ``tree_flatten_with_path`` numbers them.  The port's flat
params are keyed by those paths already, so ``{"params": params, "opt":
state}`` writes the files the reference writes for its own state, and
either package restores the other's checkpoints.  bfloat16 is stored as
its uint16 bits (through a torch view; no bfloat16-aware numpy needed).

:func:`restore` places each leaf whose sharding is given
(``shardings``, a tree of
:class:`repro_torch.distributed.sharding.NamedSharding` beside
``like_tree``'s leaves) as its pieces on the sharding's mesh
(:func:`repro_torch.distributed.sharding.shard_tensor`), so a checkpoint
restores under another mesh than the one it was saved from; the others come
back whole.

A step is written to ``step_%09d.tmp`` and renamed; ``LATEST`` is
replaced last.  :class:`CheckpointManager` saves from a background thread
and keeps the newest ``keep`` steps; it copies every tensor to the host
before the thread starts, since the optimizer updates the live tensors in
place.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_tensor

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = ""):
    """[(path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten_like(like, values: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, f"{prefix}{k}/")
                for k, v in like.items()}
    return values[prefix[:-1]]


def _host(leaf, copy: bool = True) -> torch.Tensor:
    """A leaf on the host: a copy (never a view of a live tensor), or, with
    ``copy=False``, the leaf itself when it is there already."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return torch.from_numpy(np.array(leaf))


def _to_numpy(t: torch.Tensor):
    """(array to write, dtype name): bfloat16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr, dtype_name: str) -> torch.Tensor:
    if dtype_name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step``; returns the step's directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = step_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, dtype_name = _to_numpy(_host(leaf, copy=False))
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": dtype_name})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp, step_dir)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return step_dir


def latest_step(ckpt_dir: str):
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def restore(ckpt_dir: str, like_tree, step: int | None = None,
            shardings=None):
    """Restore step ``step`` (the latest by default) into the structure of
    ``like_tree``, each leaf at the like leaf's dtype: a leaf with a
    sharding in ``shardings`` (a tree of ``NamedSharding`` by the same
    paths; absent or None: whole) as the list of its pieces on the
    sharding's mesh devices, any other whole on the like leaf's device.
    Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    values = {}
    for path, like in _flatten(like_tree):
        entry = by_path[path]
        t = _from_numpy(np.load(os.path.join(step_dir, entry["file"])),
                        entry["dtype"]).to(dtype=like.dtype)
        shd = placed.get(path)
        values[path] = (t.to(like.device) if shd is None
                        else shard_tensor(t, shd.mesh, shd.spec))
    return _unflatten_like(like_tree, values), step


class CheckpointManager:
    """Rotating asynchronous checkpointer."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree):
        # copy every leaf to the host now (the caller goes on updating the
        # live tensors in place); write in the background
        host_tree = _unflatten_like(
            tree, {p: _host(leaf) for p, leaf in _flatten(tree)})
        self.wait()

        def work():
            save(self.dir, step, host_tree)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def _gc(self):
        steps = sorted(int(d.split("_")[-1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree, shardings=None):
        self.wait()
        return restore(self.dir, like_tree, shardings=shardings)

    def latest_step(self):
        return latest_step(self.dir)
