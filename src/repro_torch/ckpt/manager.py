"""Checkpoint manager: atomic, retention-limited, restorable by either
package.

The counterpart of ``repro.ckpt.manager`` over the port's trees: nested
dicts of tensors, tuples and lists, ``optim.OptState(step, inner)`` (any
NamedTuple), and Python ints (the optimizer's step).  Format, as the
reference writes it: one directory per step holding ``arrays.<host>.npz``
(the flattened tree, keys ``/``-joined paths) and ``manifest.json`` (step,
time, tree description, keys, host count, the caller's ``extra``, such as
the data cursor).  Writes go to a temp dir that is atomically renamed, so a
crash mid-save never corrupts the latest checkpoint.

The keys are those of JAX's ``tree_flatten_with_path`` on the same
structure: a dict's sorted keys, a sequence's indices, and a NamedTuple's
attribute keys as ``str(GetAttrKey)`` writes them, with a leading dot
(``{"opt": OptState(...)}`` flattens to ``opt/.step`` and
``opt/.inner/m/...``).  So each package restores the other's checkpoint.
Tensors go to numpy on the host; an int leaf is stored as a 0-d int32
array, as the reference's ``OptState.step`` is.  numpy has no bfloat16 of
its own, so a bfloat16 tensor is stored as its bits, a uint16 array, and
restored bit-exactly into a bfloat16 ``like``; a 2-byte void array (how
``np.savez`` writes a JAX bfloat16 leaf) is read the same way.  The
manifest's ``treedef`` describes the port's own tree (JAX's repr cannot be
made without JAX); restore reads keys and shapes only, as the reference's
does, and puts each tensor on the device and in the dtype of ``like``.

The per-host layout (``arrays.<host>.npz``) is kept as the reference has
it; one card is one host, host 0.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(key, child)`` pairs in JAX's flatten order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _leaves(tree, prefix=()):
    """``(path tuple, leaf)`` pairs in flatten order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, child in kids:
        yield from _leaves(child, prefix + (k,))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {"/".join(path): _to_numpy(leaf) for path, leaf in _leaves(tree)}


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(getattr(tree, f))}" for f in tree._fields) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(x) for x in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    new = [_unflatten(child, leaves) for _, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), new))
    if _is_namedtuple(like):
        return type(like)(*new)
    return type(like)(new)


def _from_numpy(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
                and arr.dtype.kind in "uiV":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(like.device)
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    return type(like)(arr)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None, host: int = 0) -> str:
    """Atomically write a checkpoint for ``step``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, f"arrays.{host}.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "treedef": _describe(tree),
            "keys": sorted(flat.keys()),
            "n_hosts": 1,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, allow_nan=False)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def restore_latest(directory: str, like: Any,
                   host: int = 0) -> tuple[Optional[int], Any, dict]:
    """Restore the newest complete checkpoint into the structure of ``like``.

    Returns (step, tree, extra); (None, like, {}) when nothing to restore.
    """
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_")) if os.path.isdir(directory) else []
    if not steps:
        return None, like, {}
    step = steps[-1]
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    new_leaves = []
    with np.load(os.path.join(path, f"arrays.{host}.npz")) as data:
        for pth, leaf in _leaves(like):
            key = "/".join(pth)
            arr = data[key]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if arr.shape != shape:
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {shape}")
            new_leaves.append(_from_numpy(arr, leaf))
    return step, _unflatten(like, iter(new_leaves)), \
        manifest.get("extra", {})


@dataclass
class CheckpointManager:
    """Retention + cadence policy around save/restore."""
    directory: str
    every_steps: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> Optional[str]:
        if step % self.every_steps != 0:
            return None
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return path

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return path

    def restore(self, like: Any):
        return restore_latest(self.directory, like)

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
