"""Flat-npz checkpointing with step metadata (port of
``repro/checkpoint/checkpoint.py``; numpy only).

Layout: ``<dir>/step_<N>.npz`` holding flattened leaves keyed by joined
tree paths, plus a ``_meta`` JSON entry.  The format is the reference's,
file names and keys included, so either package reads a store the other
wrote: keys are the paths of
:func:`repro_torch.pytree.tree_flatten_with_path`, the port's one
``jax.tree_util``-order walker (a dict key, a sequence index, or
``.name`` for a NamedTuple field).

Durability contract (:mod:`repro_torch.engine.resilience` relies on all
three):

* **atomic publish** — the npz is written to a ``.tmp`` sibling, fsynced,
  then ``os.replace``d into place and the directory entry fsynced; a
  crash mid-save leaves at most a stale ``.tmp``, never a torn
  ``step_*.npz`` (``latest_step`` only ever sees complete files);
* **bounded retention** — ``keep_last=N`` prunes the oldest steps after
  each successful publish, strictly AFTER the new step is durable;
* **collision-free keys** — tree-path components are escaped before
  joining with ``/`` (``{"a": {"b": x}}`` and ``{"a/b": x}`` flatten to
  the distinct keys ``a/b`` and ``a\\/b``).
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.pytree import tree_flatten_with_path, tree_unflatten_like


def _escape(component: str) -> str:
    """Escape one tree-path component so ``/``-joined keys are injective
    (a literal backslash escapes first, then the separator)."""
    return component.replace("\\", "\\\\").replace("/", "\\/")


def _path_key(path) -> str:
    """The npz key for one tree path (a tuple of components)."""
    return "/".join(_escape(str(p)) for p in path)


def to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf (a tensor on any device, or array-like)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in tree_flatten_with_path(tree):
        key = _path_key(path)
        if key in flat:
            raise ValueError(
                f"checkpoint tree flattens two leaves to key {key!r}")
        flat[key] = to_numpy(leaf)
    return flat


def _fsync_dir(directory: str):
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(directory: str, step: int, tree, meta: Optional[dict] = None,
         keep_last: Optional[int] = None) -> str:
    """Write ``<directory>/step_<N>.npz`` atomically and durably; with
    ``keep_last=N`` prune all but the newest N steps afterwards."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    flat["_meta"] = np.frombuffer(
        json.dumps({"step": step, **(meta or {})}).encode(), dtype=np.uint8)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)
    if keep_last is not None:
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1: {keep_last!r}")
        for old in _step_files(directory)[:-keep_last]:
            os.remove(os.path.join(directory, old))
    return path


def _step_files(directory: str) -> list:
    """Completed checkpoint filenames, oldest first (.tmp leftovers of a
    crashed save never match)."""
    return sorted(fn for fn in os.listdir(directory)
                  if re.match(r"step_(\d+)\.npz$", fn))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := re.match(r"step_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def load_flat(directory: str, step: Optional[int] = None):
    """Template-free read: ``(flat, meta)`` with ``flat`` mapping escaped
    tree-path keys to host numpy arrays (the latest step by default)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"step_{step:08d}.npz")) as data:
        meta = json.loads(bytes(data["_meta"]).decode())
        flat = {k: data[k] for k in data.files if k != "_meta"}
    return flat, meta


def restore(directory: str, template, step: Optional[int] = None):
    """Returns ``(tree, meta)``; ``template`` gives the structure and each
    leaf's dtype (and, for a tensor leaf, its device)."""
    flat, meta = load_flat(directory, step)
    out = []
    for path, leaf in tree_flatten_with_path(template):
        arr = flat[_path_key(path)]
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(np.asarray(arr, dtype=np.asarray(leaf).dtype))
    return tree_unflatten_like(template, out), meta
