"""Carry checkpoint/resume (`liquid_dsp_tpu/utils/checkpoint.py`).

The reference has no checkpointing (SURVEY.md §5): all state lives in
opaque C structs whose only lifecycle affordance is `_reset()`.  In the
block/carry architecture the entire runtime state of any chain IS the
carry, so checkpointing is serializing it: a stream can be stopped,
saved, moved between hosts, and resumed.

The file layout is the JAX package's: ``leaf_i`` arrays in JAX's pytree
flatten order (dict keys sorted, tuples and lists in order, None no
leaf) and a ``__treedef__`` entry with the structure's text.  The port's
carries have the JAX package's structure (`convert.py`), so a checkpoint
written by either package loads into the other.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_carry", "load_carry"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves):
    """Append tree's leaves in JAX's order; returns the structure's text
    as JAX prints a PyTreeDef."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in keys) + "}"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v, leaves) for v in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(parts) + "]"
        if _is_namedtuple(tree):
            return f"{type(tree).__name__}(" + ", ".join(parts) + ")"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: None for k in like}          # keep the caller's key order
        for k in sorted(like):
            out[k] = _unflatten(like[k], it)
        return out
    if isinstance(like, (tuple, list)):
        vals = [_unflatten(v, it) for v in like]
        if _is_namedtuple(like):
            return type(like)(*vals)
        return type(like)(vals)
    return next(it)


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_carry(path, carry) -> None:
    """Serialize a carry (tensors, numpy arrays or scalars nested in dicts,
    tuples and lists) to an .npz file."""
    flat = []
    text = _flatten(carry, flat)
    arrays = {f"leaf_{i}": _numpy(v) for i, v in enumerate(flat)}
    arrays["__treedef__"] = np.frombuffer(
        f"PyTreeDef({text})".encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_carry(path, like):
    """Restore a carry saved by save_carry (by either package); `like`
    gives the structure (e.g. proc.init(...)).  A leaf whose `like` is a
    tensor comes back as a tensor on that tensor's device, others as
    numpy.  Raises ValueError when a leaf's shape differs."""
    data = np.load(path)
    flat_like = []
    _flatten(like, flat_like)
    leaves = []
    for i, want in enumerate(flat_like):
        got = data[f"leaf_{i}"]
        shape = tuple(want.shape) if torch.is_tensor(want) else np.shape(want)
        if got.shape != shape:
            raise ValueError(f"checkpoint leaf shape {got.shape} does not "
                             f"match expected {shape}")
        leaves.append(torch.from_numpy(np.array(got)).to(want.device)
                      if torch.is_tensor(want) else got)
    return _unflatten(like, iter(leaves))
