"""Move coefficients and streaming state between the JAX package and the
port.

Both sides take numpy: ``jax.tree.map(np.asarray, proc.params)`` and
``jax.tree.map(np.asarray, carry)`` on the JAX side, so this module
never imports jax.  A stream can run its first blocks in one package and
continue in the other, because carries have the same keys, shapes and
dtypes on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import Chain, Proc
from .planar import _Stage

__all__ = ["load_jax_params", "carry_from_numpy", "carry_to_numpy"]


def _load(module: Proc, spec, tree, path: str):
    if isinstance(spec, str):
        buf = module.get_buffer(spec)      # "filt.B": a submodule's buffer
        src = torch.from_numpy(np.array(tree))
        if src.shape != buf.shape or src.dtype != buf.dtype:
            raise ValueError(f"{path}: JAX param {tuple(src.shape)} "
                             f"{src.dtype} does not fit buffer "
                             f"{tuple(buf.shape)} {buf.dtype}")
        with torch.no_grad():
            buf.copy_(src)
    elif isinstance(spec, dict):
        if set(spec) != set(tree):
            raise ValueError(f"{path}: params keys {sorted(tree)} != "
                             f"{sorted(spec)}")
        for k in spec:
            _load(module, spec[k], tree[k], f"{path}.{k}")
    else:
        if len(spec) != len(tree):
            raise ValueError(f"{path}: {len(tree)} params for {len(spec)}")
        for k, (s, t) in enumerate(zip(spec, tree)):
            _load(module, s, t, f"{path}[{k}]")


def load_jax_params(module: Proc, params_tree) -> None:
    """Copy a JAX Proc's params (a pytree of numpy arrays) into the
    matching port module's buffers, walking the tree in the JAX package's
    structure: a chain's params are the tuple of its stages' params, a
    planar view's are its stage's, a leaf stage's follow its
    ``param_spec``.  Raises on any structure, shape or dtype mismatch."""

    def walk(m, tree, path):
        if isinstance(m, Chain):
            if len(tree) != len(m.stages):
                raise ValueError(f"{path}: {len(tree)} param groups for "
                                 f"{len(m.stages)} stages")
            for k, (s, t) in enumerate(zip(m.stages, tree)):
                walk(s, t, f"{path}[{k}]")
        elif isinstance(m, _Stage):
            walk(m.inner, tree, path)
        else:
            _load(m, m.param_spec, tree, f"{path}({m.name})")

    walk(module, params_tree, "params")


def carry_from_numpy(tree, device=None):
    """A carry of numpy arrays (tuples/lists/dicts nested as the JAX
    package builds them) as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: carry_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(carry_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def carry_to_numpy(carry):
    """A port carry as numpy arrays in the same structure."""
    if isinstance(carry, dict):
        return {k: carry_to_numpy(v) for k, v in carry.items()}
    if isinstance(carry, (tuple, list)):
        return type(carry)(carry_to_numpy(v) for v in carry)
    return carry.detach().cpu().numpy()
