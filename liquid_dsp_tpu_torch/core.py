"""Core streaming abstraction of the PyTorch port (`liquid_dsp_tpu/core.py`).

Every streaming operation is a `Proc`, a ``torch.nn.Module`` whose block
step is::

    y_block, carry' = proc(carry, x_block)        # Proc.forward

* coefficients (taps, ramps, tables) are registered **buffers**, so
  ``.to(device)`` and ``state_dict()`` carry them; the JAX package's
  ``params`` argument has no counterpart;
* ``carry`` is a tuple or dict of tensors with the same keys, shapes and
  dtypes as the JAX package's carry (`convert.py` moves it across);
* ``x_block`` is ``[..., T]``: time is the LAST axis, leading axes are
  batch/channel axes.

A Proc never chooses a device: buffers follow ``.to(device)``, carries
are made on the ``device`` given to ``init``, and each step runs where
its input tensor lies.  The entry points that take host arrays
(`framesync64`, `Framesync64`, `qdetector_detect`, `symtrack`,
`Symtrack`) run on the card unless the caller passes ``device="cpu"``;
`entry_device` is their check.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["LTI", "Proc", "Chain", "chain", "planar_per_plane",
           "entry_device", "entry_tensor"]


@contextlib.contextmanager
def full_f32():
    """cuBLAS matmuls in full float32 inside the block, whatever the
    global TF32 switch says: where a product feeds a tolerance (the JAX
    package pins HIGHEST precision there)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of trees of one structure (dicts, lists,
    tuples; a NamedTuple keeps its type), as `jax.tree.map` walks a
    pytree; a leaf that is no tensor (None, a number) is kept as it is in
    ``tree``."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        kids = [tree_map(fn, *z) for z in zip(tree, *rest)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return fn(tree, *rest) if torch.is_tensor(tree) else tree


def entry_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Without a card a CUDA device raises here; nothing falls back
    to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card and "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to "
            "run on the CPU")
    return dev


_NARROW = {np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64,
           np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}


def entry_tensor(x, device="cuda") -> torch.Tensor:
    """x as a tensor: a tensor stays where it lies; a host array (or
    scalar) goes to ``entry_device(device)`` in the dtype the JAX package
    gives it with 64-bit types off (float64 -> float32, complex128 ->
    complex64, int64 -> int32)."""
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    a = np.ascontiguousarray(a, _NARROW.get(a.dtype, a.dtype))
    return torch.from_numpy(a).to(entry_device(device))


@dataclasses.dataclass(frozen=True)
class LTI:
    """Static linear-time-invariant description of a Proc, enabling chain
    fusion (`fuse.py`):

        y[i] = sum_j taps[j] * x[down*i + d - j]

    with ``taps`` a HOST numpy array (1-D), integer decimation ``down`` >= 1
    and input offset ``0 <= d < down``.
    """

    taps: Any
    down: int = 1
    d: int = 0


class Proc(nn.Module):
    """A streaming block processor.

    Metadata (same meaning as the JAX package's `Proc` fields):
      rate:  output/input sample-rate ratio ``(num, den)``.
      halo:  if set, the carry is exactly the last `halo` input samples.
      lti:   static FIR/decimator description for `fuse`.
      meta:  static op description for pattern-matching transforms
             (`kernel_fuse` recognises a mixer by it).
      param_spec: the JAX package's ``params`` pytree with the names of
             this module's buffers as leaves (`convert.load_jax_params`).

    Stages that run natively on (re, im) float planes (`planar.py`) set
    ``forward_planar(carry, (re, im))`` and ``init_planar(...)``; stages
    with a closed-form carry advance set ``advance(carry, n)``.
    """

    rate: Tuple[int, int] = (1, 1)
    halo: Optional[int] = None
    lti: Optional[LTI] = None
    meta: Optional[dict] = None
    param_spec: Any = ()
    forward_planar: Optional[Callable] = None
    init_planar: Optional[Callable] = None
    advance: Optional[Callable] = None

    def __init__(self, name: str = "proc"):
        super().__init__()
        self.name = name

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        """Fresh carry state on ``device``."""
        raise NotImplementedError

    def forward(self, carry, x):
        raise NotImplementedError

    def scan_blocks(self, x_blocks, carry=None, **init_kw):
        """Run over ``[N_blocks, ..., T]`` block after block, the carry
        handed on (the JAX package's `lax.scan` over axis 0).

        ``x_blocks`` is a tensor or a tuple/dict of them (a planar stage's
        ``(re, im)``), each leaf sliced on axis 0.  With no carry the run
        starts from ``self.init(**init_kw)``: pass ``device=`` there as to
        `init`.  Returns ``(y, carry)``: the blocks' outputs stacked on a
        new axis 0 leaf by leaf (tuples, NamedTuples and dicts keep their
        type), and the carry the last block left.
        """
        sizes = set()
        tree_map(lambda t: sizes.add(t.shape[0]), x_blocks)
        if len(sizes) != 1 or not min(sizes):
            raise ValueError(f"scan_blocks: the leaves of x_blocks have "
                             f"{sorted(sizes)} blocks on axis 0; they must "
                             "agree, and be at least 1")
        if carry is None:
            carry = self.init(**init_kw)
        ys = []
        for n in range(sizes.pop()):
            y, carry = self(carry, tree_map(lambda t: t[n], x_blocks))
            ys.append(y)
        return tree_map(lambda *leaves: torch.stack(leaves), *ys), carry

    def _buffer(self, name: str, value) -> None:
        """Register a host array as a buffer (copied: a buffer never
        aliases the numpy array it came from, e.g. `lti.taps`)."""
        self.register_buffer(name, torch.tensor(value))


class Chain(Proc):
    """Stages composed left to right; the carry is the tuple of the
    stages' carries (the JAX package's `chain`)."""

    def __init__(self, procs, name: str = "chain"):
        super().__init__(name)
        self.stages = nn.ModuleList(procs)
        num = den = 1
        for p in procs:
            num *= p.rate[0]
            den *= p.rate[1]
        self.rate = (num, den)

    def init(self, **kw):
        return tuple(p.init(**kw) for p in self.stages)

    def forward(self, carry, x):
        new_carry = []
        for p, c in zip(self.stages, carry):
            x, c = p(c, x)
            new_carry.append(c)
        return x, tuple(new_carry)


def chain(*procs: Proc, name: str = "chain") -> Chain:
    """Compose processors left-to-right (the analog of wiring liquid
    objects in sequence, reference src/framing/src/framesync64.c:327-365)."""
    return Chain(procs, name=name)


def planar_per_plane(forward: Callable, init: Callable):
    """(forward_planar, init_planar) for an op that is R-linear with REAL
    coefficients and an input-tail carry: filtering a complex stream is
    then exactly filtering each float plane independently (planar.py).
    The op's own init/forward run per plane with f32."""

    def init_planar(batch_shape=(), dtype=torch.float32, device=None):
        return (init(batch_shape=batch_shape, dtype=dtype, device=device),
                init(batch_shape=batch_shape, dtype=dtype, device=device))

    def forward_planar(carry, x):
        (r, i), (cr, ci) = x, carry
        yr, cr2 = forward(cr, r)
        yi, ci2 = forward(ci, i)
        return (yr, yi), (cr2, ci2)

    return forward_planar, init_planar
