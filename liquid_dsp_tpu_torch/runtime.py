"""Streaming runtime: drive a Proc pipeline over a capture or live block
source with the carry kept on the device (`liquid_dsp_tpu/runtime.py`).

The reference library's "runtime" is the user's own C loop pushing
samples through objects (SURVEY.md §1: no scheduler).  Here the
equivalent production loop is provided: fixed-size blocks, a
device-resident carry between blocks, and checkpoint/restore of the
stream state (a checkpoint of either package loads into the other).

    runner = StreamRunner(chain(nco(0.1), firfilt(h)), batch_shape=())
    for block in io.iq_stream("capture.cs16", "cs16", block=65536):
        y = runner(block)
    runner.save("state.npz")            # resume later via load()
"""
from __future__ import annotations

import numpy as np
import torch

from . import trace
from .core import Proc, entry_device
from .utils.checkpoint import load_carry, save_carry

__all__ = ["StreamRunner"]

_NP_DTYPES = {torch.complex64: np.complex64, torch.float32: np.float32,
              torch.complex128: np.complex128, torch.float64: np.float64}


class StreamRunner:
    """Streaming executor for a Proc pipeline on one device or a mesh.

    The proc is moved to ``device`` (the card unless the caller names
    another; without one a CUDA device raises) and its carry is made and
    kept there.  With ``mesh`` (`parallel.stream_mesh`) each block step is
    `parallel.time_shard_apply` over it, as in the JAX package: the
    device is then the mesh's home device, where the carry lives (a
    ``device`` that names another raises ValueError).  Each call takes
    one block, numpy or a tensor, as one contiguous tensor on the device
    (numpy in ``dtype``), runs the step under ``torch.inference_mode``
    and returns the output tensor on the device.

    ``blocks_processed`` counts the calls; ``h2d_bytes`` counts the bytes
    the calls copied from host memory to a card (numpy blocks and CPU
    tensors; a block already on the device copies nothing), for a capture
    loop whose host copy sets its pace.  Both restart at `reset`.  Under
    `torch.profiler` each call records the spans `runtime.call`,
    `runtime.h2d` (around such a copy) and `runtime.step` (`trace`).
    """

    def __init__(self, proc: Proc, batch_shape=(), dtype=torch.complex64,
                 mesh=None, device=None):
        if mesh is None:
            self.device = entry_device("cuda" if device is None else device)
            self.proc = proc.to(self.device)
            self._step = self.proc
        else:
            from .parallel.mesh import _device
            from .parallel.stream import time_shard_apply
            self.device = mesh.home
            if device is not None and _device(device) != self.device:
                raise ValueError(f"device {device!r} is not the mesh's home "
                                 f"device {self.device}")
            self.proc = proc.to(self.device)
            self._step = time_shard_apply(self.proc, mesh)
        self.batch_shape = tuple(batch_shape)
        self.dtype = dtype
        self.blocks_processed = 0
        self.h2d_bytes = 0
        self.carry = self._init(dtype)

    def _init(self, dtype):
        with torch.inference_mode():
            return self.proc.init(batch_shape=self.batch_shape, dtype=dtype,
                                  device=self.device)

    def _block(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(
                x, _NP_DTYPES.get(self.dtype)))
        if x.device.type != "cpu" or self.device.type == "cpu":
            return x.to(self.device).contiguous()
        with trace.span("runtime.h2d"):
            y = x.to(self.device).contiguous()
        self.h2d_bytes += x.numel() * x.element_size()
        return y

    def __call__(self, x):
        with trace.span("runtime.call", self.blocks_processed):
            with torch.inference_mode():
                x = self._block(x)
                with trace.span("runtime.step"):
                    y, self.carry = self._step(self.carry, x)
            self.blocks_processed += 1
        return y

    def run(self, blocks):
        """Iterate a block source; yields output blocks."""
        for x in blocks:
            yield self(x)

    def reset(self, dtype=torch.complex64):
        self.dtype = dtype
        self.carry = self._init(dtype)
        self.blocks_processed = 0
        self.h2d_bytes = 0

    def save(self, path) -> None:
        """Checkpoint the stream state (carry + block counter)."""
        save_carry(path, {"carry": self.carry,
                          "blocks": np.int64(self.blocks_processed)})

    def load(self, path) -> None:
        """Restore a checkpoint written by save() of either package."""
        state = load_carry(path, {"carry": self.carry,
                                  "blocks": np.int64(0)})
        self.carry = state["carry"]
        self.blocks_processed = int(state["blocks"])
