"""Stage pipelining across devices (`liquid_dsp_tpu/parallel/pipeline.py`).

The reference composes DSP objects sequentially in one thread (SURVEY.md
§2.12: "pipeline across chain stages" has no reference analog).  Here each
stage of a chain lives on its OWN device, its buffers and carry there, and
a block flows stage to stage by device-to-device copies.

Concurrency: CUDA launches are asynchronous and each device runs its own
stream, so a host loop that enqueues block i+1 into stage 0 while block i
sits in stage 1 overlaps the stages on distinct cards.  Stages on one
device queue on its stream.  The semantics are those of `chain(*procs)` on
one device: the pipeline only changes WHERE each stage runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import entry_tensor
from .mesh import cuda_devices, move

__all__ = ["StagePipeline"]


class StagePipeline:
    """Run a chain of Procs as a pipeline across devices.

    procs: the stages (any rates); devices: one device per stage, cycled
    if there are fewer than stages; None takes the CUDA devices and raises
    without a card.  Each stage is moved to its device (the pipeline
    moves the modules it is given) and its carry made there.

    feed(block) pushes one block through all stages and returns the last
    stage's output on its device (the launches are queued, not waited
    for); run(blocks) feeds a [N, ..., T] stack and returns the outputs
    stacked as numpy.  reset() makes the carries anew.
    """

    def __init__(self, procs, devices=None, batch_shape=(),
                 dtype=torch.complex64):
        self.procs = list(procs)
        devs = [torch.device(d) for d in (devices if devices is not None
                                          else cuda_devices())]
        if not devs:
            raise ValueError("no devices")
        self._devs = [devs[i % len(devs)] for i in range(len(self.procs))]
        self._batch_shape = tuple(batch_shape)
        self._dtype = dtype
        for p, d in zip(self.procs, self._devs):
            p.to(d)
        self.reset()

    def reset(self):
        self._carries = [
            p.init(batch_shape=self._batch_shape, dtype=self._dtype,
                   device=d) for p, d in zip(self.procs, self._devs)]

    def feed(self, block):
        """Push one block (a tensor, or a host array, which goes to the
        first stage's device) through the pipeline."""
        y = entry_tensor(block, self._devs[0])
        for s, (p, d) in enumerate(zip(self.procs, self._devs)):
            y = move(y, d)                          # inter-stage transfer
            y, self._carries[s] = p(self._carries[s], y)
        return y

    def run(self, blocks):
        """Process a [N, ..., T] stack of blocks; returns the stacked
        outputs (waits for them).  Block i+1 enters stage 0 while block i
        is downstream."""
        outs = [self.feed(b) for b in blocks]
        return np.stack([o.cpu().numpy() for o in outs])
