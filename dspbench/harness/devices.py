"""What the harness asks of a device: a marker in its stream that the
host can wait on.  On the card a CUDA event; on the CPU, which the
harness's own tests drive, the work is done when the call returns."""
from __future__ import annotations

__all__ = ["event"]


class _Done:
    def synchronize(self):
        pass


def event(torch, device):
    """A marker after all work queued so far on `device`'s stream."""
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev
