"""Block-level debug tap points (`liquid_dsp_tpu/debug.py`): the runtime
analog of the reference's compile-time DEBUG_* machinery (reference
src/framing/src/framesync64.c:38-41 DEBUG_FRAMESYNC64 and the debug_x
windows :116-118, which dump internal state to Octave .m files when
compiled in).

Here the taps are runtime-gated and store numpy arrays:

    from liquid_dsp_tpu_torch import debug
    with debug.capture() as store:
        sync.execute(samples)
    store["stream_rx.seg_peak"]  # list of per-call arrays
    debug.dump("rx_debug.npz")   # or persist for plotting

`tap(name, value)` returns at once, and synchronizes nothing, unless a
capture() is active; inside one it copies the tensor to the host (a
sync on the card).  There is no compiled program to re-trace: a tap
takes effect on the next call.  A receiver that runs a batch of channels
in one call taps the whole batch in one entry.

Taps in the port: ``agc.gain`` (`ops/agc.py`), ``stream_rx.seg_peak``,
``stream_rx.dphi`` and ``stream_rx.region_syms`` (`framing/stream_rx.py`)
and ``ofdm.metric`` (`multichannel/ofdm.py`).
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np

__all__ = ["tap", "capture", "enabled", "dump", "store"]

_ENABLED = False
_STORE: dict[str, list] = {}


def enabled() -> bool:
    """True while a capture() context is active."""
    return _ENABLED


def tap(name: str, value) -> None:
    """Record a named tensor (no-op unless a capture() is active)."""
    if not _ENABLED:
        return
    _STORE.setdefault(name, []).append(value.detach().cpu().numpy())


def store() -> dict:
    """The current capture store: name -> list of per-call arrays."""
    return _STORE


@contextmanager
def capture():
    """Enable tap points for the duration of the context; yields the
    store dict (name -> list of arrays, one entry per tapped call)."""
    global _ENABLED
    _STORE.clear()
    _ENABLED = True
    try:
        yield _STORE
    finally:
        _ENABLED = False


def dump(path: str) -> None:
    """Persist the capture store as an .npz (stacked per tap name)."""
    arrs = {}
    for k, v in _STORE.items():
        key = k.replace(".", "_")
        try:
            arrs[key] = np.stack(v)
        except ValueError:      # ragged across calls: save individually
            for i, a in enumerate(v):
                arrs[f"{key}_{i}"] = a
    np.savez(path, **arrs)
