"""Device meshes for sharded stream processing, in one process
(`liquid_dsp_tpu/parallel/mesh.py`).

The reference is single-threaded C with no parallel axes (SURVEY.md §2.12).
The JAX package's mesh has two axes:

  * "ch": data parallelism over independent channels;
  * "t":  sequence parallelism over contiguous time blocks, with filter-tail
    halos passed to the right time neighbour.

Here a mesh is an array of ``torch.device`` driven by one Python process,
as the JAX package drives its devices from one controller.  A halo is a
copy of the left neighbour's tail to the shard's device (none when both
shards lie on one device); what JAX gathers with a collective is gathered
onto the mesh's first device, the home device, where the carry lives.
A device may repeat: its shards then run one after another on it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import entry_device

__all__ = ["Mesh", "stream_mesh", "cuda_devices", "move"]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def move(t, dev, dtype=None, copy: bool = False):
    """t on ``dev`` (in ``dtype``), the copy queued without waiting where
    the destination is a card.  A copy to the host waits for its data:
    a non-blocking copy from a card to the host returns before the data
    has arrived, and host code that reads it next would read it
    unfinished."""
    dev = torch.device(dev)
    return t.to(dev, dtype, non_blocking=dev.type != "cpu", copy=copy)


class Mesh:
    """An array of ``torch.device`` with named axes (the analog of
    ``jax.sharding.Mesh``): ``devices`` is the object array, ``shape`` a
    dict from axis name to size, ``home`` the first device."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of {arr.ndim} axes needs as many "
                             f"names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.vectorize(_device, otypes=[object])(arr)
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        return self.devices.flat[0]

    def grid(self, time_axis: str, channel_axes=()) -> list:
        """The devices as [channel group][time shard]: the groups run over
        the product of ``channel_axes`` (the first name the slowest), the
        time shards along ``time_axis``; every other axis is a replica
        axis, of which the first index is taken."""
        axes = list(channel_axes) + [time_axis]
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        arr = arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr
        return arr.reshape(-1, arr.shape[-1]).tolist()

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def cuda_devices() -> list:
    """Every CUDA device of this process; RuntimeError naming the card when
    there is none (`core.entry_device`)."""
    entry_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def stream_mesh(n_time: int = 1, n_channel: int = 1, devices=None) -> Mesh:
    """A ("ch", "t") mesh of n_channel x n_time devices, time neighbours
    adjacent in device order.

    devices: a list of devices (``torch.device`` or names), the same
    device more than once if need be (its shards then run one after
    another on it); None takes every CUDA device and raises without a
    card.  n_time * n_channel must equal the number of devices."""
    devices = list(devices) if devices is not None else cuda_devices()
    if n_time * n_channel != len(devices):
        raise ValueError(
            f"mesh {n_channel}x{n_time} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_channel, n_time), ("ch", "t"))
