"""Time-sharded streaming receiver: the SURVEY §2.12 sequence-parallel axis
applied to the detect-everywhere framer (`liquid_dsp_tpu/parallel/rx.py`;
reference analog framesync64.c:241-269, whose per-sample state machine
cannot split the time axis at all).

The block [..., T] splits into n contiguous shards of T_local.  Each shard
runs the single-device receiver (framing/stream_rx.py) on a local buffer
whose history is the (hist + Lb)-sample tail of its LEFT neighbour, copied
to its device; the Lb extra samples stand for the matched filter's front
zero pad mid-stream.  Shard 0 keeps the stream-head semantics and takes
the inter-block carry.

  * emission: each shard emits the candidates starting in its local
    [0, T_local) buffer positions.  These windows tile absolute time, so
    every frame decodes on exactly ONE shard, and the shard's history and
    lookahead cover the whole frame.
  * detection: the segment grid is absolute (T_local % 256 == 0); the
    first segment's local-peak test takes the left neighbour's last owned
    segment peak (`_seg_peak_at`, from the neighbour's own buffer).
  * suppression: the greedy in-order fold runs once, on the home device,
    over every shard's (candidate, position) in shard order, so the keeps
    and the next block's watermark are the single-device receiver's.

The host runs the three steps of `_detect_refine` over the shards in turn:
every shard's segment detection, the one fold, every shard's refinement
and sync.  Per block step and shard (hist + Lb) complex samples and one
float a row cross to the right neighbour, and ~2 (T_local/256 + 1) words a
row go to the home device and back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framing.frame64 import _frame64_block, _stream_cfg
from ..framing.stream_rx import (_DET_HOP, StreamRxConfig,
                                 _advance_watermark, _detect_segments,
                                 _refine, _seg_peak_at, _suppress,
                                 batched_apply, preamble_stream)
from .mesh import Mesh, move
from .stream import replicas

__all__ = ["preamble_stream_time_sharded", "framesync64_time_sharded"]


def preamble_stream_time_sharded(block_len: int, cfg: StreamRxConfig,
                                 mesh: Mesh, time_axis: str = "t",
                                 threshold: float = 0.5,
                                 max_frames_per_shard: int = 4,
                                 hist: int | None = None):
    """(init, step) of the time-sharded preamble-sync receiver.

    step(carry, x[..., T]) -> (StreamRxBlock with n_shards * P candidate
    slots, carry'): leading axes are independent channels (flattened as
    `batched_apply` does), the last is split over the mesh's
    ``time_axis``.  The carry lives on the mesh's home device, the output
    is assembled on x's device.  Decodes the frames `preamble_stream(T,
    ...)` decodes on one device; the slot LAYOUT differs: a group of P
    slots per shard, in shard order (compact on ``valid``).  A shard
    that keeps more than P candidates drops the rest, as one device with
    ``max_frames`` P would."""
    return _time_sharded(block_len, cfg, mesh, time_axis, threshold,
                         max_frames_per_shard, hist, lambda out, d: out)


def _time_sharded(block_len, cfg, mesh, time_axis, threshold,
                  max_frames_per_shard, hist, finish):
    """`preamble_stream_time_sharded`, each shard's StreamRxBlock passed
    through ``finish(out, device)`` on its own device before the shards'
    results (NamedTuples of [B, P, ...] fields) are joined on x's
    device."""
    n = int(mesh.shape[time_axis])
    T = int(block_len)
    if T % n:
        raise ValueError("block_len must divide by the mesh time axis")
    Tl = T // n
    if Tl % _DET_HOP:
        raise ValueError(
            f"per-shard block must be a multiple of {_DET_HOP}")
    # the history floor: preamble_stream refuses a history too short for
    # the frame region
    core = preamble_stream(Tl, cfg, threshold, int(max_frames_per_shard),
                           hist=hist)
    hist, Lb = core.hist, core.Lb
    halo = hist + Lb
    if Tl < halo:
        raise ValueError(
            f"per-shard block {Tl} shorter than the history halo {halo};"
            " use a longer block or fewer time shards")
    devs = mesh.grid(time_axis)[0]
    reps = replicas(core, devs)
    home = mesh.home

    def init(batch_shape=(), dtype=torch.complex64):
        return core.init(batch_shape, dtype, device=home)

    def step_2d(carry, x):
        xs = [move(x[:, i * Tl:(i + 1) * Tl], d, torch.complex64)
              for i, d in enumerate(devs)]
        bufs, exts, segs = [], [], []
        prev_pk = None
        for i, (xi, d) in enumerate(zip(xs, devs)):
            r = reps[d]
            if i == 0:
                hist_in, ext = move(carry["buf"], d), None
            else:
                left = move(xs[i - 1][:, Tl - halo:], d)
                hist_in = left[:, Lb:]
                ext = torch.stack([left[:, :Lb].real, left[:, :Lb].imag],
                                  dim=1)                  # [B, 2, Lb]
            buf = torch.cat([hist_in, xi], dim=-1)       # [B, hist + Tl]
            dc = r._dc()
            segs.append(_detect_segments(
                buf, dc, r.threshold, Tl, r.starts,
                None if prev_pk is None else move(prev_pk, d)))
            # this shard's last owned segment: the right neighbour's
            # "segment before the first"
            prev_pk = _seg_peak_at(buf, dc, Tl - _DET_HOP)
            bufs.append(buf)
            exts.append(ext)

        # one greedy fold over every shard's segments, in shard order, in
        # shard 0's buffer coordinates
        cand = torch.cat([move(s["cand"], home) for s in segs], dim=1)
        n0 = torch.cat([move(s["n0_seg"] + i * Tl, home)
                        for i, s in enumerate(segs)], dim=1)
        keep = _suppress(carry["last_end"], cand, n0, core.span)
        keeps = keep.split(segs[0]["cand"].shape[1], dim=1)

        outs = []
        for i, d in enumerate(devs):
            r = reps[d]
            det = _refine(bufs[i], segs[i], move(keeps[i], d),
                          r._dc(), r.P, Tl, front_pad=Lb, win_len=r.win_len,
                          left_ext=exts[i])
            base = move(carry["base"], d) + i * Tl
            outs.append(finish(r._sync(bufs[i], det, base), d))
        out = type(outs[0])(*(
            torch.cat([move(f, x.device) for f in fields], dim=1)
            for fields in zip(*outs)))
        new_carry = {
            # the block's last hist samples live on the LAST shard
            "buf": move(bufs[-1][:, Tl:], home, copy=True),
            "base": carry["base"] + T,
            "last_end": _advance_watermark(
                carry["last_end"], {"cand": keep, "n0_seg": n0},
                core.span, T),
        }
        return out, new_carry

    return init, batched_apply(step_2d, T)


def framesync64_time_sharded(block_len: int, mesh: Mesh,
                             time_axis: str = "t",
                             threshold: float = 0.5,
                             max_frames_per_shard: int = 4):
    """Time-sharded streaming frame64 receiver: (init, step) with
    step(carry, x[..., T]) -> (Frame64Block over n * P slots, carry').
    The frames `framesync64_stream` decodes on one device; see
    `preamble_stream_time_sharded`.  Each shard takes its payload
    statistics on its own device."""
    data_idx = torch.from_numpy(
        np.nonzero(np.arange(630) % 21 != 0)[0].astype(np.int64))
    on_device = {}

    def finish(out, dev):
        if dev not in on_device:
            on_device[dev] = data_idx.to(dev)
        return _frame64_block(out, on_device[dev])

    return _time_sharded(block_len, _stream_cfg(), mesh, time_axis,
                         threshold, max_frames_per_shard, None, finish)
