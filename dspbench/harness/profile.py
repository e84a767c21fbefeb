"""The device trace of a few blocks: torch.profiler on the card, with the
retake logic of the port's smoke script (`chip_smoke.py:device_profile`,
`PROFILE_MARGINS_S`) copied here so that the yardstick does not move.

The card's profiler now and then loses device events, in spells of a few
seconds late in a long process: some of a trace's, or all of a short
one's.  Every block launches the same work, so a trace whose count of
device events is zero or no multiple of the blocks is taken again with a
wider margin of idle host time at each end, up to len(MARGINS_S) takes;
each retake is reported on standard error.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, NamedTuple

__all__ = ["MARGINS_S", "Trace", "take_trace", "SPANS"]

# idle host time at each end of a trace, one a take
MARGINS_S = (0.02, 0.25, 1.0, 3.0, 3.0, 3.0)
# the benchmark's own host spans around the calls into each layer
SPANS = ("bench.enqueue", "bench.result_copy", "bench.consumer_wait",
         "bench.consume")


class Trace(NamedTuple):
    """One profiled stretch of `blocks` blocks, times in seconds on the
    profiler's clock: device operations (name, start, end) and the
    benchmark's host spans (name, start, end)."""
    blocks: int
    device: list
    spans: list
    retakes: int


def take_trace(torch, run: Callable[[int], None], n: int) -> Trace:
    """Profile `run(n)` (n blocks through the loop with the host spans
    on).  A first profiler cycle is the warm-up, traced and dropped."""
    from torch.profiler import ProfilerActivity, profile, schedule
    dev, spans, events = [], [], 0
    for take, margin in enumerate(MARGINS_S):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            run(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(margin)
            run(n)
            torch.cuda.synchronize()
            time.sleep(margin)
        dev, spans = [], []
        for ev in prof.events():
            t0 = ev.time_range.start / 1e6
            t1 = ev.time_range.end / 1e6
            if ev.name.startswith("ProfilerStep"):
                continue
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                # a host span mirrored on the device is an annotation
                if not ev.name.startswith("bench."):
                    dev.append((ev.name, t0, t1))
            elif ev.name in SPANS:
                spans.append((ev.name, t0, t1))
        events = len(dev)
        if events and events % n == 0:
            return Trace(n, dev, spans, take)
        print(f"profile: {events} device events in a trace of {n} blocks "
              f"at a margin of {margin} s", file=sys.stderr, flush=True)
    return Trace(n, dev, spans, len(MARGINS_S))


def busy_intervals(trace: Trace):
    """The union of the device operations' intervals, sorted."""
    out = []
    for _, a, b in sorted((e for e in trace.device), key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def window(trace: Trace) -> tuple[float, float]:
    """The traced window: from the first block's enqueue to the end of
    the last block's wait for its results."""
    starts = [a for name, a, _ in trace.spans if name == "bench.enqueue"]
    ends = [b for _, _, b in trace.spans]
    return min(starts), max(ends)


def busy_s(trace: Trace) -> float:
    a, b = window(trace)
    return sum(max(0.0, min(e, b) - max(s, a))
               for s, e in busy_intervals(trace))


def idle_gaps(trace: Trace):
    """[(label, seconds)] of each stretch of the window with no device
    operation, labelled by the innermost host span that was open when it
    began ("host" where none was)."""
    a, b = window(trace)
    gaps, t = [], a
    for s, e in busy_intervals(trace) + [[b, b]]:
        s, e = max(s, a), min(e, b)
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    out = []
    for g0, g1 in gaps:
        open_ = [(s1 - s0, name) for name, s0, s1 in trace.spans
                 if s0 <= g0 < s1]
        out.append((min(open_)[1][len("bench."):] if open_ else "host",
                    g1 - g0))
    return out
