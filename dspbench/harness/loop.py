"""The closed loop that feeds a system blocks of its stream: at most two
blocks in flight, as a double-buffered receiver runs.  Block k+1 is
handed to the runner only once block k-1's results are ready where its
consumer uses them.

Each block records, on the host clock, the time from handing it to the
runner until its results were seen ready (its latency) and the time the
runner's call took (the enqueue).  With `spans` on, the calls are also
wrapped in torch.profiler ranges named after `profile.SPANS`, so that a
device trace can say what the host was doing in each idle gap.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

__all__ = ["Loop"]


class Loop:
    """Feeds `system` its global blocks g0, g0+1, ... (see run)."""

    def __init__(self, system, record_function=None):
        self.system = system
        self._rf = record_function
        self.next_block = 0

    def _span(self, name, on):
        return self._rf(name) if on else contextlib.nullcontext()

    def run(self, n=None, seconds=None, spans=False):
        """Run n blocks, or blocks until `seconds` have passed since the
        first was handed over, then wait for every block in flight.
        Returns (first hand-over, last ready, [latency s], [enqueue s]),
        host clock; each block's consumer seconds go to `consume_s`."""
        sysm, pending = self.system, deque()
        lat, enq = [], []
        self.consume_s = []
        t_first = t_last = time.perf_counter()

        def finish():
            g, ts, handle = pending.popleft()
            nonlocal t_last
            with self._span("bench.consumer_wait", spans):
                sysm.wait(handle)
            t_last = time.perf_counter()
            lat.append(t_last - ts)
            with self._span("bench.consume", spans):
                sysm.consume(g, handle)
            self.consume_s.append(time.perf_counter() - t_last)

        count = 0
        while True:
            now = time.perf_counter()
            if n is not None and count >= n:
                break
            if seconds is not None and count and now - t_first >= seconds:
                break
            g = self.next_block
            x = sysm.block(g)
            ts = time.perf_counter()
            if count == 0:
                t_first = ts
            with self._span("bench.enqueue", spans):
                out = sysm.runner(x)
            enq.append(time.perf_counter() - ts)
            with self._span("bench.result_copy", spans):
                handle = sysm.after(g, out)
            pending.append((g, ts, handle))
            self.next_block += 1
            count += 1
            if len(pending) == 2:
                finish()
        while pending:
            finish()
        return t_first, t_last, lat, enq
