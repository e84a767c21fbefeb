"""The program's spans: where a block's host time goes inside the port.

A span site is ``with trace.span("layer.what"):`` at a layer boundary of
the block step (`runtime.StreamRunner.__call__`, the step it dispatches,
a kernel's launch and carry update).  A span is kept as its name, its
start and end (`time.perf_counter_ns`), its block where the site names
one (the `StreamRunner`'s `blocks_processed` at the call's entry) and its
thread: two clock reads and one append at the site, nothing more.  The
readers rebuild the rest (`spans`): a span's parent is the innermost span
of its thread that encloses it, and a span without a block takes its
parent's, so that the spans of one block share an identifier.

Spans are recorded exactly while a `torch.profiler` session records (the
flag torch keeps for fast Python checks,
`torch.autograd.profiler._is_profiler_enabled`), and only then: with the
profiler off a span site costs that flag read and a shared do-nothing
context, no clock read and no object.  They are kept in memory, the last
`RING` of them, and read with `spans()`.  They are not emitted to the
profiler (no `record_function`, no NVTX): a range around a launch would be
mirrored on the device's timeline as an annotation and counted with the
device's work.  `align` puts them on the profiler trace's clock instead.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        for block in blocks:
            runner(block)
    calls = trace.last_calls(100)           # the last 100 blocks' spans
    call_us = trace.mean_us(calls, "runtime.call")
    dispatch_us = trace.mean_us(calls, "runtime.step", own=True)
"""
from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

from torch.autograd import profiler as _profiler

__all__ = ["RING", "Span", "span", "spans", "clear", "last_calls",
           "self_ns", "mean_us", "align", "innermost"]

RING = 65536    # spans kept: about 13,000 blocks of five spans


class Span(NamedTuple):
    """One closed span; times in ns of `time.perf_counter_ns`.  `id` is
    the span's place in the order spans opened, within one `spans()`;
    `parent` is the enclosing span's id."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    block: Optional[int]


_ring: deque = deque(maxlen=RING)   # (name, start, end, block, thread)


class _Recording:
    __slots__ = ("name", "block", "start")

    def __init__(self, name, block):
        self.name, self.block = name, block

    def __enter__(self):
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        _ring.append((self.name, self.start, time.perf_counter_ns(),
                      self.block, threading.get_ident()))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, block: Optional[int] = None):
    """A context that records the span `name` while the profiler records,
    and does nothing otherwise.  `block` names the block of a root span;
    a span inside another takes its block."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, block)


def spans() -> list:
    """Every span kept, in the order they opened, with its parent and
    block rebuilt from how the spans of each thread nest."""
    # by start, an enclosing span before those inside it: the longer
    # first, and where two coincide the one closed (kept) later
    kept = sorted(enumerate(_ring),
                  key=lambda ks: (ks[1][1], -ks[1][2], -ks[0]))
    ids = {k: i for i, (k, _) in enumerate(kept)}
    out, stacks = [], {}
    for k, (name, t0, t1, block, thread) in kept:
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1].end_ns < t1:
            stack.pop()
        top = stack[-1] if stack else None
        s = Span(name, t0, t1, ids[k], top.id if top else None,
                 block if block is not None or top is None else top.block)
        stack.append(s)
        out.append(s)
    return out


def clear() -> None:
    _ring.clear()


def last_calls(n: int) -> Optional[list]:
    """The spans of the last n runner calls: the last n `runtime.call`
    spans, with every span inside them, in the order they opened.  None
    where fewer than n calls are kept."""
    kept = spans()
    roots = [s.id for s in kept
             if s.name == "runtime.call" and s.parent is None]
    if n <= 0 or len(roots) < n:
        return None
    ids = set(roots[-n:])
    out = []
    for s in kept:
        if s.id in ids or s.parent in ids:
            ids.add(s.id)
            out.append(s)
    return out


def self_ns(group: list) -> dict:
    """{id: self time in ns} of each span of `group`: its duration less
    the part of it that its children in `group` cover."""
    kids: dict = {}
    for s in group:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    out = {}
    for s in group:
        covered, t = 0, s.start_ns
        for c in sorted(kids.get(s.id, ()), key=lambda c: c.start_ns):
            a, b = max(c.start_ns, t), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                t = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def mean_us(group: Optional[list], name: str, own: bool = False):
    """The mean duration in us of the spans named `name` in `group` (their
    self time with `own`), or None where there are none."""
    if not group:
        return None
    hits = [s for s in group if s.name == name]
    if not hits:
        return None
    own_ns = self_ns(group) if own else None
    return statistics.fmean(
        (own_ns[s.id] if own else s.end_ns - s.start_ns) for s in hits) / 1e3


def align(program_calls: list, bench_enqueues: list):
    """The offset c (trace time = program time + c) that puts each of the
    program's calls inside the span of the other clock that encloses it,
    one to one and in order: `program_calls` and `bench_enqueues` are
    [(start, end)] in one unit, the calls on the program's clock.  c lies
    between max(enqueue start - call start) and min(enqueue end - call
    end); returns (midpoint, half the interval), or None where the counts
    differ or no c nests every pair."""
    if not program_calls or len(program_calls) != len(bench_enqueues):
        return None
    lo = max(e0 - c0 for (c0, _), (e0, _) in zip(program_calls,
                                                   bench_enqueues))
    hi = min(e1 - c1 for (_, c1), (_, e1) in zip(program_calls,
                                                   bench_enqueues))
    if lo > hi:
        return None
    return (lo + hi) / 2, (hi - lo) / 2


def innermost(group: list, t_ns: int) -> Optional[Span]:
    """The innermost span of `group` open at t_ns (start <= t_ns < end),
    or None where none is."""
    open_ = [s for s in group if s.start_ns <= t_ns < s.end_ns]
    return max(open_, key=lambda s: (s.start_ns, s.id)) if open_ else None
