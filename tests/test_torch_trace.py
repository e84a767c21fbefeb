"""The port's span recorder (`liquid_dsp_tpu_torch.trace`) on the CPU.

Spans are recorded exactly while a torch.profiler session records: with
the profiler off a span site reads no clock and keeps nothing.  Under
the profiler a StreamRunner over the headline chain
(planar(kernel_fuse(fuse(chain(nco, firfilt, firfilt, msresamp(0.5))))),
the plain mix_fir_decim on the CPU) records per block the tree
runtime.call > runtime.step > (mix_fir_decim.launch, mix_fir_decim.carry),
every span carrying the block's number, and nothing of it reaches the
profiler's own events.  Self times add up to the call; spans of two
threads nest apart; the ring keeps the newest RING spans; `align` finds
the offset between two clocks from spans nested one in another.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_port  # noqa: F401  (two torch threads a worker)
from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse, planar, trace
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
from liquid_dsp_tpu_torch.ops.fir import firfilt
from liquid_dsp_tpu_torch.ops.nco import nco
from liquid_dsp_tpu_torch.ops.resample import msresamp
from liquid_dsp_tpu_torch.runtime import StreamRunner

B, T = 8, 8192
TREE = {"runtime.call": None, "runtime.step": "runtime.call",
        "mix_fir_decim.launch": "runtime.step",
        "mix_fir_decim.carry": "runtime.step"}


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


def _runner():
    proc = planar(kernel_fuse(fuse(chain(
        nco(dphi=0.125, direction="down"),
        firfilt(firdes_kaiser(64, 0.2, 60.0)),
        firfilt(firdes_kaiser(57, 0.3, 60.0)), msresamp(0.5)))))
    return StreamRunner(proc, batch_shape=(B,), device="cpu")


def _blocks(n):
    g = torch.Generator().manual_seed(5)
    return [torch.randn(2, B, T, generator=g) for _ in range(n)]


def test_nothing_recorded_with_the_profiler_off(monkeypatch):
    clock = []

    class Clock:
        @staticmethod
        def perf_counter_ns():
            clock.append(1)
            return 0

    monkeypatch.setattr(trace, "time", Clock)
    r = _runner()
    for x in _blocks(3):
        r(x)
    assert r.blocks_processed == 3
    assert trace.spans() == [] and clock == []
    assert trace.span("runtime.call") is trace.span("runtime.step")


def test_span_tree_of_each_block():
    r = _runner()
    xs = _blocks(4)
    r(xs[0])                                    # outside the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for x in xs[1:]:
            r(x)
    got = trace.spans()
    assert len(got) == 3 * len(TREE)
    by_id = {s.id: s for s in got}
    for k, block in enumerate((1, 2, 3)):
        tree = got[k * len(TREE):(k + 1) * len(TREE)]
        assert {s.name for s in tree} == set(TREE)
        assert all(s.block == block for s in tree)
        for s in tree:
            parent = by_id.get(s.parent)
            assert (parent.name if parent else None) == TREE[s.name]
            if parent:
                assert parent.start_ns <= s.start_ns <= s.end_ns \
                    <= parent.end_ns
    # the program's spans stay off the profiler's timeline
    names = {ev.name for ev in prof.events()}
    assert not names & set(TREE) and "runtime.h2d" not in names
    assert r.h2d_bytes == 0


def test_self_times_add_up_to_the_call():
    r = _runner()
    with profile(activities=[ProfilerActivity.CPU]):
        for x in _blocks(3):
            r(x)
    group = trace.last_calls(3)
    own = trace.self_ns(group)
    for call in (s for s in group if s.name == "runtime.call"):
        tree = [s for s in group if s.block == call.block]
        assert sum(own[s.id] for s in tree) == call.end_ns - call.start_ns
        assert all(v >= 0 for v in (own[s.id] for s in tree))
    parts = (trace.mean_us(group, "runtime.call", own=True)
             + trace.mean_us(group, "runtime.step", own=True)
             + trace.mean_us(group, "mix_fir_decim.launch")
             + trace.mean_us(group, "mix_fir_decim.carry"))
    assert parts == pytest.approx(trace.mean_us(group, "runtime.call"),
                                  rel=1e-9)
    assert trace.last_calls(4) is None
    assert trace.mean_us(group, "runtime.h2d") is None


def test_the_ring_keeps_the_newest_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(trace.RING + 1000):
            with trace.span("s", block=k):
                pass
    got = trace.spans()
    assert len(got) == trace.RING
    assert [s.block for s in got[:2]] == [1000, 1001]
    assert got[-1].block == trace.RING + 999


def test_each_threads_spans_nest_apart():
    # two threads' calls overlap in time: a span's parent is of its thread
    import threading
    both = threading.Barrier(2)

    def work(k):
        with trace.span("runtime.call", block=k):
            both.wait()
            with trace.span("runtime.step"):
                both.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        ts = [threading.Thread(target=work, args=(k,)) for k in (10, 20)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    got = trace.spans()
    by_id = {s.id: s for s in got}
    steps = [s for s in got if s.name == "runtime.step"]
    assert len(got) == 4 and sorted(s.block for s in steps) == [10, 20]
    for s in steps:
        assert by_id[s.parent].block == s.block
    assert [s.id for s in got] == list(range(4))


def test_h2d_bytes_stay_zero_on_the_cpu():
    r = StreamRunner(chain(nco(dphi=0.1), firfilt(firdes_kaiser(32, 0.2,
                                                                60.0))),
                     batch_shape=(4,), device="cpu")
    x = np.ones((4, 1024), np.complex64)
    with profile(activities=[ProfilerActivity.CPU]):
        r(x)
        r(torch.from_numpy(x))
    assert r.h2d_bytes == 0 and r.blocks_processed == 2
    assert "runtime.h2d" not in {s.name for s in trace.spans()}
    r.reset()
    assert r.h2d_bytes == 0 and r.blocks_processed == 0


def test_align_finds_the_offset():
    rng = np.random.default_rng(3)
    c = 1234.5678
    calls, enq = [], []
    for k in range(50):
        a, b = rng.uniform(0.5, 3.0, 2)
        if k == 7:
            a = 0.5
        if k == 31:
            b = 0.5
        calls.append((10.0 * k, 10.0 * k + 4.0))
        enq.append((10.0 * k + c - a, 10.0 * k + 4.0 + c + b))
    mid, half = trace.align(calls, enq)
    assert mid == pytest.approx(c) and half == pytest.approx(0.5)
    assert trace.align(calls, enq[1:]) is None
    assert trace.align([], []) is None
    # a call longer than its enclosing span: no offset nests it
    enq[9] = (enq[9][0], enq[9][0] + 3.0)
    assert trace.align(calls, enq) is None


def test_innermost_open_span():
    S = trace.Span
    group = [S("runtime.call", 0, 100, 0, None, 0),
             S("runtime.step", 10, 90, 1, 0, 0),
             S("mix_fir_decim.launch", 20, 40, 2, 1, 0)]
    assert trace.innermost(group, 30).name == "mix_fir_decim.launch"
    assert trace.innermost(group, 40).name == "runtime.step"
    assert trace.innermost(group, 5).name == "runtime.call"
    assert trace.innermost(group, 100) is None
