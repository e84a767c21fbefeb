"""The readers of the program's spans on a real CPU profile of the tiny
`ddc64.stream` loop: the harness's own Loop with its `bench.*` ranges on,
a `profile.Trace` built from those ranges with device intervals made up
around them.  Each reader gives a finite value; the program's calls align
with the harness's enqueues; an idle gap planted inside the kernel's
launch span counts as the program's, one planted in the result's event
outside it; and without the program's spans every reader gives None."""
import math
import sys
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile as torch_profile

from dspbench.harness import main as hm
from dspbench.harness import profile
from dspbench.harness.loop import Loop
from dspbench.tests.tiny import TINY

READERS = ("runner_call_us", "runner_self_us", "step_dispatch_us",
           "mix_fir_decim.launch_us", "mix_fir_decim.carry_us",
           "device_idle_in_program_pct")
N = 6


@pytest.fixture(scope="module")
def traced():
    """(the program's ring, bench spans) of N looped blocks."""
    from dspbench.systems import ddc
    from liquid_dsp_tpu_torch import trace
    cfg = hm.load_named("configs", "ddc64")
    traffic = dict(hm.load_named("traffic", "ddc64.stream"),
                   **TINY["ddc64.stream"])
    sysm = ddc.build(torch, cfg, traffic, 2**33 + 5, torch.device("cpu"))
    loop = Loop(sysm, torch.profiler.record_function)
    loop.run(n=2)
    trace.clear()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run(n=N, spans=True)
    bench = [(ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
             for ev in prof.events() if ev.name in profile.SPANS]
    raw = list(trace._ring)
    trace.clear()
    return raw, bench


def _ctx(bench, gaps):
    """A Context whose trace keeps the device busy over the whole window
    but for `gaps` [(start, end)], trace clock."""
    a, b = profile.window(profile.Trace(N, [], bench, 0))
    dev, t = [], a
    for g0, g1 in sorted(gaps):
        dev.append(("void mix_fir_decim_kernel<float>", t, g0))
        t = g1
    dev.append(("void mix_fir_decim_kernel<float>", t, b))
    tr = profile.Trace(N, dev, bench, 0)
    return hm.Context(tr, [1e-3] * N, [2e-3] * N, 1.0, {})


def _restore(raw, monkeypatch):
    from liquid_dsp_tpu_torch import trace
    monkeypatch.setattr(trace, "_ring", deque(raw, maxlen=trace.RING))
    return trace


def test_calls_align_with_the_enqueues(traced, monkeypatch):
    group, bench = traced
    trace = _restore(group, monkeypatch)
    calls = trace.last_calls(N)
    assert calls is not None and {s.block for s in calls} == set(range(2, 8))
    got = trace.align(
        [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in calls
         if s.name == "runtime.call"],
        [(x, y) for name, x, y in bench if name == "bench.enqueue"])
    assert got is not None and got[1] < 50e-6


def test_readers_read_the_spans(traced, monkeypatch, capsys):
    group, bench = traced
    trace = _restore(group, monkeypatch)
    group = trace.spans()
    calls = [s for s in group if s.name == "runtime.call"]
    enq = [(x, y) for name, x, y in bench if name == "bench.enqueue"]
    c, _ = trace.align([(s.start_ns * 1e-9, s.end_ns * 1e-9)
                        for s in calls], enq)
    launch = [s for s in group if s.name == "mix_fir_decim.launch"][2]
    t_launch = (launch.start_ns + launch.end_ns) / 2e9 + c
    copy = [(x, y) for name, x, y in bench if name == "bench.result_copy"][3]
    t_copy = (copy[0] + copy[1]) / 2
    ctx = _ctx(bench, [(t_launch, t_launch + 1e-4),
                              (t_copy, t_copy + 3e-4)])
    got = {name: hm.load_reader(name)(ctx) for name in READERS}
    assert all(v is not None and math.isfinite(v) and v >= 0
               for v in got.values()), got
    assert got["device_idle_in_program_pct"] == pytest.approx(25.0,
                                                              rel=1e-6)
    parts = (got["runner_self_us"] + got["step_dispatch_us"]
             + got["mix_fir_decim.launch_us"] + got["mix_fir_decim.carry_us"])
    assert parts == pytest.approx(got["runner_call_us"], rel=1e-9)
    err = capsys.readouterr().err
    assert "mix_fir_decim.launch 0.1000" in err
    assert "outside the program 0.3000" in err
    assert f"bench.enqueue in the traced stretch, {N} blocks" in err


def test_readers_without_the_programs_spans(traced, monkeypatch):
    group, bench = traced
    ctx = _ctx(bench, [])
    trace = _restore([], monkeypatch)
    assert trace.last_calls(N) is None
    assert all(hm.load_reader(name)(ctx) is None for name in READERS)
    # no trace at all, as in a run without --trace 1
    _restore(group, monkeypatch)
    none = hm.Context(None, [1e-3], [2e-3], 1.0, {})
    assert all(hm.load_reader(name)(none) is None for name in READERS)
    # a program without the recorder
    import liquid_dsp_tpu_torch
    monkeypatch.delattr(liquid_dsp_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "liquid_dsp_tpu_torch.trace", None)
    assert all(hm.load_reader(name)(ctx) is None for name in READERS)
