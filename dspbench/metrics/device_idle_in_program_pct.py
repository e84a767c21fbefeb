"""device_idle_in_program_pct: of the traced stretch's idle device
seconds (the gaps of `profile.idle_gaps`), the share whose gap began
while a span of the program (`liquid_dsp_tpu_torch.trace`) was open.
The program's spans are put on the trace's clock by `trace.align`, each
`runtime.call` inside the benchmark's `bench.enqueue` of its block.
Standard error gets the alignment's half-width and the idle seconds by
the innermost span open where each gap began.  None where the program
records no spans or the clocks cannot be aligned."""
import sys


def read(ctx):
    try:
        from liquid_dsp_tpu_torch import trace
    except ImportError:
        return None
    tr = ctx.trace
    group = trace.last_calls(tr.blocks) if tr and tr.device else None
    if group is None:
        return None
    calls = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in group
             if s.name == "runtime.call"]
    enqueues = [(a, b) for name, a, b in tr.spans if name == "bench.enqueue"]
    got = trace.align(calls, enqueues)
    if got is None:
        return None
    c, half = got
    a, b = ctx.profile.window(tr)
    by_span, t = {}, a
    for s, e in ctx.profile.busy_intervals(tr) + [[b, b]]:
        s, e = max(s, a), min(e, b)
        if s > t:
            where = trace.innermost(group, round((t - c) * 1e9))
            name = where.name if where else "outside the program"
            by_span[name] = by_span.get(name, 0.0) + (s - t)
        t = max(t, e)
    idle = sum(by_span.values())
    if idle <= 0:
        return None
    print(f"device_idle_in_program_pct: aligned within {half * 1e6:.3f} us;"
          " idle ms by where it began: " + ", ".join(
              f"{k} {v * 1e3:.4f}" for k, v in sorted(
                  by_span.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    return 100.0 * (idle - by_span.get("outside the program", 0.0)) / idle
