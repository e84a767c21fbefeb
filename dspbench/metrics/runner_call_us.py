"""runner_call_us: the mean host time of a StreamRunner call inside the
program, its span `runtime.call` (`liquid_dsp_tpu_torch.trace`), over the
traced blocks: the in-program counterpart of runner_enqueue_ms.  The
spans are on only under the profiler, so its host cost an operation is
in it.  Standard error gets the mean and median of the benchmark's
`bench.enqueue` around the traced calls (also where the program records
no spans), the calls' median and p99 and, for the three longest, the
span inside that took the most of it.  None where the program records no
spans."""
import statistics
import sys


def read(ctx):
    if ctx.trace:
        enq = sorted(b - a for name, a, b in ctx.trace.spans
                     if name == "bench.enqueue")
        if enq:
            print(f"runner_call_us: bench.enqueue in the traced stretch, "
                  f"{len(enq)} blocks, mean "
                  f"{statistics.fmean(enq) * 1e6:.2f} us, median "
                  f"{statistics.median(enq) * 1e6:.2f} us", file=sys.stderr)
    try:
        from liquid_dsp_tpu_torch import trace
    except ImportError:
        return None
    group = trace.last_calls(ctx.trace.blocks) if ctx.trace else None
    if group is None:
        return None
    calls = sorted((s for s in group if s.name == "runtime.call"),
                   key=lambda s: s.end_ns - s.start_ns)
    us = [(s.end_ns - s.start_ns) / 1e3 for s in calls]
    own = trace.self_ns(group)
    worst = []
    for call in calls[-3:]:
        top = max((s for s in group if s.block == call.block),
                  key=lambda s: own[s.id])
        worst.append(f"{(call.end_ns - call.start_ns) / 1e3:.1f} us, "
                     f"{top.name} {own[top.id] / 1e3:.1f} us")
    p99 = (statistics.quantiles(us, n=100, method="inclusive")[98]
           if len(us) > 1 else us[0])
    print(f"runner_call_us: {len(us)} calls, median "
          f"{statistics.median(us):.2f} us, p99 {p99:.2f} us; the longest: "
          + "; ".join(worst), file=sys.stderr)
    return trace.mean_us(group, "runtime.call")
