"""mix_fir_decim.roofline_pct: the fused mixer + FIR + decimator
kernel's least time for the cell's work over its device time in the
trace.  The work, from the configuration's shapes: each input plane read
once and each output plane written once (float32), and per output
`taps` multiply-adds on each of 2 planes, per input one complex rotation
(6 operations)."""


def read(ctx):
    sh = ctx.shapes.get("mix_fir_decim")
    got = ctx.kernel_s("mix_fir_decim_kernel") if ctx.trace else None
    if sh is None or got is None:
        return None
    B, T, L, down = sh["rows"], sh["samples"], sh["taps"], sh["down"]
    n_bytes = 2 * B * T * 4 + 2 * B * (T // down) * 4
    n_ops = B * (T // down) * L * 2 * 2 + B * T * 6
    seconds, launches = got
    return 100.0 * ctx.bound_s(n_bytes, n_ops)[0] * launches / seconds
