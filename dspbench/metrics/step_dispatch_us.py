"""step_dispatch_us: the mean self time of the program's `runtime.step`
span (`liquid_dsp_tpu_torch.trace`) over the traced blocks: the step less
the kernels' launch and carry spans inside it, so the module call and
the planar stage's dispatch.  None where the program records no
spans."""


def read(ctx):
    try:
        from liquid_dsp_tpu_torch import trace
    except ImportError:
        return None
    group = trace.last_calls(ctx.trace.blocks) if ctx.trace else None
    return trace.mean_us(group, "runtime.step", own=True)
