"""runner_self_us: the mean self time of the program's `runtime.call`
span (`liquid_dsp_tpu_torch.trace`) over the traced blocks: the call
less its children, so `inference_mode`, the block to the device
(`_block`) and the runner's bookkeeping.  None where the program records
no spans."""


def read(ctx):
    try:
        from liquid_dsp_tpu_torch import trace
    except ImportError:
        return None
    group = trace.last_calls(ctx.trace.blocks) if ctx.trace else None
    return trace.mean_us(group, "runtime.call", own=True)
