"""mix_fir_decim.launch_us: the mean host time of the fused mixer + FIR +
decimator's wrapper call, the program's span `mix_fir_decim.launch`
(`liquid_dsp_tpu_torch.trace`) over the traced blocks: its checks, the
output planes' allocation and the launch.  None where the program
records no spans."""


def read(ctx):
    try:
        from liquid_dsp_tpu_torch import trace
    except ImportError:
        return None
    group = trace.last_calls(ctx.trace.blocks) if ctx.trace else None
    return trace.mean_us(group, "mix_fir_decim.launch")
