"""mix_fir_decim.carry_us: the mean host time of the fused mixer + FIR +
decimator's carry update, the program's span `mix_fir_decim.carry`
(`liquid_dsp_tpu_torch.trace`) over the traced blocks: the NCO phase's
advance and the two tail copies, each a small device operation.  None
where the program records no spans."""


def read(ctx):
    try:
        from liquid_dsp_tpu_torch import trace
    except ImportError:
        return None
    group = trace.last_calls(ctx.trace.blocks) if ctx.trace else None
    return trace.mean_us(group, "mix_fir_decim.carry")
