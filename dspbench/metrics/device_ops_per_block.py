"""device_ops_per_block: device operations (kernels, copies, memsets) in
the traced blocks, over the blocks.  None where the profiler lost
events on every take."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or len(tr.device) % tr.blocks:
        return None
    return len(tr.device) / tr.blocks
