"""Share of the traced window in which no kernel, copy or memset ran on the
card (the union of the device's intervals in the torch.profiler trace).
Layer: device."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
