"""Kernel launches the profiler recorded in the traced window, per 1,000
queries answered in it. Layer: device."""


def read(ctx):
    if ctx.trace is None or not ctx.queries:
        return None
    return 1000.0 * ctx.trace.launches / ctx.queries
