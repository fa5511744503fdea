"""The least device time the traced window's work needs, over the summed
time of the kernels the profiler recorded in it. The least time is the
bytes the work must move (work.py: each distinct query once, its lists'
codec bytes and 4 bytes per id written) over the card's peak memory rate.
Layer: kernels (ops/cuda_*.py, csrc/, and the torch ops around them)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0 or not ctx.least_bytes:
        return None
    return 100.0 * (ctx.least_bytes / ctx.peak_bytes_per_s) / \
        ctx.trace.kernel_s
