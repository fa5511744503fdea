"""Share of the traced window's calls (summed `tpi.stream` time, host
clock) in which the host blocked on the card: time in `tpi.wait` (event
waits, synchronous reads) and `tpi.upload` (the synchronous copies of
query arrays from pageable memory, which wait for every kernel queued
before them; upload_pct alone); the two never nest (benchmark/spans.py).
Layer: staged stream (models/staged.py)."""
import spans


def read(ctx):
    return spans.share(ctx.stats, ("tpi.wait", "tpi.upload"),
                       spans.INCLUSIVE)
