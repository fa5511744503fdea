"""Share of the traced window's calls (summed `tpi.stream` time, host
clock) in `tpi.upload`: the synchronous copies of query arrays from
pageable memory to the card, in which the host waits for every kernel
queued before them; a part of wait_pct (benchmark/spans.py). Layer: staged
stream (models/staged.py)."""
import spans


def read(ctx):
    return spans.share(ctx.stats, ("tpi.upload",), spans.INCLUSIVE)
