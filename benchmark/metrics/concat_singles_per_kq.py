"""Queries the concat classes served singly, past the largest class, per
1,000 queries of the window (`last_stream_stats["concat_singles"]`, summed
over the window's calls). Layer: staged stream (models/staged.py)."""
import spans


def read(ctx):
    r = spans.counter_ratio(ctx.stats, "concat_singles")
    return None if r is None else 1000.0 * r
