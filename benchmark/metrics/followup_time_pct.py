"""Share of the traced window's calls (summed `tpi.stream` time, host
clock) spent serving the AND stream's follow-ups (ladder re-serves and the
concat AND): inclusive time of `tpi.followups` (benchmark/spans.py).
Layer: staged stream (models/staged.py)."""
import spans


def read(ctx):
    return spans.share(ctx.stats, ("tpi.followups",), spans.INCLUSIVE)
