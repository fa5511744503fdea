"""Share of the traced window's calls (summed `tpi.stream` time, host
clock) that packing the batches, the cross-query dedup and the concat
stream's resolve spent themselves: self time of `tpi.pack`, `tpi.dedup`
and `tpi.resolve` (benchmark/spans.py). Layer: pack + dedup (host)."""
import spans


def read(ctx):
    return spans.share(ctx.stats, ("tpi.pack", "tpi.dedup", "tpi.resolve"),
                       spans.SELF)
