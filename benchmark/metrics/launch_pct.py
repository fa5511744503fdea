"""Share of the traced window's calls (summed `tpi.stream` time, host
clock) spent launching device work: self time of `tpi.dispatch` (K2's pass
and its copies, the concat classes' chunks, the ladder's runs), which
leaves out the uploads and waits inside it (`tpi.upload`, `tpi.wait`:
wait_pct; benchmark/spans.py). Layer: staged stream (models/staged.py)."""
import spans


def read(ctx):
    return spans.share(ctx.stats, ("tpi.dispatch",), spans.SELF)
