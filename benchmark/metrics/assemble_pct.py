"""Share of the traced window's calls (summed `tpi.stream` time, host
clock) spent on the host turning fetched planes into answers: self time of
`tpi.harvest` and `tpi.assemble` (benchmark/spans.py). Layer: staged
stream (models/staged.py)."""
import spans


def read(ctx):
    return spans.share(ctx.stats, ("tpi.harvest", "tpi.assemble"),
                       spans.SELF)
