"""Share of AND queries served again after the staged stream's first pass:
small-P overflows, ladder re-serves and concat ANDs
(`QueryEngine.last_stream_stats`, summed over the window's calls), per
query answered. Layer: staged stream (models/staged.py)."""


def read(ctx):
    stats = [s for s in ctx.stats if s]
    queries = sum(s["queries"] for s in stats)
    if not queries:
        return None
    again = sum(s["small_p_overflow"] + s["ladder_reserve"] + s["concat"]
                for s in stats)
    return 100.0 * again / queries
