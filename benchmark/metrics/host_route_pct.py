"""Share of the window's queries served on the host, by the router's host
route or a hybrid stream's host thread (`last_stream_stats["host_queries"]`
over `["queries"]`, summed over the window's calls). Layer: router."""
import spans


def read(ctx):
    r = spans.counter_ratio(ctx.stats, "host_queries")
    return None if r is None else 100.0 * r
