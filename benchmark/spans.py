"""The program's spans as the metric readers take them: each call's
`last_stream_stats["spans"]` ({name: [count, inclusive_ns, self_ns]}, the
reduction of inverted_index_2_tpu_torch/utils/tracing.py, present while a
profiler records), summed over the traced window's calls. Every share is of
the summed time of the calls' root span, `tpi.stream`, on the host's
clock."""

COUNT, INCLUSIVE, SELF = 0, 1, 2
ROOT = "tpi.stream"


def summed(stats):
    """{name: [count, inclusive_ns, self_ns]} summed over the calls whose
    stats carry spans; None when none does."""
    out = None
    for s in stats:
        if not s or not s.get("spans"):
            continue
        out = {} if out is None else out
        for name, row in s["spans"].items():
            acc = out.setdefault(name, [0, 0, 0])
            for i in (COUNT, INCLUSIVE, SELF):
                acc[i] += row[i]
    return out


def share(stats, names, col):
    """Percent of the summed root time in column `col` of spans `names`;
    None without spans."""
    tot = summed(stats)
    if not tot or not tot.get(ROOT, (0, 0, 0))[INCLUSIVE]:
        return None
    part = sum(tot[n][col] for n in names if n in tot)
    return 100.0 * part / tot[ROOT][INCLUSIVE]


def counter_ratio(stats, num, den="queries"):
    """sum(num) / sum(den) over the calls whose stats have counter `num`;
    None when none has it or the denominator is 0."""
    have = [s for s in stats if s and num in s]
    d = sum(s[den] for s in have)
    if not d:
        return None
    return sum(s[num] for s in have) / d
