"""Span arithmetic the readers share."""


def total_ms(spans, names):
    """Summed milliseconds of the spans named `names`."""
    return sum(t1 - t0 for n, t0, t1, _tid in spans if n in names) / 1e6


def self_ms(spans, names):
    """Self time of the spans named `names`, in ms: each one's duration
    less the union of the spans nested inside it on its thread."""
    by_tid = {}
    for rec in spans:
        by_tid.setdefault(rec[3], []).append(rec)
    total = 0
    for recs in by_tid.values():
        recs.sort(key=lambda r: (r[1], -r[2]))
        for i, (name, t0, t1, _tid) in enumerate(recs):
            if name not in names:
                continue
            covered, end = 0, t0
            for _n, c0, c1, _t in recs[i + 1:]:
                if c0 >= t1:
                    break
                if c1 > t1 or (c0, c1) == (t0, t1):
                    continue
                c0 = max(c0, end)
                if c1 > c0:
                    covered += c1 - c0
                    end = c1
            total += (t1 - t0) - covered
    return total / 1e6
