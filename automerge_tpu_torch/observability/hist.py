"""Fixed log2-bucket latency/size histograms.

64 power-of-two buckets over a scaled integer domain: bucket 0 holds
scaled values < 1, bucket b holds [2^(b-1), 2^b). A latency histogram
uses ``scale=1e9`` (nanosecond resolution across ~9 seconds of dynamic
range per bucket doubling); a byte histogram uses ``scale=1``. Fixed
buckets mean ``record`` is one multiply + one int.bit_length + two adds —
cheap enough for per-batch seams — and two snapshots subtract bucketwise,
so ``delta`` gives exact per-workload distributions the way the metrics
counters do.

Percentiles report the bucket UPPER bound (conservative: the true pN is
<= the reported value), which makes test pins exact instead of
interpolation-dependent.

The module keeps a global registry (``histogram(name)`` get-or-creates)
behind the same off-by-default master switch the spans use:
``record_value`` / ``record_many`` are no-ops until ``enable()``.
"""

import math

__all__ = ['Histogram', 'histogram', 'record_value', 'histogram_snapshot',
           'histogram_delta', 'reset', 'enable', 'disable', 'on',
           'NBUCKETS']

NBUCKETS = 64

_on = False
_registry = {}


def on():
    return _on


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def reset():
    """Drop every registered histogram (name registry included)."""
    _registry.clear()


def _percentile_from_buckets(counts, count, q, scale):
    """Upper bound of the bucket holding the q-quantile observation."""
    if count <= 0:
        return None
    target = max(int(math.ceil(q * count)), 1)
    acc = 0
    for b, c in enumerate(counts):
        acc += c
        if acc >= target:
            return (1 << b) / scale
    return (1 << (NBUCKETS - 1)) / scale


def _summarize(counts, count, total, scale):
    return {
        'count': count,
        'sum': total,
        'mean': (total / count) if count else None,
        'p50': _percentile_from_buckets(counts, count, 0.50, scale),
        'p95': _percentile_from_buckets(counts, count, 0.95, scale),
        'p99': _percentile_from_buckets(counts, count, 0.99, scale),
    }


class Histogram:
    """Fixed log2-bucket histogram of non-negative values."""

    __slots__ = ('name', 'scale', 'unit', 'counts', 'sums', 'count',
                 'total', 'vmin', 'vmax')

    def __init__(self, name, scale=1, unit=''):
        self.name = name
        self.scale = scale
        self.unit = unit
        self.counts = [0] * NBUCKETS
        # per-bucket value sums, updated BEFORE the bucket count: the
        # exposition derives its `_sum` from a copy of this vector taken
        # inside a counts-stable bracket (export._hist_snapshot), so a
        # record counted on the page always has its value in the page's
        # sum — the `_sum` twin of the round-14 torn-read contract
        self.sums = [0.0] * NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def bucket_of(self, value):
        """Bucket index for a raw (unscaled) value."""
        s = int(value * self.scale)
        if s <= 0:
            return 0
        b = s.bit_length()
        return b if b < NBUCKETS else NBUCKETS - 1

    def bucket_bounds(self, b):
        """(lo, hi) raw-value bounds of bucket b: values v with
        lo <= v*scale < hi land in b (bucket 0 is [0, 1/scale))."""
        lo = (1 << (b - 1)) / self.scale if b > 0 else 0.0
        hi = (1 << b) / self.scale
        return lo, hi

    def record(self, value):
        """Returns the bucket index the value landed in, so a caller
        that also classifies by bucket (the SLO latency SLI) pays
        bucket_of once."""
        b = self.bucket_of(value)
        self.sums[b] += value
        self.counts[b] += 1
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value
        return b

    def record_many(self, values):
        """Vectorized record over an array-like of raw values — one
        numpy pass (frexp exponent == bit_length for positive ints), for
        the per-doc seams where a Python loop would be the overhead."""
        import numpy as np
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return
        s = np.maximum((v * self.scale).astype(np.int64), 0)
        _m, exp = np.frexp(s.astype(np.float64))
        b = np.where(s > 0, exp, 0)
        np.clip(b, 0, NBUCKETS - 1, out=b)
        binned = np.bincount(b, minlength=NBUCKETS)
        summed = np.bincount(b, weights=v, minlength=NBUCKETS)
        for i in np.flatnonzero(binned):
            self.sums[int(i)] += float(summed[i])
            self.counts[int(i)] += int(binned[i])
        self.count += int(v.size)
        self.total += float(v.sum())
        lo, hi = float(v.min()), float(v.max())
        if self.vmin is None or lo < self.vmin:
            self.vmin = lo
        if self.vmax is None or hi > self.vmax:
            self.vmax = hi

    def percentile(self, q):
        return _percentile_from_buckets(self.counts, self.count, q,
                                        self.scale)

    def summary(self):
        out = _summarize(self.counts, self.count, self.total, self.scale)
        out['min'] = self.vmin
        out['max'] = self.vmax
        out['unit'] = self.unit
        return out

    def snapshot(self):
        """Monotonic state for later delta(): bucket counts + count/sum
        plus the summary fields."""
        out = self.summary()
        out['buckets'] = tuple(self.counts)
        out['scale'] = self.scale
        return out

    def delta(self, prev):
        """Distribution accumulated since `prev` (an earlier snapshot()):
        bucketwise subtraction with percentiles recomputed over the
        difference. min/max are not delta-able and are omitted."""
        buckets = [c - p for c, p in zip(self.counts, prev['buckets'])]
        count = self.count - prev['count']
        total = self.total - prev['sum']
        out = _summarize(buckets, count, total, self.scale)
        out['buckets'] = tuple(buckets)
        out['unit'] = self.unit
        return out

    def __repr__(self):
        s = self.summary()
        return (f'Histogram({self.name!r}, n={s["count"]}, '
                f'p50={s["p50"]}, p99={s["p99"]})')


def histogram(name, scale=1, unit=''):
    """Get-or-create the named histogram in the global registry."""
    h = _registry.get(name)
    if h is None:
        h = _registry[name] = Histogram(name, scale=scale, unit=unit)
    return h


def record_value(name, value, scale=1, unit=''):
    """Record into the named histogram iff histograms are enabled."""
    if _on:
        histogram(name, scale=scale, unit=unit).record(value)


def histogram_snapshot():
    """{name: snapshot()} for every registered histogram."""
    return {name: h.snapshot() for name, h in _registry.items()}


def histogram_delta(prev):
    """{name: delta vs prev[name]} for histograms present in both."""
    out = {}
    for name, h in _registry.items():
        if name in prev:
            out[name] = h.delta(prev[name])
        else:
            out[name] = h.snapshot()
    return out
