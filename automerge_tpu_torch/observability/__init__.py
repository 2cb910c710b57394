"""Metrics, tracing, and forensics for the fleet engine (the slice of
the observability package the fleet seam imports).

- **Counters & roll-ups** (metrics.py): per-fleet monotonic `Metrics`,
  `register_health_source`/`health_counts` and the dispatch roll-ups,
  and `trace` around `torch.profiler`.
- **Host-phase spans** (spans.py): `span(name, **attrs)`, `span_seq`,
  `spanned` — near-zero overhead while disabled, a bounded ring while
  enabled, exported as Chrome-trace JSON.
- **Latency histograms** (hist.py) and the **flight recorder**
  (recorder.py), unchanged.
- **Memory gauges**: `register_mem_source(name, fn)` records a tier's
  resident-bytes callable; `mem_sources()` reads them back.

`enable()`/`disable()` flip spans + histograms together.
"""

import threading

from . import hist as _hist
from . import spans as _spans
from .metrics import (Counters, Metrics, counts_delta, dispatch_counts,
                      dispatch_delta, health_counts, health_delta,
                      register_dispatch_source, register_health_source,
                      timed, trace)
from .spans import span, span_seq, spanned

__all__ = [
    'Counters', 'Metrics', 'timed', 'trace',
    'register_dispatch_source', 'dispatch_counts',
    'register_health_source', 'health_counts',
    'counts_delta', 'health_delta', 'dispatch_delta',
    'register_mem_source', 'mem_sources',
    'span', 'span_seq', 'spanned',
    'enable', 'disable', 'enabled',
]

_mem_lock = threading.Lock()
_mem_sources = {}


def register_mem_source(name, fn):
    """Register a zero-arg callable returning a tier's CURRENT resident
    bytes (same registry discipline as register_dispatch_source; unlike
    the counter roll-ups these are gauges, so re-reads may go down)."""
    with _mem_lock:
        _mem_sources[name] = fn


def mem_sources():
    """{tier name: current resident bytes} over every registered source."""
    with _mem_lock:
        sources = dict(_mem_sources)
    return {name: int(fn()) for name, fn in sources.items()}


def enable(span_capacity=4096):
    """Turn span recording AND histogram recording on (off by default —
    the hot seams' instrumentation cost while off is one flag check)."""
    _spans.enable(capacity=span_capacity)
    _hist.enable()


def disable():
    """Turn spans + histograms off (rings/registries are retained)."""
    _spans.disable()
    _hist.disable()


def enabled():
    return _spans.on() or _hist.on()
