"""Host-phase spans: a near-zero-overhead-when-off begin/end recorder.

``span(name, **attrs)`` is the one call sites use. When tracing is OFF
(the default) it returns a shared no-op context manager — the entire cost
of an instrumented seam is one module-flag check and two empty method
calls, which is why the hot paths (turbo apply, journal commit, Bloom
build) can stay instrumented permanently instead of behind copy-pasted
``if`` guards. When ON (``enable()``), every span close records
``(name, t0_ns, t1_ns, thread, attrs, error)`` into a bounded ring — old
spans fall off the end, so a long-running fleet never grows memory.

``span_seq()`` is the shape the multi-phase seams use (turbo apply,
recovery): ``mark(name)`` closes the previous phase and opens the next at
the SAME timestamp, so consecutive phases tile an interval with no
unattributed gap — that contiguity is what lets bench.py's observability
section prove the emitted trace accounts for >= 90% of a seam batch's
wall-clock.

Spans stay in THIS ring only; the flight recorder reads the ring's tail
at dump time (recorder.dump_flight_record) rather than mirroring every
close into its own event ring — a traced run would otherwise flood the
small fault-event ring with span closes and evict exactly the
quarantine/rot events a forensic dump exists to preserve.

``export_chrome_trace(path)`` writes the ring as Chrome trace-event JSON
("X" complete events, microsecond timestamps), the format Perfetto and
chrome://tracing load directly. By default the timestamps are raw
``perf_counter`` microseconds, a clock of their own: they do not line up
with a ``torch.profiler`` capture, whose trace counts wall-clock
microseconds less its ``baseTimeNanoseconds``. For that the recorder
keeps a clock anchor, a (``perf_counter_ns``, ``time_ns``) pair read when
recording is enabled and again whenever the spans are read;
``profiler_ns`` maps a span's time linearly between the two, and
``export_chrome_trace(profiler_base_ns=...)`` writes the spans on the
profiler trace's clock. ``observability.trace(log_dir)`` does that for
its block and writes one file holding both.
"""

import json
import threading
import time

from .metrics import register_health_source

__all__ = ['enable', 'disable', 'on', 'span', 'span_seq', 'spanned',
           'clear', 'iter_spans', 'export_chrome_trace', 'Span',
           'record_span', 'spans_dropped', 'profiler_ns']

_on = False                 # the master switch; module-global for one-load checks
_ring = []                  # preallocated record slots (None until written)
_cap = 0
_idx = 0                    # next write position
_total = 0                  # lifetime spans recorded (wraparound-aware)
_dropped_lifetime = 0       # spans evicted by wraparound, never reset
_lock = threading.Lock()    # guards ring writes only; reads copy under it
# (perf_counter_ns, time_ns) read at enable() and at the latest read of
# the spans: the two ends of the map onto the profiler's wall clock
_anchor0 = _anchor1 = None

# a wrapped ring silently truncating a trace is the no-silent-caps rule's
# textbook violation: the health counter makes the loss countable, and
# export_chrome_trace emits a synthetic marker event so the Perfetto view
# itself discloses that older spans fell off
register_health_source('spans_dropped', lambda: _dropped_lifetime)


def on():
    """True when span recording is enabled (the fast-path guard)."""
    return _on


def _clock_reading():
    """(perf_counter_ns, time_ns) read together: the perf counter between
    two wall-clock reads, paired with their midpoint; the tightest of
    three tries, so the pair is off by at most half that gap."""
    best = None
    for _ in range(3):
        w0 = time.time_ns()
        p = time.perf_counter_ns()
        w1 = time.time_ns()
        if best is None or w1 - w0 < best[0]:
            best = (w1 - w0, p, (w0 + w1) // 2)
    return best[1], best[2]


def _read_anchor():
    global _anchor1
    reading = _clock_reading()
    with _lock:
        _anchor1 = reading


def enable(capacity=4096):
    """Turn span recording on with a bounded ring of `capacity` spans."""
    global _on, _ring, _cap, _idx, _total, _anchor0, _anchor1
    reading = _clock_reading()
    with _lock:
        _ring = [None] * int(capacity)
        _cap = int(capacity)
        _idx = 0
        _total = 0
        _anchor0 = _anchor1 = reading
        _on = True


def profiler_ns(t_ns):
    """A ``perf_counter_ns`` time on the wall clock that torch.profiler's
    trace counts in (Unix ns): mapped linearly between the anchor read
    at enable() and the one read at the latest read of the spans, so
    the two clocks' drift over the recording is taken out. Without an
    anchor, the offset read now."""
    a0, a1 = _anchor0, _anchor1
    if a0 is None:
        a0 = a1 = _clock_reading()
    (p0, w0), (p1, w1) = a0, a1
    if p1 <= p0:
        return w0 + (t_ns - p0)
    return w0 + (t_ns - p0) * (w1 - w0) // (p1 - p0)


def disable():
    """Turn span recording off. The ring is kept until enable() resets it
    so a forensic dump can still read the tail of a disabled trace."""
    global _on
    _on = False


def clear():
    """Drop every recorded span (keeps the enabled state and capacity)."""
    global _idx, _total
    with _lock:
        for i in range(_cap):
            _ring[i] = None
        _idx = 0
        _total = 0


def _record(name, t0, t1, attrs, error, tid=None):
    global _idx, _total, _dropped_lifetime
    rec = (name, t0, t1,
           threading.get_ident() if tid is None else tid, attrs, error)
    with _lock:
        if not _cap:
            return
        if _ring[_idx] is not None:
            _dropped_lifetime += 1
        _ring[_idx] = rec
        _idx = (_idx + 1) % _cap
        _total += 1


def record_span(name, t0_ns, t1_ns, tid=None, **attrs):
    """Inject an externally-timed span into the ring. For phases measured
    outside Python — the native codec's pool workers time their parse
    slices against CLOCK_MONOTONIC, the same epoch ``perf_counter_ns``
    reads on Linux, so injected slices line up with host-phase spans in
    one Perfetto timeline. ``tid`` (default: calling thread) lets each
    worker render as its own track."""
    if not _on:
        return
    _record(name, t0_ns, t1_ns, attrs or None, None, tid=tid)


class Span:
    """A live span: records on close (including exceptional close, with
    the exception type attached as the ``error`` field — every begin has
    an end even when the guarded block raises)."""

    __slots__ = ('_name', '_t0', '_attrs')

    def __init__(self, name, attrs):
        self._name = name
        self._attrs = attrs or None
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def set(self, **attrs):
        """Attach attributes discovered mid-span."""
        if self._attrs is None:
            self._attrs = {}
        self._attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        _record(self._name, self._t0, time.perf_counter_ns(), self._attrs,
                exc_type.__name__ if exc_type is not None else None)
        return False


class _NullSpan:
    """Shared do-nothing span returned while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


class SpanSeq:
    """Sequential phase spans: each mark() closes the running phase and
    opens the next at the same instant, so the phases tile the interval.
    `on` is True (the null sequence's is False): an attribute that costs
    work to compute is computed only under ``if ps.on``."""

    __slots__ = ('_name', '_t0', '_attrs')
    on = True

    def __init__(self):
        self._name = None
        self._t0 = 0
        self._attrs = None

    def mark(self, name, **attrs):
        t = time.perf_counter_ns()
        if self._name is not None:
            _record(self._name, self._t0, t, self._attrs, None)
        self._name = name
        self._t0 = t
        self._attrs = attrs or None

    def add(self, **counts):
        """Add `counts` to the running phase's attributes of those names
        (a missing one starts at 0): bytes copied over a loop of copies,
        rows moved in a pass."""
        if self._name is None:
            return
        if self._attrs is None:
            self._attrs = {}
        for key, n in counts.items():
            self._attrs[key] = self._attrs.get(key, 0) + n

    def done(self, error=None, **attrs):
        if self._name is None:
            return
        if attrs:
            if self._attrs is None:
                self._attrs = {}
            self._attrs.update(attrs)
        _record(self._name, self._t0, time.perf_counter_ns(), self._attrs,
                error)
        self._name = None
        self._attrs = None


class _NullSeq:
    __slots__ = ()
    on = False

    def mark(self, name, **attrs):
        pass

    def add(self, **counts):
        pass

    def done(self, error=None, **attrs):
        pass


_NULL = _NullSpan()
_NULL_SEQ = _NullSeq()


def span(name, **attrs):
    """Open a span. Off: returns the shared no-op context manager. On:
    returns a recording Span — use as ``with span('native_parse', n=5):``."""
    if not _on:
        return _NULL
    return Span(name, attrs)


def span_seq():
    """A sequential-phase recorder (see SpanSeq); no-op when off."""
    if not _on:
        return _NULL_SEQ
    return SpanSeq()


def spanned(name):
    """Decorator recording the whole call as one span. For per-batch
    seams only: the off cost is one flag check + two no-op calls per
    invocation, fine per batch, too much per op."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def iter_spans():
    """Recorded spans, oldest first, as dicts. Copies the ring under the
    lock, so it is safe against concurrent recording. Reads the clock
    anchor's second pair (see `profiler_ns`)."""
    _read_anchor()
    with _lock:
        if _total >= _cap:
            raw = _ring[_idx:] + _ring[:_idx]
        else:
            raw = _ring[:_idx]
    out = []
    for rec in raw:
        if rec is None:
            continue
        name, t0, t1, tid, attrs, error = rec
        d = {'name': name, 't0_ns': t0, 't1_ns': t1,
             'dur_ns': t1 - t0, 'tid': tid}
        if attrs:
            d['attrs'] = dict(attrs)
        if error:
            d['error'] = error
        out.append(d)
    return out


def span_count():
    """Lifetime spans recorded since enable()/clear() (past wraparound)."""
    return _total


def spans_dropped():
    """Spans evicted from the CURRENT ring by wraparound — the count of
    older spans an export of this ring is missing (0 = the ring holds
    the full trace). The 'spans_dropped' health counter is the lifetime
    total across enable()/clear() cycles."""
    return max(0, _total - _cap) if _cap else 0


def export_chrome_trace(path=None, pid=1, profiler_base_ns=None):
    """The recorded spans as Chrome trace-event 'X' (complete) events —
    the JSON Perfetto / chrome://tracing load. Timestamps are the raw
    perf_counter microseconds by default; host spans from one process
    share a clock, so phases nest correctly, but that clock is not a
    torch.profiler trace's. With `profiler_base_ns` (a profiler trace's
    ``baseTimeNanoseconds``; 0 for a trace in absolute microseconds) they
    are on that trace's clock instead, mapped by `profiler_ns`: Unix
    microseconds less the base. Returns the event list; writes
    ``{"traceEvents": [...]}`` to `path` when given."""
    events = []
    for rec in iter_spans():
        if profiler_base_ns is None:
            ts, dur = rec['t0_ns'] / 1000.0, rec['dur_ns'] / 1000.0
        else:
            t0 = profiler_ns(rec['t0_ns']) - profiler_base_ns
            ts = t0 / 1000.0
            dur = (profiler_ns(rec['t1_ns']) - profiler_base_ns - t0) / 1000.0
        ev = {'ph': 'X', 'name': rec['name'], 'pid': pid,
              'tid': rec['tid'] % 1_000_000, 'ts': ts, 'dur': dur}
        args = dict(rec.get('attrs') or {})
        if rec.get('error'):
            args['error'] = rec['error']
        if args:
            ev['args'] = args
        events.append(ev)
    dropped = spans_dropped()
    if dropped and events:
        # truncation disclosure (no-silent-caps): a wrapped ring means
        # this trace is a TAIL, not the run — say so inside the trace
        # itself, as an instant event at the surviving window's start
        events.insert(0, {
            'ph': 'I', 'name': 'spans_dropped', 'pid': pid, 'tid': 0,
            's': 'g', 'ts': events[0]['ts'],
            'args': {'dropped': dropped,
                     'note': 'span ring wrapped; this trace is the '
                             f'newest window only ({dropped} older '
                             'spans lost)'}})
    if path is not None:
        with open(path, 'w') as f:
            json.dump({'traceEvents': events,
                       'displayTimeUnit': 'ms'}, f, default=repr)
    return events
