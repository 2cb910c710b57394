"""Flight recorder: a bounded ring of recent structured events plus the
forensic dump that fires when something goes wrong.

The health counters (metrics.py) can say "quarantined_docs moved by 1";
this module records WHICH doc, in WHAT phase, with WHAT typed error, and
what the surrounding events were. Event recording is always on — the
events are rare (quarantines, truncations, checkpoints, overflow) and an
append into a deque costs nothing against the faults they describe. The
event ring holds ONLY these fault/health events; a traced run's phase
timeline is read out of the span ring's tail at dump time, so thousands
of span closes can never evict the handful of fault events the dump
exists to preserve.

``dump_flight_record(trigger, detail)`` assembles the forensic report —
trigger, detail, the event ring, the most recent spans (when spans are
enabled), health-counter and histogram snapshots — keeps it in memory
(``last_flight_record()``) and, when a dump directory is configured
(``configure(dump_dir=...)`` or the ``AUTOMERGE_TPU_FLIGHT_DIR`` env
var), writes it as ``flight-<trigger>-<seq>.json``. The
fault-containment seams call it automatically: batched-apply quarantine
(fleet/backend.py), sync-receive quarantine (fleet/sync_driver.py),
recovery truncation/rot (fleet/durability.py), and multihost
SyncOverflow (fleet/exchange.py).
"""

import collections
import json
import os
import threading
import time

from . import spans as _spans
from .metrics import Counters, health_counts, register_health_source

__all__ = ['configure', 'record_event', 'recent_events', 'clear_events',
           'dump_flight_record', 'last_flight_record', 'flight_stats']

_events = collections.deque(maxlen=256)
_dump_dir = os.environ.get('AUTOMERGE_TPU_FLIGHT_DIR') or None
_dump_spans = 64             # newest spans included per forensic dump
# Disk-write rate limit: a quarantine STORM (thousands of poisoned docs
# in one incident) must not amplify into disk exhaustion — at most
# _dump_limit dump FILES land per _dump_window_s sliding window; excess
# dumps are still assembled in memory (last_flight_record keeps working)
# but the file write is suppressed and counted in 'dumps_suppressed'.
_dump_limit = int(os.environ.get('AUTOMERGE_TPU_FLIGHT_DUMP_LIMIT', 16))
_dump_window_s = float(os.environ.get('AUTOMERGE_TPU_FLIGHT_DUMP_WINDOW',
                                      60.0))
_dump_times = collections.deque()
_dump_lock = threading.Lock()   # the window check is check-then-append
_last = None
_stats = Counters({'flight_events': 0, 'flight_dumps': 0,
                   'dumps_suppressed': 0})
register_health_source('flight_events', lambda: _stats['flight_events'])
register_health_source('flight_dumps', lambda: _stats['flight_dumps'])
register_health_source('dumps_suppressed',
                       lambda: _stats['dumps_suppressed'])

_UNSET = object()


def configure(capacity=None, dump_dir=_UNSET, dump_spans=None,
              dump_limit=None, dump_window_s=None):
    """Adjust the recorder: ring capacity (the newest events are kept up
    to the new bound; call clear_events() for a fresh ring),
    forensic-dump directory (None = keep dumps in memory only), how
    many of the newest spans each dump includes, and the disk-write
    rate limit (`dump_limit` files per `dump_window_s` sliding window;
    limit <= 0 disables the cap)."""
    global _events, _dump_dir, _dump_spans, _dump_limit, _dump_window_s
    if capacity is not None:
        _events = collections.deque(_events, maxlen=int(capacity))
    if dump_dir is not _UNSET:
        _dump_dir = dump_dir
    if dump_spans is not None:
        _dump_spans = int(dump_spans)
    if dump_limit is not None:
        _dump_limit = int(dump_limit)
    if dump_window_s is not None:
        _dump_window_s = float(dump_window_s)


def _dump_write_allowed(now):
    """Sliding-window admission for dump FILE writes (the report itself
    always assembles). True = write, with the slot recorded."""
    if _dump_limit <= 0:
        return True
    with _dump_lock:
        while _dump_times and now - _dump_times[0] > _dump_window_s:
            _dump_times.popleft()
        if len(_dump_times) >= _dump_limit:
            return False
        _dump_times.append(now)
        return True


def record_event(kind, **fields):
    """Append a structured event to the ring. Values should already be
    JSON-friendly (strings/numbers); anything else is repr'd at dump."""
    _stats.inc('flight_events')
    ev = {'kind': kind, 'ts_ns': time.time_ns()}
    ev.update(fields)
    # archlint: ok[lock-discipline] lock-free ring by design: deque.append is one atomic op under the GIL and the ring is bounded by maxlen
    _events.append(ev)
    return ev


def recent_events(n=None):
    """The newest `n` events (all, oldest first, when n is None)."""
    evs = list(_events)
    return evs if n is None else evs[-n:]


def clear_events():
    # archlint: ok[lock-discipline] lock-free ring by design: deque.clear is one atomic op under the GIL (test-scoped reset, not a hot path)
    _events.clear()


def dump_flight_record(trigger, detail=None, path=None):
    """Assemble (and possibly write) the forensic report around `trigger`.
    Returns the report dict; it is also retained for
    ``last_flight_record()``. ``path`` overrides the configured dump
    directory for this one dump — and bypasses the rate limit (an
    explicit path is an operator asking, not a storm amplifying). Disk
    writes to the CONFIGURED directory are rate-limited (see
    ``configure``): a suppressed dump still assembles in memory, gains
    ``'suppressed': True``, and bumps the 'dumps_suppressed' health
    counter."""
    global _last
    from . import hist
    _stats.inc('flight_dumps')
    now = time.time()
    report = {
        'trigger': trigger,
        'seq': _stats['flight_dumps'],
        'ts': now,
        'detail': detail,
        'events': list(_events),
        'recent_spans': _spans.iter_spans()[-_dump_spans:],
        'health': health_counts(),
        'histograms': {name: h.summary()
                       for name, h in hist._registry.items()},
    }
    _last = report
    out_path = path
    if out_path is None and _dump_dir is not None:
        if _dump_write_allowed(now):
            os.makedirs(_dump_dir, exist_ok=True)
            out_path = os.path.join(
                _dump_dir, f'flight-{trigger}-{report["seq"]}.json')
        else:
            _stats.inc('dumps_suppressed')
            report['suppressed'] = True
    if out_path is not None:
        with open(out_path, 'w') as f:
            json.dump(report, f, indent=1, default=repr)
        report['path'] = out_path
    return report


def last_flight_record():
    """The most recent forensic report (None before the first dump)."""
    return _last


def flight_stats():
    return dict(_stats)
