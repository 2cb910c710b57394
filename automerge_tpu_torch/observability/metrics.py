"""Monotonic counters and the dispatch/health roll-up registries.

- `Metrics`: cheap monotonic counters every DocFleet maintains
  (`fleet.metrics`): device dispatches, ops applied on device, changes
  ingested, bytes ingested, host fallbacks, actor renumber remaps,
  capacity growths. `snapshot()` returns a plain dict; `delta(prev)`
  diffs two snapshots — subtract around a workload to get per-phase
  counts.
- `trace(log_dir)`: context manager around `torch.profiler`, with the
  host-phase spans (spans.py) recording — writes one Chrome/Perfetto
  trace of every host op and CUDA kernel inside the block and of the
  program's spans, all on the profiler's clock.
- `timed(metrics, key)`: context manager accumulating wall-clock seconds
  into a counter, for host-side phases (decode, gate, patch build).
- `register_dispatch_source(name, fn)` / `dispatch_counts(fleets)`: one
  roll-up of every device-dispatch counter in the system. DocFleet counts
  its dispatches in `fleet.metrics.dispatches`, but some batched paths run
  over HOST backends with no fleet in sight (the sync driver's Bloom
  build/probe lives in `fleet/bloom.py` module state); those modules
  register a monotonic counter here, so bench.py and the dispatch-count
  regression tests can diff total device dispatches around a workload
  without knowing which modules dispatched.
- `register_health_source(name, fn)` / `health_counts()`: the same
  roll-up pattern for fault-containment counters — quarantined docs,
  rejected changes/filters, sync retries, injected wire faults, fuzz
  corpus size, and the durability layer's checkpoint/compaction/
  journal-fsync/replay/truncation/rot counters (fleet/durability.py).

The roll-up key space is shared with the synthetic keys `dispatch_counts`
itself emits ('total', and 'fleet<N>' per passed fleet), so those names
are RESERVED: registering a source under one would silently corrupt the
roll-up (the module counter overwritten by — or summed into — the
synthetic key). Both register functions reject them with ValueError.
"""

import contextlib
import re
import threading
import time

__all__ = ['Counters', 'Metrics', 'timed', 'trace',
           'register_dispatch_source', 'dispatch_counts',
           'register_health_source', 'health_counts',
           'counts_delta', 'health_delta', 'dispatch_delta']


# One process-global lock for every Counters family: stat increments are
# rare events (health counters, not per-op work), so contention on a
# shared lock is cheaper than a lock object per module — and a single
# lock means two families incremented from one code path can never
# deadlock against each other.
_COUNTERS_LOCK = threading.Lock()


class Counters(dict):
    """A module-stats dict whose increments are ATOMIC under threads.

    ``d[key] += n`` on a plain dict is a read-modify-write that the GIL
    can split between threads — which is exactly how the round-15
    thread-per-shard pump pool undercounted health counters (two pumps
    read the same value, both wrote value+1). Every module `_stats`
    family is now one of these, and every increment goes through
    ``inc``, which holds the shared lock across the whole
    read-add-write. Plain reads and whole-value assignments
    (``d[key] = 0`` resets, gauge sets) stay ordinary dict operations —
    each is a single GIL-atomic bytecode effect.
    """

    __slots__ = ()

    def inc(self, key, n=1):
        """Atomically add ``n`` (may be negative) to ``key`` (missing
        keys start at 0). Returns the new value."""
        with _COUNTERS_LOCK:
            value = self.get(key, 0) + n
            self[key] = value
        return value


class Metrics:
    """Monotonic counters; plain attributes so incrementing is one add."""

    _FIELDS = (
        'dispatches',            # device merge dispatches issued
        'device_ops',            # real op rows applied on device (padding excluded)
        'changes_ingested',      # binary changes accepted by apply paths
        'bytes_ingested',        # wire bytes parsed
        'turbo_calls',           # batched turbo applies
        'exact_calls',           # mirror-exact applies
        'fallbacks',             # turbo calls routed to the exact path
        'promotions',            # documents promoted to the host engine
        'remaps',                # actor renumber dispatches
        'grows',                 # capacity regrowths (doc/key axes)
        'seq_migrations',        # sequence rows moved up a size class
        'seq_pack_grouped',      # sequence dispatches packed from their
                                 # input's row runs, with no sort
        'seq_pack_sorted',       # sequence dispatches whose runs repeated
                                 # a row and took a stable sort first
        'mirror_rebuilds',       # lazy mirror replays after turbo
        'graph_builds',          # deferred hash-graph materializations
        'docs_bulk_loaded',      # documents installed by the native loader
        'doc_materializations',  # bulk-loaded docs whose history was read
        'turbo_commit_fallback_docs',  # per-doc commit-loop iterations
                                 # (staged/slow docs only; the columnar
                                 # fast path contributes ZERO — pinned
                                 # by the commit-phase regression guard)
        'turbo_causal_docs',     # docs the turbo gate accepted as causal
                                 # runs (concurrent branches, merges)
        'turbo_drain_docs',      # docs the turbo gate sent to the host's
                                 # general gate (_drain_queue)
        'turbo_multihead_docs',  # docs a turbo commit left with more
                                 # than one head (in the head lanes)
    )

    def __init__(self):
        for name in self._FIELDS:
            setattr(self, name, 0)
        self.seconds = {}        # phase name -> accumulated wall seconds

    def snapshot(self):
        out = {name: getattr(self, name) for name in self._FIELDS}
        out['seconds'] = dict(self.seconds)
        return out

    def delta(self, prev):
        """Counters accumulated since `prev` (an earlier snapshot())."""
        now = self.snapshot()
        out = {k: now[k] - prev.get(k, 0) for k in self._FIELDS}
        out['seconds'] = {k: v - prev.get('seconds', {}).get(k, 0.0)
                          for k, v in now['seconds'].items()}
        return out

    def __repr__(self):
        parts = [f'{k}={getattr(self, k)}' for k in self._FIELDS
                 if getattr(self, k)]
        return f'Metrics({", ".join(parts)})'


@contextlib.contextmanager
def timed(metrics, key):
    """Accumulate the block's wall-clock seconds into metrics.seconds[key]."""
    start = time.perf_counter()
    try:
        yield
    finally:
        metrics.seconds[key] = metrics.seconds.get(key, 0.0) + \
            (time.perf_counter() - start)


# ---- device-dispatch roll-up ----------------------------------------------

_dispatch_sources = {}

# 'total' and 'fleet<N>' are synthesized by dispatch_counts itself; a
# module registering under either would corrupt the roll-up (round-7
# satellite: the collision was silent before this guard).
_RESERVED = re.compile(r'total|fleet\d+')


def _check_source_name(name):
    if not isinstance(name, str) or _RESERVED.fullmatch(name):
        raise ValueError(
            f'{name!r} is reserved: dispatch_counts() synthesizes '
            f"'total' and 'fleet<N>' keys, so sources may not register "
            f'under those names')


def register_dispatch_source(name, fn):
    """Register a zero-arg callable returning a module's monotonic device
    dispatch count (e.g. fleet.bloom registers its batched build/probe
    counter at import). Re-registering a name replaces the source.
    Raises ValueError for the reserved roll-up keys ('total',
    'fleet<N>')."""
    _check_source_name(name)
    with _COUNTERS_LOCK:
        _dispatch_sources[name] = fn


def dispatch_counts(fleets=()):
    """Snapshot every registered module dispatch counter plus the given
    fleets' `metrics.dispatches`, with a 'total' sum. Take one snapshot
    before and one after a workload and subtract per key (the counters are
    monotonic) to get dispatches attributable to that workload."""
    out = {name: int(fn()) for name, fn in _dispatch_sources.items()}
    for i, fleet in enumerate(fleets):
        out[f'fleet{i}'] = int(fleet.metrics.dispatches)
    out['total'] = sum(out.values())
    return out


# ---- fault-containment health roll-up -------------------------------------

_health_sources = {}


def register_health_source(name, fn):
    """Register a zero-arg callable returning a module's monotonic
    fault-containment counter (quarantined docs, rejected changes, sync
    retries, injected wire faults, ...). Re-registering a name replaces
    the source — same contract (and same reserved-name rejection) as
    register_dispatch_source."""
    _check_source_name(name)
    with _COUNTERS_LOCK:
        _health_sources[name] = fn


def health_counts():
    """Snapshot every registered health counter. Counters are monotonic;
    subtract two snapshots around a workload to attribute events to it."""
    return {name: int(fn()) for name, fn in _health_sources.items()}


# ---- snapshot/delta over counter roll-ups ---------------------------------
#
# The counter twin of Histogram.snapshot()/delta(): the roll-ups return
# plain monotonic dicts, and every consumer used to subtract them by hand
# (bench.py's faults section, obs_report dump comparisons, now the SLO
# windows every tick). One shared subtraction keeps the semantics in one
# place: keys are unioned, a key missing from either side reads 0.

def counts_delta(now, prev):
    """Per-key difference of two counter snapshots (``now - prev``).
    Keys are unioned; a key absent from one side counts as 0 there, so
    a counter that appeared (or a source registered) between the two
    snapshots still contributes its full movement."""
    out = {}
    for k, v in now.items():
        out[k] = v - prev.get(k, 0)
    for k, v in prev.items():
        if k not in now:
            out[k] = -v
    return out


def health_delta(prev):
    """Health counters accumulated since ``prev`` (an earlier
    health_counts() snapshot)."""
    return counts_delta(health_counts(), prev)


def dispatch_delta(prev, fleets=()):
    """Device dispatches accumulated since ``prev`` (an earlier
    dispatch_counts() snapshot over the same fleets)."""
    return counts_delta(dispatch_counts(fleets), prev)


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler trace (CPU + CUDA activity) of everything inside
    the block, with the program's host-phase spans recording, written as
    one Chrome-trace JSON, ``log_dir/trace.json``, for Perfetto: the
    profiler's events and the spans as 'X' events on the profiler's
    clock (spans.profiler_ns), so a span nests around the profiler's
    ranges and kernels it encloses. Span recording is on for the block
    only, unless it already was: then the ring is kept, and all of it
    is written."""
    import json
    import os
    import torch
    from . import spans
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    was_on = spans.on()
    if not was_on:
        spans.enable(capacity=1 << 16)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        if not was_on:
            spans.disable()
    path = os.path.join(str(log_dir), 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as fh:
        data = json.load(fh)
    data.setdefault('traceEvents', []).extend(spans.export_chrome_trace(
        pid=os.getpid(),
        profiler_base_ns=int(data.get('baseTimeNanoseconds', 0))))
    with open(path, 'w') as fh:
        json.dump(data, fh, default=repr)
