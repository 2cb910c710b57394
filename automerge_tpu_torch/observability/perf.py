"""Continuous performance observatory: seam baselines, the device
kernel cost ledger, and memory watermarks.

The torch counterpart of automerge_tpu/observability/perf.py. The seam
baselines and the memory watermarks are copies; the kernel cost ledger
keeps the reference's API and report shape but is written for torch:

- **Seam perf baselines** (``PerfBaselines``): every named seam reads
  its signal from an existing log2 histogram (``apply_batch_s``,
  ``sync_round_s``, ``fsync_s``, ``materialize_at_s``,
  ``subscription_diff_s``, ``service_tick_s``, ``shard_pump_s``) as
  consecutive (count, sum) deltas into event WINDOWS; the trailing
  baseline is an EWMA over the closed windows' means that FREEZES while
  the current window drifts past the fire threshold, and drift drives
  the hysteretic edge-triggered alert machinery (slo._Alert): a fire
  lands in the flight recorder with a forensic dump of the seam's
  recent spans and window means. Gauges export on the Prometheus page.
- **Kernel cost ledger** (``instrument_kernel``): the port's kernel
  entry points (fleet/apply.py, registers.py, sequence.py, bloom.py,
  hashindex.py, sharding.py, exchange.py) are wrapped under the
  reference's kind names, so one dashboard reads both packages. Off
  (default), the wrap costs one flag check per call. On
  (``enable_ledger()``), each call counts
  per-kind dispatches and host-blocking wall seconds (no
  ``torch.cuda.synchronize()``: on the card that is launch time, and
  device time belongs to ``observability.trace`` captures) and records
  the call's signature (tensor shapes and dtypes; other arguments by
  repr) ONCE per distinct shape. Where the reference asks XLA's
  ``cost_analysis`` for a signature, the port works its cost out from
  the recorded shapes when the signature first misses: ``'bytes
  accessed'`` is the nbytes of the tensors the call reads and writes
  (its arguments' leaves and its result's). No ``'flops'`` is
  reported, as the reference drops a key its backend does not report.
  One kind has no counterpart here: ``pallas_apply_op_batch``,
  because the port's merge entry points launch the hand kernel
  themselves (fleet/merge_kernel.py). The mesh kinds (``sharded_*``,
  ``exchange_all_to_all``) register when fleet/sharding.py and
  fleet/exchange.py import. ``kernel_report()`` / ``dump_ledger()`` keep
  the shape ``tools/obs_report.py --floor`` reads.
- **Memory watermarks** (``sample_watermarks``): process RSS plus
  per-tier byte gauges from registered sources (fleet-resident device
  state, the storage tier's lanes and arena, the journal's loss window,
  the frontier index, the span and flight-recorder rings), each with a
  process-lifetime high watermark, and ``page_fault_counts()``.

Everything is off by default. ``enable_observatory()`` /
``disable_observatory()`` flip all three legs together; each leg also
has its own switch. ``maybe_tick()`` is the cheap hook the service tick
calls: a no-op unless the default baselines registry is enabled.
"""

import json
import os
import threading
import time

from . import hist as _hist
from . import recorder as _flight
from . import spans as _spans
from .metrics import Counters, register_health_source
from .slo import _Alert

__all__ = ['PerfBaselines', 'SeamSpec', 'DEFAULT_SEAMS', 'baselines',
           'enable_baselines', 'disable_baselines', 'maybe_tick',
           'instrument_kernel', 'enable_ledger', 'disable_ledger',
           'ledger_on', 'kernel_snapshot', 'kernel_report', 'kernel_kinds',
           'reset_ledger', 'dump_ledger',
           'register_mem_source', 'sample_watermarks',
           'watermark_snapshot', 'reset_watermarks', 'rss_bytes',
           'page_fault_counts',
           'enable_observatory', 'disable_observatory', 'perf_stats']

_stats = Counters({
    'perf_alerts_fired': 0,      # seam drift alert activations (monotonic)
    'perf_alerts_cleared': 0,    # seam drift alert deactivations
    'perf_alerts_active': 0,     # currently-firing seam alerts (gauge)
    'perf_ticks': 0,             # baseline evaluation ticks (monotonic)
    'kernel_dispatches': 0,      # ledger-counted kernel calls (monotonic)
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def perf_stats():
    return dict(_stats)


# ---- seam perf baselines ---------------------------------------------------

class SeamSpec:
    """One watched seam: which histogram carries its latency signal and
    which span-name prefixes a forensic dump should attach (the phase
    timeline around the regression)."""

    __slots__ = ('name', 'hist', 'span_prefixes')

    def __init__(self, name, hist, span_prefixes=()):
        self.name = name
        self.hist = hist
        self.span_prefixes = tuple(span_prefixes)


# The seams the repo has banked perf wins on (ROADMAP), each already
# instrumented with a log2 histogram at its hot path.
DEFAULT_SEAMS = (
    SeamSpec('apply_batch', 'apply_batch_s',
             ('turbo_', 'native_parse', 'parse_chunk')),
    SeamSpec('sync_round', 'sync_round_s', ('sync_', 'bloom_')),
    SeamSpec('fsync', 'fsync_s', ('journal_',)),
    SeamSpec('materialize_at', 'materialize_at_s', ('materialize',)),
    SeamSpec('subscription_diff', 'subscription_diff_s',
             ('subscription', 'diff')),
    SeamSpec('service_tick', 'service_tick_s', ('service_',)),
    SeamSpec('shard_pump', 'shard_pump_s', ('shard_tick',)),
)


class _SeamState:
    """Rolling state for one seam: the open window's accumulation, the
    preallocated ring of closed window means, the frozen-while-drifting
    EWMA baseline, and the hysteretic alert."""

    __slots__ = ('spec', 'prev_count', 'prev_total', 'win_events',
                 'win_total', 'ring', 'ring_n', 'ring_idx', 'windows',
                 'ewma', 'last_window', 'drift', 'alert')

    def __init__(self, spec, history):
        self.spec = spec
        self.prev_count = 0
        self.prev_total = 0.0
        self.win_events = 0        # events accumulated in the open window
        self.win_total = 0.0
        self.ring = [0.0] * history   # closed window means, preallocated
        self.ring_n = 0               # ring slots filled (<= history)
        self.ring_idx = 0             # next write position
        self.windows = 0              # lifetime closed windows
        self.ewma = None              # trailing baseline (seconds)
        self.last_window = None       # newest closed window mean
        self.drift = 1.0
        self.alert = _Alert()

    def recent_means(self):
        """Closed window means, oldest first."""
        n, cap = self.ring_n, len(self.ring)
        if n < cap:
            return list(self.ring[:n])
        return list(self.ring[self.ring_idx:]) + \
            list(self.ring[:self.ring_idx])


class PerfBaselines:
    """See the module docstring. Single-writer by contract (the tick
    caller); gauge readers take plain-dict snapshots."""

    def __init__(self, seams=DEFAULT_SEAMS, window_events=32, history=16,
                 ewma_alpha=0.3, drift_pct=0.20, up_ticks=2, down_ticks=6,
                 min_windows=3, forensic_spans=48):
        # tick() holds this lock: the default registry is driven from
        # every DocService.pump, and a ShardRouter pump POOL runs those
        # concurrently — two interleaved ticks would double-drain the
        # histogram deltas (both read the same prev_count) and race the
        # window rings. One uncontended acquire per tick, nothing on
        # any per-request path.
        self._tick_lock = threading.Lock()
        self.seams = {s.name: _SeamState(s, int(history)) for s in seams}
        self.window_events = int(window_events)
        self.ewma_alpha = float(ewma_alpha)
        self.drift_pct = float(drift_pct)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        # windows before a baseline is trusted enough to judge drift: a
        # cold seam must not alert off its very first (compile-warmup
        # shaped) window
        self.min_windows = int(min_windows)
        self.forensic_spans = int(forensic_spans)
        self.ticks = 0

    @property
    def fire_threshold(self):
        return 1.0 + self.drift_pct

    def record(self, seam, seconds):
        """Record a latency sample directly (the replay/test path, and
        seams without a registered histogram). Production seams feed
        through their histograms instead."""
        state = self.seams[seam]
        state.win_events += 1
        state.win_total += float(seconds)

    def tick(self):
        """One evaluation round: drain each seam's histogram delta into
        its open window, close windows that reached ``window_events``,
        fold closed means into the baseline, judge drift, drive alerts.
        Cost is O(seams) dict reads — independent of event volume.
        Thread-safe: concurrent tickers (the shard pump pool's services
        all drive the default registry) serialize on the tick lock."""
        with self._tick_lock:
            self._tick_locked()

    def _tick_locked(self):
        self.ticks += 1
        _stats.inc('perf_ticks')
        registry = _hist._registry
        for state in self.seams.values():
            h = registry.get(state.spec.hist)
            if h is not None:
                count, total = h.count, h.total
                d_count = count - state.prev_count
                if d_count > 0:
                    state.win_events += d_count
                    state.win_total += total - state.prev_total
                if d_count >= 0:
                    state.prev_count, state.prev_total = count, total
                else:
                    # the histogram registry was reset under us: re-pin
                    state.prev_count, state.prev_total = count, total
            while state.win_events >= self.window_events:
                self._close_window(state)

    def _close_window(self, state):
        """Close one window of exactly ``window_events`` events (an
        over-full open window carries its excess into the next — window
        means stay comparable across ticks of any cadence)."""
        n = self.window_events
        mean = state.win_total / state.win_events
        take_total = mean * n
        state.win_events -= n
        state.win_total = max(0.0, state.win_total - take_total)
        state.ring[state.ring_idx] = mean
        state.ring_idx = (state.ring_idx + 1) % len(state.ring)
        state.ring_n = min(state.ring_n + 1, len(state.ring))
        state.windows += 1
        state.last_window = mean
        baseline = state.ewma
        if baseline is None:
            state.ewma = mean
            state.drift = 1.0
            return
        drifting = state.windows > self.min_windows and \
            mean >= baseline * self.fire_threshold
        state.drift = (mean / baseline) if baseline > 0 else 1.0
        if not drifting:
            # fold the clean window into the trailing baseline; a
            # drifting window is QUARANTINED from it — the baseline must
            # not absorb the regression it exists to expose (else the
            # alert self-clears as the EWMA chases the slowdown)
            state.ewma = baseline + self.ewma_alpha * (mean - baseline)
        if state.windows <= self.min_windows:
            state.drift = 1.0
            return
        # the alert machinery judges EXCESS drift (drift - 1), not the
        # raw ratio: _Alert clears at signal <= threshold/2, which for a
        # ratio centered at 1.0 would demand the seam run ~40% FASTER
        # than its own baseline to clear — with the excess, fire holds
        # at drift >= 1 + drift_pct and clear at drift <= 1 + drift_pct/2
        edge = state.alert.observe(state.drift - 1.0, self.drift_pct,
                                   self.up_ticks, self.down_ticks)
        if edge is not None:
            self._transition(state, edge)

    def _transition(self, state, edge):
        name = state.spec.name
        if edge == 'fire':
            _stats.inc('perf_alerts_fired')
            _stats.inc('perf_alerts_active')
        else:
            _stats.inc('perf_alerts_cleared')
            _stats.inc('perf_alerts_active', -1)
        _flight.record_event(
            'perf_drift', seam=name, edge=edge,
            drift=round(state.drift, 3),
            window_s=state.last_window, baseline_s=state.ewma,
            tick=self.ticks)
        if edge == 'fire':
            prefixes = state.spec.span_prefixes
            spans = [s for s in _spans.iter_spans()
                     if s['name'].startswith(prefixes)] if prefixes else []
            _flight.dump_flight_record('perf', detail={
                'seam': name,
                'drift': round(state.drift, 3),
                'window_s': state.last_window,
                'baseline_s': state.ewma,
                'window_means_s': state.recent_means(),
                'offending_spans': spans[-self.forensic_spans:],
            })

    # -- read surfaces ---------------------------------------------------

    def gauges(self):
        """{seam: {'baseline_s', 'window_s', 'drift', 'alert',
        'windows'}} — plain data for the Prometheus page. Seams that
        closed no window yet are omitted (no series churn for idle
        seams)."""
        out = {}
        for name, state in self.seams.items():
            if state.windows == 0:
                continue
            out[name] = {'baseline_s': state.ewma,
                         'window_s': state.last_window,
                         'drift': round(state.drift, 4),
                         'alert': int(state.alert.active),
                         'windows': state.windows}
        return out

    def active_alerts(self):
        return [name for name, s in self.seams.items() if s.alert.active]


_default_baselines = None


def baselines():
    """The default registry (created enabled=False state on first use)."""
    global _default_baselines
    if _default_baselines is None:
        _default_baselines = PerfBaselines()
    return _default_baselines


_baselines_on = False


def enable_baselines(**kwargs):
    """Install (and reset) the default baselines registry; service ticks
    then drive it through ``maybe_tick``."""
    global _default_baselines, _baselines_on
    _default_baselines = PerfBaselines(**kwargs)
    _baselines_on = True
    return _default_baselines


def disable_baselines():
    global _baselines_on
    _baselines_on = False


def maybe_tick():
    """The per-tick hook (DocService.pump): one flag check when off."""
    if _baselines_on:
        baselines().tick()


def baseline_gauges():
    """Gauges of the default registry when enabled, else {} (what
    export.snapshot_all reads)."""
    if not _baselines_on or _default_baselines is None:
        return {}
    return _default_baselines.gauges()


# ---- device-kernel cost ledger ---------------------------------------------

_ledger_lock = threading.Lock()
_ledger_enabled = False
_kernels = {}                  # kind -> _KernelEntry


class _KernelEntry:
    __slots__ = ('kind', 'fn', 'dispatches', 'seconds', 'sigs')

    def __init__(self, kind, fn):
        self.kind = kind
        self.fn = fn
        self.dispatches = 0
        self.seconds = 0.0
        # sig key -> {'count', 'seconds', 'cost': {'bytes accessed': B}}
        self.sigs = {}


def _flatten(obj, out):
    """Append the leaves of a call's arguments (or result) to `out` in a
    fixed order: tensors and arrays, and the scalars beside them.
    Tuples (NamedTuples too), lists and dicts recurse, and so do the
    port's state and op-batch classes (FleetState, OpBatch,
    RegisterState, SeqState, ...: ``__slots__`` classes whose slots
    hold their tensors)."""
    if isinstance(obj, (tuple, list)):
        for item in obj:
            _flatten(item, out)
    elif isinstance(obj, dict):
        for key in sorted(obj):
            _flatten(obj[key], out)
    elif hasattr(obj, 'shape') and hasattr(obj, 'dtype'):
        out.append(obj)
    else:
        slots = getattr(type(obj), '__slots__', None)
        if slots and not isinstance(obj, (str, bytes)):
            for name in ((slots,) if isinstance(slots, str) else slots):
                _flatten(getattr(obj, name, None), out)
        else:
            out.append(obj)
    return out


def _sig_key(leaves):
    """Hashable signature of flattened call leaves: arrays by (shape,
    dtype), everything else (static ints, bools) by repr. The steady
    state computes ONLY this — the cost is worked out on a signature
    MISS, never per dispatch."""
    key = []
    for leaf in leaves:
        shape = getattr(leaf, 'shape', None)
        dtype = getattr(leaf, 'dtype', None)
        if shape is not None and dtype is not None:
            key.append(('a', tuple(shape), str(dtype)))
        else:
            key.append(('s', repr(leaf)))
    return tuple(key)


def _nbytes(leaves):
    """Bytes of the tensor and array leaves, from their shapes and
    dtypes (torch and numpy dtypes both carry ``itemsize``)."""
    total = 0
    for leaf in leaves:
        shape = getattr(leaf, 'shape', None)
        dtype = getattr(leaf, 'dtype', None)
        if shape is None or dtype is None:
            continue
        n = 1
        for dim in shape:
            n *= int(dim)
        total += n * int(getattr(dtype, 'itemsize', 0))
    return total


def instrument_kernel(kind, fn, guards=()):
    """Wrap a kernel entry point for the cost ledger. Off: one flag
    check of overhead per call. The wrapper only forwards (donated
    entry points still update their arguments in place), and exposes
    the wrapped callable as ``__wrapped__``. `guards` names keyword
    arguments that only guard the call on the host (the hash-index
    insert's load bound): they stay out of the signature, as they are
    no part of the launch's shape.

    Timing caveat: ``seconds`` is the HOST-BLOCKING wall time of the
    call. On the CPU that is the kernel's execution; on the card it is
    the launch (and any host work of the entry point) — the wrapper
    deliberately does NOT ``torch.cuda.synchronize()`` (that would
    serialize the launch queue the seam exists to keep full), so
    device-time attribution belongs to ``observability.trace`` profiler
    captures, and the derived GB/s columns read as host-side rates.

    The signature is taken from the arguments BEFORE the call: the
    donated entry points change their arguments in place."""
    entry = _KernelEntry(kind, fn)
    with _ledger_lock:
        _kernels[kind] = entry

    def wrapper(*args, **kwargs):
        if not _ledger_enabled:
            return fn(*args, **kwargs)
        leaves = _flatten((args, {k: v for k, v in kwargs.items()
                                  if k not in guards}), [])
        key = _sig_key(leaves)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        with _ledger_lock:
            entry.dispatches += 1
            entry.seconds += dt
            sig = entry.sigs.get(key)
        if sig is None:
            # signature MISS (one per distinct shape): only now work out
            # the bytes the call reads and writes
            cost = {'bytes accessed':
                    float(_nbytes(leaves) + _nbytes(_flatten(out, [])))}
            with _ledger_lock:
                sig = entry.sigs.setdefault(
                    key, {'count': 0, 'seconds': 0.0, 'cost': cost})
        with _ledger_lock:
            sig['count'] += 1
            sig['seconds'] += dt
        _stats.inc('kernel_dispatches')
        return out

    wrapper.__name__ = getattr(fn, '__name__', kind)
    wrapper.__doc__ = getattr(fn, '__doc__', None)
    wrapper.__wrapped__ = fn
    wrapper.kernel_kind = kind
    return wrapper


def enable_ledger():
    global _ledger_enabled
    _ledger_enabled = True


def disable_ledger():
    global _ledger_enabled
    _ledger_enabled = False


def ledger_on():
    return _ledger_enabled


def kernel_kinds():
    with _ledger_lock:
        return sorted(_kernels)


def reset_ledger():
    """Zero every entry's counters (instrumented kinds stay wired)."""
    with _ledger_lock:
        for entry in _kernels.values():
            entry.dispatches = 0
            entry.seconds = 0.0
            entry.sigs = {}


def kernel_snapshot():
    """{kind: {'dispatches', 'seconds', 'signatures'}} — the cheap
    monotonic view (Prometheus gauges; no cost math)."""
    with _ledger_lock:
        return {kind: {'dispatches': e.dispatches,
                       'seconds': e.seconds,
                       'signatures': len(e.sigs)}
                for kind, e in _kernels.items() if e.dispatches}


_COST_KEYS = ('flops', 'bytes accessed', 'transcendentals',
              'utilization operand 0', 'optimal_seconds')


def kernel_report(include_costs=True):
    """The full ledger: per kind, dispatch count, blocking wall seconds,
    and per-signature cost (bytes accessed, worked out from the recorded
    shapes). The shape ``tools/obs_report.py --floor`` renders; the
    flops and rate totals appear only where a cost reports flops, as in
    the reference."""
    with _ledger_lock:
        entries = [(kind, e, {k: dict(s) for k, s in e.sigs.items()})
                   for kind, e in _kernels.items() if e.dispatches]
    report = {}
    for kind, entry, sigs in entries:
        kind_row = {'dispatches': entry.dispatches,
                    'seconds': round(entry.seconds, 6),
                    'signatures': []}
        flops_total = bytes_total = 0.0
        have_cost = False
        for sig in sigs.values():
            row = {'dispatches': sig['count'],
                   'seconds': round(sig['seconds'], 6)}
            if include_costs:
                cost = sig['cost']
                row['cost'] = {k: v for k, v in cost.items()
                               if k in _COST_KEYS or k == 'error'}
                if 'flops' in cost:
                    have_cost = True
                    flops_total += cost['flops'] * sig['count']
                    bytes_total += cost.get('bytes accessed', 0.0) * \
                        sig['count']
            kind_row['signatures'].append(row)
        if have_cost:
            kind_row['flops_total'] = flops_total
            kind_row['bytes_accessed_total'] = bytes_total
            if entry.seconds > 0:
                kind_row['gflops_per_s'] = flops_total / entry.seconds / 1e9
                kind_row['gbytes_per_s'] = bytes_total / entry.seconds / 1e9
        report[kind] = kind_row
    return report


def dump_ledger(path, include_costs=True, extra=None):
    """Write the ledger report as JSON (the ``obs_report --floor``
    input), atomically (temp + rename)."""
    body = {'kind': 'kernel_ledger', 'ts': time.time(),
            'kernels': kernel_report(include_costs=include_costs)}
    if extra:
        body.update(extra)
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w') as f:
        json.dump(body, f, indent=1, default=repr)
    os.replace(tmp, path)
    return path

# ---- memory watermarks -----------------------------------------------------

_mem_sources = {}
_mem_high = {}
_mem_last = {}
_mem_lock = threading.Lock()


def register_mem_source(name, fn):
    """Register a zero-arg callable returning a tier's CURRENT resident
    bytes (same registry discipline as register_dispatch_source; unlike
    the counter roll-ups these are gauges, so re-reads may go down)."""
    with _mem_lock:
        _mem_sources[name] = fn


def rss_bytes():
    """(rss, hwm) bytes of this process. Linux: VmRSS/VmHWM from
    /proc/self/status (the kernel's own high watermark); elsewhere:
    ru_maxrss doubles for both."""
    try:
        with open('/proc/self/status') as f:
            rss = hwm = 0
            for line in f:
                if line.startswith('VmRSS:'):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith('VmHWM:'):
                    hwm = int(line.split()[1]) * 1024
            if rss:
                return rss, (hwm or rss)
    except OSError:
        pass
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return peak, peak


def page_fault_counts():
    """(minor, major) page faults for this process since start. Major
    faults are the storage tier's cold-read signal: an mmap'd parked
    chunk served off the page cache costs zero; one read from disk
    costs a major fault. Linux: /proc/self/stat fields 10/12;
    elsewhere: getrusage ru_minflt/ru_majflt."""
    try:
        with open('/proc/self/stat') as f:
            # field 2 (comm) may contain spaces — split after the
            # closing paren
            rest = f.read().rsplit(')', 1)[1].split()
        # rest[0] is field 3 (state); minflt/majflt are fields 10/12
        return int(rest[7]), int(rest[9])
    except (OSError, IndexError, ValueError):
        pass
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return int(ru.ru_minflt), int(ru.ru_majflt)


def sample_watermarks():
    """Read every tier source + RSS, fold the process-lifetime highs,
    return current values. Cost: one /proc read + one call per source —
    a per-tick sampler, not a per-request one. Page-fault counters ride
    along under 'pagefaults_minor'/'pagefaults_major' (monotonic
    counters, not byte gauges — the storage tier's cold-read split)."""
    rss, hwm = rss_bytes()
    current = {'rss': rss}
    highs = {'rss': max(hwm, rss)}
    minor, major = page_fault_counts()
    current['pagefaults_minor'] = highs['pagefaults_minor'] = minor
    current['pagefaults_major'] = highs['pagefaults_major'] = major
    for name, fn in list(_mem_sources.items()):
        try:
            value = int(fn())
        # archlint: ok[typed-errors] containment: a dying mem source must not take the sampler down; the source is skipped, not trusted
        except Exception:                         # noqa: BLE001
            continue
        current[name] = value
        highs[name] = value
    # sources were read unlocked (they may call back into modules that
    # take their own locks); only the shared fold holds _mem_lock
    with _mem_lock:
        for name, value in highs.items():
            _mem_high[name] = max(_mem_high.get(name, 0), value)
        _mem_last.clear()
        _mem_last.update(current)
    return current


def watermark_snapshot(sample=True):
    """{'current': {tier: bytes}, 'high': {tier: bytes}} — optionally
    sampling first (the exporter path samples so a scrape is never
    staler than its own page)."""
    current = sample_watermarks() if sample else dict(_mem_last)
    return {'current': current, 'high': dict(_mem_high)}


def reset_watermarks():
    with _mem_lock:
        _mem_high.clear()
        _mem_last.clear()


# the observatory's own rings are tiers too (bounded by design, but the
# bound should be VISIBLE): rough per-slot estimates, documented as such
def _span_ring_bytes():
    from . import spans as _spans
    return _spans._cap * 120        # (name, 2 ints, tid, attrs) estimate


def _flight_ring_bytes():
    return len(_flight._events) * 200


register_mem_source('span_ring_est', _span_ring_bytes)
register_mem_source('flight_ring_est', _flight_ring_bytes)


# ---- the one switch --------------------------------------------------------

def enable_observatory(**baseline_kwargs):
    """All three legs on (plus spans/histograms via observability.enable
    stays the caller's choice — the observatory needs only histograms).
    Returns the baselines registry."""
    _hist.enable()
    enable_ledger()
    reg = enable_baselines(**baseline_kwargs)
    sample_watermarks()
    return reg


def disable_observatory():
    disable_ledger()
    disable_baselines()
