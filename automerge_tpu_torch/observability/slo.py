"""Per-tenant SLO telemetry: SLIs, error budgets, burn-rate alerting.

The flight recorder answers post-hoc forensic questions; this module
answers the standing one — *is each tenant inside its service
objectives right now, and if not, how fast is its error budget
burning?* Three SLI families, all maintained as cheap rolling deltas
over state the request path already touches (the continuous-view
framing of "Formal Foundations of Continuous Graph Processing",
PAPERS.md: incremental maintenance over the event stream, never a full
rescan):

- **Latency**: per (tenant, kind), the fraction of committed requests
  completing under ``SloPolicy.threshold_s``, classified bucketwise on
  the per-pair ``service_request_s`` log2 histogram: good iff the
  bucket's UPPER bound is within the threshold (the boundary bucket is
  precomputed per pair, so the per-request cost is one integer
  compare). The per-tick (good, bad) movement the windows consume is
  the INCREMENTAL form of ``counts_delta``/``Histogram.delta`` between
  consecutive tick snapshots — accumulated at record time instead of
  recomputed by subtraction, same numbers, none of the rescan
  (tests/test_slo.py pins the equivalence).
- **Availability**: committed vs typed-rejection fractions, split by
  rejection class. The classes burn DIFFERENT budgets —
  ``TenantThrottled`` (the tenant ran itself dry; a generous budget),
  ``Overloaded`` (the service shed; a tight budget), and
  ``DeadlineExceeded`` (admitted but too late; the tightest) — so a
  tenant flooding itself into throttles cannot mask the service
  starting to shed other work. The class comes from the typed error's
  ``budget`` attribute (errors.py), never from string matching.
- **Freshness**: subscription cursor lag in service ticks — how long a
  subscriber's cursor trailed the document heads before a push caught
  it up (fed by ``DocService._run_subscriptions`` and
  ``SubscriptionHub.bind_slo``).

Objectives are ``SloPolicy(target, ...)`` declarations resolved most
specific first: (tenant, kind) > kind > registry default, cached per
pair. Evaluation is multi-window burn-rate alerting: burn =
bad_fraction / (1 - target) over a FAST window (default 5 ticks, high
threshold — pages on sharp regressions) and a SLOW window (default 60
ticks, low threshold — catches slow leaks), each window's alert
edge-triggered and hysteretic like the brownout ladder (sustained
above-threshold ticks to fire, sustained below-clear ticks to clear,
so a flapping signal cannot thrash). Every transition bumps the
``slo_alerts_fired``/``slo_alerts_cleared`` health counters, lands in
the flight-recorder event ring, and an alert FIRING assembles a full
forensic dump carrying the offending tenant's recent request outcomes.

``SloRegistry.record`` is the per-request hot path (a few dict adds +
one histogram record); ``tick()`` runs once per service tick over the
DIRTY pairs only, plus the pairs with a currently-firing alert (their
clear hysteresis needs per-tick decay) — an idle pair costs NOTHING
per tick, its windows catching up with zeros on the next push. The
steady-state cost is therefore proportional to the tenants actually
talking this tick, not the tenant universe, which is what holds the
measured budget to <=2% on the 10k-session clean service leg (bench.py
``slo`` section, paired alternating-order reps — BASELINE.md "SLO
contract").
"""

import array
import collections

from . import hist as _hist
from . import recorder as _flight
from .metrics import Counters, register_health_source

__all__ = ['SloPolicy', 'SloRegistry', 'outcome_class', 'slo_stats',
           'DEFAULT_POLICIES', 'AVAILABILITY_CLASSES']

# rejection classes that burn an availability budget (each its own SLO;
# 'wire'/'error'/'retries' outcomes are tallied but burn no budget by
# default — they are the CLIENT's bytes or a typed retry exhaustion)
AVAILABILITY_CLASSES = ('throttled', 'overloaded', 'deadline')

_stats = Counters({
    'slo_alerts_fired': 0,       # alert activations (monotonic)
    'slo_alerts_cleared': 0,     # alert deactivations (monotonic)
    'slo_alerts_active': 0,      # currently-firing alerts (gauge)
    'slo_ticks': 0,              # registry evaluation ticks (monotonic)
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def slo_stats():
    return dict(_stats)


def outcome_class(error):
    """Budget class of one request resolution: 'committed' for success,
    the typed error's ``budget`` attribute ('throttled' / 'overloaded' /
    'deadline') for the shedding classes, 'retries' for exhausted retry
    schedules, 'wire' for corruption the client sent, 'error' for
    everything else typed."""
    if error is None:
        return 'committed'
    budget = getattr(error, 'budget', None)
    if budget is not None:
        return budget
    from ..errors import RetriesExhausted, WireCorruption
    if isinstance(error, RetriesExhausted):
        return 'retries'
    if isinstance(error, WireCorruption):
        return 'wire'
    return 'error'


class SloPolicy:
    """One objective: ``target`` is the good fraction (0.99 = 1% error
    budget). ``threshold_s`` scopes latency SLOs (a committed request is
    good iff its histogram bucket's upper bound is <= threshold_s —
    conservative, like the percentile convention in hist.py);
    ``max_lag_ticks`` scopes freshness SLOs. Window geometry and burn
    thresholds: the FAST window (default 5 ticks) alerts at
    ``fast_burn`` (sharp regressions), the SLOW window (default 60) at
    ``slow_burn`` (slow leaks). Hysteresis mirrors the brownout ladder:
    burn must hold >= the threshold for ``up_ticks`` evaluations to
    fire and <= threshold/2 for ``down_ticks`` to clear; windows with
    fewer than ``min_events`` observations evaluate as burn 0 (no
    alerting on noise floors)."""

    __slots__ = ('target', 'threshold_s', 'max_lag_ticks', 'fast_window',
                 'slow_window', 'fast_burn', 'slow_burn', 'up_ticks',
                 'down_ticks', 'min_events')

    def __init__(self, target, threshold_s=None, max_lag_ticks=None,
                 fast_window=5, slow_window=60, fast_burn=8.0,
                 slow_burn=2.0, up_ticks=2, down_ticks=10, min_events=8):
        if not 0.0 < target < 1.0:
            raise ValueError(f'target must be in (0, 1), got {target!r}')
        self.target = float(target)
        self.threshold_s = threshold_s
        self.max_lag_ticks = max_lag_ticks
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        if self.fast_window <= 0 or self.slow_window < self.fast_window:
            raise ValueError('need 0 < fast_window <= slow_window')
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.min_events = int(min_events)

    @property
    def budget(self):
        return 1.0 - self.target

    def __repr__(self):
        return (f'SloPolicy(target={self.target}, '
                f'threshold_s={self.threshold_s}, '
                f'max_lag_ticks={self.max_lag_ticks})')


# Registry defaults: deliberately loose enough that a healthy service
# never pages, documented in BASELINE.md "SLO contract". Callers with a
# real contract override per kind or per (tenant, kind).
DEFAULT_POLICIES = {
    'latency': SloPolicy(0.99, threshold_s=0.25),
    'avail_throttled': SloPolicy(0.95),
    'avail_overloaded': SloPolicy(0.99),
    'avail_deadline': SloPolicy(0.995),
    'freshness': SloPolicy(0.95, max_lag_ticks=8),
}


class _Window:
    """One (good, bad) event stream evaluated over two nested rolling
    tick windows, held in a PREALLOCATED ring of ``slow_n`` per-tick
    slots (slot = tick % slow_n) with running sums for both spans — a
    push mutates ints in place and allocates NOTHING. That matters
    beyond the raw op count: the first cut kept (tick, good, bad)
    tuples in eviction deques, and the ~10^5 short-lived tuples per
    service leg tripled the measured overhead via gen-0 GC pressure
    (the collector's cost lands OUTSIDE the accounting wrappers, which
    is exactly how it hid from the in-leg attribution).

    A gap of idle ticks is caught up on the next push by zeroing only
    the skipped slots (bounded by ``slow_n``; a gap past the slow span
    resets the whole ring in O(slow_n), independent of gap length), so
    idle pairs still cost nothing per tick. Sums are identical to the
    dense per-tick interpretation: a window covers the half-open tick
    span (now - n, now]."""

    __slots__ = ('fast_n', 'slow_n', 'ring_good', 'ring_bad',
                 'fast_good', 'fast_bad', 'slow_good', 'slow_bad',
                 'last_tick', 'zero_published')

    def __init__(self, fast_n, slow_n):
        self.fast_n = fast_n
        self.slow_n = slow_n
        # array('q'), not list: raw C longs carry no per-slot PyObject
        # pointers, so a registry's hundreds of rings add NOTHING to
        # the GC's gen-1/2 scan working set (with list rings the sweep
        # cost showed up as paired-leg overhead the in-leg attribution
        # could not see)
        self.ring_good = array.array('q', bytes(8 * slow_n))
        self.ring_bad = array.array('q', bytes(8 * slow_n))
        self.fast_good = self.fast_bad = 0
        self.slow_good = self.slow_bad = 0
        self.last_tick = None
        self.zero_published = False    # healthy gauge already rendered 0

    def _advance(self, tick):
        """Roll the ring forward to ``tick``: every tick slot walked in
        order, evicting the slot's previous occupant (tick - slow_n)
        from the slow sums and the tick leaving the fast span from the
        fast sums, then zeroing the slot for its new tick."""
        last = self.last_tick
        slow_n = self.slow_n
        if last is None or tick - last >= slow_n:
            ring = self.ring_good
            for i in range(slow_n):
                ring[i] = 0
            ring = self.ring_bad
            for i in range(slow_n):
                ring[i] = 0
            self.fast_good = self.fast_bad = 0
            self.slow_good = self.slow_bad = 0
        else:
            ring_good = self.ring_good
            ring_bad = self.ring_bad
            fast_n = self.fast_n
            for t in range(last + 1, tick + 1):
                # fast eviction first: with fast_n == slow_n the two
                # horizons share a slot, and the slow step zeroes it
                f = (t - fast_n) % slow_n
                g = ring_good[f]
                b = ring_bad[f]
                if g or b:
                    self.fast_good -= g
                    self.fast_bad -= b
                s = t % slow_n
                g = ring_good[s]
                b = ring_bad[s]
                if g or b:
                    self.slow_good -= g
                    self.slow_bad -= b
                    ring_good[s] = 0
                    ring_bad[s] = 0
        self.last_tick = tick

    def push(self, tick, good, bad):
        self._advance(tick)
        if good or bad:
            s = tick % self.slow_n
            self.ring_good[s] = good
            self.ring_bad[s] = bad
            self.slow_good += good
            self.slow_bad += bad
            self.fast_good += good
            self.fast_bad += bad
            if bad:
                self.zero_published = False

    @property
    def empty(self):
        return self.slow_good == 0 and self.slow_bad == 0

    def burn(self, policy):
        """(fast_burn, slow_burn) rates vs the policy's error budget.
        Windows under ``min_events`` observations read 0 (noise floor)."""
        out = []
        for good, bad in ((self.fast_good, self.fast_bad),
                          (self.slow_good, self.slow_bad)):
            total = good + bad
            if total < policy.min_events:
                out.append(0.0)
            else:
                out.append((bad / total) / policy.budget)
        return out[0], out[1]


class _AvailWindow:
    """The three availability SLIs share their good stream (committed
    requests) and, in the healthy steady state, differ in nothing at
    all — so one merged window carries (committed, throttled,
    overloaded, deadline) per entry with running sums per class,
    turning three deque pushes + three evictions per dirty pair per
    tick into one. Requires the classes' policies to share window
    geometry (the defaults do; heterogeneous geometries fall back to
    per-SLI ``_Window``s). Per-class burn semantics are identical to
    three independent windows: an SLI's denominator is committed + its
    OWN bad class."""

    __slots__ = ('fast_n', 'slow_n', 'ring', 'fast', 'slow',
                 'last_tick', 'zero_published')

    def __init__(self, fast_n, slow_n):
        self.fast_n = fast_n
        self.slow_n = slow_n
        # flat preallocated ring: 4 lanes per tick slot (same
        # allocation-free, GC-invisible discipline as _Window)
        self.ring = array.array('q', bytes(8 * slow_n * 4))
        self.fast = [0, 0, 0, 0]     # committed, throttled, over, deadline
        self.slow = [0, 0, 0, 0]
        self.last_tick = None
        self.zero_published = False

    def _advance(self, tick):
        last = self.last_tick
        slow_n = self.slow_n
        ring = self.ring
        if last is None or tick - last >= slow_n:
            for i in range(slow_n * 4):
                ring[i] = 0
            self.fast = [0, 0, 0, 0]
            self.slow = [0, 0, 0, 0]
        else:
            fast_n = self.fast_n
            fast = self.fast
            slow = self.slow
            for t in range(last + 1, tick + 1):
                f = ((t - fast_n) % slow_n) * 4
                if ring[f] or ring[f + 1] or ring[f + 2] or ring[f + 3]:
                    fast[0] -= ring[f]
                    fast[1] -= ring[f + 1]
                    fast[2] -= ring[f + 2]
                    fast[3] -= ring[f + 3]
                s = (t % slow_n) * 4
                if ring[s] or ring[s + 1] or ring[s + 2] or ring[s + 3]:
                    slow[0] -= ring[s]
                    slow[1] -= ring[s + 1]
                    slow[2] -= ring[s + 2]
                    slow[3] -= ring[s + 3]
                    ring[s] = ring[s + 1] = ring[s + 2] = ring[s + 3] = 0
        self.last_tick = tick

    def push(self, tick, committed, thr, ovl, dl):
        self._advance(tick)
        if committed or thr or ovl or dl:
            s = (tick % self.slow_n) * 4
            ring = self.ring
            ring[s] = committed
            ring[s + 1] = thr
            ring[s + 2] = ovl
            ring[s + 3] = dl
            slow = self.slow
            slow[0] += committed
            fast = self.fast
            fast[0] += committed
            if thr or ovl or dl:
                slow[1] += thr
                slow[2] += ovl
                slow[3] += dl
                fast[1] += thr
                fast[2] += ovl
                fast[3] += dl
                self.zero_published = False

    @property
    def bad_total(self):
        slow = self.slow
        return slow[1] + slow[2] + slow[3]

    @property
    def empty(self):
        return not any(self.slow)

    def burn(self, idx, policy):
        """(fast, slow) burn of availability class ``idx`` (0=throttled,
        1=overloaded, 2=deadline) vs its policy."""
        out = []
        for sums in (self.fast, self.slow):
            total = sums[0] + sums[idx + 1]
            if total < policy.min_events:
                out.append(0.0)
            else:
                out.append((sums[idx + 1] / total) / policy.budget)
        return out[0], out[1]


class _Alert:
    """Hysteretic edge-triggered alert state for one window of one SLO
    (the brownout ladder's transition discipline, applied to burn)."""

    __slots__ = ('active', 'above', 'below')

    def __init__(self):
        self.active = False
        self.above = 0
        self.below = 0

    def observe(self, burn, threshold, up_ticks, down_ticks):
        """Returns 'fire' / 'clear' on an edge, None otherwise."""
        if burn >= threshold:
            self.above += 1
            self.below = 0
        elif burn <= threshold / 2.0:
            self.below += 1
            self.above = 0
        else:
            self.above = 0
            self.below = 0
        if not self.active and self.above >= up_ticks:
            self.active = True
            self.above = 0
            return 'fire'
        if self.active and self.below >= down_ticks:
            self.active = False
            self.below = 0
            return 'clear'
        return None


# pending-delta slots (see _PairState.pending): one tick's (good, bad)
# movement per SLI, accumulated AT RECORD TIME so the tick roll never
# rescans counters or buckets. The committed count doubles as the good
# side of every availability SLO.
_P_COMMITTED, _P_THROTTLED, _P_OVERLOADED, _P_DEADLINE = 0, 1, 2, 3
_P_LAT_GOOD, _P_LAT_BAD, _P_FRESH_GOOD, _P_FRESH_BAD = 4, 5, 6, 7


class _PairState:
    """Everything the registry tracks for one (tenant, kind) pair."""

    __slots__ = ('tallies', 'hist', 'lag_max', 'windows', 'alerts',
                 'pending', 'policy_gen', 'lat_policy', 'lat_good_bucket',
                 'avail_policies', 'fresh_policy', 'avail_window')

    def __init__(self):
        self.tallies = {}            # outcome class -> monotonic count
        self.hist = None             # committed-request latency histogram
        self.lag_max = 0             # worst cursor lag ever seen (gauge)
        self.windows = {}            # sli -> _Window (latency/freshness,
        #                              and the avail fallback path)
        self.alerts = {}             # (sli, 'fast'|'slow') -> _Alert
        self.pending = [0] * 8       # this tick's per-SLI (good, bad)
        self.policy_gen = -1         # resolved-policy cache generation
        self.lat_policy = None
        self.lat_good_bucket = -1    # largest log2 bucket within threshold
        self.avail_policies = (None, None, None)
        self.fresh_policy = None
        self.avail_window = None     # merged _AvailWindow when geometry
        #                              is homogeneous across the classes


class SloRegistry:
    """See the module docstring. Single-writer by contract (the service
    tick thread); readers (the metrics exporter) take snapshot copies
    with a bounded retry, so a concurrent scrape never sees a torn
    dict."""

    def __init__(self, policies=None, tick_windows=True, forensics=24):
        base = dict(DEFAULT_POLICIES)
        if policies:
            base.update(policies)
        # (sli, tenant, kind) -> SloPolicy; None wildcards, resolved
        # most-specific-first and cached per concrete (tenant, kind, sli)
        self._policies = {(sli, None, None): p for sli, p in base.items()
                          if p is not None}
        self._policy_cache = {}
        self._policy_gen = 0         # bumped by set_policy: pairs re-pin
        self._pairs = {}             # (tenant, kind) -> _PairState
        self._dirty = set()          # pairs touched since the last tick
        self._alerting = set()       # pairs with an alert currently firing
        self._gauges = {}            # (tenant, kind, sli) -> gauge dict
        self._forensics = {}         # tenant -> deque of recent outcomes
        self._forensic_cap = int(forensics)
        self._tick_windows = bool(tick_windows)
        self.ticks = 0
        # (tick, tenant, kind, sli, window, 'fire'|'clear', burn) —
        # BOUNDED like every other telemetry ring here (a flapping
        # tenant must not grow process memory forever); lifetime totals
        # live in the slo_alerts_fired/cleared health counters, so a
        # wrapped log discloses its loss as fired+cleared-len(log)
        self.alert_log = collections.deque(maxlen=4096)

    # -- objectives -----------------------------------------------------

    def set_policy(self, sli, policy, tenant=None, kind=None):
        """Declare (or, with policy=None, remove) the objective for
        ``sli`` ('latency', 'avail_throttled', 'avail_overloaded',
        'avail_deadline', 'freshness'), scoped to a tenant and/or kind
        (None = wildcard)."""
        key = (sli, tenant, kind)
        if policy is None:
            self._policies.pop(key, None)
        else:
            self._policies[key] = policy
        self._policy_cache.clear()
        self._policy_gen += 1        # existing pairs re-pin lazily

    def policy_for(self, sli, tenant, kind):
        """Most-specific policy for (sli, tenant, kind); None when the
        SLI has no objective at any scope."""
        ckey = (sli, tenant, kind)
        try:
            return self._policy_cache[ckey]
        except KeyError:
            pass
        for key in ((sli, tenant, kind), (sli, None, kind),
                    (sli, tenant, None), (sli, None, None)):
            policy = self._policies.get(key)
            if policy is not None:
                break
        self._policy_cache[ckey] = policy
        return policy

    # -- the per-request hot path ---------------------------------------

    def _pair(self, tenant, kind):
        key = (tenant, kind)
        pair = self._pairs.get(key)
        if pair is None:
            pair = self._pairs[key] = _PairState()
        if pair.policy_gen != self._policy_gen:
            self._resolve_pair_policies(pair, tenant, kind)
        return pair

    def _resolve_pair_policies(self, pair, tenant, kind):
        """Pin the pair's resolved policies (re-done when set_policy
        bumps the generation): the hot path then classifies against
        plain attributes instead of walking the scope ladder. An SLI
        whose objective was REMOVED drops its windows and alerts here
        (an active alert counts as cleared — it must not dangle in the
        gauges or pin the pair in the per-tick alerting set)."""
        pair.policy_gen = self._policy_gen
        pair.lat_policy = self.policy_for('latency', tenant, kind)
        pair.lat_good_bucket = -1
        if pair.lat_policy is not None and \
                pair.lat_policy.threshold_s is not None:
            # good iff the log2 bucket's UPPER bound 2^b/scale is within
            # the threshold: b <= floor(log2(threshold * scale)) — the
            # bucketwise histogram-delta classification, precomputed to
            # one integer compare per committed request
            scaled = int(pair.lat_policy.threshold_s * 1e9)
            pair.lat_good_bucket = scaled.bit_length() - 1 \
                if scaled >= 1 else -1
        pair.avail_policies = tuple(
            self.policy_for(f'avail_{cls}', tenant, kind)
            for cls in AVAILABILITY_CLASSES)
        pair.fresh_policy = self.policy_for('freshness', tenant, kind)
        geometries = {(p.fast_window, p.slow_window)
                      for p in pair.avail_policies if p is not None}
        if len(geometries) == 1:
            geometry = geometries.pop()
            if pair.avail_window is None or \
                    (pair.avail_window.fast_n,
                     pair.avail_window.slow_n) != geometry:
                pair.avail_window = _AvailWindow(*geometry)
            # merged mode owns the avail accounting: per-SLI fallback
            # windows (from an earlier heterogeneous config) retire
            for cls in AVAILABILITY_CLASSES:
                pair.windows.pop(f'avail_{cls}', None)
        else:
            pair.avail_window = None
        live = {f'avail_{cls}' for cls, p in
                zip(AVAILABILITY_CLASSES, pair.avail_policies)
                if p is not None}
        if pair.lat_policy is not None:
            live.add('latency')
        if pair.fresh_policy is not None:
            live.add('freshness')
        for sli in [s for s in pair.windows if s not in live]:
            del pair.windows[sli]
        # gauges swept for EVERY de-declared SLI, not just windowed
        # ones: merged-avail mode keeps the avail SLIs out of
        # pair.windows, so their burn/alert gauges would otherwise
        # export stale series forever after set_policy(..., None)
        for sli in (['latency', 'freshness'] +
                    [f'avail_{c}' for c in AVAILABILITY_CLASSES]):
            if sli not in live:
                self._gauges.pop((tenant, kind, sli), None)
        for key in [k for k in pair.alerts if k[0] not in live]:
            alert = pair.alerts.pop(key)
            if alert.active:
                _stats.inc('slo_alerts_cleared')
                _stats.inc('slo_alerts_active', -1)
                self.alert_log.append((self.ticks, tenant, kind, key[0],
                                       key[1], 'clear', 0.0))
        if not any(a.active for a in pair.alerts.values()):
            self._alerting.discard((tenant, kind))

    def record(self, tenant, kind, latency_s, error=None, trace=None):
        """One request resolution (or typed admission rejection). The
        latency lands in the pair's histogram only for COMMITTED
        requests — a fast typed rejection must not flatter the latency
        SLI. ``trace`` is the request's trace id (tracecontext.py),
        kept in the forensic ring so an alert's dump stitches into the
        Perfetto view. This is the per-request hot path: the committed
        branch is laid out straight-line (no classifier call, one key
        tuple) because the clean leg takes it 100% of the time."""
        key = (tenant, kind)
        pair = self._pairs.get(key)
        if pair is None:
            pair = self._pairs[key] = _PairState()
        if pair.policy_gen != self._policy_gen:
            self._resolve_pair_policies(pair, tenant, kind)
        pending = pair.pending
        if error is None:
            cls = 'committed'
            hist = pair.hist
            if hist is None:
                hist = pair.hist = _hist.Histogram(
                    f'service_request_s:{tenant}:{kind}', scale=1e9,
                    unit='s')
            bucket = hist.record(latency_s)
            pending[_P_COMMITTED] += 1
            if pair.lat_good_bucket >= 0:
                if bucket <= pair.lat_good_bucket:
                    pending[_P_LAT_GOOD] += 1
                else:
                    pending[_P_LAT_BAD] += 1
        else:
            cls = outcome_class(error)
            if cls == 'throttled':
                pending[_P_THROTTLED] += 1
            elif cls == 'overloaded':
                pending[_P_OVERLOADED] += 1
            elif cls == 'deadline':
                pending[_P_DEADLINE] += 1
        pair.tallies[cls] = pair.tallies.get(cls, 0) + 1
        self._dirty.add(key)
        forensics = self._forensics.get(tenant)
        if forensics is None:
            forensics = self._forensics[tenant] = collections.deque(
                maxlen=self._forensic_cap)
        # latency kept as integer microseconds: cheaper than rounding a
        # float on every request, converted back at dump time
        forensics.append((self.ticks, kind, cls, int(latency_s * 1e6),
                          trace))

    def record_freshness(self, tenant, lag_ticks, kind='subscribe'):
        """One subscription push's cursor lag (ticks the cursor trailed
        the heads before this push). Good iff within the freshness
        policy's ``max_lag_ticks``; without a policy only the lag gauge
        moves."""
        pair = self._pair(tenant, kind)
        if lag_ticks > pair.lag_max:
            pair.lag_max = lag_ticks
        policy = pair.fresh_policy
        if policy is None or policy.max_lag_ticks is None:
            return
        if lag_ticks <= policy.max_lag_ticks:
            pair.pending[_P_FRESH_GOOD] += 1
        else:
            pair.pending[_P_FRESH_BAD] += 1
        self._dirty.add((tenant, kind))

    # -- the tick -------------------------------------------------------

    def tick(self, now=None):
        """One evaluation round over the DIRTY pairs (touched since the
        last tick) plus the pairs with a currently-firing alert (their
        clear hysteresis needs per-tick decay). Idle pairs cost NOTHING
        here — their windows catch up with zeros when they next push
        (see _Window.push) — so the steady-state tick is O(talkers),
        independent of the tenant universe and of request volume."""
        self.ticks += 1
        _stats.inc('slo_ticks')
        if not self._tick_windows:
            self._dirty.clear()
            return
        transitions = []
        todo = self._dirty
        if self._alerting:
            todo = todo | self._alerting
        for key in todo:
            pair = self._pairs[key]
            if pair.policy_gen != self._policy_gen:
                # a policy change mid-flight: re-pin (and shed windows/
                # alerts for de-declared SLIs) even if the pair is only
                # here because its alert is decaying
                self._resolve_pair_policies(pair, key[0], key[1])
            self._roll(key, pair, transitions)
        self._dirty = set()
        for tenant, kind, sli, window, edge, burn in transitions:
            self._transition(tenant, kind, sli, window, edge, burn)

    def _roll(self, key, pair, transitions):
        """Push one pair's pending per-SLI (good, bad) deltas — the
        incremental form of ``counts_delta`` between consecutive tally
        snapshots, accumulated at record time — into its windows, then
        evaluate burn and drive the alert edges."""
        tenant, kind = key
        pending = pair.pending
        tick_no = self.ticks
        committed = pending[_P_COMMITTED]
        windows = pair.windows
        avail_window = pair.avail_window
        if avail_window is not None:
            # merged path (homogeneous geometry — the default config):
            # ONE push covers all three classes, and the healthy fast
            # path skips all three evaluations in one compare
            avail_window.push(tick_no, committed, pending[_P_THROTTLED],
                              pending[_P_OVERLOADED],
                              pending[_P_DEADLINE])
            if not (avail_window.bad_total == 0 and
                    avail_window.zero_published and not pair.alerts):
                for i, cls in enumerate(AVAILABILITY_CLASSES):
                    policy = pair.avail_policies[i]
                    if policy is None:
                        continue
                    fast, slow = avail_window.burn(i, policy)
                    self._drive_alert(tenant, kind, 'avail_' + cls,
                                      policy, fast, slow, pair,
                                      transitions)
                if avail_window.bad_total == 0:
                    avail_window.zero_published = True
        else:
            for i, cls in enumerate(AVAILABILITY_CLASSES):
                policy = pair.avail_policies[i]
                if policy is None:
                    continue
                sli = 'avail_' + cls
                bad = pending[i + 1]
                window = windows.get(sli)
                if window is None:
                    if not (committed or bad):
                        continue
                    window = windows[sli] = _Window(policy.fast_window,
                                                    policy.slow_window)
                window.push(tick_no, committed, bad)
                self._evaluate_one(tenant, kind, sli, policy, window,
                                   pair, transitions)
        policy = pair.lat_policy
        if policy is not None and pair.lat_good_bucket >= 0:
            good, bad = pending[_P_LAT_GOOD], pending[_P_LAT_BAD]
            window = windows.get('latency')
            if window is None and (good or bad):
                window = windows['latency'] = _Window(policy.fast_window,
                                                      policy.slow_window)
            if window is not None:
                window.push(tick_no, good, bad)
                self._evaluate_one(tenant, kind, 'latency', policy,
                                   window, pair, transitions)
        policy = pair.fresh_policy
        if policy is not None:
            good, bad = pending[_P_FRESH_GOOD], pending[_P_FRESH_BAD]
            window = windows.get('freshness')
            if window is None and (good or bad):
                window = windows['freshness'] = _Window(
                    policy.fast_window, policy.slow_window)
            if window is not None:
                window.push(tick_no, good, bad)
                self._evaluate_one(tenant, kind, 'freshness', policy,
                                   window, pair, transitions)
        for i in range(8):
            pending[i] = 0

    def _evaluate_one(self, tenant, kind, sli, policy, window, pair,
                      transitions):
        if window.slow_bad == 0 and window.zero_published and \
                (sli, 'fast') not in pair.alerts and \
                (sli, 'slow') not in pair.alerts:
            # the healthy steady state (the clean leg's every pair): no
            # bad events anywhere in the slow span, gauges already read
            # 0, no alert brewing or decaying — nothing can transition,
            # so the evaluation is three compares and out
            return
        fast, slow = window.burn(policy)
        self._drive_alert(tenant, kind, sli, policy, fast, slow, pair,
                          transitions)
        if window.slow_bad == 0:
            window.zero_published = True

    def _drive_alert(self, tenant, kind, sli, policy, fast, slow, pair,
                     transitions):
        """Publish one SLI's burns to its gauge and run both windows'
        hysteretic alert machinery."""
        gauge = self._gauges.get((tenant, kind, sli))
        if gauge is None:
            gauge = self._gauges[(tenant, kind, sli)] = {}
        gauge['fast_burn'] = fast
        gauge['slow_burn'] = slow
        for wname, burn, threshold in (('fast', fast, policy.fast_burn),
                                       ('slow', slow, policy.slow_burn)):
            alert = pair.alerts.get((sli, wname))
            if alert is None:
                if burn < threshold:
                    gauge['alert_' + wname] = 0
                    continue        # nothing brewing: stay allocation-free
                alert = pair.alerts[(sli, wname)] = _Alert()
            edge = alert.observe(burn, threshold, policy.up_ticks,
                                 policy.down_ticks)
            gauge['alert_' + wname] = int(alert.active)
            if edge is not None:
                transitions.append((tenant, kind, sli, wname, edge, burn))
            elif not alert.active and not alert.above:
                # no fire streak brewing (an inactive alert's `below`
                # counter drives nothing): drop the object so the
                # healthy fast path above re-engages
                del pair.alerts[(sli, wname)]

    def _transition(self, tenant, kind, sli, window, edge, burn):
        pair = self._pairs[(tenant, kind)]
        if edge == 'fire':
            _stats.inc('slo_alerts_fired')
            _stats.inc('slo_alerts_active')
            # a firing pair joins the per-tick evaluation set: its clear
            # hysteresis must decay even if the tenant goes silent
            self._alerting.add((tenant, kind))
        else:
            _stats.inc('slo_alerts_cleared')
            _stats.inc('slo_alerts_active', -1)
            if not any(a.active for a in pair.alerts.values()):
                self._alerting.discard((tenant, kind))
        self.alert_log.append((self.ticks, tenant, kind, sli, window,
                               edge, round(burn, 3)))
        _flight.record_event('slo_alert', tenant=tenant,
                             request_kind=kind, sli=sli, window=window,
                             edge=edge, burn=round(burn, 3),
                             tick=self.ticks)
        if edge == 'fire':
            # the forensic dump an on-call reads first: which tenant,
            # which objective, and what its last requests looked like
            _flight.dump_flight_record('slo', detail={
                'alert': {'tenant': tenant, 'kind': kind, 'sli': sli,
                          'window': window, 'burn': round(burn, 3),
                          'tick': self.ticks},
                'recent_requests': [
                    {'tick': t, 'kind': k, 'outcome': c,
                     'latency_ms': us / 1e3,
                     **({'trace': tr} if tr is not None else {})}
                    for t, k, c, us, tr in
                    self._forensics.get(tenant, ())],
            })

    # -- read surfaces ---------------------------------------------------

    @staticmethod
    def _copy(d, deep=False):
        """Snapshot a dict that a concurrent writer may be growing: a
        plain dict() copy with a bounded retry on the (rare) resize
        race. The VALUES are ints/tuples or dicts copied one level —
        enough for torn-free exposition."""
        for _ in range(8):
            try:
                if deep:
                    return {k: dict(v) for k, v in d.items()}
                return dict(d)
            except RuntimeError:
                continue
        return {}

    def tallies(self):
        """{(tenant, kind): {outcome class: count}} — the monotonic
        request-outcome tallies (the loadgen audit's server side). The
        inner dicts take the same retry-guarded copy as the outer map:
        a tick thread inserting a pair's FIRST outcome of a new class
        resizes that inner dict too."""
        return {key: self._copy(pair.tallies)
                for key, pair in self._copy(self._pairs).items()}

    def gauges(self):
        """{(tenant, kind, sli): {'fast_burn', 'slow_burn',
        'alert_fast', 'alert_slow'}} as of the last tick()."""
        return self._copy(self._gauges, deep=True)

    def lag_gauges(self):
        """{(tenant, kind): worst cursor lag seen} for pairs that
        recorded freshness."""
        return {key: pair.lag_max
                for key, pair in self._copy(self._pairs).items()
                if pair.lag_max}

    def histograms(self):
        """{(tenant, kind): Histogram} of committed-request latency —
        what the Prometheus exposition renders as per-tenant series."""
        return {key: pair.hist
                for key, pair in self._copy(self._pairs).items()
                if pair.hist is not None}

    def active_alerts(self):
        """[(tenant, kind, sli, window)] currently firing."""
        out = []
        for (tenant, kind), pair in self._copy(self._pairs).items():
            for (sli, wname), alert in self._copy(pair.alerts).items():
                if alert.active:
                    out.append((tenant, kind, sli, wname))
        return out
