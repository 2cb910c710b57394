# The port's copy of tests/test_slo.py: imports re-pointed at
# automerge_tpu_torch, fleets and hubs on the CPU (device='cpu'), the
# acceptance leg through service_cases.py (the port's loadgen).
"""Per-tenant SLO telemetry plane (ISSUE-10): SLI accounting, multi-
window burn-rate alerting, and the service/loadgen integration.

The contracts pinned here:

- outcome classification comes from the typed taxonomy's ``budget``
  attributes (TenantThrottled / Overloaded / DeadlineExceeded burn
  DIFFERENT budgets), never string matching;
- a latency regression fires the FAST-window burn alert within 10
  ticks (the acceptance bound), the transition moves health counters,
  lands in the flight-recorder event ring, and the firing dump carries
  the offending tenant's recent request forensics;
- alerts are hysteretic like the brownout ladder: a flapping burn
  signal cannot thrash, and recovery clears only after sustained
  below-threshold ticks;
- the service accounts EVERY resolution and every admission-edge
  rejection per (tenant, kind), which the loadgen audit then checks
  against client-observed outcomes exactly;
- the synthetic mid-leg latency step (loadgen ``latency_step``) is
  caught by the fast window within 10 ticks, visible in both the
  Prometheus exposition and a flight-recorder dump.
"""

import pytest

from automerge_tpu_torch import native
from automerge_tpu_torch.errors import (DeadlineExceeded, MalformedChange,
                                  Overloaded, RetriesExhausted,
                                  TenantThrottled)
from automerge_tpu_torch.observability import recorder as obs_recorder
from automerge_tpu_torch.observability import render_prometheus
from automerge_tpu_torch.observability.slo import (AVAILABILITY_CLASSES,
                                             SloPolicy, SloRegistry,
                                             _Window, outcome_class,
                                             slo_stats)

# ---------------------------------------------------------------------------
# classification and policy plumbing (no fleet, no clocks)
# ---------------------------------------------------------------------------


def test_outcome_class_follows_budget_attrs():
    assert outcome_class(None) == 'committed'
    assert outcome_class(TenantThrottled('t', tenant='a',
                                         retry_after=0.1)) == 'throttled'
    assert outcome_class(Overloaded('o', retry_after=None, shed=False,
                                    stage=None)) == 'overloaded'
    assert outcome_class(DeadlineExceeded('d', deadline=1.0,
                                          late_by=0.5)) == 'deadline'
    assert outcome_class(RetriesExhausted('r', attempts=3)) == 'retries'
    assert outcome_class(MalformedChange('m')) == 'wire'
    assert outcome_class(ValueError('x')) == 'error'
    assert set(AVAILABILITY_CLASSES) == {'throttled', 'overloaded',
                                         'deadline'}


def test_window_rolls_fast_inside_slow():
    w = _Window(fast_n=2, slow_n=4)
    for tick, (good, bad) in enumerate([(10, 0), (10, 0), (0, 10),
                                        (0, 10)], start=1):
        w.push(tick, good, bad)
    # fast window = last 2 ticks (all bad); slow = all 4 (half bad)
    assert (w.fast_good, w.fast_bad) == (0, 20)
    assert (w.slow_good, w.slow_bad) == (20, 20)
    policy = SloPolicy(0.9, min_events=1)
    fast, slow = w.burn(policy)
    assert fast == pytest.approx(1.0 / policy.budget)
    assert slow == pytest.approx(0.5 / policy.budget)
    # rolling off: four clean ticks drain both windows
    for tick in range(5, 9):
        w.push(tick, 0, 0)
    assert w.empty
    # a gap longer than the slow window resets in O(1) on the next push
    w.push(9, 3, 1)
    w.push(200, 1, 0)
    assert (w.slow_good, w.slow_bad) == (1, 0)


def test_window_ring_matches_dense_reference():
    """The preallocated-ring windows (allocation-free hot path) must
    agree with the obvious dense definition — sum over the half-open
    span (now - n, now] — under random sparse pushes with random gaps,
    including gaps past the slow span and fast_n == slow_n."""
    import random
    from automerge_tpu_torch.observability.slo import _AvailWindow
    rng = random.Random(7)
    for fast_n, slow_n in [(2, 5), (5, 60), (3, 3), (1, 8)]:
        w = _Window(fast_n, slow_n)
        aw = _AvailWindow(fast_n, slow_n)
        history = {}                       # tick -> pushed values
        tick = 0
        for _ in range(400):
            tick += rng.choice([1, 1, 1, 2, 3, slow_n, slow_n + 5])
            vals = [rng.randrange(4) for _ in range(4)]
            history[tick] = vals
            w.push(tick, vals[0], vals[1])
            aw.push(tick, *vals)
            for n, got in ((fast_n, (w.fast_good, w.fast_bad)),
                           (slow_n, (w.slow_good, w.slow_bad))):
                want = [sum(history.get(t, [0] * 4)[i]
                            for t in range(tick - n + 1, tick + 1))
                        for i in range(2)]
                assert list(got) == want, (fast_n, slow_n, tick)
            for n, got in ((fast_n, aw.fast), (slow_n, aw.slow)):
                want = [sum(history.get(t, [0] * 4)[i]
                            for t in range(tick - n + 1, tick + 1))
                        for i in range(4)]
                assert got == want, (fast_n, slow_n, tick)


def test_policy_resolution_most_specific_wins():
    reg = SloRegistry()
    base = SloPolicy(0.9)
    kind_p = SloPolicy(0.95)
    tenant_kind_p = SloPolicy(0.99)
    reg.set_policy('latency', base)
    reg.set_policy('latency', kind_p, kind='sync')
    reg.set_policy('latency', tenant_kind_p, tenant='whale', kind='sync')
    assert reg.policy_for('latency', 'minnow', 'apply') is base
    assert reg.policy_for('latency', 'minnow', 'sync') is kind_p
    assert reg.policy_for('latency', 'whale', 'sync') is tenant_kind_p
    # cache invalidates on re-declaration
    reg.set_policy('latency', None, kind='sync')
    assert reg.policy_for('latency', 'minnow', 'sync') is base


def test_min_events_gates_noise_floor():
    # 1 bad event per tick: the FAST window (5 ticks) holds fewer than
    # min_events=8 observations, so its burn must read 0 — a
    # near-silent tenant's single slow request cannot page. The slow
    # window (60 ticks) legitimately accumulates past the floor.
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.99, threshold_s=0.01, min_events=8)})
    for _ in range(10):
        reg.record('t', 'apply', 1.0)
        reg.tick()
    gauges = reg.gauges()
    assert gauges[('t', 'apply', 'latency')]['fast_burn'] == 0.0
    assert not any(w == 'fast' for *_rest, w in reg.active_alerts())


# ---------------------------------------------------------------------------
# burn-rate alerting
# ---------------------------------------------------------------------------


def run_step(reg, tenant='t1', kind='apply', good_ticks=30, rate=10,
             good_s=0.002, bad_s=0.5):
    """Clean traffic, then a latency step; returns ticks-to-fire of the
    fast window (None = never fired)."""
    for _ in range(good_ticks):
        for _ in range(rate):
            reg.record(tenant, kind, good_s)
        reg.tick()
    for t in range(1, 21):
        for _ in range(rate):
            reg.record(tenant, kind, bad_s)
        reg.tick()
        for (tn, kd, sli, window) in reg.active_alerts():
            if window == 'fast' and sli == 'latency':
                return t
    return None


def test_latency_step_fires_fast_alert_within_10_ticks():
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.99, threshold_s=0.05)})
    fired_after = run_step(reg)
    assert fired_after is not None and fired_after <= 10, fired_after
    # the transition is in the alert log, the health counters, and the
    # flight-recorder ring
    assert any(edge == 'fire' and sli == 'latency'
               for _, _, _, sli, _, edge, _ in reg.alert_log)
    assert slo_stats()['slo_alerts_fired'] >= 1
    events = [e for e in obs_recorder.recent_events()
              if e['kind'] == 'slo_alert' and e['edge'] == 'fire']
    assert events and events[-1]['tenant'] == 't1'
    # the firing dump carries the tenant's recent request forensics
    dump = obs_recorder.last_flight_record()
    assert dump['trigger'] == 'slo'
    assert dump['detail']['alert']['tenant'] == 't1'
    assert dump['detail']['recent_requests']
    assert all(r['outcome'] == 'committed'
               for r in dump['detail']['recent_requests'])


def test_alert_clears_hysteretically_after_recovery():
    policy = SloPolicy(0.99, threshold_s=0.05, down_ticks=6)
    reg = SloRegistry(policies={'latency': policy})
    assert run_step(reg) is not None
    # recovery: clean traffic; the alert must NOT clear before the burn
    # has drained below threshold/2 for down_ticks evaluations
    cleared_at = None
    for t in range(1, 40):
        for _ in range(10):
            reg.record('t1', 'apply', 0.002)
        reg.tick()
        if not any(w == 'fast' for *_x, _sli, w in
                   [(a[0], a[1], a[2], a[3]) for a in reg.active_alerts()]):
            cleared_at = t
            break
    assert cleared_at is not None
    assert cleared_at > policy.down_ticks // 2   # not instant
    assert slo_stats()['slo_alerts_cleared'] >= 1


def test_flapping_burn_does_not_thrash():
    # a 10% budget with burn threshold 8: one fully-bad tick spikes the
    # fast burn above threshold, but the following good ticks dilute
    # the window back under it before up_ticks consecutive evaluations
    # accumulate — the hysteresis the brownout ladder uses, applied to
    # burn, so an isolated spike per window never pages
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.9, threshold_s=0.05, up_ticks=2,
                             min_events=1)})
    for _ in range(30):
        for _ in range(10):
            reg.record('t', 'apply', 0.5)
        reg.tick()
        for _ in range(4):
            for _ in range(10):
                reg.record('t', 'apply', 0.001)
            reg.tick()
    fast_fires = [row for row in reg.alert_log
                  if row[4] == 'fast' and row[5] == 'fire']
    assert not fast_fires, reg.alert_log


def test_availability_budgets_are_separate():
    reg = SloRegistry(policies={
        'avail_throttled': SloPolicy(0.5, min_events=4),
        'avail_overloaded': SloPolicy(0.99, min_events=4),
    })
    throttle = TenantThrottled('t', tenant='a', retry_after=0.1)
    # heavy throttling, zero overload sheds: only the throttle SLO burns
    for _ in range(10):
        for _ in range(6):
            reg.record('a', 'apply', 0.0, throttle)
            reg.record('a', 'apply', 0.001)
        reg.tick()
    gauges = reg.gauges()
    assert gauges[('a', 'apply', 'avail_throttled')]['fast_burn'] == \
        pytest.approx(1.0, rel=0.01)      # 50% bad of a 50% budget
    assert gauges[('a', 'apply', 'avail_overloaded')]['fast_burn'] == 0.0
    alerts = reg.active_alerts()
    assert ('a', 'apply', 'avail_overloaded', 'fast') not in alerts


def test_freshness_policy_counts_lag():
    reg = SloRegistry(policies={
        'freshness': SloPolicy(0.5, max_lag_ticks=4, min_events=2)})
    for _ in range(8):
        reg.record_freshness('t', 1)      # within budget
        reg.record_freshness('t', 20)     # stale
        reg.tick()
    gauges = reg.gauges()
    assert gauges[('t', 'subscribe', 'freshness')]['fast_burn'] == \
        pytest.approx(1.0, rel=0.01)
    assert reg.lag_gauges()[('t', 'subscribe')] == 20


def test_idle_pairs_cost_nothing_and_windows_catch_up():
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.99, threshold_s=0.05, min_events=1)})
    for _ in range(3):
        for _ in range(4):
            reg.record('t', 'apply', 1.0)      # all bad
        reg.tick()
    window = reg._pairs[('t', 'apply')].windows['latency']
    assert window.slow_bad == 12
    # idle ticks: the pair is visited by NEITHER the dirty nor the
    # alerting set (tick cost tracks talkers)... except the firing
    # alert keeps it evaluated until it clears — the slow window holds
    # the bad events for its full 60-tick span, so give it room
    for _ in range(80):
        reg.tick()
    assert not reg.active_alerts()
    assert ('t', 'apply') not in reg._alerting
    visited_tick = reg._pairs[('t', 'apply')].windows['latency'].last_tick
    for _ in range(100):
        reg.tick()
    assert reg._pairs[('t', 'apply')].windows['latency'].last_tick == \
        visited_tick                            # untouched while idle
    # the next event catches the window up: a >slow-window gap means
    # nothing of the old content survives
    reg.record('t', 'apply', 0.001)
    reg.tick()
    window = reg._pairs[('t', 'apply')].windows['latency']
    assert (window.slow_good, window.slow_bad) == (1, 0)


def test_removing_policy_clears_firing_alert():
    """De-declaring an objective while its alert fires must not leave
    the alert dangling (gauges, active count, or the per-tick alerting
    set)."""
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.99, threshold_s=0.05, min_events=1)})
    for _ in range(10):
        for _ in range(5):
            reg.record('t', 'apply', 1.0)
        reg.tick()
    assert reg.active_alerts()
    active0 = slo_stats()['slo_alerts_active']
    reg.set_policy('latency', None)
    reg.tick()
    assert not reg.active_alerts()
    assert ('t', 'apply') not in reg._alerting
    assert slo_stats()['slo_alerts_active'] < active0
    # the latency artifacts are gone; the still-declared default
    # availability objectives keep their (healthy) windows
    assert 'latency' not in reg._pairs[('t', 'apply')].windows
    assert ('t', 'apply', 'latency') not in reg._gauges


def test_removing_merged_avail_policy_clears_its_gauge():
    """Merged-window mode (the default homogeneous geometry) keeps the
    avail SLIs out of pair.windows — de-declaring one must still sweep
    its burn/alert gauge, or the exporter serves the dead objective's
    last burn as a live series forever."""
    from automerge_tpu_torch.errors import Overloaded
    reg = SloRegistry()
    for _ in range(3):
        reg.record('t', 'apply', 0.0, Overloaded('x', retry_after=None,
                                                 shed=False, stage=None))
        reg.tick()
    assert ('t', 'apply', 'avail_overloaded') in reg._gauges
    reg.set_policy('avail_overloaded', None)
    reg.record('t', 'apply', 0.001)     # re-pins the pair's policies
    reg.tick()
    assert ('t', 'apply', 'avail_overloaded') not in reg._gauges
    # the still-declared sibling budgets keep their gauges
    assert ('t', 'apply', 'avail_throttled') in reg._gauges


def test_pending_deltas_match_counts_delta_of_tallies():
    """The windows consume the INCREMENTAL per-tick delta accumulated at
    record time; it must equal counts_delta over consecutive tally
    snapshots (the satellite API) — same numbers, no rescan."""
    from automerge_tpu_torch.observability.metrics import counts_delta
    reg = SloRegistry(policies={
        'avail_throttled': SloPolicy(0.9, min_events=1)})
    throttle = TenantThrottled('t', tenant='a', retry_after=0.1)
    prev = {}
    for n_good, n_bad in [(5, 1), (0, 3), (2, 0)]:
        for _ in range(n_good):
            reg.record('a', 'apply', 0.001)
        for _ in range(n_bad):
            reg.record('a', 'apply', 0.0, throttle)
        pending = list(reg._pairs[('a', 'apply')].pending)
        now = dict(reg._pairs[('a', 'apply')].tallies)
        delta = counts_delta(now, prev)
        assert pending[0] == delta.get('committed', 0)
        assert pending[1] == delta.get('throttled', 0)
        prev = now
        reg.tick()
        # the roll consumed the pending slots
        assert reg._pairs[('a', 'apply')].pending == [0] * 8
    # homogeneous geometry -> the merged availability window holds the
    # class-split sums: [committed, throttled, overloaded, deadline]
    window = reg._pairs[('a', 'apply')].avail_window
    assert window.slow == [7, 4, 0, 0]


def test_latency_classification_matches_bucketwise_delta():
    """The precomputed good-bucket compare must agree with the explicit
    bucketwise histogram classification (bucket upper bound <=
    threshold) for values across the whole dynamic range."""
    from automerge_tpu_torch.observability.hist import Histogram
    policy = SloPolicy(0.99, threshold_s=0.25)
    reg = SloRegistry(policies={'latency': policy})
    probe = Histogram('probe', scale=1e9, unit='s')
    values = [0.0, 1e-9, 0.001, 0.12, 0.1342, 0.1343, 0.25, 0.26, 0.5,
              3.0, 100.0]
    good = bad = 0
    for v in values:
        reg.record('t', 'apply', v)
        b = probe.bucket_of(v)
        _lo, hi = probe.bucket_bounds(b)
        if hi <= policy.threshold_s:
            good += 1
        else:
            bad += 1
    pending = reg._pairs[('t', 'apply')].pending
    assert pending[4] == good and pending[5] == bad
    assert good and bad                  # both classes exercised


# ---------------------------------------------------------------------------
# service integration
# ---------------------------------------------------------------------------

pytestmark_fleet = pytest.mark.skipif(not native.available(),
                                      reason='native codec unavailable')


def change_bytes(actor, seq, val=1):
    from automerge_tpu_torch.columnar import encode_change
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': seq, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': 'k',
                 'value': val, 'datatype': 'int', 'pred': []}]})


@pytestmark_fleet
def test_service_accounts_commits_and_edge_rejections():
    from automerge_tpu_torch.fleet.backend import DocFleet
    from automerge_tpu_torch.service import DocService
    svc = DocService(fleet=DocFleet(doc_capacity=8, key_capacity=64,
                                    device='cpu'),
                     tenant_rate=0.0001, tenant_burst=2.0)
    session = svc.open_session('tight')
    ok = svc.submit(session, 'apply', [change_bytes('aa' * 16, 1)])
    svc.submit(session, 'apply', [change_bytes('aa' * 16, 2)])
    # bucket dry: the edge rejection must be accounted without a ticket
    with pytest.raises(TenantThrottled):
        svc.submit(session, 'apply', [change_bytes('aa' * 16, 3)])
    svc.pump()
    assert ok.status == 'ok'
    tallies = svc.slo.tallies()[('tight', 'apply')]
    assert tallies['committed'] == 2
    assert tallies['throttled'] == 1
    # per-pair latency histogram only holds the committed requests
    hist = svc.slo.histograms()[('tight', 'apply')]
    assert hist.count == 2


@pytestmark_fleet
def test_closed_session_burns_throttled_not_overloaded():
    """'session closed' is the CLIENT's fault (it kept a dead handle),
    so it must burn the per-tenant throttled budget, not the
    overloaded budget whose alert pages for service-wide shedding."""
    from automerge_tpu_torch.errors import Overloaded
    from automerge_tpu_torch.fleet.backend import DocFleet
    from automerge_tpu_torch.service import DocService
    svc = DocService(fleet=DocFleet(doc_capacity=4, key_capacity=64,
                                    device='cpu'))
    session = svc.open_session('t0')
    svc.close_session(session)
    with pytest.raises(Overloaded):
        svc.submit(session, 'apply', [change_bytes('aa' * 16, 1)])
    tallies = svc.slo.tallies()[('t0', 'apply')]
    assert tallies.get('throttled') == 1
    assert 'overloaded' not in tallies


@pytestmark_fleet
def test_service_slo_false_disables_accounting():
    from automerge_tpu_torch.fleet.backend import DocFleet
    from automerge_tpu_torch.service import DocService
    svc = DocService(fleet=DocFleet(doc_capacity=4, key_capacity=64,
                                    device='cpu'),
                     slo=False)
    session = svc.open_session('t')
    ticket = svc.submit(session, 'apply', [change_bytes('aa' * 16, 1)])
    svc.pump()
    assert ticket.status == 'ok'
    assert svc.slo is None
    assert ticket.trace is None        # telemetry off: no minting either


@pytestmark_fleet
def test_service_subscription_freshness_lag():
    from automerge_tpu_torch.fleet.backend import DocFleet
    from automerge_tpu_torch.service import DocService
    svc = DocService(fleet=DocFleet(doc_capacity=4, key_capacity=64,
                                    device='cpu'),
                     tenant_rate=10_000.0, tenant_burst=1000.0)
    session = svc.open_session('sub')
    first = svc.submit(session, 'subscribe')
    svc.pump()
    assert first.status == 'ok'
    # new changes land, then several quiet ticks pass before the pull
    t = svc.submit(session, 'apply', [change_bytes('bb' * 16, 1)])
    svc.pump()
    assert t.status == 'ok'
    svc.pump()
    svc.pump()
    pull = svc.submit(session, 'subscribe')
    svc.pump()
    assert pull.status == 'ok' and pull.result['changes']
    lag = svc.slo.lag_gauges().get(('sub', 'subscribe'))
    assert lag is not None and lag >= 2


def test_hub_bind_slo_reports_cursor_lag():
    import automerge_tpu_torch as A
    from automerge_tpu_torch import backend as host_backend
    from automerge_tpu_torch.query import SubscriptionHub
    doc = A.frontend.get_backend_state(A.init('cc' * 16), 'slo-hub')
    reg = SloRegistry(policies={
        'freshness': SloPolicy(0.5, max_lag_ticks=1, min_events=1)})
    hub = SubscriptionHub(device='cpu')
    hub.register('d', doc)
    hub.bind_slo(reg, tenant_of=lambda key: 'hubtenant')
    sub = hub.subscribe('d')
    hub.tick()                       # initial full-state push, lag 0
    # doc advances; the sub stays behind for two quiet source ticks
    doc, _ = host_backend.apply_changes(doc, [change_bytes('cc' * 16, 1)])
    hub.tick()                       # stale tick 1 (pushes the change)
    hub.update_source('d', doc)
    hub.tick()
    assert hub.stats['lag_max'] >= 1
    assert reg.lag_gauges().get(('hubtenant', 'subscribe')) is not None
    assert sub.fresh_tick is not None


# ---------------------------------------------------------------------------
# the acceptance leg: synthetic latency step through the real service
# ---------------------------------------------------------------------------


@pytestmark_fleet
def test_latency_step_leg_alert_within_10_ticks_and_visible():
    from automerge_tpu_torch.service_cases import run_leg
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.999, threshold_s=0.05, min_events=4)})
    step_tick = 40
    report = run_leg('slo-step', sessions=24, tenants=6, requests=2400,
                     arrivals_per_tick=24, sync_fraction=0.0,
                     chaos=False, seed=7, tick_dt=0.004,
                     latency_step=(step_tick, 0.4), convergence=True,
                     service_kwargs={'slo': reg}, device='cpu')
    assert report['untyped_escapes'] == 0
    assert report['slo_audit'] and not report['slo_audit']['mismatches']
    fires = [a for a in report['slo_alerts']
             if a['edge'] == 'fire' and a['sli'] == 'latency' and
             a['window'] == 'fast']
    assert fires, report['slo_alerts']
    # detection latency: the fast window must catch the step within 10
    # service ticks of the injection
    assert fires[0]['tick'] - step_tick <= 10, fires[0]
    # the transition is visible on the Prometheus exposition...
    page = render_prometheus(slo=reg)
    assert 'automerge_tpu_slo_alert_active' in page
    assert 'automerge_tpu_slo_burn_rate' in page
    assert 'automerge_tpu_slo_requests_total' in page
    # ...and in a flight-recorder dump (the firing assembled one)
    assert any(e['kind'] == 'slo_alert' and e['edge'] == 'fire'
               for e in obs_recorder.recent_events())
