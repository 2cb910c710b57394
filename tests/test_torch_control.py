# The port's copy of tests/test_control.py: imports re-pointed at
# automerge_tpu_torch, every fleet on the CPU (device='cpu'), the chaos
# leg through automerge_tpu_torch/shard_cases.py (the port's copy of
# tools/loadgen.py's shard leg). The acceptance episode keeps the
# reference's shape under `slow` (3.5-4 s here, 13.9-20 s for the
# reference under contention); a tier-1 dose follows it.
"""Self-driving control plane (ISSUE-20): the observatory closes the loop.

The control plane rides the existing pumps (``DocService(control=...)``
/ ``ShardRouter(control=...)``) and is pinned here layer by layer:

- SIGNALS: ``SignalBus`` hands back per-window DELTAS over the same
  monotonic counters the dashboards read — deltas reset every sample
  and CLAMP at zero when a dead shard takes its counters out of the
  sum (no negative movement, ever).
- POLICIES: pure decision functions over one sample plus ``_Alert``
  hysteresis — N consecutive windows to arm, N at half-threshold to
  clear, midband noise resets both streaks. A signal hovering at a
  boundary cannot flap an actuator.
- ACTUATORS: existing seams only — ``set_tenant_rate`` retargets the
  live bucket in place, the ``ClockDemote`` pin lane exempts handles
  from demotion, ``rehome_tenant`` guards its inputs and rides the
  standard migration machinery.
- LEDGER: every decision (active AND shadow) carries the input signal
  snapshot and trace ids; shadow mode produces the byte-for-byte same
  decision sequence as active while touching nothing.
- CONVERGENCE: steady load reaches a FIXED POINT (>= 5 consecutive
  decision-free windows, zero reversals); the kill-one-of-four chaos
  leg settles within a pinned tick budget with zero acked-write loss
  and the heal lane doing the post-revive placement work the loadgen
  used to hardcode.
"""

import json
import os
import sys
import types

import pytest

from automerge_tpu_torch import native
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.control import (AdmissionRatePolicy, Controller,
                                   PinResidentPolicy, ShardBalancePolicy,
                                   SignalBus)
from automerge_tpu_torch.control.controller import _is_reversal
from automerge_tpu_torch.errors import AutomergeError
from automerge_tpu_torch.fleet import backend as fleet_backend
from automerge_tpu_torch.fleet.backend import DocFleet, init_docs
from automerge_tpu_torch.fleet.storage import StorageEngine
from automerge_tpu_torch.fleet.tiering import ClockDemote
from automerge_tpu_torch.service.admission import AdmissionController
from automerge_tpu_torch.service.core import DocService

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tools'))

from automerge_tpu_torch.shard_cases import (    # noqa: E402
    run_shard_leg as _run_shard_leg)


def run_shard_leg(name, **kw):
    return _run_shard_leg(name, device='cpu', **kw)


# --- synthetic signals ------------------------------------------------------

def _sig(tick=0, tenants=None, admission=None, shards=None,
         misplaced=(), shard_tenants=None, pump_mean_s=0.0,
         watermark=None):
    sig = {'tick': tick,
           'admission': {'admitted_d': 0, 'overloaded_d': 0,
                         'throttled_d': 0, 'reject_frac': 0.0,
                         'queue_pressure': 0.0},
           'tenants': tenants or {},
           'perf': {'max_drift': 0.0, 'alerts': 0},
           'watermark': {'pressure': watermark},
           'tiering': {'fire': 0, 'defer': 0}}
    if admission:
        sig['admission'].update(admission)
    if shards is not None:
        sig['shards'] = shards
        sig['shard_tenants'] = shard_tenants or {}
        sig['pump_mean_s'] = pump_mean_s
        sig['misplaced'] = sorted(misplaced)
        sig['migrating'] = 0
    return sig


def _tenant(admitted_d=0, throttled_d=0, rate=2.0, base_rate=2.0,
            fresh_burn=0.0, fresh_alert=0, lag=0):
    return {'admitted_d': admitted_d, 'throttled_d': throttled_d,
            'rate': rate, 'base_rate': base_rate,
            'throttled_burn': 0.0, 'fresh_burn': fresh_burn,
            'fresh_alert': fresh_alert, 'lag': lag}


def _shard(alive=True, ewma=0.0, tenants=1):
    return {'alive': alive, 'last_pump_s': ewma, 'pump_ewma_s': ewma,
            'slipped_d': 0, 'tenants': tenants}


# --- SignalBus --------------------------------------------------------------

class TestSignalBus:
    def test_deltas_reset_each_sample(self):
        svc = DocService(fleet=DocFleet(device='cpu'), tenant_rate=2.0,
                         tenant_burst=4.0)
        bus = SignalBus(service=svc)
        s = svc.open_session('t')
        for _ in range(10):
            try:
                svc.submit(s, 'sync', None)
            except AutomergeError:
                pass
        svc.pump(0.0)
        sig1 = bus.sample(1)
        assert sig1['admission']['admitted_d'] == 4      # burst tokens
        assert sig1['admission']['throttled_d'] == 6
        assert sig1['admission']['reject_frac'] == pytest.approx(0.6)
        assert sig1['tenants']['t']['throttled_d'] == 6
        assert sig1['tenants']['t']['rate'] == pytest.approx(2.0)
        # no new traffic: the next sample's movement is zero
        sig2 = bus.sample(2)
        assert sig2['admission']['admitted_d'] == 0
        assert sig2['admission']['throttled_d'] == 0
        assert sig2['tenants']['t']['throttled_d'] == 0

    def test_dead_service_counters_clamp_at_zero(self):
        bus = SignalBus()
        a, b = AdmissionController(), AdmissionController()
        a.stats['admitted'] = 100
        b.stats['admitted'] = 50
        two = [(0, types.SimpleNamespace(admission=a)),
               (1, types.SimpleNamespace(admission=b))]
        bus._sample_admission(two)
        # shard 1 dies: the summed monotonic counter DROPS by 50, which
        # must read as "no events", never as negative movement
        out = bus._sample_admission(two[:1])
        assert out['admitted_d'] == 0
        a.stats['admitted'] = 130
        out = bus._sample_admission(two[:1])
        assert out['admitted_d'] == 30


# --- policies (hysteresis over synthetic signals) ---------------------------

class TestAdmissionRatePolicy:
    def test_raise_needs_consecutive_windows_then_caps(self):
        p = AdmissionRatePolicy()
        hot = lambda: _sig(tenants={'t': _tenant(admitted_d=1,   # noqa: E731
                                                 throttled_d=9)})
        assert p.decide(hot()) == []             # window 1: arming
        acts = p.decide(hot())                   # window 2: fires
        assert [a['action'] for a in acts] == ['set_rate']
        assert acts[0]['direction'] == 'up'
        assert acts[0]['rate'] == pytest.approx(3.0)     # 2.0 * 1.5
        rates = [acts[0]['rate']]
        for _ in range(8):
            rates += [a['rate'] for a in p.decide(hot())]
        # capped at max_mult x base, then the policy goes quiet
        assert max(rates) == pytest.approx(8.0)
        assert p.decide(hot()) == []
        assert p.active() == {'tenant:t': 4.0}

    def test_midband_noise_never_fires(self):
        p = AdmissionRatePolicy()
        hot = _sig(tenants={'t': _tenant(admitted_d=1, throttled_d=9)})
        mid = _sig(tenants={'t': _tenant(admitted_d=9, throttled_d=1)})
        for _ in range(4):                       # alternating: no streak
            assert p.decide(hot) == []
            assert p.decide(mid) == []

    def test_overload_walks_boosts_back_to_base(self):
        p = AdmissionRatePolicy()
        hot = _sig(tenants={'t': _tenant(admitted_d=1, throttled_d=9)})
        p.decide(hot)
        p.decide(hot)                            # boosted to 1.5x
        assert p.active() == {'tenant:t': 1.5}
        over = _sig(tenants={'t': _tenant(admitted_d=5)},
                    admission={'queue_pressure': 0.8})
        assert p.decide(over) == []              # overload alert arming
        acts = p.decide(over)
        assert acts[0]['direction'] == 'down'
        # cut toward base, never below: 1.5 * 0.5 floors at 1.0x
        assert acts[0]['rate'] == pytest.approx(2.0)
        assert p.active() == {}


class TestPinResidentPolicy:
    def test_pin_fires_and_clears_hysteretically(self):
        p = PinResidentPolicy()
        hot = _sig(tenants={'t': _tenant(fresh_burn=2.0, lag=7)})
        cold = _sig(tenants={'t': _tenant()})
        assert p.decide(hot) == []
        acts = p.decide(hot)
        assert [a['action'] for a in acts] == ['pin']
        assert p.pinned == {'t'}
        assert p.decide(cold) == []              # clear streak 1
        acts = p.decide(cold)
        assert [a['action'] for a in acts] == ['unpin']
        assert p.pinned == set()

    def test_watermark_lane_tightens_and_relaxes(self):
        p = PinResidentPolicy()
        high = _sig(watermark=1.5)
        low = _sig(watermark=0.3)
        assert p.decide(high) == []
        acts = p.decide(high)
        assert acts == [{'policy': 'pin_resident',
                         'action': 'pressure_factor',
                         'direction': 'down', 'target': 'demote_clock',
                         'value': 0.75, 'detail': {'pressure': 1.5}}]
        assert p.decide(low) == []
        acts = p.decide(low)
        assert acts[0]['value'] == 1.0 and acts[0]['direction'] == 'up'


class TestShardBalancePolicy:
    def test_heal_lane_rehomes_misplaced(self):
        p = ShardBalancePolicy()
        sig = lambda: _sig(shards={'s0': _shard(), 's1': _shard()},  # noqa: E731
                           misplaced=['a', 'b'])
        assert p.decide(sig()) == []             # heal_up_windows=2
        acts = p.decide(sig())
        assert sorted(a['tenant'] for a in acts) == ['a', 'b']
        assert all(a['action'] == 'rehome' and a['dst'] is None and
                   a['direction'] == 'heal' for a in acts)

    def test_relief_moves_one_and_heal_never_tugs_it_back(self):
        p = ShardBalancePolicy(up_windows=2)
        hot = lambda: _sig(                                      # noqa: E731
            shards={'s0': _shard(ewma=0.04, tenants=2),
                    's1': _shard(ewma=0.002, tenants=1)},
            shard_tenants={'s0': ['x', 'y']}, pump_mean_s=0.01)
        assert p.decide(hot()) == []             # arming
        acts = p.decide(hot())
        assert len(acts) == 1
        assert acts[0]['tenant'] == 'x' and acts[0]['dst'] == 's1'
        assert acts[0]['direction'] == 's0->s1'
        assert 'x' in p.owned
        # the moved tenant is now off its ring primary, but the heal
        # lane OWNS that: no tug-of-war rehome back
        cool = lambda: _sig(                                     # noqa: E731
            shards={'s0': _shard(ewma=0.002), 's1': _shard(ewma=0.002)},
            misplaced=['x'], pump_mean_s=0.002)
        for _ in range(4):
            assert p.decide(cool()) == []


def test_reversal_semantics():
    assert _is_reversal('up', 'down') and _is_reversal('down', 'up')
    assert not _is_reversal(None, 'up')
    assert not _is_reversal('up', 'up')
    assert _is_reversal('s0->s1', 's1->s0')
    assert not _is_reversal('s0->s1', 's0->s1')
    assert not _is_reversal('s0->s1', 's1->s2')
    assert not _is_reversal('heal', 'heal')


# --- actuator seams ---------------------------------------------------------

def test_set_tenant_rate_retargets_bucket_in_place():
    adm = AdmissionController(rate=2.0, burst=10.0)
    bucket = adm.tenant('t').bucket
    adm.set_tenant_rate('t', rate=5.0, burst=4.0)
    assert adm.tenant('t').bucket is bucket      # same object, mid-flight
    assert bucket.rate == 5.0 and bucket.burst == 4.0
    assert bucket.tokens == 4.0                  # clamped to new burst


def _parked_docs(n):
    fleet = DocFleet(device='cpu')
    eng = StorageEngine(fleet)
    handles = init_docs(n, fleet)
    per = [[encode_change(
        {'actor': f'{d:04x}' * 4, 'seq': 1, 'startOp': 1, 'time': 0,
         'message': '', 'deps': [],
         'ops': [{'action': 'set', 'obj': '_root', 'key': 'k',
                  'value': d, 'datatype': 'int', 'pred': []}]})]
        for d in range(n)]
    handles, _ = fleet_backend.apply_changes_docs(handles, per,
                                                  mirror=False)
    return eng, handles


def test_clock_pin_lane_and_pressure_factor():
    eng, handles = _parked_docs(8)
    resident = {'n': 8}
    clock = ClockDemote(eng, budget_bytes=2,
                        source=lambda: resident['n'], batch=8)
    clock.register(handles)
    pinned = handles[:2]
    clock.pin(pinned)
    parked_total = []
    for _ in range(6):
        parked_total.extend(clock.tick())
        resident['n'] = 8 - len(parked_total)
    # every unpinned doc demoted; the pinned two never did, however
    # cold they looked to the hand
    assert len(parked_total) == 6
    assert all(not h.get('frozen') for h in pinned)
    assert clock.pinned_count() == 2
    # pressure_factor scales the effective budget
    assert clock.pressure() == pytest.approx(1.0)        # 2 / 2
    clock.pressure_factor = 0.5
    assert clock.pressure() == pytest.approx(2.0)        # 2 / 1
    # unpin: the exemption lifts and the tightened budget demotes them
    clock.unpin(pinned)
    parked = clock.tick()
    assert len(parked) == 2
    assert clock.pinned_count() == 0


def test_rehome_tenant_guards():
    from automerge_tpu_torch.shard import ShardRouter
    router = ShardRouter(n_shards=2, clock=lambda: 0.0, device='cpu')
    try:
        router.open_tenant('t')
        home = router.tenant_record('t').home
        other = next(s for s in router.ring.shard_ids() if s != home)
        assert not router.rehome_tenant('nope', other)   # unknown tenant
        assert not router.rehome_tenant('t', home)       # no-op move
        assert not router.rehome_tenant('t', 'zz')       # unknown shard
        assert router.rehome_tenant('t', other)
        assert router.tenant_record('t').migrating is not None
        assert not router.rehome_tenant('t', home)       # mid-migration
    finally:
        router.close()


# --- the closed loop --------------------------------------------------------

_FLOODED = {}


def _flooded(mode):
    """One deterministic flooded-service episode per mode, memoized:
    two tenants submitting 20 syncs/tick against a 2/s base rate for
    120 ticks, controller on a 5-tick window."""
    if mode in _FLOODED:
        return _FLOODED[mode]
    ctrl = Controller(mode=mode, window=5)
    svc = DocService(fleet=DocFleet(device='cpu'), control=ctrl,
                     tenant_rate=2.0, tenant_burst=4.0)
    sessions = [svc.open_session(t) for t in ('alice', 'bob')]
    now = 0.0
    for _ in range(120):
        for s in sessions:
            for _i in range(20):
                try:
                    svc.submit(s, 'sync', None)
                except AutomergeError:
                    pass
        svc.pump(now)
        now += 0.1
    _FLOODED[mode] = (ctrl, svc)
    return ctrl, svc


def test_active_mode_actuates_and_reaches_fixed_point():
    ctrl, svc = _flooded('active')
    log = ctrl.decision_log()
    assert log, 'the controller never acted on a flooded service'
    assert all(e['action'] == 'set_rate' and e['applied'] for e in log)
    # actuated through the live admission seam, capped at 4x base
    for tenant in ('alice', 'bob'):
        assert svc.admission.tenants[tenant].bucket.rate == \
            pytest.approx(8.0)
    g = ctrl.gauges()
    assert g['reversals'] == {}
    assert g['active'][('admission_rate', 'tenant:alice')] == 4.0
    # FIXED POINT: under steady load the tail of the run is >= 5
    # consecutive windows with zero decisions
    last_window = g['last_decision_tick'] // g['window']
    assert g['windows'] - last_window >= 5, g


def test_shadow_mode_decides_identically_and_touches_nothing():
    active_ctrl, _ = _flooded('active')
    shadow_ctrl, shadow_svc = _flooded('shadow')
    # shadow NEVER actuated: rates still at base
    for tenant in ('alice', 'bob'):
        assert shadow_svc.admission.tenants[tenant].bucket.rate == \
            pytest.approx(2.0)
    # ...yet the decision sequence is byte-for-byte the active one
    # (the parity that makes a shadow deployment's graphs trustworthy)
    def strip(ctrl):
        return [(e['tick'], e['policy'], e['action'], e['target'],
                 e['direction'], e['rate'], e['mult'])
                for e in ctrl.decision_log()]
    assert strip(shadow_ctrl) == strip(active_ctrl)
    assert all(e['mode'] == 'shadow' and not e['applied']
               for e in shadow_ctrl.decision_log())


def test_ledger_entries_carry_signal_snapshot_and_traces():
    ctrl, _ = _flooded('active')
    for e in ctrl.decision_log():
        assert e['signals']['tick'] == e['tick']
        assert 'admission' in e['signals']
        assert 'watermark' in e['signals']
        assert e['signals']['tenant']['base_rate'] == pytest.approx(2.0)
        assert isinstance(e['traces'], list)
        assert e['detail']['throttled_frac'] > 0
    # the same decisions landed in the flight recorder ring
    from automerge_tpu_torch.observability import recorder
    flight = [e for e in recorder.recent_events()
              if e['kind'] == 'control_decision']
    assert flight
    assert all('signals' in e and 'traces' in e for e in flight)


def test_dump_round_trips_and_obs_report_renders(tmp_path, capsys):
    ctrl, _ = _flooded('active')
    path = str(tmp_path / 'control_ledger.json')
    report = ctrl.dump_decisions(path)
    assert report['kind'] == 'control_ledger'
    with open(path) as f:
        assert json.load(f)['decisions']         # valid JSON on disk
    import obs_report
    assert obs_report.render_control(path) == 0
    out = capsys.readouterr().out
    assert '# control plane:' in out and 'set_rate' in out
    assert 'signals:' in out
    # --json: stdout is ONE machine-readable object (pipe discipline)
    assert obs_report.render_control(path, json_out=True) == 0
    data = json.loads(capsys.readouterr().out)
    assert data['kind'] == 'control_report'
    assert data['per_policy'].get('admission_rate/set_rate', 0) >= 1


# --- chaos: the self-driving episode ----------------------------------------

@pytest.mark.slow
@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
def test_kill_one_of_four_settles_under_active_control():
    """The acceptance episode: kill one of four shards under chaos
    links with the controller driving recovery placement (the leg's
    hardcoded rebalance-after-revive is OFF under active control).
    Pinned: zero acked-write loss, byte-identical convergence, <= 2
    reversals per policy, the last decision within 300 ticks of the
    revive, and a decision-free CONVERGENCE HOLD — 10 quiet decision
    windows pumped after the drain with zero further decisions."""
    report = run_shard_leg(
        'control_kill', n_shards=4, tenants=16, requests=600,
        chaos=True, seed=2, kills=((25, 0, 50),),
        control='active', settle_bound=300)
    assert report['ok'], report
    assert report['untyped_escapes'] == 0
    assert report['final_audit']['acked_lost'] == 0
    assert report['final_audit']['replica_mismatches'] == 0
    ctl = report['control']
    # the heal lane did the post-revive placement work
    assert ctl['decisions'].get('shard_balance', 0) >= 1
    assert all(n <= 2 for n in ctl['reversals'].values())
    assert ctl['fixed_point'] is True
    assert ctl['settle_ticks'] is not None
    assert ctl['settle_ticks'] <= 300


@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
def test_kill_one_of_four_settles_under_active_control_dose():
    """The acceptance episode's tier-1 dose (the full shape runs under
    -m slow): half the tenants, a third of the requests, the kill and
    the revive earlier. The heal lane still does the post-revive
    placement work, and the convergence hold still ends decision-free."""
    report = run_shard_leg(
        'control_kill', n_shards=4, tenants=8, requests=200,
        chaos=True, seed=2, kills=((12, 0, 24),),
        control='active', settle_bound=300)
    assert report['ok'], report
    assert report['untyped_escapes'] == 0
    assert report['final_audit']['acked_lost'] == 0
    assert report['final_audit']['replica_mismatches'] == 0
    ctl = report['control']
    assert ctl['decisions'].get('shard_balance', 0) >= 1
    assert all(n <= 2 for n in ctl['reversals'].values())
    assert ctl['fixed_point'] is True
    assert ctl['settle_ticks'] is not None
    assert ctl['settle_ticks'] <= 300
