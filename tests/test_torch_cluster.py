"""Differential tests of the port's shard cluster and control plane
(automerge_tpu_torch/shard/, control/, shard_cases.py) against the JAX
package's, on the CPU, every comparison exact.

- MIGRATION ACROSS PACKAGES: a tenant parked by one package's shard
  (StorageEngine.park, then discard: the chunk the router's migration
  carries) is ingested and revived by the other package's shard and
  adopted by its service, as ShardRouter._advance_migrations does; the
  doc's save() bytes and materialized state are the donor's, and it
  takes the next change as the host OpSet does. Both directions.
- CONTROLLER: the reference's ShardBalancePolicy, AdmissionRatePolicy,
  PinResidentPolicy and Controller and the port's get the same seeded
  streams of synthetic signals (the shapes of tests/test_control.py);
  their decision sequences, active sets and ledger JSON (wall-clock
  fields masked) are equal.
- SHARD LEGS: tools/loadgen.py run_shard_leg and
  shard_cases.run_shard_leg with the same arguments and serial pumps:
  the deterministic fields of the reports (typed outcome counts,
  completed_ok, failovers, MTTR, every audit, the shard health delta,
  the link stats) are equal, and so are every tenant's placement and
  its home and replica save() bytes. A small kill-one-of-four dose runs
  in tier-1 after a lossy-replication dose; the reference's smoke shape and its 3x kill-and-revive
  shape, each in both device modes, run under -m slow (the reference's
  JAX compiles of a new shape cost it 6-20 s a leg).
"""

import copy
import json
import os
import random
import sys

import pytest
import torch

import automerge_tpu.native as ref_native
import automerge_tpu_torch.native as port_native
from automerge_tpu import backend as ref_host
from automerge_tpu import control as ref_control
from automerge_tpu import shard as ref_shard
from automerge_tpu.columnar import encode_change
from automerge_tpu.fleet import backend as ref_fleet
from automerge_tpu_torch import backend as port_host
from automerge_tpu_torch import control as port_control
from automerge_tpu_torch import shard as port_shard
from automerge_tpu_torch.columnar import decode_change_meta
from automerge_tpu_torch.fleet import backend as port_fleet
from automerge_tpu_torch.shard_cases import run_shard_leg as port_leg

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tools'))

from loadgen import run_shard_leg as ref_leg                    # noqa: E402

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them, and more again when test workers share the cores.
torch.set_num_threads(1)


@pytest.fixture
def codecs():
    """The shard fleets ride the turbo path, so both codecs must load; a
    reference codec that failed to build (a concurrent build of the
    reference's library) skips instead of failing the comparison."""
    if not (ref_native.available() and port_native.available()):
        pytest.skip('a native codec is unavailable (the turbo path and '
                    'the reference comparison need both)')


def _change(actor, seq, deps, ops):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': seq * 4, 'time': 0,
        'message': '', 'deps': list(deps), 'ops': ops})


def _set(key, value, datatype='int'):
    return {'action': 'set', 'obj': '_root', 'key': key, 'value': value,
            'datatype': datatype, 'pred': []}


# ---- migration across the packages -----------------------------------------

def _tenant_changes():
    """Two actors writing one tenant's document: sets of ints, strings
    and floats, a counter and its inc, concurrent writes of one key."""
    a, b = 'aa' * 16, 'bb' * 16
    first = _change(a, 1, [], [
        _set('title', 'hello', None), _set('n', 1),
        _set('hits', 5, 'counter'), _set('ratio', 0.5, 'float64')])
    second = _change(b, 1, [], [_set('n', 2), _set('who', 'b', None)])
    third = _change(a, 2, [], [
        {'action': 'inc', 'obj': '_root', 'key': 'hits', 'value': 3,
         'pred': [f'6@{a}']}])
    return [first, second, third]


def _later_change():
    return _change('cc' * 16, 1, [], [_set('late', 7), _set('n', 9)])


def _shard(pkg, sid):
    if pkg is port_shard:
        return pkg.Shard(sid, clock=lambda: 0.0, device='cpu')
    return pkg.Shard(sid, clock=lambda: 0.0)


def _migrate(donor_pkg, receiver_pkg, donor_fleet, receiver_fleet,
             receiver_host):
    donor = _shard(donor_pkg, 'donor')
    receiver = _shard(receiver_pkg, 'receiver')
    session = donor.service.open_session('t0')
    ticket = donor.service.submit(session, 'apply', _tenant_changes())
    donor.pump(1)
    assert ticket.status == 'ok', ticket.error
    before = bytes(donor_fleet.save(session.handle))
    state = donor_fleet.materialize_docs([session.handle])
    # the router's migration step, across the two packages
    ids = donor.storage.park([session.handle])
    assert ids[0] is not None
    chunk = donor.storage.discard([ids[0]])[0]
    rid = receiver.storage.ingest_chunks([bytes(chunk)])[0]
    handle = receiver.storage.revive([rid])[0]
    donor.service.release_session(session)
    moved = receiver.service.adopt_session('t0', handle)
    assert handle['state'].fleet is receiver.fleet
    assert bytes(receiver_fleet.save(moved.handle)) == before
    assert receiver_fleet.materialize_docs([moved.handle]) == state
    # the migrated doc takes the next change as the host OpSet does
    ticket = receiver.service.submit(moved, 'apply', [_later_change()])
    receiver.pump(2)
    assert ticket.status == 'ok', ticket.error
    host, _ = receiver_host.apply_changes(
        receiver_host.init(), _tenant_changes() + [_later_change()])
    assert bytes(receiver_fleet.save(moved.handle)) == \
        bytes(receiver_host.save(host))
    return before, bytes(receiver_fleet.save(moved.handle))


def test_migration_carries_a_reference_tenant_into_the_port(codecs):
    _migrate(ref_shard, port_shard, ref_fleet, port_fleet, port_host)


def test_migration_carries_a_port_tenant_into_the_reference(codecs):
    _migrate(port_shard, ref_shard, port_fleet, ref_fleet, ref_host)


# ---- the controller on synthetic signals -----------------------------------

def _sig(rng, tick):
    """One seeded window of signals in the shapes of
    tests/test_control.py's _sig/_tenant/_shard: tenants that flood or
    idle, freshness burns and lags, a watermark that crosses its bounds,
    shards whose pump EWMA runs hot, misplaced tenants."""
    tenants = {}
    for t in ('alice', 'bob', 'carol'):
        hot = rng.random() < 0.6
        tenants[t] = {
            'admitted_d': rng.randrange(1, 4) if hot else
            rng.randrange(6, 12),
            'throttled_d': rng.randrange(6, 12) if hot else
            rng.randrange(0, 2),
            'rate': 2.0, 'base_rate': 2.0, 'throttled_burn': 0.0,
            'fresh_burn': rng.choice((0.0, 0.2, 2.0, 3.0)),
            'fresh_alert': rng.randrange(2), 'lag': rng.randrange(10)}
    shards = {}
    for sid in ('s0', 's1', 's2', 's3'):
        ewma = rng.choice((0.001, 0.002, 0.02, 0.05))
        shards[sid] = {'alive': rng.random() < 0.9, 'last_pump_s': ewma,
                       'pump_ewma_s': ewma, 'slipped_d': rng.randrange(2),
                       'tenants': rng.randrange(1, 4)}
    live = [s['pump_ewma_s'] for s in shards.values() if s['alive']]
    return {'tick': tick,
            'admission': {'admitted_d': rng.randrange(40),
                          'overloaded_d': rng.randrange(3),
                          'throttled_d': rng.randrange(20),
                          'reject_frac': rng.random(),
                          'queue_pressure': rng.choice((0.0, 0.3, 0.8))},
            'tenants': tenants,
            'perf': {'max_drift': 0.0, 'alerts': 0},
            'watermark': {'pressure': rng.choice((None, 0.3, 0.9, 1.5))},
            'tiering': {'fire': 0, 'defer': 0},
            'shards': shards,
            'shard_tenants': {sid: [f'x{sid}', f'y{sid}']
                              for sid in shards},
            'pump_mean_s': sum(live) / len(live) if live else 0.0,
            'misplaced': sorted(rng.sample(['m0', 'm1', 'm2', 'm3'],
                                           rng.randrange(3))),
            'migrating': 0}


def _stream(seed, n=60):
    rng = random.Random(seed)
    return [_sig(rng, tick) for tick in range(1, n + 1)]


POLICIES = ('AdmissionRatePolicy', 'PinResidentPolicy', 'ShardBalancePolicy')


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('policy', POLICIES)
def test_policy_decides_as_the_reference(policy, seed):
    ref = getattr(ref_control, policy)()
    got = getattr(port_control, policy)()
    decided = 0
    for sig in _stream(seed):
        want = ref.decide(copy.deepcopy(sig))
        assert got.decide(copy.deepcopy(sig)) == want
        assert got.active() == ref.active()
        decided += len(want)
    assert decided


class _StreamBus:
    """A SignalBus stand-in that hands the controller one window of the
    stream per sample and serves no service."""

    def __init__(self, stream):
        self.stream = iter(copy.deepcopy(stream))

    def sample(self, tick):
        return dict(next(self.stream), tick=tick)

    def services(self):
        return []


def _ledger(pkg, mode, stream, window):
    ctrl = pkg.Controller(mode=mode, window=window)
    ctrl.bus = _StreamBus(stream)
    before = pkg.control_stats()
    windows = []
    for _ in range(len(stream) * window):
        out = ctrl.tick()
        if out is not None:
            windows.append(out)
    after = pkg.control_stats()
    report = ctrl.dump_decisions()
    # wall clock: the decision latencies
    report['gauges']['decide_s_last'] = report['gauges']['decide_s_max'] = 0
    moved = {k: after[k] - before[k] for k in after}
    return json.dumps(report, sort_keys=True, default=repr), windows, moved


@pytest.mark.parametrize('mode', ['active', 'shadow'])
@pytest.mark.parametrize('seed,window', [(3, 1), (4, 5)])
def test_controller_ledger_equals_the_reference(mode, seed, window):
    stream = _stream(seed, n=40)
    want, want_windows, want_moved = _ledger(ref_control, mode, stream,
                                             window)
    got, got_windows, got_moved = _ledger(port_control, mode, stream,
                                          window)
    assert got == want
    assert got_windows == want_windows
    assert got_moved == want_moved
    assert sum(len(w) for w in got_windows) > 0


# ---- the shard legs ---------------------------------------------------------

# what a shard leg reports that is not wall time
EXACT_KEYS = ('leg', 'shards', 'tenants', 'requests_offered', 'submitted',
              'completed_ok', 'rejections', 'untyped_escapes', 'ticks',
              'lease_ticks', 'paced', 'scrub_mismatches', 'kills',
              'failovers', 'mttr_ticks', 'drained', 'audits',
              'final_audit', 'shard_health_delta', 'link_stats', 'ok')


def _leg_keeping_router(router_cls, host, run):
    """Run one shard leg; return its report and, per tenant, its home and
    replica shards and their save() bytes."""
    kept = []
    real = router_cls.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        kept.append(self)
    router_cls.__init__ = init
    try:
        report = run()
    finally:
        router_cls.__init__ = real
    router = kept[0]
    docs = {}
    for name in sorted(router._tenants):
        rec = router.tenant_record(name)
        docs[name] = (
            rec.home, rec.replica_on,
            None if rec.session is None
            else bytes(host.save(rec.session.handle)),
            None if rec.replica_handle is None
            else bytes(host.save(rec.replica_handle)))
    return report, docs


def _same_leg(**kw):
    ref, ref_docs = _leg_keeping_router(
        ref_shard.ShardRouter, ref_host, lambda: ref_leg('x', **kw))
    got, got_docs = _leg_keeping_router(
        port_shard.ShardRouter, port_host,
        lambda: port_leg('x', device='cpu', **kw))
    for key in EXACT_KEYS:
        assert got[key] == ref[key], key
    assert got_docs == ref_docs
    assert got['ok']
    assert all(home is not None and home_bytes == rep_bytes
               for home, _rep, home_bytes, rep_bytes in got_docs.values())
    return got


def test_lossy_replication_equals_the_reference(codecs):
    report = _same_leg(n_shards=2, tenants=4, requests=32,
                       arrivals_per_tick=4, chaos=True, seed=3)
    assert report['shard_health_delta']['shard_repl_quarantined'] >= 1


def test_kill_one_of_four_dose_equals_the_reference(codecs):
    report = _same_leg(n_shards=4, tenants=6, requests=48,
                       arrivals_per_tick=6, chaos=True, seed=5,
                       kills=((6, 1, 18),), mttr_bound=12)
    assert report['failovers'] == 1
    assert report['shard_health_delta']['shard_migrations'] >= 1


@pytest.mark.slow
@pytest.mark.parametrize('exact', [False, True], ids=['lww', 'exact'])
def test_kill_one_of_four_smoke_equals_the_reference(codecs, exact):
    report = _same_leg(n_shards=4, tenants=12, requests=240,
                       arrivals_per_tick=8, chaos=True, seed=5,
                       kills=((12, 1, 40),), mttr_bound=12,
                       exact_device=exact)
    assert report['failovers'] == 1


@pytest.mark.slow
@pytest.mark.parametrize('exact', [False, True], ids=['lww', 'exact'])
def test_kill_revive_3x_equals_the_reference(codecs, exact):
    report = _same_leg(n_shards=3, tenants=9, requests=270,
                       arrivals_per_tick=6, chaos=True, seed=7,
                       kills=((10, 0, 30), (60, 0, 80), (110, 0, 130)),
                       exact_device=exact)
    assert report['failovers'] == 3
    assert report['shard_health_delta']['shard_revives'] == 3


def test_audit_hook_gets_the_router_and_every_acked_change(codecs):
    seen = {}

    def audit(router, acked):
        seen['router'], seen['acked'] = router, acked
        return {'tenants': len(acked)}
    report = port_leg('x', n_shards=2, tenants=3, requests=12,
                      arrivals_per_tick=3, seed=1, device='cpu',
                      audit=audit)
    assert report['audit'] == {'tenants': 3}
    assert report['final_audit']['acked_changes_checked'] == \
        sum(len(v) for v in seen['acked'].values()) > 0
    for name, changes in seen['acked'].items():
        handle = seen['router'].tenant_record(name).session.handle
        for buf in changes:
            assert port_host.get_change_by_hash(
                handle, decode_change_meta(buf, True)['hash']) is not None


# ---- the tier legs -----------------------------------------------------------

def test_tier_leg_equals_the_reference(codecs):
    """tools/loadgen.py run_tier_leg and shard_cases.run_tier_leg: the
    same demotions, vacuums, deferrals and revives, and every doc, live
    or parked, equal to a control fleet fed its committed changes."""
    from loadgen import run_tier_leg as ref_tier
    from automerge_tpu_torch.shard_cases import run_tier_leg
    kw = dict(docs=64, hot=8, rounds=9, writes_per_round=8, seed=1)
    want = ref_tier(**kw)
    got = run_tier_leg(device='cpu', **kw)
    for report in (want, got):
        # sticky process-lifetime highs: they follow whatever else ran in
        # the process, not the leg
        del report['watermarks']
    assert got == want
    assert got['ok'] and got['demoted'] > 0 and got['revived'] > 0


@pytest.mark.slow
def test_tier_kill_leg_recovers(codecs):
    """A child process parks a population on the disk arena and dies
    inside the vacuum's manifest swap; every surviving doc reopens
    byte-identical (the child's torch import takes most of its ~4 s)."""
    from automerge_tpu_torch.shard_cases import run_tier_kill_leg
    report = run_tier_kill_leg(docs=16, device='cpu')
    assert report['child_exit'] == 71, report
    assert report['ok'], report
    assert report['recovered'] == report['expected'] > 0
