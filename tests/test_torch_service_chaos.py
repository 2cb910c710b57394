# The port's copy of tests/test_service_chaos.py: the load generators
# are automerge_tpu_torch/service_cases.py (the service legs) and
# automerge_tpu_torch/shard_cases.py (the shard legs), and every fleet
# is on the CPU (device='cpu').
"""Chaos universe for the serving core (ISSUE-7, the PR 2/3 pattern).

The loadgen's chaos client (service_cases.py) drives Zipf-tenant load —
corrupting payloads per transport attempt, violating deadlines,
replaying, flooding, disconnecting — against a live ``DocService``. The
pinned properties, tier-1 smoke dose here and the full 10k-session
matrix under ``-m slow``:

- ZERO UNTYPED ESCAPES: every rejected submit and every failed ticket
  carries an AutomergeError subclass, under shedding included.
- SHED NEVER CORRUPTS: every edit session's doc is byte-identical to an
  unloaded control fleet fed exactly the requests that committed, and
  every sync session's client replica reaches head-equality after a
  fault-free drain.
- DEADLINE ALL-OR-NOTHING: a DeadlineExceeded ticket's changes are
  absent from the doc (covered by the control audit: a partially
  applied request would diff the saves).
- DEVICE-MODE AGNOSTIC: the same deterministic (fake-clock, seeded)
  chaos script over the LWW and exact-device fleets commits the same
  requests and produces byte-identical session saves.
- OVERLOAD ENGAGES THE LADDER: the 2x-overload leg records brownout
  transitions in the health counters while staying convergent.
"""

import pytest

import torch

from automerge_tpu_torch import native
from automerge_tpu_torch.service_cases import (run_leg as _run_leg,
                                               run_standard_legs)
from automerge_tpu_torch.shard_cases import run_shard_leg as _run_shard_leg

torch.set_num_threads(1)


def run_leg(name, **kw):
    return _run_leg(name, device='cpu', **kw)


def run_shard_leg(name, **kw):
    return _run_shard_leg(name, device='cpu', **kw)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason='native codec unavailable')

SMOKE = dict(sessions=32, tenants=8, requests=320, arrivals_per_tick=32,
             sync_fraction=0.3)


def assert_leg_ok(report):
    assert report['untyped_escapes'] == 0, report
    conv = report['convergence']
    assert conv['edit_mismatches'] == 0, report
    assert conv['sync_converged'] == conv['sync_drained'], report
    for key in report['rejections']:
        assert not key.startswith('UNTYPED'), report
    # the SLO audit (ISSUE-10): the registry's per-tenant outcome
    # tallies match the client-observed typed outcomes EXACTLY — a
    # double count or a missed reject under the chaos/quarantine storm
    # fails the leg
    audit = report['slo_audit']
    assert audit is not None and 'mismatches' in audit, report
    assert audit['mismatches'] == [], audit
    assert audit['pairs_checked'] > 0, audit


def test_service_chaos_smoke():
    report = run_leg('chaos', chaos=True, seed=11, tick_dt=0.02,
                     **SMOKE)
    assert_leg_ok(report)
    assert report['chaos_corrupted'] > 0          # the chaos actually bit
    assert report['completed_ok'] > 0


def test_service_overload_brownout_smoke():
    report = run_leg('overload', overload=True, seed=12, tick_dt=0.02,
                     **SMOKE)
    assert_leg_ok(report)
    # typed pushback happened AND the ladder engaged
    assert sum(report['rejections'].values()) > 0
    assert report['brownout_transitions'] > 0


def test_service_chaos_identical_across_device_modes():
    """The same seeded, fake-clock chaos script over both fleet modes:
    identical committed sets, byte-identical session saves."""
    saves = {}
    for mode in (False, True):
        report = run_leg('xmode', chaos=True, seed=13, tick_dt=0.02,
                         exact_device=mode, collect_saves=True,
                         sessions=24, tenants=6, requests=192,
                         arrivals_per_tick=24, sync_fraction=0.25)
        assert_leg_ok(report)
        saves[mode] = report['session_saves']
        assert report['session_saves'], 'empty save map'
    assert saves[False] == saves[True], \
        'device modes diverged under the identical chaos script'


def assert_shard_leg_ok(report):
    assert report['untyped_escapes'] == 0, report
    assert report['drained'], report
    for audit in report['audits']:
        # ZERO acknowledged-write loss and byte-identical home/replica
        # convergence at EVERY settle point, not just the end
        assert audit['acked_lost'] == 0, audit
        assert audit['replica_mismatches'] == 0, audit
        assert audit['replica_pairs'] > 0, audit
    assert report['ok'], report


def test_shard_kill_one_of_four_smoke():
    """The acceptance leg (ISSUE-11): kill one of 4 shards mid-workload
    under chaos links — zero acked-write loss, the dead shard's tenants
    served by their replicas within the lease window, post-quiet
    byte-identical convergence across the surviving shards."""
    report = run_shard_leg('kill_one_of_four', n_shards=4, tenants=12,
                           requests=240, arrivals_per_tick=8,
                           chaos=True, seed=5, kills=((12, 1, 40),),
                           mttr_bound=12)
    assert_shard_leg_ok(report)
    assert report['failovers'] == 1
    assert report['mttr_ticks'][0] is not None
    assert report['mttr_ticks'][0] <= report['lease_ticks'] + 9
    assert report['completed_ok'] > 0


def test_shard_kill_revive_cycles_same_shard():
    """The satellite: kill and revive ONE shard 3x mid-workload (with a
    rebalance pulling its tenants home each revive), asserting the
    byte-identical convergence audit after every round."""
    report = run_shard_leg(
        'kill_revive_3x', n_shards=3, tenants=9, requests=270,
        arrivals_per_tick=6, chaos=True, seed=7,
        kills=((10, 0, 30), (60, 0, 80), (110, 0, 130)))
    assert_shard_leg_ok(report)
    assert report['kills'] == 3
    # three settle audits (one per revive) plus the final one, each
    # byte-identical — checked in assert_shard_leg_ok
    assert len(report['audits']) == 4
    assert report['shard_health_delta'].get('shard_revives', 0) == 3


@pytest.mark.slow
def test_shard_kill_matrix_full():
    """Scaled kill schedule: two different victims plus a repeat kill,
    both device modes."""
    for mode in (False, True):
        report = run_shard_leg(
            'kill_matrix', n_shards=4, tenants=32, requests=1600,
            arrivals_per_tick=16, chaos=True, seed=19,
            exact_device=mode,
            kills=((20, 1, 60), (120, 3, 160), (220, 1, 260)))
        assert_shard_leg_ok(report)
        assert report['failovers'] == 3


@pytest.mark.slow
def test_service_full_matrix_10k():
    """The acceptance run: 10k concurrent sessions through all three
    legs, both device modes."""
    for mode in (False, True):
        for report in run_standard_legs(sessions=10_000, tenants=256,
                                        requests=20_000, seed=0,
                                        exact_device=mode, device='cpu'):
            assert_leg_ok(report)
            if report['leg'] == 'overload':
                assert report['brownout_transitions'] > 0
