# The port's copy of the service legs of tests/test_service_chaos.py:
# the load generator is automerge_tpu_torch/service_cases.py and every
# fleet is on the CPU (device='cpu'). The shard legs wait for the shard
# slice.
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

torch.set_num_threads(1)


def run_leg(name, **kw):
    return _run_leg(name, device='cpu', **kw)

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
