# The port's copy of tests/test_perf_obs.py: imports re-pointed at
# automerge_tpu_torch, fleets on the CPU (device='cpu'). The kernel
# ledger's tests are rewritten for the port's torch ledger, with a
# differential against the reference's. Not copied: TestBenchLedger,
# TestPerfGate and the trajectory test (they test tools/bench_ledger.py
# and tools/perf_gate.py, not the package). The threaded ShardRouter
# count runs its routers' shard fleets on the CPU.
"""Performance observatory coverage (ISSUE-13).

- DRIFT DETECTOR NOISE IMMUNITY: the seam-baseline detector replayed
  against per-event deltas sampled from BENCH_r07's RECORDED ±40%
  noisy-box history must fire ZERO alerts across 5 clean windows, and
  must detect a synthetic 1.3x slowdown within 2 windows — the
  windowed-mean aggregation (window_events events per judgment) is
  what earns both at once.
- KERNEL COST LEDGER: off = no counting; on = per-kind dispatches /
  blocking seconds / one signature per distinct shape, with the bytes
  a signature reads and writes worked out from its recorded shapes;
  the port's kernel entry points count what the reference's count.
- MEMORY WATERMARKS: tier sources sampled with sticky process-lifetime
  highs; RSS always present.
- ATOMIC COUNTERS: Counters.inc is exact under a thread hammer
  (the round-15 undercount).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from automerge_tpu_torch.observability import hist as obs_hist
from automerge_tpu_torch.observability import perf as obs_perf
from automerge_tpu_torch.observability import recorder as obs_recorder
from automerge_tpu_torch.observability.metrics import Counters
from automerge_tpu_torch.observability.perf import PerfBaselines, SeamSpec

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_perf_state():
    obs_perf.disable_observatory()
    obs_hist.disable()
    obs_perf.reset_ledger()
    yield
    obs_perf.disable_observatory()
    obs_hist.disable()
    obs_perf.reset_ledger()


# ---- recorded noise: BENCH_r07's ±40% history ------------------------------

def _recorded_r07_deltas():
    """Relative deltas derived from the numbers BENCH_r07/r06 actually
    recorded (the measurement history that repeatedly blamed the box):
    the r07 headline, its same-day control, the thread sweep, and the
    r06 headline, each vs their common median."""
    with open(os.path.join(_ROOT, 'BENCH_r07.json')) as f:
        r07 = json.load(f)
    with open(os.path.join(_ROOT, 'BENCH_r06.json')) as f:
        r06 = json.load(f)
    values = [float(r07['parsed']['value']),
              float(r07['notes']['same_day_baseline_control_seam']),
              float(r06['parsed']['value'])]
    values += [float(v) for v in
               r07['notes']['thread_scaling_sweep'].values()]
    med = float(np.median(values))
    deltas = [v / med - 1.0 for v in values]
    # the recorded swing really is the ±40% story the ISSUE cites
    assert max(deltas) - min(deltas) > 0.4
    return deltas


class TestDriftDetector:
    def _replay(self, reg, seam, base_s, n_windows, scale=1.0, start=0):
        """Feed n_windows full windows of per-event latencies sampled
        from the recorded delta table, then tick once per window."""
        deltas = _recorded_r07_deltas()
        k = start
        for _ in range(n_windows):
            for _ in range(reg.window_events):
                reg.record(seam, base_s * scale *
                           (1.0 + deltas[k % len(deltas)]))
                k += 1
            reg.tick()
        return k

    def test_zero_false_fires_on_recorded_noise_then_detects_1p3x(self):
        reg = PerfBaselines(seams=(SeamSpec('probe', 'probe_hist_s'),),
                            window_events=32, drift_pct=0.20,
                            up_ticks=2, min_windows=2)
        fired0 = obs_perf.perf_stats()['perf_alerts_fired']
        # 5 clean windows of recorded ±40% per-event noise: quiet
        k = self._replay(reg, 'probe', 0.1, 5)
        assert obs_perf.perf_stats()['perf_alerts_fired'] == fired0
        assert not reg.active_alerts()
        state = reg.seams['probe']
        assert state.windows == 5
        assert 0.9 < state.drift < 1.1        # window means concentrated
        # synthetic 1.3x slowdown: detected within 2 windows
        self._replay(reg, 'probe', 0.1, 2, scale=1.3, start=k)
        assert obs_perf.perf_stats()['perf_alerts_fired'] == fired0 + 1
        assert reg.active_alerts() == ['probe']
        assert state.drift == pytest.approx(1.3, rel=0.1)

    def test_baseline_freezes_under_drift_and_alert_is_edge_triggered(self):
        reg = PerfBaselines(seams=(SeamSpec('probe', 'x'),),
                            window_events=8, drift_pct=0.20,
                            up_ticks=2, min_windows=2)
        self._replay(reg, 'probe', 0.1, 5)
        baseline_before = reg.seams['probe'].ewma
        fired0 = obs_perf.perf_stats()['perf_alerts_fired']
        # a sustained regression must not teach the baseline its own
        # slowdown (else the alert would self-clear)
        self._replay(reg, 'probe', 0.1, 6, scale=1.4)
        assert reg.seams['probe'].ewma == \
            pytest.approx(baseline_before, rel=0.15)
        # edge-triggered: ONE fire despite 6 drifting windows
        assert obs_perf.perf_stats()['perf_alerts_fired'] == fired0 + 1

    def test_alert_clears_after_recovery(self):
        """The clear rule judges EXCESS drift (drift - 1): a recovered
        seam back at its baseline (drift ~1.0) must clear within
        down_ticks windows — not demand the seam run 40% FASTER than
        baseline (the raw-ratio-into-_Alert bug)."""
        reg = PerfBaselines(seams=(SeamSpec('probe', 'x'),),
                            window_events=8, drift_pct=0.20,
                            up_ticks=2, down_ticks=4, min_windows=2)
        self._replay(reg, 'probe', 0.1, 5)
        self._replay(reg, 'probe', 0.1, 4, scale=1.5)
        assert reg.active_alerts() == ['probe']
        cleared0 = obs_perf.perf_stats()['perf_alerts_cleared']
        # full recovery to baseline, same recorded noise
        self._replay(reg, 'probe', 0.1, 8)
        assert reg.active_alerts() == []
        assert obs_perf.perf_stats()['perf_alerts_cleared'] == \
            cleared0 + 1

    def test_fire_lands_in_flight_recorder(self):
        obs_recorder.clear_events()
        reg = PerfBaselines(seams=(SeamSpec('probe', 'x'),),
                            window_events=8, drift_pct=0.20,
                            up_ticks=2, min_windows=2)
        self._replay(reg, 'probe', 0.1, 4)
        self._replay(reg, 'probe', 0.1, 3, scale=1.5)
        kinds = [e['kind'] for e in obs_recorder.recent_events()]
        assert 'perf_drift' in kinds
        dump = obs_recorder.last_flight_record()
        assert dump['trigger'] == 'perf'
        assert dump['detail']['seam'] == 'probe'
        assert dump['detail']['drift'] >= 1.2
        assert len(dump['detail']['window_means_s']) >= 4

    def test_histogram_feed_and_gauges(self):
        obs_hist.enable()
        reg = obs_perf.enable_baselines(window_events=4, min_windows=1)
        try:
            for _ in range(8):
                obs_hist.record_value('apply_batch_s', 0.05, scale=1e9,
                                      unit='s')
            reg.tick()
            gauges = obs_perf.baseline_gauges()
            assert 'apply_batch' in gauges
            g = gauges['apply_batch']
            assert g['window_s'] == pytest.approx(0.05)
            assert g['windows'] == 2
            assert g['alert'] == 0
        finally:
            obs_perf.disable_baselines()

    def test_service_tick_drives_default_registry(self):
        from automerge_tpu_torch.fleet.backend import DocFleet
        from automerge_tpu_torch.service import DocService
        reg = obs_perf.enable_baselines()
        try:
            service = DocService(fleet=DocFleet(device='cpu'), slo=False)
            before = reg.ticks
            service.pump()
            assert reg.ticks == before + 1
        finally:
            obs_perf.disable_baselines()


# ---- kernel cost ledger ----------------------------------------------------

def _seam_changes(n_docs, rnd):
    """Round 0 sets k0 and makes counter c; round 1 sets k1 and
    increments c (a set-only fresh batch, then a general one)."""
    from automerge_tpu_torch.columnar import encode_change
    actor = 'ab' * 16
    if rnd == 0:
        second = {'action': 'set', 'obj': '_root', 'key': 'c', 'value': 0,
                  'datatype': 'counter', 'pred': []}
    else:
        second = {'action': 'inc', 'obj': '_root', 'key': 'c', 'value': 2,
                  'pred': [f'2@{actor}']}
    change = encode_change({
        'actor': actor, 'seq': rnd + 1, 'startOp': 1 + 2 * rnd, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': f'k{rnd}',
                 'value': rnd, 'datatype': 'int', 'pred': []}, second]})
    return [[change] for _ in range(n_docs)]


class TestKernelLedger:
    def test_off_by_default_counts_when_enabled(self):
        fn = obs_perf.instrument_kernel('probe_kernel',
                                        lambda x: torch.sum(x * 2))
        fn(torch.arange(8))
        assert 'probe_kernel' not in obs_perf.kernel_snapshot()
        obs_perf.enable_ledger()
        fn(torch.arange(8))
        fn(torch.arange(8))
        fn(torch.arange(16))        # a second signature
        snap = obs_perf.kernel_snapshot()['probe_kernel']
        assert snap['dispatches'] == 3
        assert snap['signatures'] == 2
        assert snap['seconds'] > 0

    def test_report_counts_the_bytes_read_and_written(self):
        fn = obs_perf.instrument_kernel('probe_cost', lambda x: x @ x)
        obs_perf.enable_ledger()
        fn(torch.ones((16, 16)))
        report = obs_perf.kernel_report()['probe_cost']
        sig = report['signatures'][0]
        assert sig['dispatches'] == 1
        # the [16, 16] float32 input read, the [16, 16] result written;
        # no flops (the port reports none), so no rate totals
        assert sig['cost'] == {'bytes accessed': 2 * 16 * 16 * 4.0}
        assert 'flops_total' not in report
        assert set(report) == {'dispatches', 'seconds', 'signatures'}

    def test_state_classes_flatten_and_donation_keys_before_the_call(self):
        from automerge_tpu_torch.fleet.tensor_doc import FleetState

        def grow(state, n):
            # changes its argument in place: the signature is the input's
            state.winners = torch.zeros((n, 4), dtype=torch.int32)
            return state
        fn = obs_perf.instrument_kernel('probe_donated', grow)
        obs_perf.enable_ledger()
        for _ in range(2):
            fn(FleetState.empty(2, 3, 'cpu'), 8)
        report = obs_perf.kernel_report()['probe_donated']
        assert report['dispatches'] == 2
        assert len(report['signatures']) == 1
        # read: three [2, 4] int32 grids; written: [8, 4] + two [2, 4]
        assert report['signatures'][0]['cost'] == {
            'bytes accessed': float(3 * 32 + 128 + 2 * 32)}

    def test_dump_ledger_is_floor_readable(self, tmp_path):
        fn = obs_perf.instrument_kernel('probe_dump', lambda x: x + 1)
        obs_perf.enable_ledger()
        fn(torch.arange(4))
        path = obs_perf.dump_ledger(str(tmp_path / 'ledger.json'))
        with open(path) as f:
            dump = json.load(f)
        assert dump['kind'] == 'kernel_ledger'
        assert 'probe_dump' in dump['kernels']

    def test_wrapped_entry_points_keep_the_reference_kinds(self):
        from automerge_tpu.observability import perf as ref_perf
        import automerge_tpu.fleet.backend  # noqa: F401 (wires the kinds)
        import automerge_tpu_torch.fleet.backend  # noqa: F401
        ref_kinds = set(ref_perf.kernel_kinds())
        kinds = set(obs_perf.kernel_kinds())
        # every reference kind but the Pallas merge (the port's merge
        # entry points launch the hand kernel themselves) and the mesh
        # kinds (the multi-device slice)
        missing = {k for k in ref_kinds - kinds
                   if not k.startswith(('sharded_', 'probe_', 'export_'))}
        assert missing <= {'pallas_apply_op_batch', 'exchange_all_to_all'}
        assert 'pallas_apply_op_batch' not in kinds

    @pytest.mark.parametrize('exact', [False, True], ids=['lww', 'exact'])
    def test_seam_dispatches_equal_the_reference(self, exact):
        """The same batches through both packages' seams (LWW grids or
        exact registers): equal dispatch counts for every kind both
        instrument."""
        from automerge_tpu import native as ref_native
        from automerge_tpu.fleet import backend as ref_backend
        from automerge_tpu.observability import perf as ref_perf
        from automerge_tpu_torch import native
        from automerge_tpu_torch.fleet import backend as fleet_backend
        if not (native.available() and ref_native.available()):
            pytest.skip('a native codec is unavailable')
        snaps = {}
        for name, fb, perf, kw in (
                ('ref', ref_backend, ref_perf, {}),
                ('port', fleet_backend, obs_perf, {'device': 'cpu'})):
            perf.disable_ledger()
            perf.reset_ledger()
            fleet = fb.DocFleet(doc_capacity=8, key_capacity=8,
                                exact_device=exact, **kw)
            perf.enable_ledger()
            try:
                handles = fb.init_docs(4, fleet)
                for rnd in range(2):
                    handles, _ = fb.apply_changes_docs(
                        handles, _seam_changes(4, rnd), mirror=False)
                docs = fb.materialize_docs(handles)
                fb.free_docs(handles[:1])
                snaps[name] = (docs, {k: v['dispatches'] for k, v in
                                      perf.kernel_snapshot().items()})
            finally:
                perf.disable_ledger()
                perf.reset_ledger()
        assert snaps['port'][0] == snaps['ref'][0]
        ref, got = snaps['ref'][1], snaps['port'][1]
        shared = set(ref_perf.kernel_kinds()) & set(obs_perf.kernel_kinds())
        assert {k: v for k, v in got.items() if k in shared} == \
            {k: v for k, v in ref.items() if k in shared}
        assert set(got) >= ({'apply_register_batch_donated',
                             'visible_registers'} if exact else
                            {'apply_op_batch_noinc_fresh',
                             'apply_op_batch_donated',
                             'zero_doc_rows_donated'})


# ---- memory watermarks -----------------------------------------------------

class TestWatermarks:
    def test_rss_and_sticky_highs(self):
        obs_perf.reset_watermarks()
        value = [1000]
        obs_perf.register_mem_source('probe_tier', lambda: value[0])
        try:
            cur = obs_perf.sample_watermarks()
            assert cur['rss'] > 0
            assert cur['probe_tier'] == 1000
            value[0] = 5000
            obs_perf.sample_watermarks()
            value[0] = 200
            snap = obs_perf.watermark_snapshot()
            assert snap['current']['probe_tier'] == 200
            assert snap['high']['probe_tier'] == 5000   # sticky
            assert snap['high']['rss'] >= snap['current']['rss'] > 0
        finally:
            obs_perf._mem_sources.pop('probe_tier', None)

    def test_fleet_and_store_tiers_registered(self):
        from automerge_tpu_torch.fleet.backend import DocFleet, init_docs
        from automerge_tpu_torch.fleet.storage import MainStore
        fleet = DocFleet(device='cpu')
        init_docs(4, fleet)
        store = MainStore()
        store.add(b'x' * 100, ['ab' * 32], {'ab' * 32: 1}, 3, 1)
        cur = obs_perf.sample_watermarks()
        assert cur['mainstore_bytes'] >= 100
        assert 'fleet_resident_bytes' in cur
        assert store.resident_bytes() >= 100 + 32


# ---- atomic counters under threads -----------------------------------------

class TestAtomicCounters:
    def test_inc_exact_under_hammer(self):
        c = Counters({'hits': 0})
        threads, per_thread = 6, 10000

        def hammer():
            for _ in range(per_thread):
                c.inc('hits')

        ts = [threading.Thread(target=hammer) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # a plain dict loses updates here (the round-15 undercount);
        # the locked inc must be EXACT
        assert c['hits'] == threads * per_thread

    def test_inc_negative_and_missing_key(self):
        c = Counters()
        assert c.inc('gauge') == 1
        assert c.inc('gauge', -1) == 0
        c['reset_me'] = 7
        c['reset_me'] = 0
        assert c['reset_me'] == 0

    @pytest.mark.parametrize('module', ['merge_kernel', 'register_kernel',
                                        'seq_kernel', 'sync_kernels'])
    def test_kernel_launch_counts_exact_under_threads(self, module):
        """The shard router pumps its shards from a thread pool, so the
        kernel wrappers count their launches from several threads at
        once: every launch table takes the locked increment."""
        import importlib
        import sys
        mod = importlib.import_module(f'automerge_tpu_torch.fleet.{module}')
        threads, per_thread = 16, 2000
        saved = dict(mod.LAUNCHES)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            mod.reset_launches()

            def launch():
                for _ in range(per_thread):
                    for name in mod.LAUNCHES:
                        mod.LAUNCHES.inc(name)
            ts = [threading.Thread(target=launch) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            assert set(mod.LAUNCHES.values()) == {threads * per_thread}
        finally:
            sys.setswitchinterval(interval)
            mod.LAUNCHES.update(saved)

    def test_threaded_router_pump_counts_exact(self):
        """The satellite pin: at pump_threads>1, module health counters
        land EXACT (they are Counters now, not bare dict increments)."""
        from automerge_tpu_torch import native
        if not native.available():
            pytest.skip('native codec unavailable')
        from automerge_tpu_torch.columnar import encode_change
        from automerge_tpu_torch.observability import health_counts
        from automerge_tpu_torch.service.backoff import Backoff
        from automerge_tpu_torch.shard import ShardRouter
        clk = [0.0]
        router = ShardRouter(n_shards=4, clock=lambda: clk[0],
                             pump_threads=4, lease_ticks=3,
                             backoff=Backoff(base=0.02, factor=1.5,
                                             cap=0.32, retries=14,
                                             seed=1), device='cpu')
        n_tenants, per_tenant = 12, 3
        try:
            for i in range(n_tenants):
                router.open_tenant(f't{i}')
            before = health_counts()
            tickets = []
            for i in range(n_tenants):
                for seq in range(1, per_tenant + 1):
                    tickets.append(router.submit(
                        f't{i}', 'apply', [encode_change({
                            'actor': f'{i:02x}' * 16, 'seq': seq,
                            'startOp': seq, 'time': 0, 'message': '',
                            'deps': [],
                            'ops': [{'action': 'set', 'obj': '_root',
                                     'key': 'k', 'value': seq,
                                     'datatype': 'int', 'pred': []}]})]))
            for _ in range(400):
                if all(t.done for t in tickets):
                    break
                router.pump(now=clk[0])
                clk[0] += 0.02
            assert all(t.status == 'ok' for t in tickets), \
                [(t.status, t.error) for t in tickets if not t.done
                 or t.status != 'ok'][:4]
            after = health_counts()
            moved = {k: after[k] - before.get(k, 0)
                     for k in after if after[k] != before.get(k, 0)}
            n = n_tenants * per_tenant
            # no retries in a clean router: submit == dispatch == done
            assert moved.get('shard_retries', 0) == 0
            assert moved.get('service_requests') == n, moved
            assert moved.get('service_completed') == n, moved
        finally:
            router.close()


def test_guard_keywords_stay_out_of_the_signature():
    """The hash-index insert's load bound changes every call; it guards
    the launch on the host and is no part of its shape."""
    fn = obs_perf.instrument_kernel('probe_guarded',
                                    lambda x, bound=0: x + 1,
                                    guards=('bound',))
    obs_perf.enable_ledger()
    for bound in range(5):
        fn(torch.arange(4), bound=bound)
    snap = obs_perf.kernel_snapshot()['probe_guarded']
    assert snap == dict(snap, dispatches=5, signatures=1)
