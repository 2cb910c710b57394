# The port's copy of tests/test_export.py: imports re-pointed at
# automerge_tpu_torch; the kernel-ledger test wraps a torch function; the
# fixture also turns the observatory off BEFORE each test, so no switch
# another test left on leaks in.
"""Prometheus `_sum` exposition + perf-observatory gauges (ISSUE-13).

The round-14 torn-read contract said: cumulative buckets always agree
with the `_count` rendered on the same page. This file extends the pin
to `_sum`: every histogram family (plain registry histograms AND the
per-(tenant, kind) SLO latency histograms) renders a `_sum` line next
to `_count`, derived from the SAME consistently-copied snapshot — so
rate(..._sum[m]) / rate(..._count[m]) PromQL (rate-of-mean) is honest
under concurrent recording. Histogram.record updates the per-bucket
sums BEFORE the bucket counts and the exposition copies counts-sums-
counts with a stability retry, so the page's sum can never UNDERcount
the records its `_count` claims — the only allowed skew is the value
of a record still in flight, which the hammer test bounds exactly.

Also pinned here: the new perf-observatory gauge families (seam
baselines, kernel ledger, memory watermarks) render iff their switch
is on — no series churn for processes that never enable them.
"""

import threading

import pytest
import torch

from automerge_tpu_torch.observability import hist as obs_hist
from automerge_tpu_torch.observability import perf as obs_perf
from automerge_tpu_torch.observability.export import render_prometheus
from automerge_tpu_torch.observability.slo import SloPolicy, SloRegistry


@pytest.fixture(autouse=True)
def _clean():
    # watermark sampling is sticky by design (once sampled, the mem
    # gauges render); reset so the not-enabled assertions mean something
    obs_perf.disable_observatory()
    obs_hist.disable()
    obs_perf.reset_watermarks()
    yield
    obs_perf.disable_observatory()
    obs_hist.disable()
    obs_perf.reset_ledger()
    obs_perf.reset_watermarks()


def _parse_series(page):
    out = {}
    for line in page.splitlines():
        if not line or line.startswith('#'):
            continue
        name, _, value = line.rpartition(' ')
        out[name] = float(value)
    return out


def _bucket_bounds(series, prefix):
    """[(lo, hi, count_in_bucket)] from a page's cumulative buckets."""
    items = [(k, v) for k, v in series.items()
             if k.startswith(f'{prefix}_bucket')]
    lo = 0.0
    prev = 0.0
    out = []
    for key, cum in items:
        le = key.split('le="', 1)[1].rstrip('"}')
        hi = float('inf') if le == '+Inf' else float(le)
        out.append((lo, hi, cum - prev))
        lo, prev = hi, cum
    return out


def test_sum_next_to_count_for_every_histogram_family():
    h = obs_hist.histogram('sum_probe_s', scale=1e9, unit='s')
    h.record(0.25)
    h.record(0.75)
    reg = SloRegistry(policies={'latency': SloPolicy(0.99,
                                                    threshold_s=0.05)})
    reg.record('tenantA', 'apply', 0.004)
    reg.record('tenantA', 'apply', 0.006)
    reg.tick()
    page = render_prometheus(slo=reg)
    series = _parse_series(page)
    # plain registry histogram: _sum exact and beside _count
    assert series['automerge_tpu_sum_probe_s_count'] == 2
    assert series['automerge_tpu_sum_probe_s_sum'] == \
        pytest.approx(1.0, rel=1e-9)
    # per-(tenant, kind) SLO latency histogram: same contract
    key = ('automerge_tpu_slo_request_latency_seconds_sum'
           '{tenant="tenantA",kind="apply"}')
    assert series[key] == pytest.approx(0.010, rel=1e-9)
    assert series[key.replace('_sum', '_count')] == 2
    # page ordering: the _sum line sits in the histogram block, right
    # before its _count line (the PromQL-friendly shape)
    lines = [ln for ln in page.splitlines()
             if ln.startswith('automerge_tpu_sum_probe_s')]
    assert lines[-2].startswith('automerge_tpu_sum_probe_s_sum')
    assert lines[-1].startswith('automerge_tpu_sum_probe_s_count')


def test_sum_consistent_under_concurrent_recording():
    """The `_sum` twin of the round-14 torn-read hammer: while a writer
    records, every rendered page must satisfy (a) +Inf bucket == count,
    (b) sum >= the bucketwise LOWER bound of the counted records, and
    (c) sum <= the bucketwise UPPER bound plus at most ONE in-flight
    value (sums update before counts; one writer => one in-flight)."""
    h = obs_hist.histogram('sum_torn_probe', scale=1, unit='B')
    stop = threading.Event()
    max_value = 1000.0

    def hammer():
        v = 1
        while not stop.is_set():
            h.record(1.0 + (v % 1000))
            v += 1

    writer = threading.Thread(target=hammer, daemon=True)
    writer.start()
    try:
        for _ in range(50):
            series = _parse_series(render_prometheus())
            prefix = 'automerge_tpu_sum_torn_probe'
            count = series[f'{prefix}_count']
            total = series[f'{prefix}_sum']
            assert series[f'{prefix}_bucket{{le="+Inf"}}'] == count
            buckets = _bucket_bounds(series, prefix)
            lower = sum(lo * n for lo, _, n in buckets)
            upper = sum(min(hi, max_value + 1) * n
                        for _, hi, n in buckets)
            assert total >= lower - 1e-6, (total, lower)
            assert total <= upper + max_value + 1 + 1e-6, (total, upper)
    finally:
        stop.set()
        writer.join(timeout=5)


def test_perf_gauges_render_only_when_enabled():
    page_off = render_prometheus()
    assert 'perf_drift_ratio' not in page_off
    assert 'automerge_tpu_mem_bytes' not in page_off
    reg = obs_perf.enable_observatory()
    for _ in range(2 * reg.window_events):
        reg.record('apply_batch', 0.05)
    reg.tick()
    page = render_prometheus()
    series = _parse_series(page)
    assert series['automerge_tpu_perf_drift_ratio{seam="apply_batch"}'] \
        == pytest.approx(1.0)
    assert series[
        'automerge_tpu_perf_window_seconds{seam="apply_batch"}'] == \
        pytest.approx(0.05)
    assert series[
        'automerge_tpu_perf_alert_active{seam="apply_batch"}'] == 0
    # memory watermarks: rss current + high present once sampled
    assert series['automerge_tpu_mem_bytes{tier="rss"}'] > 0
    assert series['automerge_tpu_mem_high_bytes{tier="rss"}'] >= \
        series['automerge_tpu_mem_bytes{tier="rss"}']


def test_kernel_ledger_gauges_render():
    fn = obs_perf.instrument_kernel('export_probe_kernel', lambda x: x * 3)
    obs_perf.enable_ledger()
    fn(torch.arange(4))
    fn(torch.arange(4))
    series = _parse_series(render_prometheus())
    key = ('automerge_tpu_kernel_dispatches_total'
           '{kernel="export_probe_kernel"}')
    assert series[key] == 2
    assert series[key.replace('dispatches_total', 'seconds_total')] > 0


def test_shard_label_composes_with_perf_gauges():
    reg = obs_perf.enable_observatory()
    for _ in range(reg.window_events):
        reg.record('sync_round', 0.01)
    reg.tick()
    page = render_prometheus(shard='s7')
    assert ('automerge_tpu_perf_drift_ratio{shard="s7",'
            'seam="sync_round"}') in page
    assert 'automerge_tpu_mem_bytes{shard="s7",tier="rss"}' in page


class _FlipPolicy:
    """A synthetic policy that decides every window and alternates
    direction — so decisions, reversals, and active-state all move on
    every tick (the worst case for a concurrent scrape)."""

    name = 'probe'

    def __init__(self):
        self.n = 0

    def decide(self, sig):
        self.n += 1
        return [{'policy': self.name, 'action': 'nudge',
                 'target': 'tenant:t0',
                 'direction': 'up' if self.n % 2 else 'down',
                 'detail': {'n': self.n}}]

    def active(self):
        return {'tenant:t0': self.n}


def test_control_gauges_consistent_under_hammer():
    """The controller twin of the torn-read hammer: a pump thread
    committing a decision (with a reversal) every tick, a scraper
    rendering pages. Every page must satisfy the invariants the
    controller lock guarantees: decisions and reversals move TOGETHER
    (flip policy => reversals == decisions - 1 exactly), windows trails
    decisions by at most one, and both are monotonic across scrapes."""
    from automerge_tpu_torch.control import Controller
    ctrl = Controller(mode='shadow', window=1,
                      policies=[_FlipPolicy()])
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            ctrl.tick()

    writer = threading.Thread(target=pump, daemon=True)
    writer.start()
    try:
        prev_d = prev_w = 0.0
        dkey = ('automerge_tpu_control_decisions_total'
                '{policy="probe",action="nudge",mode="shadow"}')
        for _ in range(50):
            series = _parse_series(render_prometheus(control=ctrl))
            d = series.get(dkey, 0.0)
            w = series['automerge_tpu_control_windows_total']
            r = series.get(
                'automerge_tpu_control_reversals_total{policy="probe"}',
                0.0)
            if d >= 1:
                assert r == d - 1, (r, d)
            assert w <= d <= w + 1, (d, w)
            assert d >= prev_d and w >= prev_w, (d, prev_d, w, prev_w)
            prev_d, prev_w = d, w
    finally:
        stop.set()
        writer.join(timeout=5)


def test_control_series_compose_with_shard_label():
    from automerge_tpu_torch.control import Controller
    ctrl = Controller(mode='shadow', window=1,
                      policies=[_FlipPolicy()])
    ctrl.tick()
    page = render_prometheus(shard='s3', control=ctrl)
    assert 'automerge_tpu_control_windows_total{shard="s3"}' in page
    assert ('automerge_tpu_control_decisions_total{shard="s3",'
            'policy="probe",action="nudge",mode="shadow"}') in page
    assert ('automerge_tpu_control_policy_active{shard="s3",'
            'policy="probe",target="tenant:t0"}') in page
    assert ('automerge_tpu_control_decide_seconds{shard="s3",'
            'window="last"}') in page
    # and the family is absent entirely when no controller is wired
    assert 'control_windows_total' not in render_prometheus()
