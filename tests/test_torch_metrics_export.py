# The port's copy of tests/test_metrics_export.py: imports re-pointed
# at automerge_tpu_torch. Added: the /metrics page after the same
# fake-clock service leg through both packages, compared line for line.
"""Prometheus exposition + MetricsExporter lifecycle (ISSUE-10).

The exporter contracts pinned here: port-0 ephemeral bind for tests, a
concurrent scrape during recording never reads torn histograms (every
``_bucket`` series sums exactly to its ``_count`` — the render comes
from an atomic snapshot), clean shutdown joins the serving thread, and
``AUTOMERGE_TPU_METRICS_PORT`` unset means FULLY disabled: no server,
no thread, nothing."""

import os
import sys
import threading
import urllib.request

import pytest

from automerge_tpu_torch.observability import hist as obs_hist
from automerge_tpu_torch.observability import (MetricsExporter, SloPolicy,
                                         SloRegistry, maybe_start_exporter,
                                         render_prometheus)
from automerge_tpu_torch.observability.export import (METRICS_PORT_ENV,
                                                METRICS_SNAPSHOT_ENV,
                                                snapshot_all)


@pytest.fixture(autouse=True)
def _fresh_hists():
    """Run each test against a clean histogram registry (the module
    registry is process-global)."""
    saved = dict(obs_hist._registry)
    obs_hist._registry.clear()
    obs_hist.enable()
    yield
    obs_hist.disable()
    obs_hist._registry.clear()
    obs_hist._registry.update(saved)


def _scrape(port, path='/metrics'):
    with urllib.request.urlopen(
            f'http://127.0.0.1:{port}{path}', timeout=5) as resp:
        return resp.status, resp.read().decode()


def _parse_series(page):
    out = {}
    for line in page.splitlines():
        if line.startswith('#') or not line.strip():
            continue
        name, value = line.rsplit(' ', 1)
        out[name] = float(value)
    return out


def test_render_health_dispatch_and_histograms():
    obs_hist.record_value('unit_test_lat_s', 0.003, scale=1e9, unit='s')
    obs_hist.record_value('unit_test_lat_s', 0.7, scale=1e9, unit='s')
    page = render_prometheus()
    series = _parse_series(page)
    assert any(k.startswith('automerge_tpu_health_total{')
               for k in series)
    assert any(k.startswith('automerge_tpu_dispatch_total{')
               for k in series)
    assert series['automerge_tpu_unit_test_lat_s_count'] == 2
    assert series['automerge_tpu_unit_test_lat_s_bucket{le="+Inf"}'] == 2
    # cumulative monotone, ending at count
    buckets = [(k, v) for k, v in series.items()
               if k.startswith('automerge_tpu_unit_test_lat_s_bucket')]
    values = [v for _, v in buckets]
    assert values == sorted(values)


def test_render_slo_series_and_label_escaping():
    reg = SloRegistry(policies={
        'latency': SloPolicy(0.99, threshold_s=0.05)})
    hostile = 'ten"ant\\{}\n2'
    reg.record(hostile, 'apply', 0.001)
    reg.tick()
    page = render_prometheus(slo=reg)
    assert 'automerge_tpu_slo_requests_total' in page
    assert 'ten\\"ant\\\\{}\\n2' in page
    # every line still parses name-space-value
    assert _parse_series(page)


def test_exporter_port0_bind_scrape_and_shutdown():
    before = threading.active_count()
    exporter = MetricsExporter(port=0).start()
    assert exporter.port and exporter.port != 0
    assert exporter.running
    status, page = _scrape(exporter.port)
    assert status == 200
    assert 'automerge_tpu_health_total' in page
    status404 = None
    try:
        _scrape(exporter.port, '/nope')
    except urllib.error.HTTPError as exc:
        status404 = exc.code
    assert status404 == 404
    exporter.stop()
    assert not exporter.running
    assert exporter.port is None
    # no thread leak: back to (at most) where we started
    assert threading.active_count() <= before + 1


def test_concurrent_scrape_never_reads_torn_histograms():
    h = obs_hist.histogram('torn_probe_s', scale=1e9, unit='s')
    stop = threading.Event()

    def hammer():
        v = 0
        while not stop.is_set():
            h.record((v % 1000) / 1e4)
            v += 1

    writer = threading.Thread(target=hammer, daemon=True)
    writer.start()
    exporter = MetricsExporter(port=0).start()
    try:
        for _ in range(25):
            _, page = _scrape(exporter.port)
            series = _parse_series(page)
            # page order IS bucket order (the dict preserves it)
            buckets = [(k, v) for k, v in series.items()
                       if k.startswith('automerge_tpu_torn_probe_s_bucket')]
            count = series['automerge_tpu_torn_probe_s_count']
            inf = series['automerge_tpu_torn_probe_s_bucket{le="+Inf"}']
            # the atomic-snapshot contract: cumulative buckets agree
            # with the count rendered on the SAME page, always
            assert inf == count, (inf, count)
            values = [v for _, v in buckets]
            assert values == sorted(values)
    finally:
        stop.set()
        writer.join(timeout=5)
        exporter.stop()


def test_env_unset_means_fully_disabled(monkeypatch):
    monkeypatch.delenv(METRICS_PORT_ENV, raising=False)
    monkeypatch.delenv(METRICS_SNAPSHOT_ENV, raising=False)
    before = threading.active_count()
    assert maybe_start_exporter() is None
    assert threading.active_count() == before


def test_env_port_starts_and_serves(monkeypatch):
    monkeypatch.setenv(METRICS_PORT_ENV, '0')
    exporter = maybe_start_exporter()
    try:
        assert exporter is not None and exporter.running
        status, page = _scrape(exporter.port)
        assert status == 200 and 'automerge_tpu' in page
    finally:
        exporter.stop()


def test_snapshot_file_mode_atomic(tmp_path, monkeypatch):
    monkeypatch.delenv(METRICS_PORT_ENV, raising=False)
    target = tmp_path / 'metrics.prom'
    monkeypatch.setenv(METRICS_SNAPSHOT_ENV, str(target))
    before = threading.active_count()
    exporter = maybe_start_exporter()
    # snapshot-only mode: no server, no thread
    assert exporter is not None and not exporter.running
    assert threading.active_count() == before
    obs_hist.record_value('snap_probe_s', 0.01, scale=1e9, unit='s')
    path = exporter.write_snapshot()
    assert path == str(target)
    page = target.read_text()
    assert 'automerge_tpu_snap_probe_s_count 1' in page
    # no temp litter (the write is temp+rename)
    assert [p.name for p in tmp_path.iterdir()] == ['metrics.prom']


def test_snapshot_all_is_plain_data():
    reg = SloRegistry()
    reg.record('t', 'apply', 0.001)
    reg.tick()
    snap = snapshot_all(slo=reg)
    import json
    # keys are tuples for the slo sections; everything else must be
    # JSON-serializable plain data
    json.dumps({k: v for k, v in snap.items()
                if not k.startswith('slo_')})
    assert snap['slo_tallies'][('t', 'apply')]['committed'] == 1


# ---------------------------------------------------------------------------
# the port against the reference: the page after the same leg
# ---------------------------------------------------------------------------

# Families whose values are process totals over every module that
# registered a source (so they follow what else ran in the process, and
# which of each package's modules, the shard and control families among
# them, it had imported): compared by the leg's moved counters in
# test_torch_service.py instead.
PROCESS_TOTALS = ('automerge_tpu_health_total', 'automerge_tpu_dispatch_total')

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tools'))

import loadgen                                                  # noqa: E402
from automerge_tpu import native as ref_native                  # noqa: E402
from automerge_tpu.fleet.backend import DocFleet as RefFleet    # noqa: E402
from automerge_tpu.observability import hist as ref_hist        # noqa: E402
from automerge_tpu.observability import perf as ref_perf        # noqa: E402
from automerge_tpu.observability import (                       # noqa: E402
    render_prometheus as ref_render)
from automerge_tpu.service import DocService as RefService      # noqa: E402
from automerge_tpu_torch import native                          # noqa: E402
from automerge_tpu_torch.fleet.backend import DocFleet          # noqa: E402
from automerge_tpu_torch.observability import perf              # noqa: E402
from automerge_tpu_torch.service import DocService              # noqa: E402
from automerge_tpu_torch.service_cases import run_leg           # noqa: E402


def _leg_page(run_leg, service_cls, fleet, hist, perf, render):
    """Run the fake-clock leg with the observatory off and an empty
    histogram registry; return the rendered page of its SLO registry."""
    kept = []
    real = service_cls.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        kept.append(self)
    saved = dict(hist._registry)
    hist._registry.clear()
    hist.disable()
    perf.disable_observatory()
    perf.reset_watermarks()
    service_cls.__init__ = init
    try:
        report = run_leg('page', fleet=fleet, sessions=12, tenants=3,
                         requests=60, seed=3, tick_dt=0.01, chaos=True)
        page = render(slo=kept[0].slo)
    finally:
        service_cls.__init__ = real
        hist._registry.clear()
        hist._registry.update(saved)
    return report, page


def test_page_after_the_same_leg_equals_the_reference():
    if not (native.available() and ref_native.available()):
        pytest.skip('a native codec is unavailable')
    ref, ref_page = _leg_page(loadgen.run_leg, RefService, RefFleet(),
                              ref_hist, ref_perf, ref_render)
    got, page = _leg_page(
        lambda *a, **k: run_leg(*a, device='cpu', **k), DocService,
        DocFleet(device='cpu'), obs_hist, perf, render_prometheus)
    assert got['completed_ok'] == ref['completed_ok'] > 0
    assert not perf.ledger_on()

    def lines(text):
        return [line for line in text.splitlines()
                if not line.startswith(PROCESS_TOTALS) and
                line not in [f'# TYPE {p} counter' for p in PROCESS_TOTALS]]
    assert 'automerge_tpu_slo_requests_total' in page
    assert lines(page) == lines(ref_page)
