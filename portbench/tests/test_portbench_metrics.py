"""The metric arithmetic: rates over all the work and all the time, the
device's reading of a trace, span self time, and the byte counts against
hand counts."""

import pytest

from portbench import bounds, run
from portbench.metrics.spans_util import self_ms, total_ms
from portbench.trace import summarize
from helpers import run_tiny


def _ev(cat, name, ts, dur, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def test_summary_of_a_hand_trace():
    events = [
        _ev('user_annotation', 'pb.align', 0, 1),
        _ev('user_annotation', 'pb.step', 10, 100),
        _ev('cuda_runtime', 'cudaLaunchKernel', 20, 2, corr=1),
        _ev('cuda_runtime', 'cudaMemcpyAsync', 30, 2, corr=2),
        _ev('cuda_runtime', 'cudaLaunchKernel', 200, 2, corr=3),
        _ev('kernel', 'lww_merge', 40, 10, corr=1),
        _ev('gpu_memcpy', 'Memcpy HtoD', 45, 10, corr=2),   # overlaps
        _ev('kernel', 'zero_rows', 210, 5, corr=3),          # outside a step
    ]
    # a program span over [60, 150) us; the mark at perf ns 0 == 0 us
    spans = [('turbo_commit', 60_000, 150_000, 1)]
    s = summarize(events, spans, align_ns=0)
    assert s['busy_us'] == pytest.approx(15 + 5)          # [40, 55) + [210, 215)
    assert s['step_kernel_us'] == pytest.approx(10)       # lww_merge only
    assert dict(s['ops']) == {'lww_merge': 10, 'Memcpy HtoD': 10,
                              'zero_rows': 5}
    # the gap [55, 210): 5 in the step, 90 in turbo_commit, 60 outside
    assert dict(s['idle_by_span']) == {'turbo_commit': pytest.approx(90),
                                       'pb.step': pytest.approx(5),
                                       'harness': pytest.approx(60)}


def test_idle_gap_outside_spans_is_the_harness():
    events = [_ev('kernel', 'a', 0, 1, 1), _ev('kernel', 'b', 5, 1, 2)]
    assert summarize(events)['idle_by_span'] == [('harness', 4)]


def test_self_time_leaves_out_nested_spans():
    spans = [('sync_generate', 0, 100_000_000, 1),
             ('bloom_build', 10_000_000, 30_000_000, 1),
             ('sync_encode', 50_000_000, 90_000_000, 1),
             ('hashindex_probe', 60_000_000, 70_000_000, 1)]
    names = ('sync_generate', 'sync_encode')
    # generate: 100 - 20 (bloom) - 40 (encode); encode: 40 - 10
    assert self_ms(spans, names) == pytest.approx(40 + 30)
    assert total_ms(spans, names) == pytest.approx(140)


def test_bound_and_roofline():
    b = bounds.bound_of(3.35e9)                  # 1 ms of bytes
    assert b['bound_ms'] == pytest.approx(1.0)
    assert b['bound_by'] == 'bytes'
    assert bounds.roofline_pct(3.35e9, 4000) == pytest.approx(25.0)
    assert bounds.roofline_pct(1, 0) is None


def _reader(name):
    return run.reader(name)


def test_merge_roofline_counts_by_hand():
    ctx = {'steps': 2, 'summary': {'step_kernel_us': 10.0},
           'step_counts': [{'lanes': 999, 'cells': 999},
                           {'lanes': 200, 'cells': 150},
                           {'lanes': 100, 'cells': 100}]}
    # the last two steps: 300 lanes x 15 B + 250 cells x 16 B = 8,500 B
    want = 100 * 8500 / 3.35e12 / 10e-6
    assert _reader('merge_roofline.changes')(ctx, 'x') == pytest.approx(want)


def test_seq_scan_roofline_counts_by_hand():
    ctx = {'steps': 1, 'summary': {'step_kernel_us': 1.0},
           'step_counts': [{'inserts': 10, 'deletes': 4}]}
    want = 100 * (10 * 29 + 4 * 13) / 3.35e12 / 1e-6
    assert _reader('seq_scan_roofline.text_ops')(ctx, 'x') == \
        pytest.approx(want)


def test_sync_roofline_counts_by_hand():
    ctx = {'steps': 1, 'summary': {'step_kernel_us': 1.0},
           'step_counts': [{'links': 2, 'filter_bytes': 100,
                            'candidates': 40, 'sent_hashes': 8}]}
    # 100 + 12 x 40 + 12 x 8 + 2 x (12 + 5)
    want = 100 * (100 + 480 + 96 + 34) / 3.35e12 / 1e-6
    assert _reader('sync_kernels_roofline.links')(ctx, 'x') == \
        pytest.approx(want)


def test_readers_find_nothing_without_a_trace():
    ctx = {'steps': 0, 'summary': None, 'step_counts': [], 'spans': [],
           'window_s': 1.0}
    for name in ('merge_roofline.changes', 'device_idle.changes',
                 'turbo_host_ms.changes', 'sync_host_ms.links'):
        assert _reader(name)(ctx, name) is None


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_rate_is_all_work_over_all_time(monkeypatch):
    """The closed loop's rate counts every batch and the reloads' time:
    steps of 1 s, the second and third behind reloads of 1.5 s."""
    import portbench.drivers.batch_loop as bl
    clock = _Clock()
    monkeypatch.setattr(bl.time, 'perf_counter', clock)
    d = bl.BatchLoop.__new__(bl.BatchLoop)
    d.step_counts, d.failed, d.device, d.n = [], 0, 'cpu', 0
    d.log = lambda msg: None

    def reload_due():
        if d.n in (1, 2):
            clock.t += 1.5

    def step():
        clock.t += 1.0
        d.n += 1
    d._reload_due, d._step = reload_due, step
    d._counts = lambda: {}
    d._batch = lambda: (None, 10)
    done, attempted, elapsed, steps = d.window(4.5)
    # 1, reload 2.5, 3.5, reload 5, 6 >= 4.5: 30 changes in 6 s
    assert (done, attempted, steps) == (30, 30, 3)
    assert done / elapsed == pytest.approx(5.0)


def test_run_reports_the_rate_over_the_window():
    result, _ = run_tiny('map-batch-10k')
    m = result['metrics']
    assert set(m) == {'setup_s', 'changes_per_s'}
    assert m['changes_per_s']['value'] > 0
    assert m['changes_per_s']['unit'] == 'changes/s'


def test_tail_counts_failures_at_infinity():
    from portbench.drivers.service_open import ServiceOpen, percentile
    lat = [0.001 * i for i in range(1, 201)]          # 1 .. 200 ms
    assert percentile(lat, 99) == pytest.approx(0.198)
    failed = lat[:-4] + [float('inf')] * 4            # 2 % failed
    assert percentile(failed, 99) == float('inf')
    d = ServiceOpen.__new__(ServiceOpen)
    d.traffic, d.log = {'tail_metric': 'req_p99_ms'}, lambda m: None
    d.lat, d.failed = lat[:-1] + [float('inf')], 1   # 0.5 % failed
    assert d.end_to_end(199, 1.0) == {
        'req_p99_ms': pytest.approx(198.0)}
    d.lat, d.failed = failed, 4
    assert d.end_to_end(196, 1.0) == {}
