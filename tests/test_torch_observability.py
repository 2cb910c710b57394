# The port's copy of tests/test_observability.py: imports re-pointed at
# automerge_tpu_torch, fleets on the CPU (device='cpu'), the change
# helper the port's own (the reference test's helper, inlined).
"""Metrics counters, host-phase spans, log2 histograms, and the flight
recorder (automerge_tpu.observability package)."""

import numpy as np
import pytest

from automerge_tpu_torch import observability
from automerge_tpu_torch.fleet import backend as fleet_backend
from automerge_tpu_torch.fleet.backend import DocFleet, FleetBackend
from automerge_tpu_torch.observability import Histogram, Metrics, timed
from automerge_tpu_torch.observability import hist as obs_hist
from automerge_tpu_torch.observability import spans as obs_spans
from automerge_tpu_torch.columnar import encode_change

ACTORS = ['aa' * 16, 'bb' * 16, 'cc' * 16, '11' * 16]


def change_buf(actor, seq, start_op, ops, deps=(), time=0, message=''):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': time,
        'message': message, 'deps': sorted(deps), 'ops': ops,
    })


@pytest.fixture(autouse=True)
def _obs_off():
    """Leave the module switches as the test found them (off)."""
    yield
    observability.disable()


def test_metrics_counters_track_turbo_and_exact():
    fb = FleetBackend(DocFleet(doc_capacity=4, key_capacity=4, device='cpu'))
    m = fb.fleet.metrics
    base = m.snapshot()
    handles = fleet_backend.init_docs(2, fb.fleet)
    per_doc = [[change_buf(ACTORS[0], 1, 1, [
        {'action': 'set', 'obj': '_root', 'key': 'a', 'value': d,
         'datatype': 'int', 'pred': []}])] for d in range(2)]
    handles, _ = fleet_backend.apply_changes_docs(handles, per_doc,
                                                  mirror=False)
    d = m.delta(base)
    assert d['turbo_calls'] == 1
    assert d['dispatches'] == 1
    assert d['changes_ingested'] == 2
    assert d['device_ops'] == 2
    assert d['bytes_ingested'] > 0

    # Lazy rebuilds are counted
    handles[0]['state'].materialize()
    fleet_backend.get_missing_deps(handles[0])
    d = m.delta(base)
    assert d['mirror_rebuilds'] == 1
    assert d['graph_builds'] >= 1

    # Exact path and promotion (nested maps AND objects inside sequences
    # are fleet-resident now; a sequence make past the packed-counter
    # window is the remaining promotion trigger)
    from automerge_tpu_torch.fleet.tensor_doc import CTR_LIMIT
    c = change_buf(ACTORS[0], 2, CTR_LIMIT + 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []}],
        deps=fleet_backend.get_heads(handles[0]))
    h0, _ = fleet_backend.apply_changes(handles[0], [c])
    d = m.delta(base)
    assert d['exact_calls'] >= 1
    assert d['promotions'] == 1


def test_metrics_repr_and_timed():
    m = Metrics()
    m.dispatches += 3
    with timed(m, 'decode'):
        pass
    assert 'dispatches=3' in repr(m)
    assert m.seconds['decode'] >= 0
    snap = m.snapshot()
    assert snap['dispatches'] == 3
    d = m.delta(snap)
    assert d['dispatches'] == 0


def test_fleet_memory_stats():
    """DocFleet.memory_stats reports per-component device byte accounting
    (grid/registers + each sequence size-class pool)."""
    import automerge_tpu_torch as A
    from automerge_tpu_torch.fleet.backend import DocFleet, FleetBackend
    fleet = DocFleet(doc_capacity=4, key_capacity=8, device='cpu')
    A.set_default_backend(FleetBackend(fleet))
    try:
        d = A.from_({'t': A.Text('hello'), 'x': 1}, '01' * 8)
        big = A.from_({'t': A.Text('y' * 200)}, '89' * 8)
        fleet.flush()
        stats = fleet.memory_stats()
        assert stats['total'] > 0
        assert 'lww_grid' in stats
        assert len(stats['seq_pools']) >= 2      # two size classes in use
        for pool in stats['seq_pools'].values():
            assert pool['bytes'] > 0 and pool['capacity'] >= 64
        # the 200-char Text span interned at least one boxed value
        assert stats['value_table_entries'] >= 1
        del d, big
    finally:
        from automerge_tpu_torch import backend as host_backend
        A.set_default_backend(host_backend)


# ---------------------------------------------------------------------------
# roll-up registries: reserved-name rejection (key-collision hazard)
# ---------------------------------------------------------------------------


def test_register_sources_reject_reserved_names():
    """dispatch_counts() synthesizes 'total' and 'fleet<N>' keys; a source
    registered under one used to silently corrupt the roll-up (the module
    counter summed into / overwritten by the synthetic key). Both
    registries must refuse them."""
    from automerge_tpu_torch.observability import (register_dispatch_source,
                                             register_health_source)
    for bad in ('total', 'fleet0', 'fleet7', 'fleet123'):
        with pytest.raises(ValueError):
            register_dispatch_source(bad, lambda: 0)
        with pytest.raises(ValueError):
            register_health_source(bad, lambda: 0)
    # non-reserved names that merely CONTAIN a reserved substring are fine
    from automerge_tpu_torch.observability import metrics as obs_metrics
    try:
        register_dispatch_source('total_test_src', lambda: 0)
        register_dispatch_source('fleet_bloom_test', lambda: 0)
        counts = observability.dispatch_counts()
        assert counts['total_test_src'] == 0
        assert counts['fleet_bloom_test'] == 0
        # and the synthetic keys stay intact alongside them
        fleet = DocFleet(doc_capacity=2, key_capacity=2, device='cpu')
        counts = observability.dispatch_counts([fleet])
        assert counts['fleet0'] == fleet.metrics.dispatches
        assert counts['total'] == sum(v for k, v in counts.items()
                                      if k != 'total')
    finally:
        obs_metrics._dispatch_sources.pop('total_test_src', None)
        obs_metrics._dispatch_sources.pop('fleet_bloom_test', None)


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def test_histogram_bucket_boundaries():
    h = Histogram('bytes', scale=1)
    # bucket b holds scaled values in [2^(b-1), 2^b); bucket 0 holds < 1
    assert h.bucket_of(0) == 0
    assert h.bucket_of(1) == 1
    assert h.bucket_of(2) == 2
    assert h.bucket_of(3) == 2
    assert h.bucket_of(4) == 3
    assert h.bucket_of(1023) == 10
    assert h.bucket_of(1024) == 11
    assert h.bucket_bounds(3) == (4.0, 8.0)
    # nanosecond-scaled seconds histograms
    hs = Histogram('lat', scale=1e9)
    assert hs.bucket_of(0.0) == 0
    assert hs.bucket_of(1e-9) == 1
    assert hs.bucket_of(1.0) == 30     # 1e9 ns -> bit_length 30
    lo, hi = hs.bucket_bounds(hs.bucket_of(0.001))
    assert lo <= 0.001 < hi


def test_histogram_record_and_percentiles():
    h = Histogram('lat', scale=1)
    for v in (1, 1, 1, 1, 1, 1, 1, 1, 1, 100):
        h.record(v)
    s = h.summary()
    assert s['count'] == 10 and s['sum'] == 109
    assert s['min'] == 1 and s['max'] == 100
    # p50 falls in bucket 1 (upper bound 2); p99 in 100's bucket (128)
    assert s['p50'] == 2.0
    assert s['p99'] == 128.0


def test_histogram_record_many_matches_scalar_path():
    a = Histogram('a', scale=1e9)
    b = Histogram('b', scale=1e9)
    values = [0.0, 1e-9, 5e-7, 3.2e-4, 0.01, 0.25, 1.5]
    for v in values:
        a.record(v)
    b.record_many(np.asarray(values))
    assert a.counts == b.counts
    assert a.count == b.count
    assert a.vmin == b.vmin and a.vmax == b.vmax


def test_histogram_snapshot_delta():
    h = Histogram('lat', scale=1)
    for v in (1, 2, 4):
        h.record(v)
    snap = h.snapshot()
    assert snap['count'] == 3 and snap['buckets'][1] == 1
    for v in (64, 64, 64):
        h.record(v)
    d = h.delta(snap)
    # the delta distribution is ONLY the three 64s
    assert d['count'] == 3 and d['sum'] == 192
    assert d['p50'] == 128.0 and d['p99'] == 128.0
    assert sum(d['buckets']) == 3 and d['buckets'][7] == 3
    assert 'min' not in d          # min/max are not delta-able


def test_record_value_respects_master_switch():
    obs_hist.reset()
    observability.record_value('gated_metric', 1.0)
    assert 'gated_metric' not in observability.histogram_snapshot()
    observability.enable()
    observability.record_value('gated_metric', 1.0)
    observability.disable()
    assert observability.histogram_snapshot()['gated_metric']['count'] == 1
    obs_hist.reset()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_ring_wraparound_keeps_newest():
    observability.enable(span_capacity=4)
    for i in range(10):
        with observability.span(f's{i}'):
            pass
    spans = observability.iter_spans()
    assert [s['name'] for s in spans] == ['s6', 's7', 's8', 's9']
    assert observability.span_count() == 10
    observability.disable()


def test_wrapped_ring_discloses_truncation():
    """No-silent-caps: a wrapped span ring must disclose the loss — in
    the spans_dropped() count, the health counter, and a synthetic
    marker event inside the Chrome-trace export itself."""
    from automerge_tpu_torch.observability import health_counts
    h0 = health_counts()
    observability.enable(span_capacity=4)
    for i in range(10):
        with observability.span(f's{i}'):
            pass
    assert observability.spans_dropped() == 6
    assert observability.health_delta(h0)['spans_dropped'] == 6
    events = observability.export_chrome_trace()
    marker = [e for e in events if e['ph'] == 'I' and
              e['name'] == 'spans_dropped']
    assert len(marker) == 1
    assert marker[0]['args']['dropped'] == 6
    assert marker[0]['ts'] == events[1]['ts']   # at the window's start
    # an unwrapped ring emits NO marker
    observability.enable(span_capacity=16)
    with observability.span('only'):
        pass
    assert observability.spans_dropped() == 0
    assert not [e for e in observability.export_chrome_trace()
                if e['ph'] == 'I']
    observability.disable()


def test_counts_delta_unions_keys():
    from automerge_tpu_torch.observability import counts_delta
    assert counts_delta({'a': 5, 'b': 2}, {'a': 3}) == {'a': 2, 'b': 2}
    # a source present only in the baseline still reports its movement
    assert counts_delta({}, {'gone': 4}) == {'gone': -4}
    assert counts_delta({}, {}) == {}


def test_spans_balanced_under_exceptions():
    """Every begin has an end even when the block raises; the exception
    type is recorded on the span."""
    observability.enable(span_capacity=16)
    with pytest.raises(ValueError):
        with observability.span('outer'):
            with observability.span('inner', doc=3):
                raise ValueError('boom')
    spans = observability.iter_spans()
    assert [s['name'] for s in spans] == ['inner', 'outer']
    assert all(s['t1_ns'] >= s['t0_ns'] for s in spans)
    assert spans[0]['error'] == 'ValueError'
    assert spans[0]['attrs'] == {'doc': 3}
    assert spans[1]['error'] == 'ValueError'
    observability.disable()


def test_span_seq_tiles_contiguously():
    observability.enable(span_capacity=16)
    ps = observability.span_seq()
    ps.mark('a')
    ps.mark('b')
    ps.mark('c')
    ps.done()
    spans = observability.iter_spans()
    assert [s['name'] for s in spans] == ['a', 'b', 'c']
    # each phase ends exactly where the next begins: no unattributed gap
    assert spans[0]['t1_ns'] == spans[1]['t0_ns']
    assert spans[1]['t1_ns'] == spans[2]['t0_ns']
    observability.disable()


def test_span_off_is_noop_and_cheap():
    assert not obs_spans.on()
    before = observability.span_count()
    with observability.span('never'):
        pass
    assert observability.span_count() == before


def test_export_chrome_trace_format(tmp_path):
    import json
    observability.enable(span_capacity=8)
    with observability.span('phase', docs=2):
        pass
    path = tmp_path / 'trace.json'
    events = observability.export_chrome_trace(str(path))
    assert events and events[-1]['ph'] == 'X'
    assert events[-1]['name'] == 'phase'
    assert events[-1]['dur'] >= 0 and 'ts' in events[-1]
    assert events[-1]['args'] == {'docs': 2}
    on_disk = json.loads(path.read_text())
    assert on_disk['traceEvents'] == events
    observability.disable()


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_ring_and_dump(tmp_path):
    import json
    from automerge_tpu_torch.observability import recorder
    recorder.clear_events()
    recorder.configure(capacity=3)
    for i in range(5):
        observability.record_event('probe', doc=i)
    evs = observability.recent_events()
    assert [e['doc'] for e in evs] == [2, 3, 4]       # bounded ring
    report = observability.dump_flight_record(
        'unit_test', detail={'docs': [4]},
        path=str(tmp_path / 'dump.json'))
    assert report['trigger'] == 'unit_test'
    assert [e['doc'] for e in report['events']] == [2, 3, 4]
    assert observability.last_flight_record() is report
    on_disk = json.loads((tmp_path / 'dump.json').read_text())
    assert on_disk['trigger'] == 'unit_test'
    assert on_disk['detail'] == {'docs': [4]}
    assert 'health' in on_disk
    recorder.configure(capacity=256)
    recorder.clear_events()


def test_dump_carries_recent_spans_without_evicting_events():
    """Span closes must NOT churn the small fault-event ring (a traced
    recovery would otherwise evict the rot/quarantine events the dump
    exists for); instead the dump reads the span ring's tail."""
    from automerge_tpu_torch.observability import recorder
    recorder.clear_events()
    recorder.configure(capacity=4)
    observability.record_event('journal_rot', durable_id=9, at_byte=123)
    observability.enable(span_capacity=64)
    for i in range(32):                       # far past event capacity
        with observability.span(f'phase{i}'):
            pass
    observability.disable()
    evs = observability.recent_events()
    assert [e['kind'] for e in evs] == ['journal_rot']   # not evicted
    report = observability.dump_flight_record('unit_test')
    assert report['events'][0]['kind'] == 'journal_rot'
    assert [s['name'] for s in report['recent_spans']][-1] == 'phase31'
    assert len(report['recent_spans']) <= 64
    recorder.configure(capacity=256)
    recorder.clear_events()
