"""Phase spans inside the bulk load (`bulk_load`: fleet/loader.py) and the
sequence dispatch (`dispatch_seq`: DocFleet._dispatch_seq), the
`seq_migrations` counter, and the program's spans written on the
torch.profiler trace's clock by `observability.trace`."""

import json

import pytest
import torch

from automerge_tpu_torch import backend as host
from automerge_tpu_torch import native, observability
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.fleet import backend as fleet_backend
from automerge_tpu_torch.fleet import load_docs, seq_cases
from automerge_tpu_torch.fleet.backend import DocFleet
from automerge_tpu_torch.observability import spans as obs_spans

torch.set_num_threads(1)

LOAD_PHASES = ('load_probe', 'load_parse', 'load_classify', 'load_engines',
               'load_map_cells', 'load_seq_values', 'load_seq_install',
               'load_fallback')
SEQ_PHASES = ('seq_place', 'seq_pack', 'seq_copy', 'seq_launch')

needs_codec = pytest.mark.skipif(
    not native.available(), reason='the bulk load needs the native codec')


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    observability.disable()


def _saved(changes):
    return bytes(host.save(host.apply_changes(host.init(), changes)[0]))


def _map_doc():
    return _saved([encode_change({
        'actor': 'aa' * 16, 'seq': 1, 'startOp': 1, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': k, 'value': i,
                 'datatype': 'int', 'pred': []}
                for i, k in enumerate('xyz')]})])


def _text_doc(seed, n_ops=60):
    return _saved(seq_cases.text_changes(n_ops, seed=seed)[0])


def _inside(spans, outer, names):
    """The spans named in `names` that lie inside the span `outer`."""
    return [s for s in spans if s['name'] in names and
            outer['t0_ns'] <= s['t0_ns'] and s['t1_ns'] <= outer['t1_ns']]


def _assert_tiled(phases):
    for a, b in zip(phases, phases[1:]):
        assert a['t1_ns'] == b['t0_ns']


def _load(fleet):
    bufs = [_text_doc(0), _text_doc(1), _text_doc(2), _map_doc()]
    return load_docs(bufs, fleet)


@needs_codec
def test_load_phases_tile_bulk_load():
    observability.enable(span_capacity=1024)
    _load(DocFleet(device='cpu'))
    spans = observability.iter_spans()
    (bulk,) = [s for s in spans if s['name'] == 'bulk_load']
    phases = _inside(spans, bulk, LOAD_PHASES)
    assert tuple(p['name'] for p in phases) == LOAD_PHASES
    _assert_tiled(phases)
    attrs = {p['name']: p.get('attrs', {}) for p in phases}
    assert attrs['load_probe'] == {'docs': 4}
    assert attrs['load_parse'] == {'docs': 4}
    assert attrs['load_engines'] == {'docs': 4}
    assert attrs['load_fallback'] == {'docs': 0}
    assert attrs['load_classify']['rows'] > 0
    # the copy sites: the map cells' one copy, the text rows' one a class
    assert attrs['load_map_cells']['bytes'] > 0
    assert attrs['load_seq_install']['bytes'] > 0
    assert attrs['load_seq_values']['rows'] == \
        attrs['load_seq_install']['rows'] > 0
    # the native parse stays nested in its phase
    (parse,) = [p for p in phases if p['name'] == 'load_parse']
    assert _inside(spans, parse, ('native_doc_parse',))


def _seq_fleet():
    """Two Text docs on the CPU: the first takes a batch that moves its
    row up a size class, the second one that does not."""
    first = [seq_cases.text_changes(40, more=(160,), seed=0),
             seq_cases.text_changes(40, more=(4,), seed=1)]
    fleet = DocFleet(device='cpu')
    handles = fleet_backend.init_docs(2, fleet)
    handles, _ = fleet_backend.apply_changes_docs(
        handles, [b[0] for b in first], mirror=False)
    return fleet, handles, [b[1] for b in first]


def _classes(fleet):
    return {row: place[0] for row, place in enumerate(fleet.seq_place)
            if place is not None}


def test_seq_dispatch_phases_and_migrations():
    fleet, handles, batch = _seq_fleet()
    before = _classes(fleet)
    m0 = fleet.metrics.snapshot()
    observability.enable(span_capacity=1024)
    fleet_backend.apply_changes_docs(handles, batch, mirror=False)
    spans = observability.iter_spans()
    after = _classes(fleet)
    moved = sum(after[r] != c for r, c in before.items())
    assert moved == 1
    assert fleet.metrics.delta(m0)['seq_migrations'] == moved
    (disp,) = [s for s in spans if s['name'] == 'dispatch_seq']
    phases = _inside(spans, disp, SEQ_PHASES)
    n_cls = len(set(after.values()))
    assert n_cls == 2
    assert [p['name'] for p in phases] == \
        ['seq_place'] + list(SEQ_PHASES[1:]) * n_cls
    _assert_tiled(phases)
    assert phases[0]['attrs']['migrated'] == moved
    copies = [p for p in phases if p['name'] == 'seq_copy']
    assert all(p['attrs']['bytes'] > 0 for p in copies)
    # the batch's rows come one run a doc: packed with no sort
    packs = [p for p in phases if p['name'] == 'seq_pack']
    assert [p['attrs']['sorted'] for p in packs] == [0] * n_cls
    assert sum(p['attrs']['rows'] for p in packs) == 2
    d = fleet.metrics.delta(m0)
    assert (d['seq_pack_grouped'], d['seq_pack_sorted']) == (1, 0)


@needs_codec
def test_spans_off_leave_the_ring_empty():
    observability.enable(span_capacity=1024)
    observability.disable()
    _load(DocFleet(device='cpu'))
    fleet, handles, batch = _seq_fleet()
    m0 = fleet.metrics.snapshot()
    fleet_backend.apply_changes_docs(handles, batch, mirror=False)
    assert observability.iter_spans() == []
    # the counter counts with the spans off
    assert fleet.metrics.delta(m0)['seq_migrations'] == 1


def test_trace_writes_spans_around_the_profiler_ranges(tmp_path):
    import time
    with observability.trace(str(tmp_path)):
        with observability.span('outer'):
            time.sleep(0.005)
            with torch.profiler.record_function('inner'):
                time.sleep(0.001)
            time.sleep(0.005)
    assert not obs_spans.on()          # off again, as it was found
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    (outer,) = [e for e in events if e.get('name') == 'outer']
    (inner,) = [e for e in events if e.get('name') == 'inner']
    assert outer['ph'] == inner['ph'] == 'X'
    assert outer['ts'] < inner['ts']
    assert inner['ts'] + inner['dur'] < outer['ts'] + outer['dur']


def test_profiler_clock_map_follows_the_wall_clock():
    import time
    w0 = time.time_ns()
    observability.enable(span_capacity=8)
    with observability.span('s'):
        pass
    (rec,) = observability.iter_spans()
    w1 = time.time_ns()
    t0 = obs_spans.profiler_ns(rec['t0_ns'])
    assert w0 <= t0 <= obs_spans.profiler_ns(rec['t1_ns']) <= w1
    (ev,) = observability.export_chrome_trace(profiler_base_ns=w0)
    # the export read the anchor again; the map now uses that reading
    t0 = obs_spans.profiler_ns(rec['t0_ns'])
    assert ev['ts'] == (t0 - w0) / 1000.0
    # the default stays on the perf counter's clock
    (raw,) = observability.export_chrome_trace()
    assert raw['ts'] == rec['t0_ns'] / 1000.0
