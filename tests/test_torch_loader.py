"""Differential tests of the bulk loader (fleet/loader.py), the parked
form (`park_docs`) and `rebuild_docs`: the same saved bytes and change
bytes go through the JAX package's DocFleet and the torch port's
(device='cpu'), in both device modes, and the results must agree
exactly: materialize_docs, save() bytes, get_patch(), heads, the
metrics counters, the LWW grids on their real key columns, the register
arrays on every doc not flagged inexact (and the inexact flags), and
every array of every size-class pool with the rows' bookkeeping.

The shapes are those of the reference's tests/test_loader.py
TestBulkLoad (its fuzz differential at its own small size),
tests/test_fleet_backend.py TestFleetRebuild and TestParkDocs, and
tests/test_columnar_commit.py TestParkedColumnarCommit. Documents are
made with the reference's frontend (the port has none yet) and enter
both packages as the same bytes; chunks saved by either package load in
the other."""

import datetime
import random

import numpy as np
import pytest
import torch

import automerge_tpu as A
import automerge_tpu.native as jax_native
from automerge_tpu import backend as jax_host
from automerge_tpu.columnar import decode_change, encode_change
from automerge_tpu.fleet import backend as jb
from automerge_tpu.fleet.loader import load_docs as jax_load_docs
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch import backend as torch_host
from automerge_tpu_torch import observability
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import load_docs as torch_load_docs
from automerge_tpu_torch.fleet import seq_cases
from automerge_tpu_torch.fleet.registers import register_state_to_numpy
from automerge_tpu_torch.fleet.sequence import seq_state_to_numpy
from automerge_tpu_torch.fleet.tensor_doc import state_to_numpy

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


_NATIVE_OK = torch_native.available() and jax_native.available()

pytestmark = pytest.mark.skipif(
    not _NATIVE_OK, reason='a native codec is unavailable (the bulk load '
    'and the reference comparison need both)')

A1, A2, A3 = '01' * 8, '89' * 8, 'fe' * 8
ACTORS = ['aa' * 16, 'bb' * 16]
MODES = [False, True]

# each package's fleet backend, host backend and loader
JAX = (jb, jax_host, jax_load_docs)
TORCH = (tb, torch_host, torch_load_docs)


def _fleet(be, exact, **kw):
    kw.setdefault('doc_capacity', 4)
    kw.setdefault('key_capacity', 8)
    if be is tb:
        kw['device'] = 'cpu'
    return be.DocFleet(exact_device=exact, **kw)


def _metrics(fleet):
    m = fleet.metrics
    return (m.dispatches, m.fallbacks, m.promotions, m.turbo_calls,
            m.remaps, m.mirror_rebuilds, m.docs_bulk_loaded,
            m.doc_materializations)


def _assert_same(jf, jh, tf, th):
    """Both fleets' documents and device state agree (see the module
    docstring)."""
    assert tb.materialize_docs(th) == jb.materialize_docs(jh)
    for a, b in zip(jh, th):
        assert tb.get_heads(b) == jb.get_heads(a)
        assert tb.get_patch(b) == jb.get_patch(a)
        assert bytes(tb.save(b)) == bytes(jb.save(a))
    assert _metrics(tf) == _metrics(jf)
    assert (tf.state is None) == (jf.state is None)
    if jf.state is not None:
        k = jf.key_cap
        for name, x, y in zip(('winners', 'values', 'counters'),
                              jf.state.tree_flatten()[0],
                              state_to_numpy(tf.state)):
            np.testing.assert_array_equal(y[:, :k], np.asarray(x)[:, :k],
                                          err_msg=name)
    assert (tf.reg_state is None) == (jf.reg_state is None)
    if jf.reg_state is not None:
        assert tf.inexact_slots() == jf.inexact_slots()
        assert tf.conflicts_all() == jf.conflicts_all()
        want = [np.asarray(x) for x in jf.reg_state.tree_flatten()[0]]
        got = register_state_to_numpy(tf.reg_state)
        exact_rows = ~want[4]
        np.testing.assert_array_equal(got[4], want[4], err_msg='inexact')
        for name, x, y in zip(('reg', 'killed', 'value', 'counter'),
                              want[:4], got[:4]):
            np.testing.assert_array_equal(y[exact_rows], x[exact_rows],
                                          err_msg=name)
    assert tf.seq_rows == jf.seq_rows
    assert tf.seq_place == jf.seq_place and tf.seq_len == jf.seq_len
    tp, jp = tf.seq_pools, jf.seq_pools
    assert (tp.free, tp.used, tp.grow_events) == \
        (jp.free, jp.used, jp.grow_events)
    assert sorted(tp.pools) == sorted(jp.pools)
    for cls in jp.pools:
        for name, x, y in zip(seq_cases.NAMES,
                              jp.pools[cls].tree_flatten()[0],
                              seq_state_to_numpy(tp.pools[cls])):
            np.testing.assert_array_equal(y, np.asarray(x),
                                          err_msg=f'class {cls} {name}')


def _both(scenario, exact, **kw):
    """Run `scenario(pkg, fleet)` (-> handles) on both packages, compare,
    and return the port's fleet and handles."""
    jf, tf = _fleet(jb, exact, **kw), _fleet(tb, exact, **kw)
    jh, th = scenario(JAX, jf), scenario(TORCH, tf)
    _assert_same(jf, jh, tf, th)
    assert tf.device.type == 'cpu'
    return tf, th


def change_buf(actor, seq, start_op, ops, deps=()):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': sorted(deps), 'ops': ops})


def _set(key, value, pred=()):
    return {'action': 'set', 'obj': '_root', 'key': key, 'value': value,
            'datatype': 'int', 'pred': list(pred)}


def _corpus():
    """Saved documents covering the loadable shapes (the reference's
    TestBulkLoad corpus): values of every datatype, counters with incs,
    nested maps and tables, text and list editing, concurrent merges with
    conflicts, deletes, multi-actor histories, an empty document."""
    docs = []
    d = A.from_({'x': 1, 's': 'hello', 'c': A.Counter(10), 'f': 2.5,
                 'ok': True, 'n': None, 'u': A.Uint(3),
                 'when': A.Int(1589032171000)}, A1)
    docs.append(A.change(d, lambda r: r['c'].increment(7)))
    d = A.from_({'cfg': {'a': {'deep': 'yes'}, 'b': 2}}, A1)
    docs.append(A.change(d, lambda r: r['cfg'].__setitem__('b', 9)))
    d = A.from_({'t': A.Text('hello world')}, A1)
    d = A.change(d, lambda r: r['t'].delete_at(0))
    docs.append(A.change(d, lambda r: r['t'].insert_at(0, 'H')))
    d = A.from_({'l': [1, 2, 3, 'four']}, A1)
    d = A.change(d, lambda r: r['l'].__setitem__(1, 20))
    docs.append(A.change(d, lambda r: r['l'].delete_at(0)))
    b1 = A.from_({'k': 'one', 'shared': 0}, A1)
    b2 = A.merge(A.init(A2), b1)
    b1 = A.change(b1, lambda r: r.__setitem__('k', 'from-a'))
    b2 = A.change(b2, lambda r: r.__setitem__('k', 'from-b'))
    docs.append(A.merge(b1, b2))
    t1 = A.from_({'t': A.Text('base')}, A1)
    t2 = A.merge(A.init(A2), t1)
    t3 = A.merge(A.init(A3), t1)
    t1 = A.change(t1, lambda r: r['t'].insert_at(0, 'X'))
    t2 = A.change(t2, lambda r: r['t'].set(1, 'A'))
    t3 = A.change(t3, lambda r: r['t'].delete_at(2))
    docs.append(A.merge(A.merge(t1, t2), t3))
    d = A.from_({'gone': 1, 'kept': 2}, A1)
    d = A.change(d, lambda r: r.__delitem__('gone'))
    docs.append(A.change(d, lambda r: r.__setitem__('kept', 3)))
    docs.append(A.init(A1))
    d = A.from_({'tbl': A.Table()}, A1)
    docs.append(A.change(d, lambda r: r['tbl'].add({'name': 'wren',
                                                    'n': 1})))
    return [bytes(A.save(d)) for d in docs]


CORPUS = _corpus()


def _loaded(bufs, lazy=True):
    """Load `bufs` (all through the bulk path); with `lazy`, the first
    read decodes no doc's history."""
    def scenario(pkg, fleet):
        be, _host, load_docs = pkg
        handles = load_docs(bufs, fleet)
        assert fleet.metrics.docs_bulk_loaded == len(bufs)
        if lazy:
            be.materialize_docs(handles)
            assert fleet.metrics.doc_materializations == 0
        return handles
    return scenario


# ---- TestBulkLoad ----------------------------------------------------------

MAP_DOCS = [0, 1, 4, 6, 7, 8]       # CORPUS indices without Text or lists
TEXT_DOCS = [2]                     # one Text
SEQ_DOCS = [3, 5]                   # a list, a Text edited concurrently


def _corpus_loads(docs, exact):
    bufs = [CORPUS[i] for i in docs]
    tf, th = _both(_loaded(bufs), exact)
    # the loaded docs read as a host load of the same bytes
    for h, buf in zip(th, bufs):
        assert tb.get_patch(h) == torch_host.get_patch(torch_host.load(buf))
    if exact:
        assert tf.metrics.mirror_rebuilds == 0
        assert tf.metrics.doc_materializations == 0


def test_map_corpus_loads_like_reference():
    _corpus_loads(MAP_DOCS, False)


def test_map_corpus_loads_like_reference_exact():
    _corpus_loads(MAP_DOCS, True)


def test_text_corpus_loads_like_reference():
    _corpus_loads(TEXT_DOCS, False)


def test_text_corpus_loads_like_reference_exact():
    _corpus_loads(TEXT_DOCS, True)


def test_seq_corpus_loads_like_reference():
    _corpus_loads(SEQ_DOCS, False)


def test_seq_corpus_loads_like_reference_exact():
    _corpus_loads(SEQ_DOCS, True)


def test_save_verbatim_until_edit():
    tf = _fleet(tb, True)
    handles = torch_load_docs(CORPUS, tf)
    for h, buf in zip(handles, CORPUS):
        assert bytes(tb.save(h)) == buf
    assert tf.metrics.doc_materializations == 0


def _edit_after_load(exact):
    """A change on top of the loaded state: reads, saves (re-encoded
    canonically) and device state agree, and the port's save equals the
    host engine's."""
    buf = bytes(A.save(A.from_({'x': 1, 'c': A.Counter(5)}, A1)))
    d2 = A.change(A.load(buf), lambda r: (r.__setitem__('x', 2),
                                          r['c'].increment(3)))
    change = A.get_last_local_change(d2)

    def scenario(pkg, fleet):
        be, _host, load_docs = pkg
        handle = load_docs([buf], fleet)[0]
        handle, _patch = be.apply_changes(handle, [change])
        return [handle]
    tf, th = _both(scenario, exact)
    assert tb.materialize_docs(th) == [{'x': 2, 'c': 8}]
    host, _ = torch_host.apply_changes(torch_host.load(buf), [change])
    assert bytes(tb.save(th[0])) == bytes(torch_host.save(host))


def test_edit_after_load():
    _edit_after_load(False)


def test_edit_after_load_exact():
    _edit_after_load(True)


def test_sync_after_load_materializes_lazily():
    """Sync needs the change history: the parked chunk materializes once,
    and the round converges against a host peer in both packages, with
    the same messages."""
    buf = bytes(A.save(A.from_({'x': 1, 't': A.Text('ab')}, A1)))
    sent = {}
    for name, (be, host, load_docs) in (('jax', JAX), ('torch', TORCH)):
        fleet = _fleet(be, False, doc_capacity=2)
        handle = load_docs([buf], fleet)[0]
        peer = host.init()
        s1, s2 = host.init_sync_state(), host.init_sync_state()
        msgs = []
        for _ in range(10):
            s1, msg = be.generate_sync_message(handle, s1)
            if msg is not None:
                peer, s2, _ = host.receive_sync_message(peer, s2, msg)
            s2, msg2 = host.generate_sync_message(peer, s2)
            if msg2 is not None:
                handle, s1, _ = be.receive_sync_message(handle, s1, msg2)
            msgs.append((msg, msg2))
            if msg is None and msg2 is None:
                break
        assert host.get_heads(peer) == be.get_heads(handle)
        assert fleet.metrics.doc_materializations == 1
        sent[name] = msgs
    assert sent['torch'] == sent['jax']


def test_counter_in_list_falls_back_to_mirror():
    d = A.from_({'l': [A.Counter(10)]}, A1)
    d = A.change(d, lambda r: r['l'][0].increment(5))
    tf, th = _both(_loaded([bytes(A.save(d))], lazy=False), False,
                   doc_capacity=2)
    assert tb.materialize_docs(th) == [{'l': [15]}]


def test_fallback_paths_still_load():
    """Raw change chunks take the per-doc path; an object inside a list
    takes the bulk path."""
    nested = bytes(A.save(A.from_({'l': [{'obj': 'in-list'}]}, A1)))
    raw = b''.join(A.get_all_changes(A.from_({'x': 1}, A1)))

    def scenario(pkg, fleet):
        return pkg[2]([nested, raw], fleet)
    tf, th = _both(scenario, False)
    assert tb.materialize_docs(th) == [{'l': [{'obj': 'in-list'}]},
                                       {'x': 1}]
    assert tf.metrics.docs_bulk_loaded == 1


def test_heads_clock_graph_match_reference():
    jf, tf = _fleet(jb, False), _fleet(tb, False)
    jh, th = jax_load_docs(CORPUS, jf), torch_load_docs(CORPUS, tf)
    for a, b, buf in zip(jh, th, CORPUS):
        host = torch_host.load(buf)
        assert tb.get_heads(b) == jb.get_heads(a) == \
            torch_host.get_heads(host)
        assert b['state'].clock == a['state'].clock == host['state'].clock
        assert b['state'].max_op == a['state'].max_op
        assert sorted(tb.get_missing_deps(b)) == \
            sorted(jb.get_missing_deps(a))
        assert [bytes(c) for c in tb.get_all_changes(b)] == \
            [bytes(c) for c in jb.get_all_changes(a)] == \
            [bytes(c) for c in torch_host.get_all_changes(host)]


def _empty_sequence_stays_device_resident(exact):
    buf = bytes(A.save(A.from_({'t': A.Text(), 'l': [], 'x': 1}, A1)))
    tf, th = _both(_loaded([buf]), exact, doc_capacity=2)
    assert tb.materialize_docs(th) == [{'t': '', 'l': [], 'x': 1}]


def _objects_inside_lists_bulk_load(exact):
    d = A.init(A1)
    d = A.change(d, lambda r: r.update(
        {'todo': [{'t': 'wash', 'n': 1}, [1, 2], A.Text('hi')], 'k': 9}))
    d = A.change(d, lambda r: r['todo'][0].update({'n': 2}))
    d = A.change(d, lambda r: r['todo'][1].append(3))
    d = A.change(d, lambda r: r['todo'].delete_at(2))
    buf = bytes(A.save(d))
    tf, th = _both(_loaded([buf, buf]), exact, key_capacity=16)
    want = {'todo': [{'t': 'wash', 'n': 2}, [1, 2, 3]], 'k': 9}
    assert tb.materialize_docs(th) == [want, want]


def test_objects_inside_lists_bulk_load():
    _objects_inside_lists_bulk_load(False)


def test_objects_inside_lists_bulk_load_exact():
    _objects_inside_lists_bulk_load(True)


def test_empty_sequence_stays_device_resident():
    _empty_sequence_stays_device_resident(False)


def test_empty_sequence_stays_device_resident_exact():
    _empty_sequence_stays_device_resident(True)


def test_get_patch_stays_lazy_in_exact_mode():
    d = A.from_({'x': 1, 'c': A.Counter(2)}, A1)
    buf = bytes(A.save(A.change(d, lambda r: r['c'].increment(3))))
    tf, th = _both(_loaded([buf]), True, doc_capacity=2)
    assert tf.metrics.doc_materializations == 0
    assert tf.metrics.mirror_rebuilds == 0


def test_overflow_doc_does_not_corrupt_batch_peers():
    """A doc whose op counters pass the packing window falls back alone;
    a peer doc's deleted key must stay deleted."""
    from automerge_tpu.columnar import decode_change_meta
    from automerge_tpu.backend.op_set import OpSet
    big = OpSet()
    c1 = change_buf(A1, 1, 1, [{'action': 'set', 'obj': '_root',
                                'key': 'k', 'value': 1,
                                'datatype': 'counter', 'pred': []}])
    h1 = decode_change_meta(c1, True)['hash']
    c2 = change_buf(A1, 2, (1 << 24) + 5, [{
        'action': 'inc', 'obj': '_root', 'key': 'k', 'value': 99,
        'pred': [f'1@{A1}']}], deps=[h1])
    big.apply_changes([c1, c2])
    deleted = OpSet()
    d1 = change_buf(A1, 1, 1, [_set('x', 7)])
    g1 = decode_change_meta(d1, True)['hash']
    d2 = change_buf(A1, 2, 5, [{'action': 'del', 'obj': '_root', 'key': 'x',
                                'pred': [f'1@{A1}']}], deps=[g1])
    deleted.apply_changes([d1, d2])

    def scenario(pkg, fleet):
        return pkg[2]([bytes(big.save()), bytes(deleted.save())], fleet)
    tf, th = _both(scenario, False)
    assert tb.materialize_docs(th) == [{'k': 100}, {}]
    assert tf.metrics.docs_bulk_loaded == 1


def _fuzz_corpus(trials=6, steps=12, seed=7):
    """The reference's fuzz differential: random two-actor editing
    histories over a text, a map and a register, merged and saved."""
    rng = random.Random(seed)
    bufs, expects = [], []
    for _trial in range(trials):
        base = A.from_({'t': A.Text('seed'), 'm': {}, 'k': 0}, A1)
        replicas = [base, A.merge(A.init(A2), base)]
        for _step in range(steps):
            i = rng.randrange(2)

            def edit(r, rng=rng):
                roll = rng.random()
                t = r['t']
                if roll < 0.3 and len(t):
                    t.delete_at(rng.randrange(len(t)))
                elif roll < 0.5:
                    t.insert_at(rng.randrange(len(t) + 1),
                                rng.choice('abcdefghij'))
                elif roll < 0.7 and len(t):
                    t.set(rng.randrange(len(t)),
                          rng.choice('abcdefghij').upper())
                elif roll < 0.85:
                    r['m'][rng.choice('abcdefghij')] = rng.randrange(100)
                else:
                    r['k'] = rng.randrange(1000)
            replicas[i] = A.change(replicas[i], edit)
            if rng.random() < 0.3:
                a, b = rng.sample(range(2), 2)
                replicas[a] = A.merge(replicas[a], replicas[b])
        final = A.merge(A.clone(replicas[0]), replicas[1])
        bufs.append(bytes(A.save(final)))
        expects.append(dict(final))
    return bufs, expects


FUZZ = _fuzz_corpus()


def _fuzz_differential(exact):
    bufs, expects = FUZZ
    tf, th = _both(_loaded(bufs), exact, doc_capacity=8, key_capacity=16)
    assert tb.materialize_docs(th) == expects


def _chunks_load_across_packages(exact):
    """A chunk saved by either package loads in the other: the JAX fleet
    saves after an edit (a canonical re-encode), the port loads it, and
    the reverse; reads, saves and patches agree with a load in the
    package that saved it."""
    buf = CORPUS[0]
    change = A.get_last_local_change(A.change(
        A.load(buf), lambda r: r.__setitem__('x', 5)))
    saved = {}
    for name, (be, _host, load_docs) in (('jax', JAX), ('torch', TORCH)):
        fleet = _fleet(be, exact)
        handle = load_docs([buf], fleet)[0]
        handle, _ = be.apply_changes(handle, [change])
        saved[name] = bytes(be.save(handle))
    assert saved['torch'] == saved['jax']
    for src, (be, _host, load_docs), (ob, _oh, other_load) in (
            ('jax', TORCH, JAX), ('torch', JAX, TORCH)):
        here = load_docs([saved[src]], _fleet(be, exact))[0]
        there = other_load([saved[src]], _fleet(ob, exact))[0]
        assert be.materialize_docs([here]) == ob.materialize_docs([there])
        assert bytes(be.save(here)) == bytes(ob.save(there)) == saved[src]
        assert be.get_patch(here) == ob.get_patch(there)


def _text_trace_loads_then_takes_a_batch(exact):
    """The text seam's trace (fleet/seq_cases.py) at a small size: saved
    after its first two batches, loaded into 2 docs, then the third batch
    applies to every loaded row through the sequence scan."""
    batches = seq_cases.text_changes(300, more=(40, 40))
    host = torch_host.init()
    for batch in batches[:2]:
        host, _ = torch_host.apply_changes(host, batch)
    buf = bytes(torch_host.save(host))

    def scenario(pkg, fleet):
        be, _host, load_docs = pkg
        handles = load_docs([buf] * 2, fleet)
        assert fleet.metrics.docs_bulk_loaded == 2
        handles, _ = be.apply_changes_docs(handles, [batches[2]] * 2,
                                           mirror=False)
        return handles
    tf, th = _both(scenario, exact)
    host, _ = torch_host.apply_changes(host, batches[2])
    want = torch_host.get_patch(host)
    assert [tb.get_patch(h) for h in th] == [want] * 2


def test_text_trace_loads_then_takes_a_batch():
    _text_trace_loads_then_takes_a_batch(False)


def test_text_trace_loads_then_takes_a_batch_exact():
    _text_trace_loads_then_takes_a_batch(True)


def test_chunks_load_across_packages():
    _chunks_load_across_packages(False)


def test_chunks_load_across_packages_exact():
    _chunks_load_across_packages(True)


def test_fuzz_differential():
    _fuzz_differential(False)


def test_fuzz_differential_exact():
    _fuzz_differential(True)


# ---- the sequence value lanes: inline columns, boxed rows in order --------

# one list of every value shape: (value, sits inline in a list lane)
MIXED_LIST = [
    (1, True), (2 ** 31, False), (7, True), (2 ** 40, False), (-3, False),
    ('a', False), ('bb', False), ('a', False), (2.5, False), (True, False),
    (None, False), (A.Int(2 ** 33), False), (A.Uint(7), False),
    (datetime.datetime(2020, 5, 9, tzinfo=datetime.timezone.utc), False),
    (A.Counter(3), False), ({'m': 1}, False), ([4, 5], False),
    (A.Text('hi'), False), (0, True)]


def _mixed_list_doc():
    """The list above (its nested list and Text hold inline rows only),
    then an inc of its counter."""
    d = A.from_({'l': [v for v, _ in MIXED_LIST]}, A1)
    at = [i for i, (v, _) in enumerate(MIXED_LIST)
          if isinstance(v, A.Counter)][0]
    return bytes(A.save(A.change(d, lambda r: r['l'][at].increment(2))))


def _saved(changes):
    return bytes(torch_host.save(torch_host.apply_changes(
        torch_host.init(), changes)[0]))


def _mixed_text_doc():
    """A Text of 'a', a map element, the string 'xyz' as one element and
    'b': the map and 'xyz' cannot sit in a Text lane."""
    ins = dict(obj=f'1@{A1}', insert=True, pred=[])
    return _saved([change_buf(A1, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        dict(ins, action='set', elemId='_head', value='a'),
        dict(ins, action='makeMap', elemId=f'2@{A1}'),
        {'action': 'set', 'obj': f'3@{A1}', 'key': 'k', 'value': 1,
         'datatype': 'int', 'pred': []},
        dict(ins, action='set', elemId=f'3@{A1}', value='xyz'),
        dict(ins, action='set', elemId=f'5@{A1}', value='b')])])


def _plain_text_doc():
    d = A.from_({'t': A.Text('plaintext')}, A1)
    return bytes(A.save(A.change(d, lambda r: r['t'].insert_at(5, '-'))))


# the rows of one load of both mixed docs that take the per-row path: the
# list's elements that cannot sit inline, the Text's map and 'xyz'
MIXED_BOXED = sum(not inline for _, inline in MIXED_LIST) + 2


def _entry(boxed):
    """A value-table entry by its class name and repr (the packages'
    link and typed classes are their own)."""
    return type(boxed).__name__, repr(boxed)


def _boxed(bufs, fleet):
    """The port's bulk load of `bufs` with spans on; returns the handles
    and the `boxed=` count of its `load_seq_values` phase."""
    observability.enable(span_capacity=1024)
    try:
        handles = torch_load_docs(bufs, fleet)
        (phase,) = [s for s in observability.iter_spans()
                    if s['name'] == 'load_seq_values']
    finally:
        observability.disable()
    return handles, phase['attrs']['boxed']


@pytest.mark.parametrize('exact', MODES)
def test_boxed_seq_values_keep_their_order(exact):
    """Inline and boxed elements interleaved in one list, a Text holding
    an object and a multi-character element, and a plain Text, in one
    load: device pools, value table and reads equal the reference's, and
    only the rows that cannot sit inline take the per-row path."""
    bufs = [_mixed_list_doc(), _mixed_text_doc(), _plain_text_doc()]
    seen = {}

    def scenario(pkg, fleet):
        if pkg is TORCH:
            handles, seen['boxed'] = _boxed(bufs, fleet)
        else:
            handles = pkg[2](bufs, fleet)
        assert fleet.metrics.docs_bulk_loaded == 3
        scenario.tables.append(fleet.value_table)
        return handles
    scenario.tables = []
    tf, th = _both(scenario, exact)
    jt, tt = scenario.tables
    assert [_entry(x) for x in tt] == [_entry(x) for x in jt]
    assert seen['boxed'] == MIXED_BOXED
    assert _boxed([bufs[2]], _fleet(tb, exact))[1] == 0
    reads = tb.materialize_docs(th)
    assert reads[0]['l'][:3] == [1, 2 ** 31, 7]
    assert reads[2] == {'t': 'plain-text'}


def _old_lane_values(fleet, out, rows, txt, doc, slot_of, oid_str,
                     obj_type, inc_mask, make_mask, vtype, val_int, rid):
    """The sequence value lanes as the loader computed them row by row
    before its column pass, kept frozen here as the replay's reference."""
    from automerge_tpu_torch.columnar import decode_value
    from automerge_tpu_torch.fleet.loader import _TYPE_NAMES
    values = np.zeros(len(rows), dtype=np.int64)
    flag_counter = np.zeros(len(rows), dtype=bool)
    for i, j in enumerate(rows):
        jj = int(j)
        if inc_mask[jj]:
            continue
        if make_mask[jj]:
            values[i] = fleet._make_link_value(
                int(slot_of[int(doc[jj])]), oid_str[int(rid[jj])],
                _TYPE_NAMES[obj_type[int(rid[jj])]])
            if txt[i]:
                flag_counter[i] = True
            continue
        vt, vi = int(vtype[jj]), int(val_int[jj])
        if txt[i] and vt == 6 and vi >= 0:
            values[i] = vi
            continue
        elif not txt[i] and vt == 4 and 0 <= vi < (1 << 31):
            values[i] = vi
            continue
        off, ln = int(out['val_off'][jj]), int(out['val_len'][jj])
        decoded = decode_value((ln << 4) | vt, out['val_blob'][off:off + ln])
        dt = decoded.get('datatype')
        if isinstance(dt, str) and dt != 'int':
            values[i] = fleet._intern_typed(decoded['value'], dt)
        else:
            values[i] = fleet._intern_value_boxed(decoded['value'])
    return values, flag_counter


class _InternLog:
    """A fleet stand-in that logs every intern and link call in order and
    answers each with a value ref of its own."""

    def __init__(self):
        self.calls = []

    def _ref(self, *call):
        self.calls.append(call)
        return -(len(self.calls) + 1)

    def _make_link_value(self, slot, oid, type_name):
        return self._ref('link', slot, oid, type_name)

    def _intern_typed(self, value, datatype):
        return self._ref('typed', type(value), value, datatype)

    def _intern_value_boxed(self, value):
        return self._ref('boxed', type(value), value)


def test_seq_lane_values_replay_the_row_loop(monkeypatch):
    """The column pass against the frozen row loop, over the columns of
    a bulk load of the fuzz corpus, the corpus and the mixed docs: equal
    values and flags, and the same intern calls in the same order."""
    from automerge_tpu_torch.fleet import loader
    from automerge_tpu_torch.observability.spans import span_seq
    real, captured = loader._seq_lane_values, []

    def capture(fleet, out, rows, txt, *cols):
        captured.append((out, rows.copy(), txt.copy(),
                         [c.copy() if isinstance(c, np.ndarray) else c
                          for c in cols[:-1]]))
        return real(fleet, out, rows, txt, *cols)
    monkeypatch.setattr(loader, '_seq_lane_values', capture)
    bufs = FUZZ[0] + CORPUS + [_mixed_list_doc(), _mixed_text_doc()]
    torch_load_docs(bufs, _fleet(tb, False, doc_capacity=32,
                                 key_capacity=32))
    (args,) = captured
    out, rows, txt, cols = args
    new_log, old_log = _InternLog(), _InternLog()
    new = real(new_log, out, rows, txt, *cols, span_seq())
    old = _old_lane_values(old_log, out, rows, txt, *cols)
    np.testing.assert_array_equal(new[0], old[0])
    np.testing.assert_array_equal(new[1], old[1])
    assert new_log.calls == old_log.calls
    assert len(new_log.calls) >= MIXED_BOXED and new[1].any()
    assert (new[0] >= 0).sum() > len(new_log.calls)


# ---- TestFleetRebuild ------------------------------------------------------

def _two_change_docs(n, actor=ACTORS[0]):
    per_doc = []
    for d in range(n):
        c1 = change_buf(actor, 1, 1, [_set('k', d)])
        h1 = decode_change(c1)['hash']
        c2 = change_buf(actor, 2, 2, [{
            'action': 'set', 'obj': '_root', 'key': 's',
            'value': 'x' * (d + 1), 'pred': []}], deps=[h1])
        per_doc.append([c1, c2])
    return per_doc


def _rebuild_from_logs(exact):
    per_doc = _two_change_docs(3)

    def scenario(pkg, fleet):
        be = pkg[0]
        handles, _ = be.apply_changes_docs(be.init_docs(3, fleet), per_doc,
                                           mirror=False)
        want = be.materialize_docs(handles)
        heads = [h['heads'] for h in handles]
        fresh = _fleet(be, exact)
        rebuilt = be.rebuild_docs(handles, fresh)
        assert all(h['frozen'] for h in handles)
        assert [h['heads'] for h in rebuilt] == heads
        assert be.materialize_docs(rebuilt) == want
        c3 = change_buf(ACTORS[0], 3, 3, [_set('k', 99, [f'1@{ACTORS[0]}'])],
                        deps=heads[0])
        rebuilt, _ = be.apply_changes_docs(rebuilt, [[c3], [], []],
                                           mirror=False)
        assert be.materialize_docs(rebuilt)[0]['k'] == 99
        scenario.fleets.append(fresh)
        return rebuilt
    scenario.fleets = []
    jh = scenario(JAX, _fleet(jb, exact))
    th = scenario(TORCH, _fleet(tb, exact))
    _assert_same(scenario.fleets[0], jh, scenario.fleets[1], th)


def test_rebuild_from_logs():
    _rebuild_from_logs(False)


def test_rebuild_from_logs_exact():
    _rebuild_from_logs(True)


def test_rebuild_requeues_held_back_changes():
    c1 = change_buf(ACTORS[0], 1, 1, [_set('a', 1)])
    h1 = decode_change(c1)['hash']
    c2 = change_buf(ACTORS[0], 2, 2, [_set('b', 2)], deps=[h1])
    h2 = decode_change(c2)['hash']
    c3 = change_buf(ACTORS[0], 3, 3, [_set('c', 3)], deps=[h2])
    got = {}
    for name, (be, _host, _load) in (('jax', JAX), ('torch', TORCH)):
        handles, _ = be.apply_changes_docs(
            be.init_docs(1, _fleet(be, False, doc_capacity=2)), [[c1, c3]],
            mirror=False)
        rebuilt = be.rebuild_docs(handles, _fleet(be, False, doc_capacity=2))
        assert be.materialize_docs(rebuilt) == [{'a': 1}]
        rebuilt, _ = be.apply_changes_docs(rebuilt, [[c2]], mirror=False)
        got[name] = (be.materialize_docs(rebuilt), bytes(be.save(rebuilt[0])))
    assert got['torch'] == got['jax']
    assert got['torch'][0] == [{'a': 1, 'b': 2, 'c': 3}]


def _rebuild_loaded_and_parked_docs(exact):
    """Bulk-loaded docs, some parked and edited while parked, rebuild
    into a fresh fleet with the reads and saves of docs never parked."""
    bufs = CORPUS[:4]
    change = A.get_last_local_change(A.change(
        A.load(bufs[0]), lambda r: r.__setitem__('x', 41)))

    def scenario(pkg, fleet):
        be, _host, load_docs = pkg
        handles = load_docs(bufs, fleet)
        handles, _ = be.apply_changes_docs(handles, [[change], [], [], []],
                                           mirror=False)
        want = (be.materialize_docs(handles),
                [bytes(be.save(h)) for h in handles])
        assert be.park_docs(handles[:2]) == 1     # doc 1 is parked clean
        fresh = _fleet(be, exact)
        rebuilt = be.rebuild_docs(handles, fresh)
        assert (be.materialize_docs(rebuilt),
                [bytes(be.save(h)) for h in rebuilt]) == want
        scenario.fleets.append(fresh)
        return rebuilt
    scenario.fleets = []
    jh = scenario(JAX, _fleet(jb, exact))
    th = scenario(TORCH, _fleet(tb, exact))
    _assert_same(scenario.fleets[0], jh, scenario.fleets[1], th)


def test_rebuild_loaded_and_parked_docs():
    _rebuild_loaded_and_parked_docs(False)


def test_rebuild_loaded_and_parked_docs_exact():
    _rebuild_loaded_and_parked_docs(True)


def test_empty_park_and_rebuild():
    assert tb.park_docs([]) == jb.park_docs([]) == 0
    assert tb.rebuild_docs([], _fleet(tb, False)) == []


# ---- TestParkDocs ----------------------------------------------------------

def _park_handles(pkg, fleet, n=3):
    """n docs of a root counter-free key and a one-character Text."""
    be = pkg[0]
    actor = ACTORS[0]
    per_doc = []
    for d in range(n):
        c1 = change_buf(actor, 1, 1, [
            _set('k', d),
            {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []}])
        h1 = decode_change(c1)['hash']
        c2 = change_buf(actor, 2, 3, [{
            'action': 'set', 'obj': f'2@{actor}', 'elemId': '_head',
            'insert': True, 'value': 'x', 'pred': []}], deps=[h1])
        per_doc.append([c1, c2])
    handles, _ = be.apply_changes_docs(be.init_docs(n, fleet), per_doc,
                                       mirror=False)
    return handles


def _park_preserves_reads_history_saves_and_applies(exact):
    def scenario(pkg, fleet):
        be = pkg[0]
        handles = _park_handles(pkg, fleet)
        want_reads = be.materialize_docs(handles)
        want_saves = [bytes(be.save(h)) for h in handles]
        want_changes = [[bytes(b) for b in be.get_changes(h, [])]
                        for h in handles]
        heads = [h['heads'] for h in handles]
        before = be.host_memory_stats(handles)
        assert be.park_docs(handles) == 3
        after = be.host_memory_stats(handles)
        assert after['change_log_bytes'] == 0 < before['change_log_bytes']
        assert after['parked_doc_bytes'] > 0
        assert be.materialize_docs(handles) == want_reads
        assert [h['heads'] for h in handles] == heads
        assert [bytes(be.save(h)) for h in handles] == want_saves
        assert [[bytes(b) for b in be.get_changes(h, [])]
                for h in handles] == want_changes
        c3 = change_buf(ACTORS[0], 3, 4, [_set('k', 99, [f'1@{ACTORS[0]}'])],
                        deps=handles[0]['heads'])
        handles, _ = be.apply_changes_docs(handles, [[c3], [], []],
                                           mirror=False)
        reads = be.materialize_docs(handles)
        assert reads[0]['k'] == 99 and reads[1:] == want_reads[1:]
        return handles
    _both(scenario, exact, key_capacity=16)


def test_park_preserves_reads_history_saves_and_applies():
    _park_preserves_reads_history_saves_and_applies(False)


def test_park_preserves_reads_history_saves_and_applies_exact():
    _park_preserves_reads_history_saves_and_applies(True)


def test_repark_drops_rematerialized_history():
    def scenario(pkg, fleet):
        be = pkg[0]
        handles = _park_handles(pkg, fleet, 1)
        assert be.park_docs(handles) == 1
        be.get_changes(handles[0], [])          # rematerializes
        stats = be.host_memory_stats(handles)
        assert stats['docs_with_decoded_history'] == 0   # native extractor
        assert stats['change_log_bytes'] > 0
        assert be.park_docs(handles) == 1
        stats = be.host_memory_stats(handles)
        assert stats['docs_with_decoded_history'] == 0
        assert stats['change_log_bytes'] == 0
        assert handles[0]['state']._impl._doc_decoded is None
        return handles
    _both(scenario, False, key_capacity=16)


def test_park_then_sync_converges():
    sent = {}
    for name, pkg in (('jax', JAX), ('torch', TORCH)):
        be, host, _load = pkg
        handle = _park_handles(pkg, _fleet(be, False, key_capacity=16), 1)[0]
        assert be.park_docs([handle]) == 1
        peer = host.init()
        s1, s2 = host.init_sync_state(), host.init_sync_state()
        msgs = []
        for _ in range(12):
            s1, msg = be.generate_sync_message(handle, s1)
            if msg is not None:
                peer, s2, _ = host.receive_sync_message(peer, s2, msg)
            s2, msg2 = host.generate_sync_message(peer, s2)
            if msg2 is not None:
                handle, s1, _ = be.receive_sync_message(handle, s1, msg2)
            msgs.append((msg, msg2))
            if msg is None and msg2 is None:
                break
        assert host.get_heads(peer) == be.get_heads(handle)
        sent[name] = msgs
    assert sent['torch'] == sent['jax']


def test_park_skips_queued_docs():
    c1 = change_buf(ACTORS[0], 1, 1, [_set('a', 1)])
    h1 = decode_change(c1)['hash']
    c2 = change_buf(ACTORS[0], 2, 2, [_set('b', 2)], deps=[h1])
    h2 = decode_change(c2)['hash']
    c3 = change_buf(ACTORS[0], 3, 3, [_set('c', 3)], deps=[h2])

    def scenario(pkg, fleet):
        be = pkg[0]
        handles, _ = be.apply_changes_docs(be.init_docs(1, fleet),
                                           [[c1, c3]], mirror=False)
        assert be.park_docs(handles) == 0     # c3 is queued
        return handles
    _both(scenario, False, doc_capacity=2)


# ---- TestParkedColumnarCommit ----------------------------------------------

def _int_change(actor, seq, deps, key, val):
    return change_buf(actor, seq, seq, [_set(key, val)], deps=deps)


def _rounds(be, handles, rounds, base_seq=1):
    for r in range(rounds):
        per_doc = [[_int_change(f'{d:04x}' * 4, base_seq + r,
                                be.get_heads(handles[d]), f'k{r}',
                                d * 10 + r)] for d in range(len(handles))]
        handles, _ = be.apply_changes_docs(handles, per_doc, mirror=False)
    return handles


def _parked_live_mixed_batch_byte_identical(exact):
    """Half the docs parked, then one batch over all: parked docs append
    to the delta tail, live docs to their log, in one call; every doc's
    full history and save equal a from-scratch replay's."""
    n, parked_idx = 6, [0, 2, 4]

    def scenario(pkg, fleet):
        be = pkg[0]
        handles = _rounds(be, be.init_docs(n, fleet), 2)
        assert be.park_docs([handles[i] for i in parked_idx]) == 3
        per_doc = [[_int_change(f'{d:04x}' * 4, 3, be.get_heads(handles[d]),
                                'kx', 100 + d)] for d in range(n)]
        handles, _ = be.apply_changes_docs(handles, per_doc, mirror=False)
        for i in parked_idx:
            impl = handles[i]['state']._impl
            assert impl._doc_pending is not None
            assert list(impl._changes) == per_doc[i]
            assert impl._parked_n == 2
        for d in range(n):
            state = handles[d]['state']
            log = [bytes(b) for b in state.changes]   # materializes parked
            ref = be.init_docs(1, _fleet(be, exact, doc_capacity=1))
            ref, _ = be.apply_changes_docs(ref, [log], mirror=False)
            assert bytes(state.save()) == bytes(ref[0]['state'].save())
            assert be.get_heads(handles[d]) == be.get_heads(ref[0])
            assert state._impl.clock == ref[0]['state']._impl.clock
        return handles
    _both(scenario, exact, doc_capacity=n)


def test_parked_live_mixed_batch_byte_identical():
    _parked_live_mixed_batch_byte_identical(False)


def test_parked_live_mixed_batch_byte_identical_exact():
    _parked_live_mixed_batch_byte_identical(True)


def test_parked_prefix_log_indexing_through_graph():
    def scenario(pkg, fleet):
        be = pkg[0]
        handles = _rounds(be, be.init_docs(1, fleet), 3)
        all_hashes = [decode_change(bytes(b))['hash']
                      for b in handles[0]['state'].changes]
        assert be.park_docs(handles) == 1
        for r in (3, 4):
            handles, _ = be.apply_changes_docs(handles, [[_int_change(
                '0000' * 4, r + 1, be.get_heads(handles[0]), f'k{r}', r)]],
                mirror=False)
        state = handles[0]['state']
        tail = [decode_change(bytes(b))['hash'] for b in state._impl._changes]
        assert len(tail) == 2
        for i, h in enumerate(all_hashes + tail):
            buf = state.get_change_by_hash(h)
            assert decode_change(bytes(buf))['hash'] == h
            assert bytes(state.changes[i]) == bytes(buf)
        return handles
    _both(scenario, False, doc_capacity=1)
