"""Differential tests of Text and list documents through the fleet seam:
the same wire bytes go through the JAX package's DocFleet and the torch
port's (device='cpu'), in both device modes, and the results must agree
exactly — materialize_docs, get_patch (served from the device rows in
exact mode), save() bytes, the dispatch, fallback, promotion and mirror
counters, the sequence rows' bookkeeping and every array of every
size-class pool, the rows' inexact flags, and in exact mode the register
arrays, conflicts_all and inexact_slots.

The scenarios are the shapes of the reference's TestSequenceSeam,
TestTurboSequence, TestSeqSizeClasses, TestRegisterPatches (text and
list patches) and TestPromotion's rows-in-lists
(tests/test_fleet_backend.py): per-op applies and the turbo path, actor
renumbering (flush and turbo), clone and free, inexact routing, size
classes and migration; plus a small text seam (the text trace of
fleet/seq_cases.py: init_docs, one apply_changes_docs(mirror=False) of
the whole chain, two incremental batches, one sequence dispatch per
batch).

Each JAX fleet compiles the sequence scan once per (rows, capacity, lanes,
width) shape, so every scenario is a test of its own (its own family in
the slow audit's accounting)."""

import numpy as np
import pytest
import torch

import automerge_tpu as am
import automerge_tpu.native as jax_native
from automerge_tpu import backend as host_backend
from automerge_tpu.columnar import decode_change, encode_change
from automerge_tpu.fleet import backend as jb
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import seq_cases, seq_kernel
from automerge_tpu_torch.fleet.registers import register_state_to_numpy
from automerge_tpu_torch.fleet.sequence import seq_state_to_numpy

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


_NATIVE_OK = torch_native.available() and jax_native.available()

pytestmark = pytest.mark.skipif(
    not _NATIVE_OK, reason='a native codec is unavailable (the turbo path '
    'and the reference comparison need both)')

ACTORS = ['aa' * 16, 'bb' * 16, 'cc' * 16, '11' * 16]
A, B = ACTORS[0], ACTORS[1]


def change_buf(actor, seq, start_op, ops, deps=()):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': sorted(deps), 'ops': ops})


def _ins(obj, elem, value, **kw):
    return dict({'action': 'set', 'obj': obj, 'elemId': elem,
                 'insert': True, 'value': value, 'pred': []}, **kw)


def _fleet(be, exact, **kw):
    kw.setdefault('doc_capacity', 4)
    kw.setdefault('key_capacity', 8)
    if be is tb:
        kw['device'] = 'cpu'
    return be.DocFleet(exact_device=exact, **kw)


def _metrics(fleet):
    m = fleet.metrics
    return (m.dispatches, m.fallbacks, m.promotions, m.turbo_calls,
            m.remaps, m.mirror_rebuilds)


def _assert_same(jf, jh, tf, th, sample=None, causal=0):
    """`causal`: batches of one doc whose concurrent changes the port's
    turbo gate accepts as a causal run, where the JAX package's
    linear-chain gate sends the call to the exact path."""
    assert tb.materialize_docs(th) == jb.materialize_docs(jh)
    pick = range(len(jh)) if sample is None else sample
    for a, b in ((jh[i], th[i]) for i in pick):
        assert tb.get_patch(b) == jb.get_patch(a)
        assert bytes(tb.save(b)) == bytes(jb.save(a))
    want = list(_metrics(jf))
    want[1] -= causal       # fallbacks
    want[3] += causal       # turbo_calls
    assert _metrics(tf) == tuple(want)
    assert tf.metrics.turbo_causal_docs == causal
    assert tf.seq_rows == jf.seq_rows
    assert tf.seq_place == jf.seq_place and tf.seq_len == jf.seq_len
    assert [tf.seq_row_inexact(r) for r in range(len(tf.seq_rows))] == \
        [jf.seq_row_inexact(r) for r in range(len(jf.seq_rows))]
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
    if jf.exact_device:
        assert tf.conflicts_all() == jf.conflicts_all()
        assert tf.inexact_slots() == jf.inexact_slots()
        assert (jf.reg_state is None) == (tf.reg_state is None)
        if jf.reg_state is not None:
            for x, y in zip(jf.reg_state.tree_flatten()[0],
                            register_state_to_numpy(tf.reg_state)):
                np.testing.assert_array_equal(y, np.asarray(x))


def _both(scenario, exact, sample=None, causal=0, **kw):
    """Run `scenario(be, fleet)` (-> handles) on both packages and compare
    (patches and saves of the `sample` handles, all by default; `causal`
    as in `_assert_same`); returns the port's fleet and handles."""
    jf, tf = _fleet(jb, exact, **kw), _fleet(tb, exact, **kw)
    jh, th = scenario(jb, jf), scenario(tb, tf)
    _assert_same(jf, jh, tf, th, sample, causal)
    assert tf.seq_pools.device.type == 'cpu'
    return tf, th


# ---- TestSequenceSeam ------------------------------------------------------

def text_doc(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'h'), _ins(f'1@{A}', f'2@{A}', 'i')])
    gb, _ = be.apply_changes(gb, [c1])
    c2 = change_buf(A, 2, 4, [
        {'action': 'del', 'obj': f'1@{A}', 'elemId': f'2@{A}',
         'pred': [f'2@{A}']}], deps=be.get_heads(gb))
    gb, _ = be.apply_changes(gb, [c2])
    return [gb]


def _text_doc_resident(exact):
    tf, (gb,) = _both(text_doc, exact)
    assert gb['state'].is_fleet and tf.metrics.promotions == 0
    assert tb.materialize_docs([gb]) == [{'t': 'i'}]
    assert not tf.seq_row_inexact(0)


# Each scenario's two device modes are two tests (two families).

def test_text_doc_stays_fleet_resident():
    _text_doc_resident(False)


def test_text_doc_stays_fleet_resident_exact():
    _text_doc_resident(True)


def list_values(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
        _ins(f'1@{A}', '_head', 7, datatype='int'),
        _ins(f'1@{A}', f'2@{A}', 'str'),
        _ins(f'1@{A}', f'3@{A}', -5, datatype='int')])
    gb, _ = be.apply_changes(gb, [c1])
    return [gb]


def test_list_values_render_from_the_device():
    tf, th = _both(list_values, False)
    assert tb.materialize_docs(th) == [{'l': [7, 'str', -5]}]
    assert not tf.seq_row_inexact(0)


def concurrent_inserts(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'm')])
    h1 = decode_change(c1)['hash']
    gb, _ = be.apply_changes(gb, [c1])
    c2 = change_buf(A, 2, 3, [_ins(f'1@{A}', '_head', 'a')], deps=[h1])
    c3 = change_buf(B, 1, 3, [_ins(f'1@{A}', '_head', 'b')], deps=[h1])
    gb, _ = be.apply_changes(gb, [c2, c3])
    return [gb]


def _concurrent_order(exact):
    _tf, th = _both(concurrent_inserts, exact)
    assert tb.materialize_docs(th) == [{'t': 'bam'}]


def test_rga_concurrent_insert_order_matches_reference():
    _concurrent_order(False)


def test_rga_concurrent_insert_order_matches_reference_exact():
    _concurrent_order(True)


def set_vs_del(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
        _ins(f'1@{A}', '_head', 1, datatype='int')])
    h1 = decode_change(c1)['hash']
    gb, _ = be.apply_changes(gb, [c1])
    c2 = change_buf(A, 2, 3, [
        {'action': 'set', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 9,
         'datatype': 'int', 'pred': [f'2@{A}']}], deps=[h1])
    c3 = change_buf(B, 1, 3, [
        {'action': 'del', 'obj': f'1@{A}', 'elemId': f'2@{A}',
         'pred': [f'2@{A}']}], deps=[h1])
    gb, _ = be.apply_changes(gb, [c2, c3])
    return [gb]


def test_concurrent_set_vs_del_stays_exact():
    for exact in (False, True):
        tf, th = _both(set_vs_del, exact)
        assert tb.materialize_docs(th) == [{'l': [9]}]
        assert not tf.seq_row_inexact(0)


def counter_in_list(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
        _ins(f'1@{A}', '_head', 10, datatype='counter')])
    gb, _ = be.apply_changes(gb, [c1])
    c2 = change_buf(A, 2, 3, [
        {'action': 'inc', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 5,
         'pred': [f'2@{A}']}], deps=be.get_heads(gb))
    gb, _ = be.apply_changes(gb, [c2])
    return [gb]


def test_counter_in_list_exact():
    for exact in (False, True):
        tf, th = _both(counter_in_list, exact)
        assert tb.materialize_docs(th) == [{'l': [15]}]
        assert not tf.seq_row_inexact(0)


def _counter_incs(n_incs):
    ops = [{'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
           _ins(f'1@{A}', '_head', 10, datatype='counter')]
    for i in range(n_incs):
        ops.append({'action': 'inc', 'obj': f'1@{A}', 'elemId': f'2@{A}',
                    'value': i + 1, 'datatype': 'counter',
                    'pred': [f'2@{A}']})
    return change_buf(A, 1, 1, ops)


def counter_patch_shapes(turbo):
    def scenario(be, fleet):
        handles = be.init_docs(3, fleet)
        per_doc = [[_counter_incs(n)] for n in (1, 2, 3)]
        if turbo:
            handles, _ = be.apply_changes_docs(handles, per_doc,
                                               mirror=False)
        else:
            handles = [be.apply_changes(h, c)[0]
                       for h, c in zip(handles, per_doc)]
        return handles
    return scenario


def test_counter_in_list_patch_shapes_per_op():
    """One, two and three incs on one counter element: the patch replays
    the reference's counterStates edit shapes."""
    _both(counter_patch_shapes(False), False)


def test_counter_in_list_patch_shapes_per_op_exact():
    _both(counter_patch_shapes(False), True)


def test_counter_in_list_patch_shapes_turbo():
    _both(counter_patch_shapes(True), False)


def test_counter_in_list_patch_shapes_turbo_exact():
    _both(counter_patch_shapes(True), True)


def _replica_history(seed):
    """tests/test_fleet_backend.py's randomized counter-in-list history:
    two host replicas diverge (inserting counter and plain elements,
    incrementing what they see, deleting) and merge now and then; returns
    the converged change log."""
    rng = np.random.default_rng(seed)
    reps = [host_backend.init(), host_backend.init()]
    boot = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []}])
    for i in (0, 1):
        reps[i], _ = host_backend.apply_changes(reps[i], [boot])
    list_id = f'1@{A}'
    seqs = {A: 1, B: 0}

    def visible_elems(rep):
        lst = host_backend.get_patch(rep)['diffs']['props'].get(
            'l', {}).get(list_id)
        out = []
        for edit in (lst or {}).get('edits', []):
            if edit['action'] in ('insert', 'update'):
                val = edit['value']
                out.append((edit.get('elemId', edit['opId']),
                            [edit['opId']],
                            isinstance(val, dict) and
                            val.get('datatype') == 'counter'))
        return out

    for _step in range(int(rng.integers(10, 16))):
        r = int(rng.integers(0, 2))
        actor = (A, B)[r]
        elems = visible_elems(reps[r])
        counters = [e for e in elems if e[2]]
        roll = rng.random()
        if roll < 0.45 or not elems:
            ref = '_head' if not elems or rng.random() < 0.4 \
                else elems[int(rng.integers(0, len(elems)))][0]
            op = _ins(list_id, ref, int(rng.integers(0, 50)),
                      datatype='counter' if rng.random() < 0.7 else 'int')
        elif roll < 0.8 and counters:
            eid, preds, _ = counters[int(rng.integers(0, len(counters)))]
            op = {'action': 'inc', 'obj': list_id, 'elemId': eid,
                  'value': int(rng.integers(-3, 9)), 'datatype': 'counter',
                  'pred': preds}
        else:
            eid, preds, _ = elems[int(rng.integers(0, len(elems)))]
            op = {'action': 'del', 'obj': list_id, 'elemId': eid,
                  'pred': preds}
        seqs[actor] += 1
        start = host_backend.get_patch(reps[r])['maxOp'] + 1
        buf = change_buf(actor, seqs[actor], start, [op],
                         deps=host_backend.get_heads(reps[r]))
        reps[r], _ = host_backend.apply_changes(reps[r], [buf])
        if rng.random() < 0.3:
            missing = host_backend.get_changes_added(reps[r], reps[1 - r])
            if missing:
                reps[r], _ = host_backend.apply_changes(
                    reps[r], [bytes(c) for c in missing])
    for r in (0, 1):
        missing = host_backend.get_changes_added(reps[r], reps[1 - r])
        if missing:
            reps[r], _ = host_backend.apply_changes(
                reps[r], [bytes(c) for c in missing])
    return reps[0], [bytes(c) for c in host_backend.get_all_changes(reps[0])]


def _randomized_counter_history(exact):
    hb, history = _replica_history(7)

    def scenario(be, fleet):
        gb = be.init(fleet)
        gb, _ = be.apply_changes(gb, history)
        return [gb]
    _tf, (gb,) = _both(scenario, exact, doc_capacity=2)
    assert tb.get_patch(gb) == host_backend.get_patch(hb)
    assert bytes(tb.save(gb)) == bytes(host_backend.save(hb))


def test_randomized_counter_history_matches_reference():
    _randomized_counter_history(False)


def test_randomized_counter_history_matches_reference_exact():
    _randomized_counter_history(True)


def clone_and_free(be, fleet):
    """Three text docs (a pool of four rows), a clone of the first (its row
    copied), divergent edits, a free and a reuse of the freed row."""
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'x')])
    handles = be.init_docs(3, fleet)
    handles, _ = be.apply_changes_docs(handles, [[c1]] * 3, mirror=False)
    gb = handles[0]
    twin = be.clone(gb)
    c2 = change_buf(A, 2, 3, [_ins(f'1@{A}', f'2@{A}', 'y')],
                    deps=be.get_heads(gb))
    gb, _ = be.apply_changes(gb, [c2])
    assert be.materialize_docs([gb, twin]) == [{'t': 'xy'}, {'t': 'x'}]
    be.free(twin)
    fresh = be.init(fleet)
    fresh, _ = be.apply_changes(fresh, [c1])
    return [gb, fresh, handles[2]]


def test_clone_and_free_with_seq_rows():
    _tf, th = _both(clone_and_free, False)
    assert tb.materialize_docs(th) == [{'t': 'xy'}, {'t': 'x'}, {'t': 'x'}]


def test_clone_and_free_with_seq_rows_exact():
    _tf, th = _both(clone_and_free, True)
    assert tb.materialize_docs(th) == [{'t': 'xy'}, {'t': 'x'}, {'t': 'x'}]


def actor_renumber(be, fleet):
    gb = be.init(fleet)
    late, early = ACTORS[2], ACTORS[3]     # 'cc…' then '11…' (sorts first)
    c1 = change_buf(late, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{late}', '_head', 'a')])
    h1 = decode_change(c1)['hash']
    gb, _ = be.apply_changes(gb, [c1])
    fleet.flush()                    # the row exists before the renumber
    c2 = change_buf(early, 1, 3, [_ins(f'1@{late}', f'2@{late}', 'b')],
                    deps=[h1])
    gb, _ = be.apply_changes(gb, [c2])
    return [gb]


def _renumbered(exact):
    tf, th = _both(actor_renumber, exact)
    assert tb.materialize_docs(th) == [{'t': 'ab'}]
    assert tf.metrics.remaps >= 1 and not tf.seq_row_inexact(0)


def test_actor_renumber_remaps_seq_rows():
    _renumbered(False)


def test_actor_renumber_remaps_seq_rows_exact():
    _renumbered(True)


def turbo_renumber(be, fleet):
    g1, g2 = be.init(fleet), be.init(fleet)
    late, early = ACTORS[2], ACTORS[3]
    c1 = change_buf(late, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{late}', '_head', 'a')])
    h1 = decode_change(c1)['hash']
    g1, _ = be.apply_changes(g1, [c1])
    fleet.flush()
    flat = change_buf(early, 1, 1, [
        {'action': 'set', 'obj': '_root', 'key': 'k', 'value': 1,
         'datatype': 'int', 'pred': []}])
    [g2], _ = be.apply_changes_docs([g2], [[flat]], mirror=False)
    c2 = change_buf(late, 2, 3, [
        {'action': 'del', 'obj': f'1@{late}', 'elemId': f'2@{late}',
         'pred': [f'2@{late}']}], deps=[h1])
    g1, _ = be.apply_changes(g1, [c2])
    return [g1, g2]


def _turbo_renumbered(exact):
    tf, th = _both(turbo_renumber, exact)
    assert tb.materialize_docs(th) == [{'t': ''}, {'k': 1}]
    assert not tf.seq_row_inexact(0)


def test_turbo_renumber_remaps_seq_rows():
    _turbo_renumbered(False)


def test_turbo_renumber_remaps_seq_rows_exact():
    _turbo_renumbered(True)


def _public_api_changes():
    """Changes the reference's frontend makes for a Text edit session."""
    d = am.init(A)
    d = am.change(d, lambda doc: doc.__setitem__('t', am.Text('hello')))
    d = am.change(d, lambda doc: doc['t'].insert_at(5, '!', '?'))
    d = am.change(d, lambda doc: doc['t'].delete_at(0, 2))
    return [bytes(c) for c in am.get_all_changes(d)]


def test_public_api_text_changes_stay_fleet_resident():
    changes = _public_api_changes()

    def scenario(be, fleet):
        gb = be.init(fleet)
        for c in changes:
            gb, _ = be.apply_changes(gb, [c])
        return [gb]
    for exact in (False, True):
        tf, th = _both(scenario, exact)
        assert tb.materialize_docs(th) == [{'t': 'llo!?'}]
        assert tf.metrics.promotions == 0
        assert str(am.load(bytes(tb.save(th[0])))['t']) == 'llo!?'


def inexact_self_overwrite(be, fleet):
    """An actor overwriting an element without pred'ing its own visible op
    (only hand-built changes do that): the row flags inexact and reads
    come from the host mirror."""
    gb = be.init(fleet)
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'a'),
        {'action': 'set', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 'X',
         'pred': [f'2@{A}']}])
    c2 = change_buf(A, 2, 4, [
        {'action': 'set', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 'Y',
         'pred': []}], deps=[decode_change(c1)['hash']])
    gb, _ = be.apply_changes(gb, [c1, c2])
    return [gb]


def test_inexact_rows_route_reads_to_the_mirror():
    for exact in (False, True):
        tf, th = _both(inexact_self_overwrite, exact)
        assert tf.seq_row_inexact(0)
        assert tf.render_seq_all() == {0: None}


# ---- TestTurboSequence -----------------------------------------------------

def _text_changes():
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'a'), _ins(f'1@{A}', f'2@{A}', 'b'),
        _ins(f'1@{A}', f'3@{A}', 'c')])
    c2 = change_buf(A, 2, 5, [
        {'action': 'del', 'obj': f'1@{A}', 'elemId': f'3@{A}',
         'pred': [f'3@{A}']}], deps=[decode_change(c1)['hash']])
    # a multi-value insert of two characters
    c3 = change_buf(A, 3, 6, [_ins(f'1@{A}', f'4@{A}', None,
                                   values=['€', 'x'])],
                    deps=[decode_change(c2)['hash']])
    return c1, c2, c3


def turbo_text(be, fleet):
    g = be.init(fleet)
    c1, c2, c3 = _text_changes()
    handles, _ = be.apply_changes_docs([g], [[c1, c2]], mirror=False)
    assert fleet.metrics.fallbacks == 0 and fleet.metrics.turbo_calls == 1
    assert be.materialize_docs(handles) == [{'t': 'ac'}]
    assert fleet.metrics.mirror_rebuilds == 0      # the device served it
    handles, _ = be.apply_changes_docs(handles, [[c3]], mirror=False)
    assert fleet.metrics.fallbacks == 0
    return handles


def test_turbo_text_no_mirror_no_fallback():
    _tf, th = _both(turbo_text, False)
    assert tb.materialize_docs(th) == [{'t': 'ac€x'}]


def test_turbo_text_no_mirror_no_fallback_exact():
    _tf, th = _both(turbo_text, True)
    assert tb.materialize_docs(th) == [{'t': 'ac€x'}]


def test_turbo_text_equals_the_per_op_path():
    tf = _fleet(tb, False)
    (turbo,) = turbo_text(tb, tf)
    per_op = tb.init(tf)
    for c in _text_changes():
        per_op, _ = tb.apply_changes(per_op, [c])
    assert tb.get_patch(turbo) == tb.get_patch(per_op)
    assert bytes(tb.save(turbo)) == bytes(tb.save(per_op))


def test_turbo_unknown_seq_object_raises_like_the_reference():
    bogus = change_buf(A, 1, 1, [_ins(f'9@{A}', '_head', 'x')])
    for be in (jb, tb):
        g = be.init(_fleet(be, False))
        with pytest.raises(ValueError, match='unknown object'):
            be.apply_changes_docs([g], [[bogus]], mirror=False)


# ---- TestSeqSizeClasses ----------------------------------------------------

def _text_doc_changes(actor, text):
    d = am.from_({'t': am.Text(text)}, actor)
    return [bytes(c) for c in am.get_all_changes(d)]


def test_long_doc_does_not_inflate_small_class():
    short_doc = _text_doc_changes(A, 'hi')
    long_doc = _text_doc_changes(B, 'x' * 300)

    def long_and_short(be, fleet):
        short = be.init(fleet)
        short, _ = be.apply_changes(short, short_doc)
        long = be.init(fleet)
        long, _ = be.apply_changes(long, long_doc)
        fleet.flush()
        return [short, long]
    tf, th = _both(long_and_short, False)
    assert tb.materialize_docs(th) == [{'t': 'hi'}, {'t': 'x' * 300}]
    classes = sorted(tf.seq_pools.pools)
    assert len(classes) >= 2
    assert tf.seq_pools.state(classes[0]).capacity == tf.seq_elem_cap
    assert tf.seq_pools.state(classes[-1]).capacity >= 300


def _growing_steps():
    """A two-character text, then two changes that append 40 characters
    each (one change per flush): the row outgrows the 64-slot class."""
    d = am.from_({'t': am.Text('ab')}, A)
    steps = [[bytes(c) for c in am.get_all_changes(d)]]
    for _ in range(2):
        d = am.change(d, lambda r: r['t'].insert_at(len(r['t']),
                                                    *('y' * 40)))
        steps.append([bytes(am.get_last_local_change(d))])
    return steps


def _grown(steps):
    def growing_doc(be, fleet):
        gb = be.init(fleet)
        for step in steps:
            gb, _ = be.apply_changes(gb, step)
            fleet.flush()
        return [gb]
    return _both(growing_doc, False, doc_capacity=2)


# The row grows inside its class first (one test), then outgrows it (the
# next, which meets the same shapes again: the reference's compiles of the
# first steps are shared).

def test_row_grows_inside_its_class_in_place():
    tf, th = _grown(_growing_steps()[:2])
    assert tb.materialize_docs(th) == [{'t': 'ab' + 'y' * 40}]
    assert tf.seq_place[0][0] == 0


def test_row_migrates_up_classes_preserving_content():
    tf, th = _grown(_growing_steps())
    assert tb.materialize_docs(th) == [{'t': 'ab' + 'y' * 80}]
    assert tf.seq_place[0][0] > 0 and 0 in tf.seq_pools.free.get(0, [])


def _tail_sorted_steps():
    """Four actors edit one text (one change per flush), then a fifth whose
    hex sorts after every other: no remap, but the pools widen their lane
    axis before its ops apply."""
    first = ['01' * 8, '22' * 8, '44' * 8, '66' * 8]
    base = am.from_({'t': am.Text('abcd')}, first[0])
    steps = [[bytes(c) for c in am.get_all_changes(base)]]
    for i, actor in enumerate(first[1:], start=1):
        rep = am.change(am.merge(am.init(actor), base),
                        lambda r, i=i: r['t'].set(i, '!'))
        steps.append([bytes(am.get_last_local_change(rep))])
    late = am.change(am.merge(am.init('ff' * 8), base),
                     lambda r: r['t'].insert_at(0, 'Z'))
    steps.append([bytes(am.get_last_local_change(late))])
    return steps


def test_tail_sorted_new_actor_widens_lanes():
    steps = _tail_sorted_steps()

    def tail_sorted_actor(be, fleet):
        gb = be.init(fleet)
        for step in steps:
            gb, _ = be.apply_changes(gb, step)
            fleet.flush()
        return [gb]
    tf, th = _both(tail_sorted_actor, False, doc_capacity=8)
    assert tb.materialize_docs(th) == [{'t': 'Za!!!'}]
    assert tf.seq_pools.state(0).actor_slots == 8
    assert not tf.seq_row_inexact(0)


def test_free_slot_releases_pool_rows():
    abc, dfe = _text_doc_changes(A, 'abc'), _text_doc_changes(A, 'def')

    def free_and_reuse(be, fleet):
        gb = be.init(fleet)
        gb, _ = be.apply_changes(gb, abc)
        fleet.flush()
        be.free(gb)
        gb2 = be.init(fleet)
        gb2, _ = be.apply_changes(gb2, dfe)
        fleet.flush()
        return [gb2]
    tf, th = _both(free_and_reuse, False, doc_capacity=2)
    assert tb.materialize_docs(th) == [{'t': 'def'}]
    assert tf.seq_place[0] == (0, 0)


# ---- TestRegisterPatches: sequence patches from the device -----------------

def _patch_scenario(changes, turbo):
    def scenario(be, fleet):
        gb = be.init(fleet)
        if turbo:
            [gb], _ = be.apply_changes_docs([gb], [list(changes)],
                                            mirror=False)
        else:
            for c in changes:
                gb, _ = be.apply_changes(gb, [c])
        return [gb]
    return scenario


def _device_patch(changes, turbo, causal=0):
    """Exact fleet: the patch comes from the device rows, equal to the
    host backend's, with no mirror rebuild."""
    hb = host_backend.init()
    for c in changes:
        hb, _ = host_backend.apply_changes(hb, [c])
    tf, (gb,) = _both(_patch_scenario(changes, turbo), True,
                      causal=causal, doc_capacity=2, key_capacity=32)
    assert tb.get_patch(gb) == host_backend.get_patch(hb)
    assert tf.metrics.mirror_rebuilds == 0
    return tf, gb


def _text_patch_changes():
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'h'), _ins(f'1@{A}', f'2@{A}', 'i')])
    c2 = change_buf(B, 1, 4, [
        {'action': 'set', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 'H',
         'pred': [f'2@{A}']},
        {'action': 'del', 'obj': f'1@{A}', 'elemId': f'3@{A}',
         'pred': [f'3@{A}']}], deps=[decode_change(c1)['hash']])
    return [c1, c2]


def test_text_patch_from_device():
    _device_patch(_text_patch_changes(), False)


def test_text_patch_from_device_turbo():
    _device_patch(_text_patch_changes(), True)


def _list_conflict_changes():
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
        _ins(f'1@{A}', '_head', 1, datatype='int'),
        _ins(f'1@{A}', f'2@{A}', 2, datatype='int')])
    h1 = decode_change(c1)['hash']
    c2 = change_buf(A, 2, 4, [
        {'action': 'set', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 10,
         'datatype': 'int', 'pred': [f'2@{A}']}], deps=[h1])
    c3 = change_buf(B, 1, 4, [
        {'action': 'set', 'obj': f'1@{A}', 'elemId': f'2@{A}', 'value': 20,
         'datatype': 'int', 'pred': [f'2@{A}']},
        {'action': 'del', 'obj': f'1@{A}', 'elemId': f'3@{A}',
         'pred': [f'3@{A}']}], deps=[h1])
    return [c1, c2, c3]


def test_list_conflict_and_resurrection_patch_from_device():
    _device_patch(_list_conflict_changes(), False)


def test_list_conflict_and_resurrection_patch_from_device_turbo():
    # c2 and c3 are concurrent: the port keeps the batch on its turbo
    # path as a causal run
    _device_patch(_list_conflict_changes(), True, causal=1)


def _rows_in_lists_changes():
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'todo', 'pred': []},
        {'action': 'makeMap', 'obj': f'1@{A}', 'elemId': '_head',
         'insert': True, 'pred': []},
        {'action': 'set', 'obj': f'2@{A}', 'key': 't', 'value': 'wash',
         'pred': []},
        {'action': 'makeList', 'obj': f'1@{A}', 'elemId': f'2@{A}',
         'insert': True, 'pred': []},
        _ins(f'4@{A}', '_head', 7, datatype='int'),
        _ins(f'1@{A}', f'4@{A}', 3, datatype='int')])
    c2 = change_buf(A, 2, 7, [
        {'action': 'set', 'obj': f'2@{A}', 'key': 'n', 'value': 5,
         'datatype': 'int', 'pred': []}], deps=[decode_change(c1)['hash']])
    return [c1, c2]


def _objects_inside_lists(turbo):
    _tf, gb = _device_patch(_rows_in_lists_changes(), turbo)
    assert tb.materialize_docs([gb]) == [
        {'todo': [{'t': 'wash', 'n': 5}, [7], 3]}]


def test_objects_inside_lists_patch_from_device():
    _objects_inside_lists(False)


def test_objects_inside_lists_patch_from_device_turbo():
    _objects_inside_lists(True)


def _typed_list_elements(turbo):
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
        _ins(f'1@{A}', '_head', 3, datatype='uint'),
        _ins(f'1@{A}', f'2@{A}', 1589032171000, datatype='timestamp'),
        _ins(f'1@{A}', f'3@{A}', 2.5, datatype='float64')])
    _tf, gb = _device_patch([c1], turbo)
    assert tb.materialize_docs([gb]) == [{'l': [3, 1589032171000, 2.5]}]


def test_typed_list_elements_patch_from_device():
    _typed_list_elements(False)


def test_typed_list_elements_patch_from_device_turbo():
    _typed_list_elements(True)


def test_typed_values_survive_the_mixed_exact_flush():
    """One doc's typed root sets and another doc's text ops in one pending
    batch: the exact mixed flush serves both."""
    c1 = change_buf(A, 1, 1, [
        {'action': 'set', 'obj': '_root', 'key': 'score', 'value': 10,
         'datatype': 'counter', 'pred': []},
        {'action': 'set', 'obj': '_root', 'key': 'u', 'value': 3,
         'datatype': 'uint', 'pred': []}])
    c2 = change_buf(A, 2, 3, [
        {'action': 'inc', 'obj': '_root', 'key': 'score', 'value': 5,
         'pred': [f'1@{A}']}], deps=[decode_change(c1)['hash']])
    text = change_buf(A, 1, 1, [
        {'action': 'makeText', 'obj': '_root', 'key': 't', 'pred': []},
        _ins(f'1@{A}', '_head', 'x')])

    def scenario(be, fleet):
        gb, other = be.init(fleet), be.init(fleet)
        gb, _ = be.apply_changes(gb, [c1, c2])
        other, _ = be.apply_changes(other, [text])
        fleet.flush()
        return [gb, other]
    tf, th = _both(scenario, True, key_capacity=16)
    assert tb.materialize_docs(th) == [{'score': 15, 'u': 3}, {'t': 'x'}]
    assert tf.metrics.mirror_rebuilds == 0


# ---- TestPromotion: rows in lists ------------------------------------------

def _object_inside_sequence(exact):
    c1 = change_buf(A, 1, 1, [
        {'action': 'makeList', 'obj': '_root', 'key': 'l', 'pred': []},
        {'action': 'makeMap', 'obj': f'1@{A}', 'elemId': '_head',
         'insert': True, 'pred': []},
        {'action': 'set', 'obj': f'2@{A}', 'key': 'row', 'value': 3,
         'datatype': 'int', 'pred': []}])

    def scenario(be, fleet):
        gb = be.init(fleet)
        gb, _ = be.apply_changes(gb, [c1])
        return [gb]
    tf, th = _both(scenario, exact, doc_capacity=2, key_capacity=2)
    assert th[0]['state'].is_fleet and tf.metrics.promotions == 0
    assert tb.materialize_docs(th) == [{'l': [{'row': 3}]}]


def test_object_inside_sequence_stays_fleet_resident():
    _object_inside_sequence(False)


def test_object_inside_sequence_stays_fleet_resident_exact():
    _object_inside_sequence(True)


def _turbo_rows_in_lists(exact):
    c1, c2 = _rows_in_lists_changes()

    def scenario(be, fleet):
        handles = be.init_docs(2, fleet)
        handles, _ = be.apply_changes_docs(handles, [[c1, c2]] * 2,
                                           mirror=False)
        return handles
    hb = host_backend.init()
    hb, _ = host_backend.apply_changes(hb, [c1, c2])
    tf, th = _both(scenario, exact, doc_capacity=2)
    m = tf.metrics
    assert (m.turbo_calls, m.fallbacks, m.promotions) == (1, 0, 0)
    assert tb.materialize_docs(th) == \
        [{'todo': [{'t': 'wash', 'n': 5}, [7], 3]}] * 2
    assert bytes(tb.save(th[0])) == bytes(host_backend.save(hb))


def test_turbo_rows_in_lists_no_fallback():
    _turbo_rows_in_lists(False)


def test_turbo_rows_in_lists_no_fallback_exact():
    _turbo_rows_in_lists(True)


# ---- a small text seam -----------------------------------------------------

SEAM_DOCS = 6
BATCHES = seq_cases.text_changes(100, more=(16, 16), seed=1)


def _text_seam_of(batches):
    def text_seam(be, fleet):
        """init_docs, the whole chain in one apply_changes_docs(
        mirror=False), then the incremental batches; one sequence dispatch
        each (one size class), and nothing falls back."""
        handles = be.init_docs(SEAM_DOCS, fleet)
        for batch in batches:
            d0 = fleet.metrics.dispatches
            handles, patches = be.apply_changes_docs(
                handles, [list(batch) for _ in range(SEAM_DOCS)],
                mirror=False)
            assert all(p is None for p in patches)
            # the root map's makeText lands in the grid/registers first
            assert fleet.metrics.dispatches - d0 == (
                2 if batch is batches[0] else 1)
        assert fleet.metrics.fallbacks == 0
        return handles
    return text_seam


def _host_text(batches):
    hb = host_backend.init()
    for batch in batches:
        hb, _ = host_backend.apply_changes(hb, batch)
    return hb


def _small_seam(exact, batches=BATCHES):
    before = seq_kernel.LAUNCHES['seq_scan']
    tf, th = _both(_text_seam_of(batches), exact,
                   sample=(0, SEAM_DOCS - 1), doc_capacity=SEAM_DOCS)
    hb = _host_text(batches)
    want = jb._leaf_value(host_backend.get_patch(hb)['diffs'])
    assert tb.materialize_docs(th) == [want] * SEAM_DOCS
    assert bytes(tb.save(th[0])) == bytes(host_backend.save(hb))
    assert not any(tf.seq_row_inexact(r) for r in range(SEAM_DOCS))
    assert seq_kernel.LAUNCHES['seq_scan'] == before        # the CPU


# The first batch alone first: the whole seam then meets its shapes again.

def test_small_text_seam_first_batch_matches_reference():
    _small_seam(False, BATCHES[:1])


def test_small_text_seam_matches_reference():
    _small_seam(False)


def test_small_text_seam_matches_reference_exact():
    _small_seam(True)


def test_text_fleet_without_a_device_needs_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tb.DocFleet()
