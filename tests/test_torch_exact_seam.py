"""Differential tests of exact-device mode: the same wire bytes go through
the JAX package's DocFleet(exact_device=True) and the torch port's
(device='cpu'), and the results must agree exactly — materialize_docs,
conflicts_all, get_patch (served from the device registers), save()
bytes, inexact_slots, dispatch counts and the register arrays.

The scenarios are the shapes of the reference's TestExactDeviceMode
(tests/test_fleet_backend.py): set-vs-delete resurrection, conflicts,
counters, string values through turbo then the mixed flush, actor
renumbering (also past the slot capacity), turbo after a lazy exact
flush and an inc of -1; plus a small seam (12 docs, concurrent actors,
deletes, incs, strings, a second batch whose actor sorts first)."""

import numpy as np
import pytest
import torch

import automerge_tpu.native as jax_native
from automerge_tpu.columnar import decode_change, encode_change
from automerge_tpu.fleet import backend as jb
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import register_kernel
from automerge_tpu_torch.fleet.registers import register_state_to_numpy

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


_NATIVE_OK = torch_native.available() and jax_native.available()

ACTORS = ['aa' * 16, 'bb' * 16, 'cc' * 16, '11' * 16]


def change_buf(actor, seq, start_op, ops, deps=()):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': sorted(deps), 'ops': ops})


def _set(key, value, pred=(), datatype='int'):
    op = {'action': 'set', 'obj': '_root', 'key': key, 'value': value,
          'pred': list(pred)}
    if datatype:
        op['datatype'] = datatype
    return op


def _fleet(be, **kw):
    kw.setdefault('doc_capacity', 4)
    kw.setdefault('key_capacity', 4)
    if be is tb:
        kw['device'] = 'cpu'
    return be.DocFleet(exact_device=True, **kw)


def _assert_same(jf, jh, tf, th):
    assert tb.materialize_docs(th) == jb.materialize_docs(jh)
    assert tf.conflicts_all() == jf.conflicts_all()
    assert tf.inexact_slots() == jf.inexact_slots()
    for a, b in zip(jh, th):
        assert tb.get_patch(b) == jb.get_patch(a)
        assert bytes(tb.save(b)) == bytes(jb.save(a))
    assert tf.metrics.dispatches == jf.metrics.dispatches
    assert (jf.reg_state is None) == (tf.reg_state is None)
    if jf.reg_state is not None:
        ja = (np.asarray(a) for a in jf.reg_state.tree_flatten()[0])
        ta = register_state_to_numpy(tf.reg_state)
        for name, x, y in zip(('reg', 'killed', 'value', 'counter',
                               'inexact'), ja, ta):
            assert x.shape == y.shape, name
            np.testing.assert_array_equal(y, x, err_msg=name)


def _both(scenario, **kw):
    jf, tf = _fleet(jb, **kw), _fleet(tb, **kw)
    jh, th = scenario(jb, jf), scenario(tb, tf)
    _assert_same(jf, jh, tf, th)
    return tf, th


# ---- the reference's TestExactDeviceMode shapes ------------------------

def resurrection(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(ACTORS[0], 1, 1, [_set('k', 5)])
    gb, _ = be.apply_changes(gb, [c1])
    c2 = change_buf(ACTORS[1], 1, 2, [_set('k', 7, [f'1@{ACTORS[0]}'])],
                    deps=be.get_heads(gb))
    c3 = change_buf(ACTORS[2], 1, 9, [
        {'action': 'del', 'obj': '_root', 'key': 'k',
         'pred': [f'1@{ACTORS[0]}']}], deps=[decode_change(c1)['hash']])
    gb, _ = be.apply_changes(gb, [c2, c3])
    return [gb]


def conflicts(be, fleet):
    gb = be.init(fleet)
    c1 = change_buf(ACTORS[0], 1, 1, [_set('x', 1)])
    c2 = change_buf(ACTORS[1], 1, 1, [_set('x', 2)])
    gb, _ = be.apply_changes(gb, [c1, c2])
    return [gb]


def counter(be, fleet):
    gb = be.init(fleet)
    specs = [_set('c', 10, datatype='counter'),
             {'action': 'inc', 'obj': '_root', 'key': 'c', 'value': 3,
              'pred': [f'1@{ACTORS[0]}']},
             _set('c', 100, [f'1@{ACTORS[0]}'])]
    cs, heads = [], []
    for i, op in enumerate(specs):
        buf = change_buf(ACTORS[0], i + 1, i + 1, [op], deps=heads)
        heads = [decode_change(buf)['hash']]
        cs.append(buf)
    gb, _ = be.apply_changes(gb, cs[:2])
    assert be.materialize_docs([gb]) == [{'c': 13}]
    gb, _ = be.apply_changes(gb, [cs[2]])
    return [gb]


def turbo_string_values(be, fleet):
    handles = be.init_docs(2, fleet)
    ints = [[change_buf(ACTORS[0], 1, 1, [_set('n', d + 1)])]
            for d in range(2)]
    handles, patches = be.apply_changes_docs(handles, ints, mirror=False)
    assert all(p is None for p in patches)
    strs = [[change_buf(ACTORS[1], 1, 5, [_set('s', f'doc{d}',
                                               datatype=None)])]
            for d in range(2)]
    handles, _ = be.apply_changes_docs(handles, strs)
    return handles


def actor_renumber(be, fleet):
    gb = be.init(fleet)
    gb, _ = be.apply_changes(gb, [change_buf(ACTORS[1], 1, 1,
                                             [_set('x', 1)])])
    fleet.flush()
    gb, _ = be.apply_changes(gb, [change_buf(ACTORS[0], 1, 1,
                                             [_set('x', 2)])])
    return [gb]


def one_slot(be, fleet):
    gb = be.init(fleet)
    gb, _ = be.apply_changes(gb, [change_buf(ACTORS[2], 1, 1,
                                             [_set('x', 9)])])
    fleet.flush()
    return [gb]


def renumber_beyond_capacity(be, fleet):
    (gb,) = one_slot(be, fleet)
    gb, _ = be.apply_changes(gb, [change_buf(ACTORS[0], 1, 1,
                                             [_set('y', 1)])])
    return [gb]


def turbo_after_lazy_exact(be, fleet):
    gb = be.init(fleet)
    gb, _ = be.apply_changes(gb, [change_buf(ACTORS[0], 1, 1,
                                             [_set('k', 1)])])
    c2 = change_buf(ACTORS[0], 2, 2, [
        {'action': 'del', 'obj': '_root', 'key': 'k',
         'pred': [f'1@{ACTORS[0]}']}], deps=be.get_heads(gb))
    handles, _ = be.apply_changes_docs([gb], [[c2]], mirror=False)
    return handles


def negative_inc(be, fleet):
    gb = be.init(fleet)
    gb, _ = be.apply_changes(gb, [change_buf(
        ACTORS[0], 1, 1, [_set('c', 10, datatype='counter')])])
    c2 = change_buf(ACTORS[0], 2, 2, [
        {'action': 'inc', 'obj': '_root', 'key': 'c', 'value': -1,
         'pred': [f'1@{ACTORS[0]}']}], deps=be.get_heads(gb))
    gb, _ = be.apply_changes(gb, [c2])
    return [gb]


def randomized(be, fleet):
    rng = np.random.default_rng(23)
    gb = be.init(fleet)
    vis, heads = {}, []
    seqs = {a: 0 for a in ACTORS[:2]}
    for ctr in range(1, 26):
        actor = ACTORS[int(rng.integers(0, 2))]
        key = f'k{int(rng.integers(0, 4))}'
        seqs[actor] += 1
        cur = sorted(vis.get(key, set()))
        if rng.random() < 0.25 and cur:
            op = {'action': 'del', 'obj': '_root', 'key': key, 'pred': cur}
            vis[key] = set()
        else:
            op = _set(key, int(rng.integers(0, 100)), cur)
            vis[key] = {f'{ctr}@{actor}'}
        buf = change_buf(actor, seqs[actor], ctr, [op], deps=heads)
        heads = [decode_change(buf)['hash']]
        gb, _ = be.apply_changes(gb, [buf])
    return [gb]


pytestmark = pytest.mark.skipif(
    not _NATIVE_OK, reason='a native codec is unavailable (the turbo path '
    'and the reference comparison need both)')


# One test per scenario: each compiles the reference's kernels at its own
# shapes, so each is its own family in the slow audit's accounting.

def test_resurrection_matches_reference():
    _both(resurrection)


def test_conflicts_match_reference():
    _both(conflicts)


def test_counter_matches_reference():
    _both(counter)


def test_turbo_string_values_match_reference():
    _both(turbo_string_values)


def test_actor_renumber_matches_reference():
    _both(actor_renumber)


def two_slots(be, fleet):
    handles = be.init_docs(2, fleet)
    for d, key in enumerate('xy'):
        handles[d], _ = be.apply_changes(handles[d], [change_buf(
            ACTORS[0], 1, 1, [_set(key, d + 1)])])
    return handles


ONE_SLOT = dict(doc_capacity=2, key_capacity=2, actor_slot_capacity=1)


def test_one_slot_fleet_matches_reference():
    """The first half of the renumbering test below: one actor in a
    fleet of one actor slot."""
    _both(one_slot, **ONE_SLOT)


def test_two_slot_fleet_matches_reference():
    """Two docs of one actor each in a fleet of two actor slots: the
    register state's shape after the renumbering test's growth."""
    _both(two_slots, **dict(ONE_SLOT, actor_slot_capacity=2))


def test_renumber_beyond_slot_capacity_matches_reference():
    _both(renumber_beyond_capacity, **ONE_SLOT)


def test_turbo_after_lazy_exact_matches_reference():
    _both(turbo_after_lazy_exact)


def test_negative_inc_matches_reference():
    _both(negative_inc)


def clone_and_free(be, fleet):
    """Clone a doc (its register row is copied), free another (its rows
    are zeroed), reuse the freed slot, and write to the clone."""
    handles = be.init_docs(3, fleet)
    per_doc = [[change_buf(ACTORS[d], 1, 1, [_set('x', d + 1)])]
               for d in range(3)]
    handles, _ = be.apply_changes_docs(handles, per_doc, mirror=False)
    twin = be.clone(handles[0])
    be.free_docs([handles[1]])
    fresh = be.init_docs(1, fleet)
    twin, _ = be.apply_changes(twin, [change_buf(
        ACTORS[3], 1, 2, [_set('x', 9, [f'1@{ACTORS[0]}'])],
        deps=be.get_heads(twin))])
    return [handles[0], handles[2], twin] + fresh


def test_clone_and_free_match_reference():
    _both(clone_and_free)


def test_randomized_history_matches_reference():
    _both(randomized)


def test_exact_corners_read_as_the_reference_reads_them():
    """The values the reference's tests assert, read from the port."""
    tf = _fleet(tb)
    assert tb.materialize_docs(resurrection(tb, tf)) == [{'k': 7}]
    tf = _fleet(tb)
    (gb,) = conflicts(tb, tf)
    assert sorted(tf.conflicts_all()[gb['state']._impl.slot]['x']
                  .values()) == [1, 2]
    tf = _fleet(tb)
    assert tb.materialize_docs(counter(tb, tf)) == [{'c': 100}]
    tf = _fleet(tb, doc_capacity=2, key_capacity=2, actor_slot_capacity=1)
    assert tb.materialize_docs(renumber_beyond_capacity(tb, tf)) == \
        [{'x': 9, 'y': 1}]
    assert tuple(tf.reg_state.reg.shape) == (2, 4, 2)
    tf = _fleet(tb)
    assert tb.materialize_docs(turbo_after_lazy_exact(tb, tf)) == [{}]
    tf = _fleet(tb)
    assert tb.materialize_docs(negative_inc(tb, tf)) == [{'c': 9}]


# ---- a small seam ---------------------------------------------------------

N_DOCS, N_KEYS, N_CHANGES = 12, 8, 10


def _seam_batches(seed=3):
    """Per-doc change lists: even docs two concurrent actors (each step's
    two changes merged by the next), odd docs one chain; sets of ints,
    strings and counters, incs (negative too) and deletes. A second
    batch from an actor that sorts first sets two keys, pred'ing what
    stands there."""
    rng = np.random.default_rng(seed)
    batch1, batch2 = [], []
    for d in range(N_DOCS):
        vis, heads, seqs, start = {}, [], {}, 1
        changes = []
        step = 0
        while len(changes) < N_CHANGES:
            actors = ACTORS[:2] if d % 2 == 0 and step else ACTORS[:1]
            made = []
            for actor in actors:
                key = f'k{int(rng.integers(0, N_KEYS))}'
                roll = rng.random()
                cur = sorted(vis.get(key, set()))
                if step == 0:
                    key, op = 'ctr', _set('ctr', 5, datatype='counter')
                elif roll < 0.2 and vis.get('ctr'):
                    key = 'ctr'
                    op = {'action': 'inc', 'obj': '_root', 'key': 'ctr',
                          'value': int(rng.integers(-9, 10)),
                          'pred': sorted(vis['ctr'])}
                elif roll < 0.35 and cur:
                    op = {'action': 'del', 'obj': '_root', 'key': key,
                          'pred': cur}
                elif roll < 0.5:
                    op = _set(key, f's{int(rng.integers(0, 50))}', cur,
                              datatype=None)
                else:
                    op = _set(key, int(rng.integers(1, 1 << 20)), cur)
                seqs[actor] = seqs.get(actor, 0) + 1
                buf = change_buf(actor, seqs[actor], start, [op],
                                 deps=heads)
                made.append((actor, buf, op, key))
            for actor, buf, op, key in made:
                oid = f'{start}@{actor}'
                if op['action'] != 'inc':
                    v = vis.setdefault(key, set())
                    v.difference_update(op['pred'])
                    if op['action'] == 'set':
                        v.add(oid)
                changes.append(buf)
            start += 1
            heads = sorted(decode_change(b)['hash'] for _a, b, _o, _k in made)
            step += 1
        batch1.append(changes)
        extra = []
        for j in range(2):
            key = 'k0' if j else f'k{int(rng.integers(1, N_KEYS))}'
            buf = change_buf(ACTORS[3], j + 1, start,
                             [_set(key, j + 7, sorted(vis.get(key, ())))],
                             deps=heads)
            vis[key] = {f'{start}@{ACTORS[3]}'}
            heads = [decode_change(buf)['hash']]
            start += 1
            extra.append(buf)
        batch2.append(extra)
    return batch1, batch2


BATCH1, BATCH2 = _seam_batches()


def _seam(batches):
    def seam(be, fleet):
        handles = be.init_docs(N_DOCS, fleet)
        for batch in batches:
            handles, patches = be.apply_changes_docs(handles, batch,
                                                     mirror=False)
            assert all(p is None for p in patches)
        return handles
    return seam


SEAM = dict(doc_capacity=N_DOCS, key_capacity=N_KEYS + 1)


def test_exact_seam_first_batch_matches_reference():
    """init_docs -> apply_changes_docs(mirror=False) on a fresh fleet."""
    tf, _th = _both(_seam([BATCH1]), **SEAM)
    assert tf.metrics.turbo_calls == 1 and tf.metrics.dispatches == 1


def test_exact_seam_two_batches_match_reference():
    """The second batch renumbers every actor lane."""
    before = register_kernel.LAUNCHES['register_scan']
    tf, th = _both(_seam([BATCH1, BATCH2]), **SEAM)
    assert tf.metrics.turbo_calls == 2 and tf.metrics.remaps == 1
    assert register_kernel.LAUNCHES['register_scan'] == before   # the CPU
    assert tf.reg_state.reg.device.type == 'cpu'


def test_exact_seam_mirror_path_matches_reference():
    """The same bytes through apply_changes_docs(mirror=True): the
    per-doc exact path, lazily flushed into the registers."""
    def seam(be, fleet):
        handles = be.init_docs(N_DOCS, fleet)
        handles, _ = be.apply_changes_docs(handles, BATCH1, mirror=True)
        return handles

    _both(seam, **SEAM)


def test_exact_fleet_without_a_device_needs_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tb.DocFleet(exact_device=True)
