"""Differential tests of the fleet backend seam: the same wire bytes go
through the JAX package's DocFleet and the torch port's (device='cpu'),
and the results must agree exactly — materialize_docs, byte-identical
save(), identical int32 grids on the real key columns, identical
dispatch counts and identical quarantine verdicts.

The workload: 48 docs x 40 keys x 20 changes; even docs carry two
concurrent actors (every step two concurrent changes, merged by the
next step), odd docs a single-actor chain. Ops are overwriting sets
(ints and strings), counter sets with incs (negative deltas too) and
deletes. A second batch adds keys past the grid's capacity (the grid
grows) and an actor that sorts before the others (actors renumber)."""

import numpy as np
import pytest
import torch

import automerge_tpu.native as jax_native
from automerge_tpu.columnar import decode_change_meta, encode_change
from automerge_tpu.errors import MalformedChange
from automerge_tpu.fleet import backend as jax_backend
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch.fleet import backend as torch_backend
from automerge_tpu_torch.fleet.merge_kernel import LAUNCHES
from automerge_tpu_torch.fleet.tensor_doc import (state_from_numpy,
                                                  state_to_numpy)

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


# Build both native codecs here, at import (collection time), so the
# ~15 s g++ builds are not charged to a test family's time budget. The
# reference's codec builds in place without a lock, so a worker that
# loads it while another is still linking it finds no codec: the
# reference side then takes its exact path and nothing compares, so
# the module skips, as the reference's own native tests do.
_NATIVE_OK = torch_native.available() and jax_native.available()

N_DOCS, N_KEYS, N_CHANGES = 48, 40, 20
A, B, C = 'aa' * 16, 'bb' * 16, '00' * 16


class _DocWriter:
    """Encodes one document's changes with exact preds/deps/startOps."""

    def __init__(self):
        self.visible = {}          # key -> set of visible op ids
        self.heads = []
        self.max_op = 0
        self.seq = {}

    def change(self, actor, ops_spec, rng):
        start = self.max_op + 1
        ops = []
        for i, (action, key, value) in enumerate(ops_spec):
            pred = sorted(self.visible.get(key, ()))
            op = {'action': action, 'obj': '_root', 'key': key,
                  'pred': pred}
            if action == 'set':
                op['value'] = value
                if isinstance(value, int):
                    op['datatype'] = 'counter' if key == 'ctr' else 'int'
            elif action == 'inc':
                op['value'] = value
                op['datatype'] = 'counter'
            ops.append(op)
        self.seq[actor] = self.seq.get(actor, 0) + 1
        buf = encode_change({
            'actor': actor, 'seq': self.seq[actor], 'startOp': start,
            'time': 0, 'message': '', 'deps': list(self.heads),
            'ops': ops})
        return buf, start, ops

    def commit(self, actor, start, ops):
        for i, op in enumerate(ops):
            oid = f'{start + i}@{actor}'
            if op['action'] == 'inc':
                continue             # incs never hide the counter
            vis = self.visible.setdefault(op['key'], set())
            vis.difference_update(op['pred'])
            if op['action'] == 'set':
                vis.add(oid)
        self.max_op = max(self.max_op, start + len(ops) - 1)


def _ops(rng, step, key_lo, key_hi, writer):
    roll = rng.random()
    key = f'k{int(rng.integers(key_lo, key_hi))}'
    if step == 0:
        return [('set', 'ctr', 5), ('set', key, int(rng.integers(1, 1000)))]
    if roll < 0.2 and writer.visible.get('ctr'):
        return [('inc', 'ctr', int(rng.integers(-9, 10)))]
    if roll < 0.3 and writer.visible.get(key):
        return [('del', key, None)]
    if roll < 0.4:
        return [('set', key, f's{int(rng.integers(0, 50))}')]
    return [('set', key, int(rng.integers(1, 1 << 20)))]


def _workload(seed=0):
    """(batch1, batch2, writers): per-doc change lists."""
    rng = np.random.default_rng(seed)
    writers = [_DocWriter() for _ in range(N_DOCS)]
    batch1 = [[] for _ in range(N_DOCS)]
    for d, w in enumerate(writers):
        concurrent = d % 2 == 0
        step = 0
        while len(batch1[d]) < N_CHANGES:
            actors = (A, B) if concurrent and step > 0 else (A,)
            made = []
            for actor in actors:
                buf, start, ops = w.change(actor, _ops(rng, step, 0, N_KEYS,
                                                       w), rng)
                made.append((actor, buf, start, ops))
            for actor, buf, start, ops in made:
                w.commit(actor, start, ops)
                batch1[d].append(buf)
            w.heads = sorted(decode_change_meta(buf, True)['hash']
                             for _a, buf, _s, _o in made)
            step += 1
    batch2 = [[] for _ in range(N_DOCS)]
    for d, w in enumerate(writers):
        for _ in range(2):
            key = f'k{int(rng.integers(N_KEYS, 3 * N_KEYS))}'
            buf, start, ops = w.change(
                C, [('set', key, int(rng.integers(1, 1000)))], rng)
            w.commit(C, start, ops)
            w.heads = [decode_change_meta(buf, True)['hash']]
            batch2[d].append(buf)
    return batch1, batch2


BATCH1, BATCH2 = _workload()


def _fleets():
    jf = jax_backend.DocFleet(doc_capacity=N_DOCS, key_capacity=N_KEYS + 1)
    tf = torch_backend.DocFleet(doc_capacity=N_DOCS,
                                key_capacity=N_KEYS + 1, device='cpu')
    return (jf, jax_backend.init_docs(N_DOCS, jf),
            tf, torch_backend.init_docs(N_DOCS, tf))


def _grids_equal(jf, tf):
    jw = [np.asarray(a) for a in (jf.state.winners, jf.state.values,
                                  jf.state.counters)]
    tw = state_to_numpy(tf.state)
    for name, a, b in zip(('winners', 'values', 'counters'), jw, tw):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b[:, :-1], a[:, :-1], err_msg=name)


def _assert_same(jf, jh, tf, th):
    assert torch_backend.materialize_docs(th) == \
        jax_backend.materialize_docs(jh)
    for a, b in zip(jh, th):
        assert bytes(b['state'].save()) == bytes(a['state'].save())
        assert b['heads'] == a['heads']
    _grids_equal(jf, tf)
    assert tf.metrics.dispatches == jf.metrics.dispatches
    assert tf.grid_overflow == jf.grid_overflow
    assert tf.del_fallback == jf.del_fallback


pytestmark = pytest.mark.skipif(
    not _NATIVE_OK, reason='a native codec is unavailable (the turbo path '
    'and the reference comparison need both)')


def test_turbo_seam_two_batches_match_reference():
    jf, jh, tf, th = _fleets()
    for batch in (BATCH1, BATCH2):
        jh, jp = jax_backend.apply_changes_docs(jh, batch, mirror=False)
        th, tp = torch_backend.apply_changes_docs(th, batch, mirror=False)
        assert tp == jp
    assert tf.metrics.grows == jf.metrics.grows >= 1
    assert tf.metrics.remaps == jf.metrics.remaps >= 1
    assert tf.metrics.turbo_calls == jf.metrics.turbo_calls == 2
    _assert_same(jf, jh, tf, th)


def test_exact_path_matches_reference():
    jf, jh, tf, th = _fleets()
    jh, jp = jax_backend.apply_changes_docs(jh, BATCH1, mirror=True)
    th, tp = torch_backend.apply_changes_docs(th, BATCH1, mirror=True)
    assert tp == jp
    _assert_same(jf, jh, tf, th)


def test_quarantine_rejects_only_the_poisoned_doc():
    jf, jh, tf, th = _fleets()
    poisoned = [list(c) for c in BATCH1]
    bad = bytearray(poisoned[5][3])
    bad[10] ^= 0xFF
    poisoned[5][3] = bytes(bad)
    jh, _jp, jerr = jax_backend.apply_changes_docs(
        jh, poisoned, mirror=False, on_error='quarantine')
    th, _tp, terr = torch_backend.apply_changes_docs(
        th, poisoned, mirror=False, on_error='quarantine')
    assert [e is None for e in terr] == [e is None for e in jerr]
    assert terr[5] is not None and terr[5].stage == jerr[5].stage
    assert type(terr[5].error).__name__ == type(jerr[5].error).__name__ \
        == MalformedChange.__name__
    _assert_same(jf, jh, tf, th)


def test_state_from_numpy_carries_a_grid_across():
    """Both fleets start batch 2 from the SAME non-empty grid: the
    reference's state after batch 1, moved into the port's fleet with
    state_from_numpy."""
    jf, jh, tf, th = _fleets()
    jh, _ = jax_backend.apply_changes_docs(jh, BATCH1, mirror=False)
    th, _ = torch_backend.apply_changes_docs(th, BATCH1, mirror=False)
    tf.state = state_from_numpy(
        *(np.asarray(a) for a in (jf.state.winners, jf.state.values,
                                  jf.state.counters)), device='cpu')
    jh, _ = jax_backend.apply_changes_docs(jh, BATCH2, mirror=False)
    th, _ = torch_backend.apply_changes_docs(th, BATCH2, mirror=False)
    _grids_equal(jf, tf)


def test_text_documents_raise_not_implemented():
    """Text documents were a later slice of the port and raised here; they
    now apply on both paths in both device modes and read as the
    reference reads them (tests/test_torch_text_seam.py holds them to the
    reference in depth)."""
    text = encode_change({
        'actor': A, 'seq': 1, 'startOp': 1, 'time': 0, 'message': '',
        'deps': [], 'ops': [{'action': 'makeText', 'obj': '_root',
                             'key': 't', 'pred': []}]})
    for exact in (False, True):
        for mirror in (False, True):
            docs = []
            for be, kw in ((jax_backend, {}), (torch_backend,
                                               {'device': 'cpu'})):
                fleet = be.DocFleet(exact_device=exact, **kw)
                handles = be.init_docs(2, fleet)
                handles, _ = be.apply_changes_docs(handles, [[text], []],
                                                   mirror=mirror)
                docs.append(be.materialize_docs(handles))
            assert docs[1] == docs[0] == [{'t': ''}, {}]


def test_cpu_seam_launches_no_kernel():
    before = LAUNCHES['lww_merge']
    _jf, _jh, tf, th = _fleets()
    torch_backend.apply_changes_docs(th, BATCH1, mirror=False)
    assert LAUNCHES['lww_merge'] == before
    assert tf.state.winners.device.type == 'cpu'
    assert tf.state.winners.dtype == torch.int32
