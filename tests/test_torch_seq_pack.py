"""The sequence dispatch's pack (`DocFleet._dispatch_seq`) against the
sort-based pack it replaced, kept here as `_sorting_pack`.

The dispatch now lays ops out by their input's row runs: one vectorised
class check places the rows (only fresh and outgrown rows take
`_place_seq_row`), and each size class's `SeqOpBatch` is written by one
flat destination index, with a stable sort of the runs only when a row
has two of them. Every scenario runs twice on fresh CPU fleets, once as
the program is and once with `_sorting_pack` as the dispatch's body, fed
the op-tuple matrix the turbo stage used to build. Every `SeqOpBatch`
handed to the scan, the rows' `seq_place` and `seq_len`, the pools' free
lists, high-water marks, growths and arrays, and the texts must be the
same, and the scenario must advance the `seq_pack_grouped` /
`seq_pack_sorted` counters as stated."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch import native
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import seq_cases, sequence
from automerge_tpu_torch.fleet.sequence import SeqPools, seq_state_to_numpy
from portbench.gen.text_rounds import TextRounds

torch.set_num_threads(1)

A, B = 'aa' * 16, 'bb' * 16

needs_codec = pytest.mark.skipif(
    not native.available(),
    reason='the turbo path needs the native codec')


def _sorting_pack(self, seq_ops, ps):
    """The dispatch's body before run packing: op tuples [M, 6 + D] in
    apply order, rows found by np.unique, two per-row placement passes,
    then a stable argsort of every op and 2-D fancy-index scatters."""
    from automerge_tpu_torch.fleet.sequence import (
        SeqOpBatch, apply_seq_batch_donated, INSERT, SEQ_PRED_LANES)
    ps.mark('seq_place')
    migrations = self.metrics.seq_migrations
    self.seq_pools.ensure_lanes(self._seq_lane_width())
    D = SEQ_PRED_LANES
    arr = np.asarray(seq_ops, dtype=np.int64)
    row_a = arr[:, 0]
    n_rows = len(self.seq_rows)
    counts = np.bincount(row_a, minlength=n_rows)
    ins = np.bincount(row_a[arr[:, 1] == INSERT], minlength=n_rows)
    pools = self.seq_pools
    lanes = self._seq_lane_width()
    uniq_rows = [int(r) for r in np.unique(row_a)]
    new_by_cls = {}
    for row in uniq_rows:
        need_cls = self._seq_need(row, self.seq_len[row] + int(ins[row]))
        place = self.seq_place[row]
        if place is None or need_cls > place[0]:
            new_by_cls[need_cls] = new_by_cls.get(need_cls, 0) + 1
    for cls, count in new_by_cls.items():
        pools.reserve(cls, count, lanes)
    cls_of = {}
    for row in uniq_rows:
        cls_of[row], _ = self._place_seq_row(
            row, self.seq_len[row] + int(ins[row]))
    ps.add(migrated=self.metrics.seq_migrations - migrations)
    by_cls = {}
    for row, cls in cls_of.items():
        by_cls.setdefault(cls, []).append(row)
    order = np.argsort(row_a, kind='stable')
    row_sorted = row_a[order]
    pos_in_row = np.arange(len(row_sorted)) - \
        np.searchsorted(row_sorted, row_sorted, side='left')
    for cls, rows in by_cls.items():
        ps.mark('seq_pack', rows=len(rows))
        st = self.seq_pools.state(cls)
        r_cap = st.elem_id.shape[0]
        sel = np.isin(row_sorted, rows)
        sub = order[sel]
        idx_of = np.zeros(n_rows, dtype=np.int64)
        for row in rows:
            idx_of[row] = self.seq_place[row][1]
        rows_idx = idx_of[row_sorted[sel]]
        pos = pos_in_row[sel]
        width = max(int(counts[rows].max()), 1)
        cols = {name: np.zeros((r_cap, width), dtype=np.int32)
                for name in ('kind', 'ref', 'packed', 'value')}
        preds = np.zeros((r_cap, width, D), dtype=np.int32)
        flag = np.zeros((r_cap, width), dtype=bool)
        for j, name in enumerate(('kind', 'ref', 'packed', 'value')):
            cols[name][rows_idx, pos] = arr[sub, j + 1]
        for d in range(D):
            preds[rows_idx, pos, d] = arr[sub, 5 + d]
        flag[rows_idx, pos] = arr[sub, 5 + D] != 0
        batch = SeqOpBatch(cols['kind'], cols['ref'], cols['packed'],
                           cols['value'], preds, flag)
        ps.mark('seq_copy')
        on_device = batch.to(self.device)
        ps.mark('seq_launch')
        apply_seq_batch_donated(st, on_device)
        self.metrics.dispatches += 1
    self.metrics.device_ops += len(seq_ops)


def _op_matrix(rows, lens, kind, ref, packed, value, preds, flag):
    """What the turbo stage handed the dispatch before: one int64 row an
    op, (row, kind, ref, packed, value, pred0..D-1, flag), in apply
    order."""
    n = len(kind)
    lanes = [np.zeros(n, np.int64) if p is None else p for p in preds]
    return np.stack([np.repeat(rows, lens), kind, ref, packed, value,
                     *lanes, flag], axis=1).astype(np.int64)


# the exact flushes hand the dispatch their op tuples through
# _SeqRuns.from_tuples: the sorting pack takes the tuples as they are
_op_matrix.from_tuples = lambda seq_ops: seq_ops


def _change(actor, seq, start, ops, deps=()):
    return encode_change({'actor': actor, 'seq': seq, 'startOp': start,
                          'time': 0, 'message': '', 'deps': sorted(deps),
                          'ops': ops})


def _ins(obj, elem, value):
    return {'action': 'set', 'obj': obj, 'elemId': elem, 'insert': True,
            'value': value, 'pred': []}


def _make(action, key):
    return {'action': action, 'obj': '_root', 'key': key, 'pred': []}


def _batch(handles, per_doc):
    return tb.apply_changes_docs(handles, per_doc, mirror=False)[0]


def _heads(buf):
    from automerge_tpu_torch.columnar import decode_change_meta
    return [decode_change_meta(buf, True)['hash']]


# ---- scenarios: (fleet kwargs, run(fleet) -> handles, (grouped, sorted))


def _text_trace(fleet):
    """Three docs of the benchmark's Text trace, then 64 ops each: one
    run a doc."""
    docs = [seq_cases.text_changes(40, more=(64,), seed=s) for s in range(3)]
    handles = tb.init_docs(3, fleet)
    for k in range(2):
        handles = _batch(handles, [d[k] for d in docs])
    return handles


def _concurrent_round(fleet):
    """A chain, then one round of 3 concurrent changes a doc (a causal
    run on the turbo path): a doc's 3 changes make one run."""
    docs = [TextRounds(seed=s, ops_per_change=8) for s in range(3)]
    handles = tb.init_docs(3, fleet)
    handles = _batch(handles,
                     [[d.start()] + d.chain(2)[0] for d in docs])
    return _batch(handles, [d.round()[0] for d in docs])


def _two_objects(actor, interleave):
    """A Text and a list in one doc, then one change of 8 inserts that
    alternate between them (or take them one object after the other)."""
    t, lst = f'1@{actor}', f'2@{actor}'
    first = _change(actor, 1, 1, [
        _make('makeText', 't'), _make('makeList', 'l'),
        _ins(t, '_head', 'a'), _ins(t, f'3@{actor}', 'b'),
        _ins(lst, '_head', 7), _ins(lst, f'5@{actor}', 8)])
    last = {t: f'4@{actor}', lst: f'6@{actor}'}
    ops = []
    for i, obj in enumerate([t, lst] * 4 if interleave else
                            [t] * 4 + [lst] * 4):
        ops.append(_ins(obj, last[obj], chr(99 + i) if obj == t else 9 + i))
        last[obj] = f'{7 + i}@{actor}'
    return first, _change(actor, 2, 7, ops, deps=_heads(first))


def _interleaved_objects(fleet):
    """Doc 0's second change alternates between its Text and its list,
    doc 1's takes them in turn: the runs repeat doc 0's rows, so the
    dispatch sorts them."""
    docs = [_two_objects(A, True), _two_objects(B, False)]
    handles = tb.init_docs(2, fleet)
    for k in range(2):
        handles = _batch(handles, [[d[k]] for d in docs])
    return handles


def _per_doc_tuples(fleet):
    """The per-doc API: each flush hands the dispatch an op-tuple list
    (`_flush_exact_mixed` in exact mode, `_flush_mixed` otherwise); doc
    0's interleaved change makes the list repeat its rows."""
    docs = [_two_objects(A, True), _two_objects(B, False)]
    handles = [tb.init(fleet) for _ in docs]
    for k in range(2):
        handles = [tb.apply_changes(h, [d[k]])[0]
                   for h, d in zip(handles, docs)]
        fleet.flush()
    return handles


def _fresh_rows(fleet):
    """Rows placed for the first time in an order other than the runs':
    doc 1 makes a Text with no inserts (a row with no placement) and doc 2
    one with an insert; doc 2 is freed, then doc 0 makes a Text (taking
    doc 2's row id) and doc 1 inserts, so the runs come in descending row
    order and both rows are fresh."""
    handles = tb.init_docs(3, fleet)
    t1, t2, t0 = f'1@{A}', f'1@{B}', f'1@{B}'
    empty = _change(A, 1, 1, [_make('makeText', 't')])
    handles = _batch(handles, [
        [], [empty],
        [_change(B, 1, 1, [_make('makeText', 't'), _ins(t2, '_head', 'x')])]])
    tb.free_docs([handles[2]])
    return _batch(handles[:2], [
        [_change(B, 1, 1, [_make('makeText', 't'), _ins(t0, '_head', 'y'),
                           _ins(t0, f'2@{B}', 'z')])],
        [_change(A, 2, 2, [_ins(t1, '_head', 'q'), _ins(t1, f'2@{A}', 'r'),
                           _ins(t1, f'3@{A}', 's')], deps=_heads(empty))]])


def _migration(fleet):
    """Doc 0's second batch moves its row up a size class while doc 1's
    stays: two classes packed in one dispatch."""
    docs = [seq_cases.text_changes(40, more=(160,), seed=0),
            seq_cases.text_changes(40, more=(4,), seed=1)]
    handles = tb.init_docs(2, fleet)
    for k in range(2):
        handles = _batch(handles, [d[k] for d in docs])
    return handles


SCENARIOS = {
    'text_trace': ({}, _text_trace, (2, 0)),
    'concurrent_round': ({}, _concurrent_round, (2, 0)),
    'interleaved_objects': ({}, _interleaved_objects, (1, 1)),
    'exact_tuples': ({'exact_device': True}, _per_doc_tuples, (1, 1)),
    'mixed_tuples': ({}, _per_doc_tuples, (1, 1)),
    'fresh_rows': ({}, _fresh_rows, (2, 0)),
    'migration': ({}, _migration, (2, 0)),
}


def _run(monkeypatch, kw, scenario, reference):
    """Run `scenario` on a fresh CPU fleet; returns the fleet, its
    handles and every SeqOpBatch handed to the scan, as numpy."""
    captured = []
    apply = sequence.apply_seq_batch_donated

    def capture(state, batch):
        captured.append([np.array(c) for c in batch.columns()])
        return apply(state, batch)

    with monkeypatch.context() as m:
        m.setattr(sequence, 'apply_seq_batch_donated', capture)
        if reference:
            m.setattr(tb.DocFleet, '_dispatch_seq_phases', _sorting_pack)
            m.setattr(tb, '_SeqRuns', _op_matrix)
        fleet = tb.DocFleet(doc_capacity=4, key_capacity=8, device='cpu',
                            **kw)
        handles = scenario(fleet)
        texts = tb.materialize_docs(handles)
    return fleet, texts, captured


@needs_codec
@pytest.mark.parametrize('name', list(SCENARIOS))
def test_pack_matches_the_sorting_pack(monkeypatch, name):
    kw, scenario, (grouped, sorted_) = SCENARIOS[name]
    got, got_texts, got_batches = _run(monkeypatch, kw, scenario, False)
    ref, ref_texts, ref_batches = _run(monkeypatch, kw, scenario, True)
    assert got_batches and len(got_batches) == len(ref_batches)
    for g, r in zip(got_batches, ref_batches):
        for x, y in zip(g, r):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
    assert got_texts == ref_texts
    assert got.seq_rows == ref.seq_rows
    assert got.seq_place == ref.seq_place and got.seq_len == ref.seq_len
    gp, rp = got.seq_pools, ref.seq_pools
    assert (gp.free, gp.used, gp.grow_events) == \
        (rp.free, rp.used, rp.grow_events)
    assert list(gp.pools) == list(rp.pools)
    for cls in rp.pools:
        for name_, x, y in zip(seq_cases.NAMES,
                               seq_state_to_numpy(gp.pools[cls]),
                               seq_state_to_numpy(rp.pools[cls])):
            np.testing.assert_array_equal(x, y,
                                          err_msg=f'class {cls} {name_}')
    m = got.metrics
    assert (m.seq_pack_grouped, m.seq_pack_sorted) == (grouped, sorted_)
    assert m.dispatches == ref.metrics.dispatches
    assert m.device_ops == ref.metrics.device_ops
    assert m.seq_migrations == ref.metrics.seq_migrations


@pytest.mark.parametrize('base', [1, 4, 64])
def test_cls_for_many_matches_cls_for(base):
    pools = SeqPools(base_capacity=base)
    caps = np.array([1, base - 1, base, base + 1, 2 * base, 2 * base + 1,
                     1000, 16387, 1 << 20], dtype=np.int64)
    caps = caps[caps > 0]
    assert pools.cls_for_many(caps).tolist() == \
        [pools.cls_for(int(c)) for c in caps]
