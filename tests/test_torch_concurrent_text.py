"""Concurrent Text editing on the port's batched path: rounds in which
several actors each send a change from the doc's frontier (concurrent
branches, 3-way merges, first inserts tied at one referent) go through
`apply_changes_docs(..., mirror=False)` on a `DocFleet(device='cpu')`.
The native turbo gate accepts such a doc's run as a causal run (every
dep a start head or an earlier change of the run), keeps its sequence
rows on the turbo path, and writes its frontier into the fleet's head
lanes.

Every scenario runs the same wire bytes through the JAX package's
DocFleet too, whose linear-chain gate sends such calls to its exact
path, and the two fleets must agree: materialize_docs, sorted heads,
get_patch, save() bytes, the sequence rows' bookkeeping, every array of
every size-class pool, the rows' inexact flags, the value table, the
LWW grid and, in exact mode, the register arrays. The port's counters
say which path each call took. Texts are also held to the plain RGA
replay (`rga_text`, the benchmark's reference in
portbench/reference/text_rga.py, which imports nothing of the program)
and to the port's host backend (`automerge_tpu_torch.backend`). The
changes come from the benchmark's round generator
(portbench/gen/text_rounds.py) at 8 ops a change."""

import numpy as np
import pytest
import torch

import automerge_tpu.native as jax_native
import automerge_tpu_torch as A
from automerge_tpu.fleet import backend as jb
from automerge_tpu.fleet.loader import load_docs as jax_load_docs
from automerge_tpu_torch import backend as host
from automerge_tpu_torch import native, observability
from automerge_tpu_torch.columnar import decode_change_meta, encode_change
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import load_docs as torch_load_docs
from automerge_tpu_torch.fleet import seq_cases
from automerge_tpu_torch.fleet.registers import register_state_to_numpy
from automerge_tpu_torch.fleet.sequence import seq_state_to_numpy
from automerge_tpu_torch.fleet.tensor_doc import state_to_numpy
from automerge_tpu_torch.observability import spans
from portbench.gen.text_rounds import ACTOR_IDS, TextRounds
from portbench.reference.text_rga import rga_text

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason='a native codec is unavailable (the turbo path and the '
    'reference comparison need both)')

OPS = 8
JAX = (jb, jax_load_docs)
TORCH = (tb, torch_load_docs)


class Doc(TextRounds):
    """One Text doc's rounds at the tests' size, keeping every change in
    buffer (causal) order and every logical op."""

    def __init__(self, seed):
        super().__init__(seed, ops_per_change=OPS)
        self.changes, self.ops = [self.start()], []

    def _keep(self, made):
        self.changes += made[0]
        self.ops += made[1]
        return made[0]

    def next_round(self, **kw):
        return self._keep(self.round(**kw))

    def next_chain(self, k=1):
        return self._keep(self.chain(k))


def _key(op_id):
    ctr, actor = op_id.split('@', 1)
    return int(ctr), actor


def _saved(doc):
    return bytes(host.save(host.apply_changes(host.init(),
                                              list(doc.changes))[0]))


def _history(seed, rounds=16):
    """A doc of `rounds` concurrent rounds of 3 x OPS ops (384 at the
    default) after its makeText, with its saved bytes."""
    doc = Doc(seed)
    for _ in range(rounds):
        doc.next_round()
    doc.saved = _saved(doc)
    return doc


@pytest.fixture(scope='module')
def hub():
    """2 seeded ~400-op concurrent histories (3 heads each), saved."""
    return [_history(100 + g) for g in range(2)]


def _copy(doc):
    """An independent copy of `doc` with a fresh stream of edits."""
    out = Doc.__new__(Doc)
    out.__dict__.update({k: (list(v) if isinstance(v, list) else
                             dict(v) if isinstance(v, dict) else v)
                         for k, v in doc.__dict__.items()})
    out.rng = np.random.default_rng(int(doc.rng.integers(1 << 62)))
    return out


def _fleet(be, exact, n, key_capacity=4):
    kw = {'device': 'cpu'} if be is tb else {}
    return be.DocFleet(doc_capacity=n, key_capacity=key_capacity,
                       exact_device=exact, **kw)


def _replay(pkg, start, batches, exact, key_capacity, before):
    """`start`: saved bytes to load, or a doc count to init; then every
    batch through apply_changes_docs(mirror=False). Returns the fleet,
    the handles and each batch's counter deltas."""
    be, load = pkg
    n = start if isinstance(start, int) else len(start)
    fleet = _fleet(be, exact, n, key_capacity)
    handles = be.init_docs(n, fleet) if isinstance(start, int) else \
        load(list(start), fleet)
    deltas = []
    for i, per_doc in enumerate(batches):
        if before:
            before(i, fleet, handles)
        m0 = fleet.metrics.snapshot()
        handles, _ = be.apply_changes_docs(handles, per_doc, mirror=False)
        deltas.append(fleet.metrics.delta(m0))
    return fleet, handles, deltas


def _entry(boxed):
    return type(boxed).__name__, repr(boxed)


def _assert_same(jf, jh, tf, th):
    """Both fleets' documents and device state agree."""
    assert tb.materialize_docs(th) == jb.materialize_docs(jh)
    for a, b in zip(jh, th):
        assert sorted(b['heads']) == sorted(a['heads'])
        assert tb.get_patch(b) == jb.get_patch(a)
        assert bytes(tb.save(b)) == bytes(jb.save(a))
    # fallbacks, turbo_calls and mirror_rebuilds follow the path a call
    # took, which differs where the port keeps a causal run on its turbo
    # path; the tests assert the port's own
    m = ('promotions', 'remaps', 'docs_bulk_loaded')
    assert [getattr(tf.metrics, k) for k in m] == \
        [getattr(jf.metrics, k) for k in m]
    assert [_entry(x) for x in tf.value_table] == \
        [_entry(x) for x in jf.value_table]
    assert (tf.state is None) == (jf.state is None)
    if jf.state is not None:
        k = jf.key_cap
        for name, x, y in zip(('winners', 'values', 'counters'),
                              jf.state.tree_flatten()[0],
                              state_to_numpy(tf.state)):
            np.testing.assert_array_equal(y[:, :k], np.asarray(x)[:, :k],
                                          err_msg=name)
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


def _both(start, batches, exact=False, key_capacity=4, before=None):
    """Replay on both packages (`before(i, fleet, handles)` runs before
    the port's i-th batch only), compare, and return the port's fleet,
    handles and counter deltas a batch."""
    jf, jh, _ = _replay(JAX, start, batches, exact, key_capacity, None)
    tf, th, deltas = _replay(TORCH, start, batches, exact, key_capacity,
                             before)
    _assert_same(jf, jh, tf, th)
    return tf, th, deltas


def _check(handles, docs):
    """Texts and sorted heads against the RGA replay and the port's host
    backend."""
    got = tb.materialize_docs(handles)
    for h, g, doc in zip(handles, got, docs):
        assert g['t'] == rga_text(doc.ops)
        assert sorted(h['heads']) == sorted(doc.heads)
        ref, _ = A.apply_changes(A.init(), list(doc.changes))
        assert g['t'] == str(ref['t'])
        assert sorted(h['heads']) == host.get_heads(
            A.Frontend.get_backend_state(ref))


def _lanes(fleet, handles):
    """Each handle's (head_n, its lanes' hashes) in the head columns."""
    cols = fleet.doc_cols
    out = []
    for h in handles:
        slot = h['state']._impl.slot
        n = int(cols.head_n[slot])
        out.append((n, [row.tobytes().hex()
                        for row in cols.head32[slot][:max(n, 0)]]))
    return out


# Every hub scenario loads the same 2 docs and sends each at most 32 ops
# a batch, so the JAX package compiles for few shapes.

def test_load_writes_the_head_lanes(hub):
    fleet, handles, _ = _both([doc.saved for doc in hub], [])
    assert fleet.metrics.docs_bulk_loaded == 2
    assert _lanes(fleet, handles) == [(3, sorted(doc.heads)) for doc in hub]
    _check(handles, hub)


def _concurrent_rounds_stay_on_turbo(hub, exact):
    docs = [_copy(doc) for doc in hub]
    batches = [[doc.next_round() for doc in docs] for _ in range(2)]
    fleet, handles, deltas = _both([d.saved for d in hub], batches, exact)
    for d in deltas:
        assert d['fallbacks'] == 0 and d['turbo_calls'] == 1
        assert d['turbo_causal_docs'] == 2
        assert d['turbo_multihead_docs'] == 2 and d['turbo_drain_docs'] == 0
    assert _lanes(fleet, handles) == [(3, sorted(doc.heads))
                                      for doc in docs]
    if exact:
        assert fleet.metrics.mirror_rebuilds == 0
    _check(handles, docs)


def test_concurrent_rounds_stay_on_turbo(hub):
    _concurrent_rounds_stay_on_turbo(hub, False)


def test_concurrent_rounds_stay_on_turbo_exact(hub):
    _concurrent_rounds_stay_on_turbo(hub, True)


@pytest.mark.parametrize('where', ['head', 'referent'])
def test_ties_at_one_referent(hub, where):
    docs = [_copy(doc) for doc in hub]
    cursors = ['_head' if where == 'head' else d.alive[len(d.alive) // 2]
               for d in docs]
    batch = [doc.next_round(cursor=c, deletes=False)
             for doc, c in zip(docs, cursors)]
    _fleet_, handles, (d,) = _both([doc.saved for doc in hub], [batch])
    assert d['fallbacks'] == 0 and d['turbo_causal_docs'] == 2
    # the three first inserts share a counter and a referent
    for doc, cur in zip(docs, cursors):
        firsts = doc.ops[-3 * OPS::OPS]
        assert {op[2] for op in firsts} == {None if cur == '_head' else cur}
        assert {_key(op[1])[0] for op in firsts} == {doc.max_op - OPS + 1}
    _check(handles, docs)


def test_three_way_merge_change(hub):
    docs = [_copy(doc) for doc in hub]
    # a merge of the 3 loaded heads and a chain after it, then branches,
    # their merge and its successor in one batch
    batches = [[doc.next_chain(k=3) for doc in docs],
               [doc.next_round() + doc.next_chain() for doc in docs]]
    _fleet_, handles, (d1, d2) = _both([d.saved for d in hub], batches)
    assert d1['fallbacks'] == 0 and d1['turbo_causal_docs'] == 0
    assert d2['fallbacks'] == 0 and d2['turbo_causal_docs'] == 2
    assert d2['turbo_multihead_docs'] == 0
    assert all(len(h['heads']) == 1 for h in handles)
    _check(handles, docs)


def test_mixed_batch_of_chain_and_concurrent_docs(hub):
    docs = [_copy(doc) for doc in hub]
    batch = [doc.next_chain(k=3) if i % 2 else doc.next_round()
             for i, doc in enumerate(docs)]
    _fleet_, handles, (d,) = _both([doc.saved for doc in hub], [batch])
    assert d['fallbacks'] == 0 and d['turbo_calls'] == 1
    assert d['turbo_causal_docs'] == 1 and d['turbo_multihead_docs'] == 1
    _check(handles, docs)


def _map_change(actor, seq, start, deps, key, value):
    buf = encode_change({'actor': actor, 'seq': seq, 'startOp': start,
                         'time': 0, 'message': '', 'deps': sorted(deps),
                         'ops': [{'action': 'set', 'obj': '_root',
                                  'key': key, 'value': value,
                                  'pred': []}]})
    return buf, decode_change_meta(buf, True)['hash']


def _map_round():
    a, b, c = ACTOR_IDS[:3]
    c0, h0 = _map_change(a, 1, 1, [], 'x', 1)
    # two concurrent sets of one key, then a merge setting another
    ca, ha = _map_change(a, 2, 2, [h0], 'k', 'a')
    cb, hb = _map_change(b, 1, 2, [h0], 'k', 'b')
    cm, hm = _map_change(c, 1, 3, [ha, hb], 'm', 3)
    return c0, ca, cb, cm, hm


def test_concurrent_map_batch_unchanged():
    c0, ca, cb, cm, _hm = _map_round()
    batches = [[[c0]] * 4, [[ca, cb], [ca, cb, cm], [cb], []]]
    _fleet_, handles, (_, d) = _both(4, batches, key_capacity=8)
    assert d['fallbacks'] == 0 and d['turbo_drain_docs'] == 0
    assert d['turbo_causal_docs'] == 2 and d['turbo_multihead_docs'] == 1
    for h, changes in zip(handles, [[c0, ca, cb], [c0, ca, cb, cm],
                                    [c0, cb], [c0]]):
        hbk, _ = host.apply_changes(host.init(), changes)
        assert sorted(h['heads']) == sorted(host.get_heads(hbk))
        assert tb.get_patch(h) == host.get_patch(hbk)
    assert tb.materialize_docs(handles)[1] == {'x': 1, 'k': 'b', 'm': 3}


@pytest.mark.parametrize('kind', ['text', 'map'])
def test_out_of_order_delivery_queues_then_drains(hub, kind):
    if kind == 'text':
        docs = [_copy(doc) for doc in hub]
        r1 = [d.next_round() for d in docs]
        r2 = [d.next_chain() for d in docs]
        # doc 0: the next change before this round (out of order); doc
        # 1: the next change alone (its deps are missing: queued), then
        # its missing round
        batches = [[r2[0] + r1[0], r2[1]], [[], r1[1]]]
        _fleet_, handles, (d, _) = _both([doc.saved for doc in hub],
                                         batches)
        assert d['fallbacks'] == 1    # the exact path for the whole call
        _check(handles, docs)
        return
    c0, ca, cb, cm, hm = _map_round()
    batches = [[[cm, c0, ca], [c0, ca, cb]], [[cb], [cm]]]
    _fleet_, handles, (d, _) = _both(2, batches, key_capacity=8)
    # doc 0 goes to the host's gate: cm waits in its queue
    assert d['fallbacks'] == 0 and d['turbo_drain_docs'] == 1
    assert d['turbo_causal_docs'] == 1
    hbk, _ = host.apply_changes(host.init(), [c0, ca, cb, cm])
    for h in handles:
        assert sorted(h['heads']) == [hm] == host.get_heads(hbk)
        assert tb.get_patch(h) == host.get_patch(hbk)


def _wide(hub):
    """Copies of the hub docs and a batch of five concurrent branches (of
    6 ops, 30 a doc): an end frontier past the lanes."""
    docs = [_copy(doc) for doc in hub]
    wide = ACTOR_IDS[:tb._DocCols.HEAD_LANES + 1]
    return docs, [doc.next_round(actors=wide, n=6) for doc in docs]


def test_frontier_wider_than_the_lanes(hub):
    # goes to the host as before (the whole call, since it holds text),
    # and leaves the lanes unused (head_n -1)
    docs, batch = _wide(hub)
    fleet, handles, (d,) = _both([d.saved for d in hub], [batch])
    assert d['fallbacks'] == 1 and d['turbo_causal_docs'] == 0
    assert _lanes(fleet, handles) == [(-1, [])] * 2
    assert all(len(h['heads']) == 5 for h in handles)
    _check(handles, docs)


def test_wide_frontier_then_a_merge_and_a_round(hub):
    # a merge of the five heads and its successors (the chain shape,
    # checked on the host), then a round from the one head
    docs, batch = _wide(hub)
    batches = [batch, [doc.next_chain(k=3) for doc in docs],
               [doc.next_round() for doc in docs]]
    fleet, handles, (_, d2, d3) = _both([d.saved for d in hub], batches)
    assert d2['fallbacks'] == 0 and d2['turbo_calls'] == 1
    assert d2['turbo_causal_docs'] == 0
    assert d3['fallbacks'] == 0 and d3['turbo_causal_docs'] == 2
    assert _lanes(fleet, handles) == [(3, sorted(doc.heads))
                                      for doc in docs]
    _check(handles, docs)


def _loaded_concurrent_history_then_a_round(hub, exact):
    docs = [_copy(doc) for doc in hub]
    _fleet_, handles, (d,) = _both(
        [d.saved for d in hub], [[doc.next_round() for doc in docs]], exact)
    assert d['fallbacks'] == 0 and d['turbo_causal_docs'] == 2
    _check(handles, docs)
    assert [bytes(tb.save(h)) for h in handles] == [
        bytes(host.save(host.apply_changes(host.init(), doc.changes)[0]))
        for doc in docs]


def test_loaded_concurrent_history_then_a_round(hub):
    _loaded_concurrent_history_then_a_round(hub, False)


def test_loaded_concurrent_history_then_a_round_exact(hub):
    _loaded_concurrent_history_then_a_round(hub, True)


def test_counters_and_spans(hub):
    docs = [_copy(doc) for doc in hub]
    batch = [docs[0].next_round() + docs[0].next_chain(),
             docs[1].next_chain(k=2)]

    def before(i, fleet, handles):
        observability.enable()
        spans.clear()
    try:
        _fleet_, handles, (d,) = _both([doc.saved for doc in hub],
                                       [batch], before=before)
        recs = {r['name']: r for r in spans.iter_spans()}
    finally:
        observability.disable()
    assert d['turbo_causal_docs'] == 1 and d['turbo_drain_docs'] == 0
    assert d['turbo_multihead_docs'] == 0 and d['fallbacks'] == 0
    attrs = recs['turbo_causal']['attrs']
    # every change of a round merges the 3 loaded heads, as do a
    # chain's first change and the change after a round
    assert attrs == {'chain': 1, 'causal': 1, 'host': 0, 'merges': 5,
                     'wide': 0}
    assert recs['turbo_drain']['attrs'] == {'docs': 0}
    assert recs['turbo_heads']['attrs'] == {'multi': 0}
    gate = recs['turbo_gate']
    for name in ('turbo_causal', 'turbo_drain'):
        assert gate['t0_ns'] <= recs[name]['t0_ns'] <= \
            recs[name]['t1_ns'] <= gate['t1_ns']
    _check(handles, docs)
