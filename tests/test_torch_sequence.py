"""The port's sequence engine (automerge_tpu_torch/fleet/sequence.py and
seq_kernel.py, the plain version of the scan on the CPU) against the JAX
package's (automerge_tpu/fleet/sequence.py, jit on the CPU): the same
seeded numpy inputs through both, compared exactly — all eight SeqState
arrays and the applied count after every batch, then element_visibility,
linearize, materialize, visible_text and element_conflicts, and the
SeqPools bookkeeping (grow, reserve, copy, release, migrate, lane growth).

The scenarios: every shape of the reference's TestRGAOrdering and
TestCounterSumOverflow (tests/test_sequence.py), one document each; the
corner inputs of fleet/seq_cases.py that the card tests and chip_smoke.py
hand the kernel; and seeded text-editing traces (the text seam's
generator at a small size, with concurrent head inserts).

Each JAX shape compiles once (~1.5 s on one CPU), so the scenarios of one
family share one padded shape: the corners one batch of one document
each, the cases one (docs, capacity, A, P) shape per lane width."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from automerge_tpu.fleet import sequence as js
from automerge_tpu_torch.fleet import seq_cases as sc
from automerge_tpu_torch.fleet import seq_kernel
from automerge_tpu_torch.fleet import sequence as ts

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


A1, A2, A3 = '01234567', '89abcdef', 'fedcba98'


def _jax_state(arrays):
    return js.SeqState(*(jnp.asarray(a) for a in arrays))


def _jax_batch(batch):
    return js.SeqOpBatch(*(jnp.asarray(c) for c in batch.columns()))


def _assert_state_equal(jstate, tstate, what=''):
    for name, a, b in zip(sc.NAMES, jstate.tree_flatten()[0],
                          ts.seq_state_to_numpy(tstate)):
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=f'{what}: {name}')


def _apply_both(arrays, batches, what=''):
    """Apply each batch in turn on both engines from the same arrays;
    compare every array and the applied count after each. Returns the two
    final states."""
    jst = _jax_state(arrays)
    tst = ts.seq_state_from_numpy(*arrays, device='cpu')
    for i, batch in enumerate(batches):
        jst, jn = js.apply_seq_batch(jst, _jax_batch(batch))
        tst, tn = ts.apply_seq_batch(tst, batch.to('cpu'))
        assert int(tn) == int(jn), f'{what} batch {i}: applied count'
        _assert_state_equal(jst, tst, f'{what} batch {i}')
    return jst, tst


def _reads_equal(jst, tst):
    for a, b in zip(js.element_visibility(jst), ts.element_visibility(tst)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    (jp, jn), (tp, tn) = js.linearize(jst), ts.linearize(tst)
    n = np.asarray(jn)
    node = np.arange(jp.shape[1])
    alloc = (node >= js.SLOT0) & (node < js.SLOT0 + n[:, None])
    # positions are defined on the allocated slots only
    np.testing.assert_array_equal(np.where(alloc, tp.numpy(), 0),
                                  np.where(alloc, np.asarray(jp), 0))
    np.testing.assert_array_equal(tn.numpy(), n)
    for a, b in zip(js.materialize(jst), ts.materialize(tst)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ts.visible_text(tst) == js.visible_text(jst)
    for row in range(jst.elem_id.shape[0]):
        assert ts.element_conflicts(tst, row) == \
            js.element_conflicts(jst, row)


# ---- tests/test_sequence.py's TestRGAOrdering corners ----------------------

def ins(ref, op_id, ch):
    return {'kind': 'insert', 'ref': ref, 'id': op_id, 'value': ord(ch)}


def _set(target, op_id, ch, pred=None):
    op = {'kind': 'set', 'target': target, 'id': op_id, 'value': ord(ch)}
    if pred is not None:
        op['pred'] = pred
    return op


def _del(target, op_id, pred=None):
    op = {'kind': 'del', 'target': target, 'id': op_id}
    if pred is not None:
        op['pred'] = pred
    return op


CORNERS = {
    'typewriter': ([ins('_head', f'2@{A1}', 'h'),
                    ins(f'2@{A1}', f'3@{A1}', 'i')], 'hi'),
    'same_position_concurrent': ([ins('_head', f'2@{A1}', 'a'),
                                  ins(f'2@{A1}', f'3@{A1}', 'c'),
                                  ins(f'2@{A1}', f'3@{A2}', 'b')], 'abc'),
    'head_concurrent': ([ins('_head', f'2@{A1}', 'd'),
                         ins('_head', f'3@{A1}', 'c'),
                         ins('_head', f'3@{A2}', 'a'),
                         ins(f'3@{A2}', f'4@{A2}', 'b')], 'abcd'),
    'delete': ([ins('_head', f'2@{A1}', 'h'), ins(f'2@{A1}', f'3@{A1}', 'x'),
                ins(f'3@{A1}', f'4@{A1}', 'i'), _del(f'3@{A1}', f'5@{A1}')],
               'hi'),
    'set_updates_value': ([ins('_head', f'2@{A1}', 'a'),
                           ins(f'2@{A1}', f'3@{A1}', 'b'),
                           _set(f'3@{A1}', f'4@{A1}', 'B')], 'aB'),
    'insert_after_deleted_elem': ([ins('_head', f'2@{A1}', 'a'),
                                   _del(f'2@{A1}', f'3@{A1}'),
                                   ins(f'2@{A1}', f'4@{A1}', 'b')], 'b'),
    'concurrent_sets_keep_both': ([ins('_head', f'2@{A1}', 'a'),
                                   _set(f'2@{A1}', f'3@{A1}', 'X',
                                        [f'2@{A1}']),
                                   _set(f'2@{A1}', f'3@{A2}', 'Y',
                                        [f'2@{A1}'])], 'Y'),
    'set_vs_del_resurrects': ([ins('_head', f'2@{A1}', 'a'),
                               _set(f'2@{A1}', f'3@{A1}', 'Z', [f'2@{A1}']),
                               _del(f'2@{A1}', f'3@{A2}', [f'2@{A1}'])], 'Z'),
    'del_vs_set_resurrects': ([ins('_head', f'2@{A1}', 'a'),
                               _del(f'2@{A1}', f'3@{A2}', [f'2@{A1}']),
                               _set(f'2@{A1}', f'3@{A1}', 'Z', [f'2@{A1}'])],
                              'Z'),
    'conflict_then_overwrite': ([ins('_head', f'2@{A1}', 'a'),
                                 _set(f'2@{A1}', f'3@{A1}', 'X', [f'2@{A1}']),
                                 _set(f'2@{A1}', f'3@{A2}', 'Y', [f'2@{A1}']),
                                 _set(f'2@{A1}', f'4@{A1}', 'R',
                                      [f'3@{A1}', f'3@{A2}'])], 'R'),
    'concurrent_dels_both_kill': ([ins('_head', f'2@{A1}', 'a'),
                                   ins(f'2@{A1}', f'3@{A1}', 'b'),
                                   _del(f'2@{A1}', f'4@{A1}', [f'2@{A1}']),
                                   _del(f'2@{A1}', f'4@{A2}', [f'2@{A1}'])],
                                  'b'),
    'self_overwrite_without_pred': ([ins('_head', f'2@{A1}', 'a'),
                                     _set(f'2@{A1}', f'3@{A1}', 'X',
                                          [f'2@{A1}']),
                                     _set(f'2@{A1}', f'4@{A1}', 'Y', [])],
                                    None),
}
INEXACT = {'self_overwrite_without_pred'}


# The corner-style scenarios share one padded JAX shape: N_PAD docs of
# capacity 64 (4 actor lanes), batches of P_PAD lanes.
N_PAD, CAP, P_PAD = 12, 64, 32


def _corner_state(n_docs=N_PAD, capacity=CAP, a=4):
    return sc.empty_arrays(n_docs, capacity, a)


def _padded(enc, per_doc):
    """per_doc's ops as one batch of [N_PAD, P_PAD] columns (trailing docs
    and lanes PAD)."""
    return enc.batch(list(per_doc) + [[]] * (N_PAD - len(per_doc)),
                     pad_to=P_PAD)


def test_rga_ordering_corners_match_jax():
    """Every TestRGAOrdering shape, one document each in one batch (actors
    A1, A2, A3), and the strings and flags the reference asserts."""
    enc = ts.SeqEncoder([A1, A2, A3])
    names = list(CORNERS)
    batch = _padded(enc, [CORNERS[k][0] for k in names])
    _jst, tst = _apply_both(_corner_state(), [batch], 'corners')
    text = ts.visible_text(tst)
    inexact = tst.inexact.numpy()
    for i, name in enumerate(names):
        assert bool(inexact[i]) == (name in INEXACT), name
        if CORNERS[name][1] is not None:
            assert text[i] == CORNERS[name][1], name
    conflicts = ts.element_conflicts(tst, names.index(
        'concurrent_sets_keep_both'))
    assert conflicts == {enc.pack(f'2@{A1}'): {
        enc.pack(f'3@{A1}'): ord('X'), enc.pack(f'3@{A2}'): ord('Y')}}
    pos, n = ts.linearize(tst)
    assert int(n[0]) == 2
    assert int(pos[0, ts.SLOT0]) == 0 and int(pos[0, ts.SLOT0 + 1]) == 1


def test_corner_reads_match_jax():
    """element_visibility, linearize, materialize, visible_text and
    element_conflicts of the corners' state, on both engines."""
    enc = ts.SeqEncoder([A1, A2, A3])
    batch = _padded(enc, [ops for ops, _text in CORNERS.values()])
    _reads_equal(*_apply_both(_corner_state(), [batch], 'corners'))


def test_incremental_batches_match_jax():
    """State carries across apply_seq_batch calls (TestRGAOrdering's
    incremental case, plus independent docs: one empty)."""
    enc = ts.SeqEncoder([A1, A2])
    b1 = _padded(enc, [[ins('_head', f'2@{A1}', 'a'),
                        ins(f'2@{A1}', f'3@{A1}', 'c')],
                       [ins('_head', f'2@{A1}', 'x')]])
    b2 = _padded(enc, [[ins(f'2@{A1}', f'3@{A2}', 'b')]])
    _jst, tst = _apply_both(_corner_state(), [b1, b2], 'incremental')
    assert ts.visible_text(tst)[:3] == ['abc', 'x', '']


def _counter_trace(deltas):
    ops = [ins('_head', f'2@{A1}', 'a')]
    for i, d in enumerate(deltas):
        ops.append({'kind': 'inc', 'ref': f'2@{A1}', 'id': f'{3 + i}@{A1}',
                    'value': d, 'pred': [f'2@{A1}']})
    return ops


def test_capacity_and_counter_corners_match_jax():
    """TestRGAOrdering's capacity overflow (6 inserts into 4 slots) and
    unknown target, and TestCounterSumOverflow's three traces, at
    capacity 4."""
    enc = ts.SeqEncoder([A1])
    overflow = [ins('_head' if i == 0 else f'{i + 1}@{A1}', f'{i + 2}@{A1}',
                    chr(ord('a') + i)) for i in range(6)]
    unknown = [ins('_head', f'2@{A1}', 'a'), _del(f'99@{A1}', f'3@{A1}'),
               ins(f'98@{A1}', f'4@{A1}', 'z')]
    traces = [overflow, unknown, _counter_trace([1 << 28, (1 << 28) - 1]),
              _counter_trace([1 << 28, 1 << 28]),
              _counter_trace([-(1 << 28), -(1 << 28)])]
    _jst, tst = _apply_both(_corner_state(5, 4),
                            [enc.batch(traces, pad_to=8)], 'capacity')
    assert ts.visible_text(tst)[:2] == ['abcd', 'a']
    assert tst.inexact.tolist() == [True, True, False, True, True]
    _vis, _win, _val, cnt = ts.element_visibility(tst)
    assert (1 << 29) - 1 in (cnt[2] >> 2).tolist()


def test_capacity_corner_counts_dropped_ops():
    """The applied counts the reference asserts: 4 of 6 inserts at
    capacity 4, 1 of 3 ops on an unknown target."""
    enc = ts.SeqEncoder([A1])
    overflow = [ins('_head' if i == 0 else f'{i + 1}@{A1}', f'{i + 2}@{A1}',
                    chr(ord('a') + i)) for i in range(6)]
    st = ts.SeqState.empty(1, 4)
    _, n = ts.apply_seq_batch(st, enc.batch([overflow]))
    assert int(n) == 4
    st = ts.SeqState.empty(1, 8)
    _, n = ts.apply_seq_batch(st, enc.batch([[
        ins('_head', f'2@{A1}', 'a'), _del(f'99@{A1}', f'3@{A1}'),
        ins(f'98@{A1}', f'4@{A1}', 'z')]]))
    assert int(n) == 1


def test_cyclic_chain_terminates_like_jax():
    """TestSequenceTermination: a cyclic nxt chain whose nodes all compare
    greater than the inserted id stops at the hop backstop."""
    arrays = _corner_state()
    arrays[1][0, js.HEAD] = js.SLOT0
    arrays[1][0, js.SLOT0] = js.SLOT0 + 1
    arrays[1][0, js.SLOT0 + 1] = js.SLOT0
    arrays[0][0, js.SLOT0] = 2 ** 30
    arrays[0][0, js.SLOT0 + 1] = 2 ** 30 + 1
    arrays[6][0] = 2
    batch = _padded(ts.SeqEncoder([A1]), [])
    batch.kind[0, 0], batch.ref[0, 0] = ts.INSERT, ts.HEAD_REF
    batch.packed[0, 0], batch.value[0, 0] = 1 << 8, 65
    _jst, tst = _apply_both(arrays, [batch], 'cyclic')
    assert int(tst.n[0]) == 3


# ---- seeded text-editing traces ----------------------------------------------

def _text_ops(rng, n_ops, actors):
    """The text seam's editing shape at a small size as SeqEncoder ops:
    inserts after the previous insert or a random alive element, deletes
    of a random alive element pred'ing it, and concurrent head inserts
    (every actor inserting at the head with one shared counter)."""
    ops, alive, last, ctr = [], [], None, 1
    while len(ops) < n_ops:
        ctr += 1
        roll = rng.random()
        if roll < 0.1:
            for a in actors:
                op_id = f'{ctr}@{a}'
                ops.append(ins('_head', op_id, chr(97 + int(
                    rng.integers(0, 26)))))
                alive.append(op_id)
            continue
        actor = actors[int(rng.integers(0, len(actors)))]
        op_id = f'{ctr}@{actor}'
        if alive and roll < 0.3:
            target = alive.pop(int(rng.integers(0, len(alive))))
            ops.append(_del(target, op_id, [target]))
            continue
        if last is not None and last in alive and rng.random() < 0.5:
            ref = last
        elif alive:
            ref = alive[int(rng.integers(0, len(alive)))]
        else:
            ref = '_head'
        ops.append(ins(ref, op_id, chr(97 + int(rng.integers(0, 26)))))
        alive.append(op_id)
        last = op_id
    return ops[:n_ops]


@pytest.mark.parametrize('seed', [0, 1])
def test_text_traces_match_jax(seed):
    rng = np.random.default_rng(seed)
    actors = [A1, A2, A3]
    enc = ts.SeqEncoder(actors)
    docs = [_text_ops(rng, 48, actors) for _ in range(4)]
    first = _padded(enc, [d[:32] for d in docs])
    rest = _padded(enc, [d[32:] for d in docs])
    jst, tst = _apply_both(_corner_state(), [first, rest],
                           f'text seed {seed}')
    _reads_equal(jst, tst)
    assert not tst.inexact.any()


# ---- the shared corner inputs (fleet/seq_cases.py) ---------------------------

def _cases_match_jax(names, a):
    for name in names:
        rng = np.random.default_rng(sc.CASES.index(name))
        arrays, batch = sc.case(name, rng, 6, 40, a, 30)
        before = [x.copy() for x in arrays]
        jst, tst = _apply_both(arrays, [batch], f'{name} A={a}')
        for x, y in zip(arrays, before):      # the inputs are left intact
            np.testing.assert_array_equal(x, y)
        assert seq_kernel.check_rows(tst).all()     # the kernel's contract


# The corners where the kernel's parallel resolution must give the scan's
# answer (csrc/sequence.cu, phase A), each a family of its own; the first
# pays the JAX compile of the shared shape.

def test_later_ref_case_matches_jax():
    """Ops naming an id an insert at a later column brings: a miss."""
    _cases_match_jax(('later_ref',), 4)


def test_dup_ids_case_matches_jax():
    """Inserts whose id an allocated element or an earlier insert already
    holds: later refs resolve to the lowest node."""
    _cases_match_jax(('dup_ids',), 4)


def test_hot_node_case_matches_jax():
    """An insert and up to 31 sets, deletes and incs of its element in one
    32-column chunk: one node's ops apply in column order."""
    _cases_match_jax(('hot_node',), 4)


def test_serial_case_matches_jax():
    """An insert that fails mid-row, then ops naming the shifted slots (the
    kernel's serial route)."""
    _cases_match_jax(('serial',), 4)


# One (6 docs, capacity 40, A, 30 lanes) shape per lane width; the cases
# split over families of a few each for the slow audit.

def test_insert_cases_match_jax():
    _cases_match_jax(('random', 'typing', 'concurrent_head', 'capacity',
                      'cyclic'), 4)


def test_register_cases_match_jax():
    _cases_match_jax(('dup_preds', 'dead_max_inc', 'wrap', 'self_conflict'),
                     4)


def test_flag_cases_match_jax():
    _cases_match_jax(('lanes_oob', 'unknown_ref', 'flags', 'kinds'), 4)


def test_cases_at_256_lanes_match_jax():
    _cases_match_jax(('random', 'lanes_oob'), 256)


def test_more_cases_at_256_lanes_match_jax():
    _cases_match_jax(('wrap', 'capacity'), 256)


def _runs_on_the_cpu(name):
    """`seq_cases.both` on the CPU (both sides the plain version, no
    kernel launch), at P = 0, 1 and 20."""
    before = seq_kernel.LAUNCHES['seq_scan']
    for lanes in (0, 1, 20):
        rng = np.random.default_rng(sc.CASES.index(name))
        arrays, batch = sc.case(name, rng, 5, 24, 4, lanes)
        got = sc.both(arrays, batch, 'cpu')
        assert got['differ'] == [] and got['max_abs_err'] == 0
        assert got['route'] is None and got['serial_rows'] is None
    assert seq_kernel.LAUNCHES['seq_scan'] == before


# One test per corner (each its own family for the slow audit).

def test_random_case_runs_on_the_cpu():
    _runs_on_the_cpu('random')


def test_typing_case_runs_on_the_cpu():
    _runs_on_the_cpu('typing')


def test_concurrent_head_case_runs_on_the_cpu():
    _runs_on_the_cpu('concurrent_head')


def test_dup_preds_case_runs_on_the_cpu():
    _runs_on_the_cpu('dup_preds')


def test_dead_max_inc_case_runs_on_the_cpu():
    _runs_on_the_cpu('dead_max_inc')


def test_lanes_oob_case_runs_on_the_cpu():
    _runs_on_the_cpu('lanes_oob')


def test_wrap_case_runs_on_the_cpu():
    _runs_on_the_cpu('wrap')


def test_unknown_ref_case_runs_on_the_cpu():
    _runs_on_the_cpu('unknown_ref')


def test_self_conflict_case_runs_on_the_cpu():
    _runs_on_the_cpu('self_conflict')


def test_flags_case_runs_on_the_cpu():
    _runs_on_the_cpu('flags')


def test_capacity_case_runs_on_the_cpu():
    _runs_on_the_cpu('capacity')


def test_cyclic_case_runs_on_the_cpu():
    _runs_on_the_cpu('cyclic')


def test_kinds_case_runs_on_the_cpu():
    _runs_on_the_cpu('kinds')


def test_later_ref_case_runs_on_the_cpu():
    _runs_on_the_cpu('later_ref')


def test_dup_ids_case_runs_on_the_cpu():
    _runs_on_the_cpu('dup_ids')


def test_hot_node_case_runs_on_the_cpu():
    _runs_on_the_cpu('hot_node')


def test_serial_case_runs_on_the_cpu():
    _runs_on_the_cpu('serial')


def test_every_case_has_a_cpu_test():
    assert {f'test_{name}_case_runs_on_the_cpu' for name in sc.CASES} <= \
        set(globals())


# ---- the kernel's launch plan and its parallel resolution --------------------

def test_class_past_the_resident_route_matches_jax():
    """Two rows of a class whose rows do not fit a CTA's shared memory
    (the kernel's 'global' route), held to the JAX scan."""
    rng = np.random.default_rng(41)
    arrays, batch = sc.case('random', rng, 2, sc.GLOBAL_CAPACITY, 4, 20)
    assert seq_kernel._launch_plan(2, sc.GLOBAL_CAPACITY + 3, 4, 20,
                                   4).route == 'global'
    _apply_both(arrays, [batch], 'global class')


def _resolution_holds(name, lanes=30):
    """`resolve_plain` against the JAX scan on one corner: on every row it
    calls exact, the scan's final elem_id holds each op's ref at its
    resolved node and each insert's id at its slot, and n = n0 + inserts.
    Returns the exact rows' mask."""
    rng = np.random.default_rng(sc.CASES.index(name))
    arrays, batch = sc.case(name, rng, 6, 40, 4, lanes)
    st = ts.seq_state_from_numpy(*arrays, device='cpu')
    res = seq_kernel.resolve_plain(st, batch.to('cpu'))
    jst, jn = js.apply_seq_batch(_jax_state(arrays), _jax_batch(batch))
    elem = np.asarray(jst.elem_id)
    node, slot = res.node.numpy(), res.slot.numpy()
    kind, ref, packed = batch.kind, batch.ref, batch.packed
    rows = np.arange(len(node))[:, None]
    exact = res.exact.numpy()
    top = elem.shape[1] - 1              # slots past capacity: never exact
    named = exact[:, None] & (node >= ts.SLOT0)
    np.testing.assert_array_equal(elem[rows, np.clip(node, 0, top)][named],
                                  ref[named])
    landed = exact[:, None] & (slot >= 0)
    np.testing.assert_array_equal(elem[rows, np.clip(slot, 0, top)][landed],
                                  packed[landed])
    np.testing.assert_array_equal(np.asarray(jst.n)[exact],
                                  res.n.numpy()[exact])
    known = (kind >= ts.INSERT) & (kind <= ts.INC)
    np.testing.assert_array_equal(node[~known], -1)
    if exact.all():
        assert int(jn) == int((node >= 0).sum())
    return exact


def test_resolution_rule_holds_on_the_parallel_corners():
    for name in ('random', 'typing', 'dup_ids', 'later_ref', 'hot_node',
                 'dup_preds', 'flags'):
        assert _resolution_holds(name).any(), name


def test_resolution_rule_sends_failing_rows_to_the_serial_route():
    assert not _resolution_holds('serial').any()
    assert not _resolution_holds('capacity').any()
    exact = _resolution_holds('unknown_ref', 20)
    assert not exact.all()


def test_launch_plan_routes_and_shared_bytes():
    """The plan at the text path's classes and at the route boundary:
    shared bytes within a CTA's 232,448, one row per CTA, and a table of
    more entries than the row has slots (load <= 0.8)."""
    plan = seq_kernel._launch_plan
    # the text seam's first batch: elem_id 32,784 B, then the table (10,248
    # uint16 entries, 20,496 B) that nxt (16,390 B) replaces, the staging
    assert plan(2048, 8195, 4, 9999, 4) == seq_kernel.Plan(
        'resident', 2048, 256, 1, 32784 + 20496 + 2448, 4, 10248)
    # its two 256-column batches, one class up
    assert plan(2048, 16387, 4, 256, 4) == seq_kernel.Plan(
        'resident', 2048, 256, 1, 65552 + 40976 + 2448, 2, 20488)
    assert plan(2048, 32771, 4, 256, 4).ctas_per_sm == 1
    assert plan(3, sc.GLOBAL_CAPACITY + 3, 4, 30, 4)[:2] == ('global', 3)
    # the largest resident row, and one node more
    top = max(n for n in range(30000, 40000)
              if seq_kernel.row_bytes(n) + seq_kernel.STAGE_BYTES <=
              seq_kernel.SMEM_BUDGET)
    assert plan(1, top, 4, 1, 4).route == 'resident'
    assert plan(1, top + 1, 4, 1, 4).route == 'global'
    for nodes in (4, 5, 67, 8195, 16387, top, top + 1, 65539, 131075):
        cap = nodes - 3
        got = plan(7, nodes, 256, 33, 8)
        assert got.smem_bytes <= seq_kernel.SMEM_LIMIT
        assert got.grid == 7 and got.rows_per_cta == 1
        assert got.smem_bytes % 16 == 0 and got.ctas_per_sm >= 1
        assert got.table_slots >= 1.25 * cap and got.table_slots > cap
        assert got.ctas_per_sm == min(8, seq_kernel.SM_SHARED //
                                      (got.smem_bytes + 1024))
    with pytest.raises(ValueError):
        plan(1, 67, 4, 8, 9)


def test_seq_scan_refuses_mismatched_tensors():
    arrays, batch = sc.case('random', np.random.default_rng(0), 2, 8, 4, 3)
    st = ts.seq_state_from_numpy(*arrays, device='cpu')
    ops = batch.to('cpu')
    ops.preds = ops.preds.long()
    with pytest.raises(ValueError, match='ops.preds'):
        seq_kernel.seq_scan(st, ops)
    ops = batch.to('cpu')
    st.killed = st.killed.int()
    with pytest.raises(ValueError, match='killed'):
        seq_kernel.seq_scan(st, ops)


def test_text_trace_changes_decode_as_described():
    """The text seam's trace: one makeText, 32 ops per change, 3 actors in
    turn on one causal chain, ~20 % deletes, and the continuation batches
    extend the same chain."""
    from automerge_tpu_torch.columnar import decode_change
    first, more = sc.text_changes(200, more=(64,), seed=3)
    changes = [decode_change(b) for b in first + more]
    assert changes[0]['ops'][0]['action'] == 'makeText'
    assert [len(c['ops']) for c in changes[1:]] == [32] * 6 + [7] + [32] * 2
    assert [c['actor'] for c in changes[:4]] == list(sc.TEXT_ACTORS) + \
        [sc.TEXT_ACTORS[0]]
    for prev, cur in zip(changes, changes[1:]):
        assert cur['deps'] == [prev['hash']]
    ops = [op for c in changes[1:] for op in c['ops']]
    dels = sum(op['action'] == 'del' for op in ops)
    assert len(ops) == 263 and 0.1 < dels / len(ops) < 0.3


# ---- SeqPools ------------------------------------------------------------------

def _pools_equal(jp, tp):
    assert (jp.free, jp.used, jp.grow_events) == \
        (tp.free, tp.used, tp.grow_events)
    assert sorted(jp.pools) == sorted(tp.pools)
    for cls in jp.pools:
        _assert_state_equal(jp.pools[cls], tp.pools[cls], f'class {cls}')


def test_pools_grow_match_jax():
    """Size classes, reserve, and allocs past a power of two (the pool
    regrows, zeroed and END-filled) on both engines' SeqPools."""
    jp, tp = js.SeqPools(4), ts.SeqPools(4, device='cpu')
    for p in (jp, tp):
        assert p.cls_for(4) == 0 and p.cls_for(5) == 1 and p.cls_for(17) == 3
        p.reserve(0, 2, 4)
        for _ in range(3):
            p.alloc(0, 4)
        p.alloc(1, 4)
    _pools_equal(jp, tp)


def _warm_pools(lanes):
    """Both engines' SeqPools (base 4) holding the same two warm classes:
    4 rows of capacity 4 and 2 rows of capacity 8."""
    jp, tp = js.SeqPools(4), ts.SeqPools(4, device='cpu')
    rng = np.random.default_rng(9)
    for cls, rows in ((0, 4), (1, 2)):
        arrays = sc.warm_arrays(rng, rows, 4 << cls, lanes, 2 + cls * 3)
        jp.pools[cls] = _jax_state(arrays)
        tp.pools[cls] = ts.seq_state_from_numpy(*arrays, device='cpu')
        for p in (jp, tp):
            p.used[cls] = rows
    return jp, tp


def test_pools_widen_and_copy_match_jax():
    """Lane growth, then a batched copy across classes."""
    jp, tp = _warm_pools(4)
    for p in (jp, tp):
        p.ensure_lanes(8)
        p.copy_rows(0, [0, 2], 1, [0, 1])
    _pools_equal(jp, tp)
    assert tp.pools[1].reg.shape[2] == 8


def test_pools_release_reuse_and_migrate_match_jax():
    """Release, reuse of a released row, and a migration up a class."""
    jp, tp = _warm_pools(8)
    for p in (jp, tp):
        p.release_rows({0: [1], 1: [0]})
        p.alloc(0, 8)
        p.migrate(0, 2, 1, 8)
    _pools_equal(jp, tp)
