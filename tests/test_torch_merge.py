"""Differential tests: the torch port's LWW merge (automerge_tpu_torch
.fleet.apply, plain version on the CPU) against the JAX reference
(automerge_tpu.fleet.apply, and the Pallas kernel in interpret mode).

Inputs come from numpy seeds and go through both packages; the
comparison is exact int32 equality on the real key columns [:, :K]
(tolerance: none — the scratch column K absorbs masked lanes and holds
garbage by contract in both)."""

import numpy as np
import pytest
import torch

from automerge_tpu.fleet import apply as jax_apply
from automerge_tpu.fleet.pallas_merge import pallas_apply_op_batch
from automerge_tpu.fleet.tensor_doc import ACTOR_BITS
from automerge_tpu.fleet.tensor_doc import FleetState as JaxState
from automerge_tpu.fleet.tensor_doc import OpBatch as JaxOps
from automerge_tpu_torch.fleet import apply as torch_apply
from automerge_tpu_torch.fleet import merge_kernel
from automerge_tpu_torch.fleet.merge_kernel import LAUNCHES, lww_merge
from automerge_tpu_torch.fleet.tensor_doc import OpBatch as TorchOps
from automerge_tpu_torch.fleet.tensor_doc import (state_from_numpy,
                                                  state_to_numpy)

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


CPU = torch.device('cpu')


def random_cols(rng, n_docs, n_keys, ops_per_doc, ctr0=1, inc=True):
    """OpBatch columns as numpy arrays (tests/test_pallas.py's
    random_batch shape): unique packed ids per doc lane, ~70% sets,
    ~90% valid, values including negatives (negative incs)."""
    shape = (n_docs, ops_per_doc)
    key_id = rng.integers(0, n_keys, shape, dtype=np.int32)
    actor = rng.integers(0, 4, shape, dtype=np.int32)
    ctrs = ctr0 + np.broadcast_to(np.arange(ops_per_doc, dtype=np.int32),
                                  shape)
    packed = (ctrs.astype(np.int32) << ACTOR_BITS) | actor
    value = rng.integers(-50, 1000, shape, dtype=np.int32)
    is_set = rng.random(shape) < 0.7 if inc else np.ones(shape, bool)
    valid = rng.random(shape) < 0.9
    return key_id, packed, value, is_set, ~is_set, valid


def both_ops(cols):
    return JaxOps(*cols), TorchOps(*cols).to(CPU)


def seeded_states(rng, n_docs, n_keys, counters=True):
    """One non-empty grid, handed to both packages: built by the
    reference, moved across with np.asarray + state_from_numpy."""
    jstate = JaxState.empty(n_docs, n_keys)
    jstate, _ = jax_apply.apply_op_batch(
        jstate, JaxOps(*random_cols(rng, n_docs, n_keys, 6, inc=counters)))
    arrays = [np.asarray(a) for a in
              (jstate.winners, jstate.values, jstate.counters)]
    return jstate, state_from_numpy(*arrays, device=CPU)


def assert_match(jstate, tstate, n_keys):
    got = state_to_numpy(tstate)
    for name, want, have in zip(('winners', 'values', 'counters'),
                                (jstate.winners, jstate.values,
                                 jstate.counters), got):
        np.testing.assert_array_equal(have[:, :n_keys],
                                      np.asarray(want)[:, :n_keys],
                                      err_msg=name)


SHAPES = [(8, 17, 12), (16, 40, 200), (200, 300, 16)]
# P where the CUDA kernel's routes split (the warp route takes up to 32
# lanes per doc, the cta route more), and batches of no lane or one
EDGE_SHAPES = [(16, 40, p) for p in (0, 1, 31, 32, 33)]


@pytest.mark.parametrize('n_docs,n_keys,p', SHAPES)
def test_apply_op_batch_matches_reference(n_docs, n_keys, p):
    _apply_matches_reference(n_docs, n_keys, p)


# The route-edge shapes are a family of their own in the slow audit's
# accounting (each shape compiles the reference's merge once).
@pytest.mark.parametrize('n_docs,n_keys,p', EDGE_SHAPES)
def test_apply_op_batch_at_route_edges_matches_reference(n_docs, n_keys, p):
    _apply_matches_reference(n_docs, n_keys, p)


def _apply_matches_reference(n_docs, n_keys, p):
    rng = np.random.default_rng(n_docs + n_keys)
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    jops, tops = both_ops(random_cols(rng, n_docs, n_keys, p, ctr0=4))
    want, want_stats = jax_apply.apply_op_batch(jstate, jops)
    before = state_to_numpy(tstate)
    got, got_stats = torch_apply.apply_op_batch(tstate, tops)
    assert int(got_stats) == int(want_stats)
    assert_match(want, got, n_keys)
    # the non-donating form leaves its input intact
    for a, b in zip(before, state_to_numpy(tstate)):
        np.testing.assert_array_equal(a, b)


def test_donated_multi_round_carry():
    rng = np.random.default_rng(7)
    n_docs, n_keys = 16, 33
    jstate = JaxState.empty(n_docs, n_keys)
    tstate = state_from_numpy(*(np.asarray(a) for a in (
        jstate.winners, jstate.values, jstate.counters)), device=CPU)
    for r in range(3):
        jops, tops = both_ops(random_cols(rng, n_docs, n_keys, 8,
                                          ctr0=1 + 8 * r))
        jstate, _ = jax_apply.apply_op_batch_donated(jstate, jops)
        out, _ = torch_apply.apply_op_batch_donated(tstate, tops)
        assert out is tstate          # in place
    assert_match(jstate, tstate, n_keys)


@pytest.mark.parametrize('n_docs,n_keys,p', SHAPES[:2] + EDGE_SHAPES)
def test_noinc_donated_matches_reference(n_docs, n_keys, p):
    rng = np.random.default_rng(3 + n_docs)
    jstate, tstate = seeded_states(rng, n_docs, n_keys, counters=False)
    jops, tops = both_ops(random_cols(rng, n_docs, n_keys, p, ctr0=4,
                                      inc=False))
    want, ws = jax_apply.apply_op_batch_noinc_donated(jstate, jops)
    got, gs = torch_apply.apply_op_batch_noinc_donated(tstate, tops)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


@pytest.mark.parametrize('n_docs,n_keys,p', SHAPES[:2] + EDGE_SHAPES)
def test_fresh_matches_reference(n_docs, n_keys, p):
    rng = np.random.default_rng(11 + p)
    jops, tops = both_ops(random_cols(rng, n_docs, n_keys, p))
    want, ws = jax_apply.apply_op_batch_fresh(jops, n_docs, n_keys)
    got, gs = torch_apply.apply_op_batch_fresh(tops, n_docs, n_keys)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


@pytest.mark.parametrize('n_docs,n_keys,p', SHAPES[:2] + EDGE_SHAPES)
def test_noinc_fresh_matches_reference(n_docs, n_keys, p):
    rng = np.random.default_rng(13 + p)
    jops, tops = both_ops(random_cols(rng, n_docs, n_keys, p, inc=False))
    want, ws = jax_apply.apply_op_batch_noinc_fresh(jops, n_docs, n_keys)
    got, gs = torch_apply.apply_op_batch_noinc_fresh(tops, n_docs, n_keys)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


def kill_lanes(rng, jstate, cols, n_keys, q=6):
    """[N, Q] kill lanes: some name a same-batch set lane's packed id,
    some the standing winner of a cell, some miss, some unused (0)."""
    key_id, packed, _value, is_set, _is_inc, valid = cols
    n, p = key_id.shape
    winners = np.asarray(jstate.winners) if jstate is not None else \
        np.zeros((n, n_keys + 1), np.int32)
    kk = np.zeros((n, q), np.int32)
    kp = np.zeros((n, q), np.int32)
    for d in range(n):
        lanes = np.flatnonzero(is_set[d] & valid[d])
        for j in range(q):
            kind = j % 4
            if kind == 0 and len(lanes):
                lane = int(rng.choice(lanes))
                kk[d, j], kp[d, j] = key_id[d, lane], packed[d, lane]
            elif kind == 1:
                live = np.flatnonzero(winners[d, :n_keys])
                if len(live):
                    k = int(rng.choice(live))
                    kk[d, j], kp[d, j] = k, winners[d, k]
            elif kind == 2:
                kk[d, j] = rng.integers(0, n_keys)
                kp[d, j] = (999 << ACTOR_BITS) | 1   # names nothing
    return kk, kp


@pytest.mark.parametrize('donated', [False, True])
@pytest.mark.parametrize('n_docs,n_keys,p', SHAPES[:2])
def test_kills_matches_reference(n_docs, n_keys, p, donated):
    rng = np.random.default_rng(17 + p + donated)
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    cols = random_cols(rng, n_docs, n_keys, p, ctr0=4)
    kk, kp = kill_lanes(rng, jstate, cols, n_keys)
    jops, tops = both_ops(cols)
    jfn = jax_apply.apply_op_batch_kills_donated if donated else \
        jax_apply.apply_op_batch_kills
    tfn = torch_apply.apply_op_batch_kills_donated if donated else \
        torch_apply.apply_op_batch_kills
    unkilled = np.asarray(
        jax_apply.apply_op_batch(jstate, jops)[0].winners)[:, :n_keys]
    want, ws = jfn(jstate, jops, kk, kp)
    got, gs = tfn(tstate, tops, torch.from_numpy(kk), torch.from_numpy(kp))
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)
    # the kill lanes really changed the outcome
    assert (np.asarray(want.winners)[:, :n_keys] != unkilled).any()


def test_kills_fresh_matches_reference():
    rng = np.random.default_rng(23)
    n_docs, n_keys, p = 16, 40, 24
    cols = random_cols(rng, n_docs, n_keys, p)
    kk, kp = kill_lanes(rng, None, cols, n_keys)
    jops, tops = both_ops(cols)
    want, ws = jax_apply.apply_op_batch_kills_fresh(jops, kk, kp, n_docs,
                                                    n_keys)
    got, gs = torch_apply.apply_op_batch_kills_fresh(
        tops, torch.from_numpy(kk), torch.from_numpy(kp), n_docs, n_keys)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


def test_zero_doc_rows_with_duplicate_indices():
    rng = np.random.default_rng(29)
    n_docs, n_keys = 24, 30
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    idx = np.array([3, 7, 3, 0, 23, 7, 7, 3], dtype=np.int32)
    want = jax_apply.zero_doc_rows_donated(jstate, idx)
    got = torch_apply.zero_doc_rows_donated(tstate, torch.from_numpy(idx))
    assert got is tstate
    assert_match(want, got, n_keys)
    assert not state_to_numpy(got)[0][[0, 3, 7, 23]].any()


def test_duplicate_delivery_is_idempotent():
    """Re-delivered ops (same packed id, same value) select the winner's
    value once; both engines agree."""
    rng = np.random.default_rng(42)
    n_docs, n_keys, p = 12, 23, 160
    cols = np.stack([c.astype(np.int32) for c in
                     random_cols(rng, n_docs, n_keys, p)])
    src = rng.integers(0, p // 2, 30)
    dst = p - 1 - rng.permutation(30)
    cols[:, :, dst] = cols[:, :, src]
    dup = (cols[0], cols[1], cols[2], cols[3] != 0, cols[4] != 0,
           cols[5] != 0)
    jops, tops = both_ops(dup)
    want, _ = jax_apply.apply_op_batch(JaxState.empty(n_docs, n_keys), jops)
    got, _ = torch_apply.apply_op_batch_fresh(tops, n_docs, n_keys)
    assert_match(want, got, n_keys)


def test_counter_keep_reset_and_negative_incs():
    """Counter base survives a re-delivered standing winner and resets
    when a newer set wins; negative incs accumulate."""
    n_docs, n_keys = 4, 8

    def mk(key, packed, value, is_set):
        return (np.full((n_docs, 1), key, np.int32),
                np.full((n_docs, 1), packed, np.int32),
                np.full((n_docs, 1), value, np.int32),
                np.full((n_docs, 1), is_set, bool),
                np.full((n_docs, 1), not is_set, bool),
                np.ones((n_docs, 1), bool))

    rounds = [mk(0, 1 << ACTOR_BITS, 10, True),
              mk(0, 2 << ACTOR_BITS, -4, False),
              mk(0, 1 << ACTOR_BITS, 10, True),    # duplicate: keep base
              mk(0, 3 << ACTOR_BITS, 6, False),
              mk(0, 5 << ACTOR_BITS, 99, True),    # newer set: reset
              mk(0, 6 << ACTOR_BITS, -7, False)]
    jstate = JaxState.empty(n_docs, n_keys)
    tstate = state_from_numpy(*(np.asarray(a) for a in (
        jstate.winners, jstate.values, jstate.counters)), device=CPU)
    seen = []
    for cols in rounds:
        jops, tops = both_ops(cols)
        jstate, _ = jax_apply.apply_op_batch(jstate, jops)
        tstate, _ = torch_apply.apply_op_batch(tstate, tops)
        assert_match(jstate, tstate, n_keys)
        seen.append(int(state_to_numpy(tstate)[2][0, 0]))
    assert seen == [0, -4, -4, 2, 0, -7]


def _pallas_case(variant, p=12, kernel=pallas_apply_op_batch):
    rng = np.random.default_rng(5)
    n_docs, n_keys = 8, 17
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    cols = random_cols(rng, n_docs, n_keys, p, ctr0=4)
    jops, tops = both_ops(cols)
    want, ws = kernel(jstate, jops, interpret=True, variant=variant)
    got, gs = torch_apply.apply_op_batch(tstate, tops)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


def test_matches_pallas_dense_interpret():
    _pallas_case('dense')


def test_matches_pallas_loop_interpret(monkeypatch):
    """The loop variant unrolls one step per lane of an op chunk, so its
    compile grows with the chunk: with the chunk set to 8 lanes (the
    PALLAS_OP_CHUNK knob of the JAX package, traced afresh under its own
    jit) the 12 lanes span two chunks, and the carry between them runs."""
    import jax
    from automerge_tpu.fleet import pallas_merge
    monkeypatch.setattr(pallas_merge, 'OP_CHUNK', 8)
    kernel = jax.jit(pallas_merge._pallas_apply_op_batch_impl,
                     static_argnames=('interpret', 'variant'))
    _pallas_case('loop', kernel=kernel)


def test_warp_route_shape_matches_pallas_interpret():
    """P = 32 lanes, the widest batch of the CUDA kernel's warp route."""
    _pallas_case('dense', p=32)


# ---- inputs that stress a warp's key groups, and key-chunked fresh rows ----

def _fresh_case(cols, n_docs, n_keys, noinc):
    jops, tops = both_ops(cols)
    if noinc:
        want, ws = jax_apply.apply_op_batch_noinc_fresh(jops, n_docs, n_keys)
        got, gs = torch_apply.apply_op_batch_noinc_fresh(tops, n_docs,
                                                         n_keys)
    else:
        want, ws = jax_apply.apply_op_batch_fresh(jops, n_docs, n_keys)
        got, gs = torch_apply.apply_op_batch_fresh(tops, n_docs, n_keys)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)
    return got


@pytest.mark.parametrize('fresh', [False, True])
def test_full_key_collision(fresh):
    """K = 3 with 32 lanes per doc: every warp's lanes fall into at most
    four key groups (key K included, the scratch column)."""
    rng = np.random.default_rng(7 + fresh)
    n_docs, n_keys, p = 24, 3, 32
    cols = list(random_cols(rng, n_docs, n_keys + 1, p, ctr0=9))
    cols[0][:4] = 1                       # four docs: all lanes on key 1
    if fresh:
        _fresh_case(cols, n_docs, n_keys, noinc=False)
        return
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    jops, tops = both_ops(cols)
    want, ws = jax_apply.apply_op_batch(jstate, jops)
    got, gs = torch_apply.apply_op_batch(tstate, tops)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


def test_duplicate_packed_ids_within_a_warp():
    """Re-delivered lanes inside one warp's 32 (same packed id, same
    value), including re-deliveries of the standing winner, which keep
    the counter's base."""
    rng = np.random.default_rng(11)
    n_docs, n_keys, p = 20, 9, 32
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    cols = np.stack([c.astype(np.int32) for c in
                     random_cols(rng, n_docs, n_keys, p, ctr0=30)])
    src = rng.integers(0, 16, 12)
    dst = 16 + rng.permutation(16)[:12]
    cols[:, :, dst] = cols[:, :, src]
    winners = np.asarray(jstate.winners)
    values = np.asarray(jstate.values)
    for d in range(n_docs):             # lane 31 re-delivers a standing winner
        key = int(rng.integers(0, n_keys))
        cols[:, d, 31] = (key, winners[d, key], values[d, key], 1, 0, 1)
    dup = (cols[0], cols[1], cols[2], cols[3] != 0, cols[4] != 0,
           cols[5] != 0)
    jops, tops = both_ops(dup)
    want, ws = jax_apply.apply_op_batch(jstate, jops)
    got, gs = torch_apply.apply_op_batch(tstate, tops)
    assert int(gs) == int(ws)
    assert_match(want, got, n_keys)


def test_negative_incs_with_reset():
    """One warp: key 0 gets a newer set and negative incs (the counter
    restarts from the incs alone), key 1 only negative incs (they add to
    the standing counter)."""
    n_docs, n_keys, p = 2, 4, 32

    def batch(lanes):
        cols = [np.zeros((n_docs, p), t) for t in
                (np.int32, np.int32, np.int32, bool, bool, bool)]
        for j, (key, ctr, value, is_set) in enumerate(lanes):
            for c, x in zip(cols, (key, ctr << ACTOR_BITS, value, is_set,
                                   not is_set, True)):
                c[:, j] = x
        return cols

    first = batch([(0, 1, 10, True), (0, 2, -3, False), (1, 3, 20, True),
                   (1, 4, 5, False)])
    second = batch([(0, 6, 77, True)] +
                   [(0, 7 + i, -2, False) for i in range(15)] +
                   [(1, 30 + i, -1, False) for i in range(16)])
    jstate = JaxState.empty(n_docs, n_keys)
    tstate = state_from_numpy(*(np.asarray(a) for a in (
        jstate.winners, jstate.values, jstate.counters)), device=CPU)
    for cols in (first, second):
        jops, tops = both_ops(cols)
        jstate, _ = jax_apply.apply_op_batch(jstate, jops)
        tstate, _ = torch_apply.apply_op_batch(tstate, tops)
        assert_match(jstate, tstate, n_keys)
    counters = np.asarray(jstate.counters)
    assert counters[0, 0] == -30 and counters[0, 1] == 5 - 16


@pytest.mark.parametrize('noinc', [False, True])
def test_fresh_rows_wider_than_a_shared_memory_tile(noinc):
    """K+1 = 20,001 is wider than one fresh CTA's tile of the CUDA kernel,
    so that route walks each row in key chunks; lanes sit on both sides
    of every chunk edge and on key K."""
    n_docs, n_keys, p = 3, 20_000, 48
    plan = merge_kernel._launch_plan(n_docs, p, n_keys + 1, fresh=True)
    assert plan.key_chunk < n_keys + 1
    rng = np.random.default_rng(13 + noinc)
    cols = list(random_cols(rng, n_docs, n_keys + 1, p, inc=not noinc))
    edges = np.arange(plan.key_chunk, n_keys + 1, plan.key_chunk)
    near = np.concatenate([edges - 1, edges, [0, n_keys - 1, n_keys]])
    for c, x in zip(cols, (near, None, None, True, False, True)):
        if x is not None:
            c[:, :len(near)] = x
    got = _fresh_case(cols, n_docs, n_keys, noinc=noinc)
    assert (got.winners[:, edges] != 0).all()


def test_cpu_merge_runs_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    _jstate, tstate = seeded_states(rng, 4, 9)
    _jops, tops = both_ops(random_cols(rng, 4, 9, 5))
    before = LAUNCHES['lww_merge']
    lww_merge(tstate, tops)
    assert LAUNCHES['lww_merge'] == before


def test_merge_wrapper_checks_inputs():
    rng = np.random.default_rng(2)
    _jstate, tstate = seeded_states(rng, 4, 9)
    cols = list(random_cols(rng, 4, 9, 5))
    bad = TorchOps(*cols).to(CPU)
    bad.packed = bad.packed.long()
    with pytest.raises(ValueError, match='packed'):
        lww_merge(tstate, bad)
    short = TorchOps(*(c[:3] for c in cols)).to(CPU)
    with pytest.raises(ValueError, match='key_id'):
        lww_merge(tstate, short)
