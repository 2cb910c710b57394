"""The port's register engine (automerge_tpu_torch/fleet/registers.py and
register_kernel.py, the plain version on the CPU) against the JAX
package's (automerge_tpu/fleet/registers.py, jit on the CPU): the same
seeded numpy inputs through both, compared exactly — all five register
arrays, the lane count, visible_registers, zero_register_rows_donated,
rows_to_register_batch and materialize_registers.

Each JAX shape compiles once (~0.8 s on one CPU), so the random batches
of one (A, D) pair share one padded shape: P up to 40 lanes (trailing
PAD lanes) and K up to 16 keys (a state of 17 columns)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from automerge_tpu.fleet import registers as jr
from automerge_tpu_torch.fleet import register_cases as rc
from automerge_tpu_torch.fleet import register_kernel
from automerge_tpu_torch.fleet import registers as tr

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


NAMES = ('reg', 'killed', 'value', 'counter', 'inexact')


def _jax_state(arrays):
    return jr.RegisterState(*(jnp.asarray(a) for a in arrays))


def _jax_batch(batch):
    return jr.RegisterOpBatch(*(jnp.asarray(c) for c in batch.columns()))


def _apply_both(arrays, batch):
    """(JAX state, JAX count, port state as numpy, port count)."""
    js, jn = jr.apply_register_batch(_jax_state(arrays), _jax_batch(batch))
    ts, tn = tr.apply_register_batch(
        tr.register_state_from_numpy(*arrays, device='cpu'),
        batch.to('cpu'))
    return js, int(jn), tr.register_state_to_numpy(ts), int(tn)


def _assert_apply_equal(arrays, batch, what=''):
    js, jn, tarr, tn = _apply_both(arrays, batch)
    assert tn == jn, f'{what}: lane count'
    for name, a, b in zip(NAMES, js.tree_flatten()[0], tarr):
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=f'{what}: {name}')
    return js, tarr


# a case's seed: its sorted place among the first ten cases, then the
# later cases in the order they were added, so no case's data moves when
# another is added
_SEEDS = {name: i for i, name in enumerate(
    sorted(rc.JAX_CASES[:10]) + list(rc.JAX_CASES[10:]))}


@pytest.mark.parametrize('name', rc.JAX_CASES)
def test_shared_cases_match_jax(name):
    rng = np.random.default_rng(_SEEDS[name])
    arrays, batch = rc.case(name, rng, 16, 6, 8, 24, 4)
    before = [a.copy() for a in arrays]
    _assert_apply_equal(arrays, batch, name)
    for a, b in zip(arrays, before):      # the inputs are left intact
        np.testing.assert_array_equal(a, b)


def _padded_random(rng, a, d, lanes=40, keys=16):
    """A random batch of P <= lanes live columns over K <= keys keys,
    padded to [N, lanes] and a state of keys + 1 columns."""
    n = 12
    k_eff = int(rng.integers(1, keys + 1))
    p_eff = int(rng.integers(0, lanes + 1))
    arrays = rc.random_state(rng, n, keys, a)
    batch = rc.random_batch(rng, arrays, lanes, d)
    batch.key_id[...] = batch.key_id % k_eff
    batch.kind[:, p_eff:] = rc.PAD
    batch.overflow[...] = rng.random(batch.overflow.shape) < 0.03
    return arrays, batch, (k_eff, p_eff)


def _random_family(a, ds, seed):
    rng = np.random.default_rng(seed)
    for d in ds:
        for _ in range(4):
            arrays, batch, shape = _padded_random(rng, a, d)
            _assert_apply_equal(arrays, batch, f'A={a} D={d} (K, P)={shape}')


def test_random_batches_one_slot_match_jax():
    _random_family(1, (1, 4), seed=11)


def test_random_batches_four_slots_match_jax():
    _random_family(4, (1, 2), seed=12)


def test_random_batches_eight_slots_match_jax():
    _random_family(8, (2, 4), seed=13)


# ---- the kernel's schedule: tiles of columns, rounds of distinct keys -----

def _assert_rounds_match(arrays, batch, what):
    """register_kernel.register_scan_rounds_plain (the CUDA kernel's
    schedule in torch ops) against the JAX scan, all five arrays and the
    lane count."""
    js, jn = jr.apply_register_batch(_jax_state(arrays), _jax_batch(batch))
    ts = tr.register_state_from_numpy(*arrays, device='cpu')
    tn = int(register_kernel.register_scan_rounds_plain(ts, batch.to('cpu')))
    assert tn == int(jn), f'{what}: lane count'
    for name, a, b in zip(NAMES, js.tree_flatten()[0],
                          tr.register_state_to_numpy(ts)):
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=f'{what}: {name}')


@pytest.mark.parametrize('lanes', [5, 40])
@pytest.mark.parametrize('name', rc.CASES)
def test_round_schedule_matches_jax(name, lanes):
    """Every register case at 5 lanes (one tile) and 40 (two tiles of
    32), 8 slots and 4 preds: the shapes of the random eight-slot
    family, so JAX compiles nothing new. 'key_range', whose lanes JAX
    reads from a clamped row, is held to register_scan_plain."""
    rng = np.random.default_rng(200 + rc.CASES.index(name))
    arrays, batch = rc.case(name, rng, 12, 16, 8, lanes, 4)
    if name in rc.JAX_CASES:
        _assert_rounds_match(arrays, batch, name)
        return
    got = tr.register_state_from_numpy(*arrays, device='cpu')
    want = tr.register_state_from_numpy(*arrays, device='cpu')
    ops = batch.to('cpu')
    assert int(register_kernel.register_scan_rounds_plain(got, ops)) == \
        int(register_kernel.register_scan_plain(want, ops))
    for name, a, b in zip(NAMES, tr.register_state_to_numpy(got),
                          tr.register_state_to_numpy(want)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _random_rounds_family(a, ds, seed):
    rng = np.random.default_rng(seed)
    for d in ds:
        for _ in range(4):
            arrays, batch, shape = _padded_random(rng, a, d)
            _assert_rounds_match(arrays, batch,
                                 f'rounds A={a} D={d} (K, P)={shape}')


def test_round_schedule_random_one_slot_matches_jax():
    _random_rounds_family(1, (1, 4), seed=21)


def test_round_schedule_random_four_slots_matches_jax():
    _random_rounds_family(4, (1, 2), seed=22)


def test_round_schedule_random_eight_slots_matches_jax():
    _random_rounds_family(8, (2, 4), seed=23)


def test_segment_widths():
    """The lanes the kernel gives one doc: the power of two >= P up to
    16 lanes, else a warp's 32 (then in tiles of 32 columns)."""
    widths = {p: 1 << register_kernel._segment_shift(p)
              for p in (1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 3000)}
    assert widths == {1: 1, 2: 2, 3: 4, 5: 8, 8: 8, 9: 16, 16: 16, 17: 32,
                      31: 32, 32: 32, 33: 32, 3000: 32}


# ---- tests/test_registers.py's corners, one document each ---------------

ACTORS = sorted(['aa' * 16, 'bb' * 16, 'cc' * 16])
ANUM = {a: i for i, a in enumerate(ACTORS)}
KEYS = ['k0', 'k1', 'k2', 'k3']
A, B, C = ACTORS
S, D_, I = rc.SET, rc.DEL, rc.INC

CORNERS = {
    'conflict_set': [(S, 'k0', f'1@{A}', 10, []), (S, 'k0', f'1@{B}', 20, [])],
    'resurrection': [(S, 'k1', f'1@{A}', 5, []),
                     (S, 'k1', f'2@{B}', 7, [f'1@{A}']),
                     (D_, 'k1', f'9@{C}', 0, [f'1@{A}'])],
    'counter_accumulates': [(S, 'k2', f'1@{A}', 10, []),
                            (I, 'k2', f'2@{A}', 4, [f'1@{A}']),
                            (I, 'k2', f'2@{B}', -2, [f'1@{A}'])],
    'counter_overwrite': [(S, 'k2', f'1@{A}', 10, []),
                          (I, 'k2', f'2@{A}', 3, [f'1@{A}']),
                          (S, 'k2', f'3@{A}', 100, [f'1@{A}'])],
    'delete': [(S, 'k3', f'1@{A}', 1, []), (D_, 'k3', f'2@{A}', 0, [f'1@{A}'])],
    'same_batch_kill': [(S, 'k0', f'5@{B}', 1, []),
                        (S, 'k0', f'6@{A}', 2, [f'5@{B}'])],
    'self_conflict': [(S, 'k0', f'1@{A}', 1, []), (S, 'k0', f'2@{A}', 2, [])],
    'bad_inc': [(I, 'k0', f'1@{A}', 1, [f'9@{A}'])],
    'pred_overflow': [(S, 'k0', f'1@{A}', 1, []),
                      (S, 'k0', f'9@{A}', 2, [f'1@{A}', f'3@{A}', f'4@{A}'])],
    'null_conflict': [(S, 'k0', f'1@{A}', 5, []), (S, 'k0', f'1@{B}', -2, [])],
}
# At two actor slots: an actor, and a pred's actor, past the width
SLOT_WIDTH = {
    'actor_beyond_width': [(S, 'k0', f'1@{C}', 1, [])],
    'pred_beyond_width': [(S, 'k0', f'1@{A}', 1, []),
                          (D_, 'k0', f'2@{A}', 0, [f'1@{C}'])],
}


def _pack(op_id):
    ctr, actor = op_id.split('@')
    return (int(ctr) << 8) | ANUM[actor]


def _history(seed, steps=40):
    """tests/test_registers.py's random causally valid op stream."""
    rng = np.random.default_rng(seed)
    visible = {k: set() for k in KEYS}
    counters, ops = {}, []
    ctr = {a: 0 for a in ACTORS}

    def lamport(op_id):
        c, a = op_id.split('@')
        return int(c), a
    for _ in range(steps):
        actor = ACTORS[int(rng.integers(0, 3))]
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        ctr[actor] = max(ctr.values()) + 1
        op_id = f'{ctr[actor]}@{actor}'
        vis = sorted(visible[key], key=lamport)
        roll = rng.random()
        targets = [v for v in vis if counters.get(v)]
        if roll < 0.2 and targets:
            ops.append((I, key, op_id, int(rng.integers(-5, 10)),
                        [targets[int(rng.integers(0, len(targets)))]]))
        elif roll < 0.4 and vis:
            pred = vis if rng.random() < 0.7 else vis[:1]
            ops.append((D_, key, op_id, 0, pred))
            visible[key] -= set(pred)
        else:
            ops.append((S, key, op_id, int(rng.integers(0, 100)), vis))
            visible[key] -= set(vis)
            visible[key].add(op_id)
            counters[op_id] = rng.random() < 0.3
    return ops


def _doc_batch(op_lists, d_preds=2, lanes=40):
    n = len(op_lists)
    kind, key, packed, value = (np.zeros((n, lanes), np.int32)
                                for _ in range(4))
    preds = np.zeros((n, lanes, d_preds), np.int32)
    overflow = np.zeros((n, lanes), bool)
    for d, ops in enumerate(op_lists):
        for i, (k, kname, op_id, val, pred) in enumerate(ops):
            kind[d, i], key[d, i] = k, KEYS.index(kname)
            packed[d, i], value[d, i] = _pack(op_id), val
            overflow[d, i] = len(pred) > d_preds
            for j, p in enumerate(pred[:d_preds]):
                preds[d, i, j] = _pack(p)
    return tr.RegisterOpBatch(kind, key, packed, value, preds, overflow)


def _zero_state(n, a):
    return [np.zeros((n, len(KEYS) + 1, a), dt)
            for dt in (np.int32, bool, np.int32, np.int32)] + \
        [np.zeros(n, bool)]


def test_reference_corners_match_jax():
    """Every corner of tests/test_registers.py and its three random
    histories, one document each in one batch; then materialize_registers
    (with the value table of the null-valued conflict) on both."""
    lists = list(CORNERS.values()) + [_history(s) for s in (0, 1, 2)]
    js, tarr = _assert_apply_equal(_zero_state(len(lists), 4),
                                   _doc_batch(lists), 'corners')
    table = [None]
    want = jr.materialize_registers(js, KEYS, value_table=table)
    got = tr.materialize_registers(
        tr.register_state_from_numpy(*tarr, device='cpu'), KEYS,
        value_table=table)
    assert got == want
    names = list(CORNERS)
    assert got[names.index('resurrection')] == {'k1': (7, {})}
    assert got[names.index('counter_accumulates')] == {'k2': (12, {})}
    assert got[names.index('null_conflict')]['k0'][0] is None
    flagged = {names[i] for i in np.flatnonzero(tarr[4][:len(names)])}
    assert flagged == {'self_conflict', 'bad_inc', 'pred_overflow'}


def test_slot_width_corners_match_jax():
    _js, tarr = _assert_apply_equal(_zero_state(2, 2),
                                    _doc_batch(list(SLOT_WIDTH.values()),
                                               lanes=2), 'slot width')
    assert tarr[4].all()


# ---- reads, row zeroing and the host layout ------------------------------

def test_reads_and_row_zeroing_match_jax():
    rng = np.random.default_rng(5)
    arrays = rc.random_state(rng, 9, 6, 8)
    arrays[0][3] = 0                   # a doc with nothing visible
    arrays[0][4, :, 0::2] = arrays[0][4, :, 1::2]   # ties between slots
    arrays[1][4] = False
    js = _jax_state(arrays)
    ts = tr.register_state_from_numpy(*arrays, device='cpu')
    for a, b in zip(jr.visible_registers(js), tr.visible_registers(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    keys = [f'k{i}' for i in range(6)]
    table = [f'v{i}' for i in range(60)]
    assert tr.materialize_registers(ts, keys, value_table=table) == \
        jr.materialize_registers(js, keys, value_table=table)
    assert tr.materialize_registers(ts, keys, value_table=table,
                                    n_docs=4) == \
        jr.materialize_registers(js, keys, value_table=table)[:4]
    idx = np.array([2, 7, 2, 0])       # duplicates are fine
    jz = jr.zero_register_rows_donated(js, jnp.asarray(idx))
    tz = tr.zero_register_rows_donated(ts, torch.from_numpy(idx))
    assert tz is ts                     # in place
    for name, a, b in zip(NAMES, jz.tree_flatten()[0],
                          tr.register_state_to_numpy(tz)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


def test_rows_to_register_batch_matches_jax():
    rng = np.random.default_rng(6)
    n_rows, n_docs = 50, 7
    doc = np.sort(rng.integers(0, n_docs, n_rows))
    flags = rng.choice([1, 2], n_rows).astype(np.uint8)
    value = rng.integers(-3, 100, n_rows).astype(np.int32)
    value[(flags == 1) & (rng.random(n_rows) < 0.3)] = -1    # dels
    value[(flags == 2) & (rng.random(n_rows) < 0.5)] = -1    # inc of -1
    counts = rng.integers(0, 6, n_rows)
    pred_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    pred = rng.integers(1, 1 << 20, int(counts.sum())).astype(np.int32)
    key = rng.integers(0, 9, n_rows).astype(np.int32)
    packed = rng.integers(1, 1 << 20, n_rows).astype(np.int32)
    force = rng.random(n_rows) < 0.1
    for kw in ({}, {'force_overflow': force}):
        want = jr.rows_to_register_batch(doc, flags, key, packed, value,
                                         pred_off, pred, n_docs=n_docs + 2,
                                         d_preds=4, **kw)
        got = tr.rows_to_register_batch(doc, flags, key, packed, value,
                                        pred_off, pred, n_docs=n_docs + 2,
                                        d_preds=4, **kw)
        for a, b in zip(want.tree_flatten()[0], got.columns()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    empty = tr.rows_to_register_batch([], [], [], [], [], [0], [], n_docs=3)
    assert empty.kind.shape == (3, 1) and not empty.kind.any()


# ---- the plain version's own checks ----------------------------------------

@pytest.mark.parametrize('name', rc.CASES)
def test_register_cases_run_on_the_cpu(name):
    """`register_cases.both` on the CPU (both sides the plain version, no
    kernel launch), including the port's rule for out-of-range keys."""
    rng = np.random.default_rng(rc.CASES.index(name))
    before = register_kernel.LAUNCHES['register_scan']
    arrays, batch = rc.case(name, rng, 8, 5, 4, 12, 3)
    got = rc.both(arrays, batch, 'cpu')
    assert got['differ'] == [] and got['max_abs_err'] == 0
    assert got['applied'][0] == int((batch.kind != rc.PAD).sum())
    assert register_kernel.LAUNCHES['register_scan'] == before
    if name == 'key_range':
        ts, ops = rc.to_device(arrays, batch, 'cpu')
        register_kernel.register_scan_plain(ts, ops)
        bad = ((ops.key_id < 0) | (ops.key_id > 5)) & (ops.kind != rc.PAD)
        assert ts.inexact[bad.any(dim=1)].all()


def test_register_scan_refuses_mismatched_tensors():
    arrays, batch = rc.case('random', np.random.default_rng(0), 4, 3, 2, 5, 2)
    ts, ops = rc.to_device(arrays, batch, 'cpu')
    ops.preds = ops.preds.long()
    with pytest.raises(ValueError, match='ops.preds'):
        register_kernel.register_scan(ts, ops)
    ts, ops = rc.to_device(arrays, batch, 'cpu')
    ts.killed = ts.killed.int()
    with pytest.raises(ValueError, match='killed'):
        register_kernel.register_scan(ts, ops)
