"""Differential tests of the mesh path: fleet/sharding.py and
DocFleet(mesh=...) against the JAX package on the same inputs.

The JAX side runs on the 8-device virtual CPU mesh tests/conftest.py
sets up; the port's side on a FleetMesh of CPU positions (one device,
several logical shards: the code path a mesh of cards runs, with other
device objects). Inputs come from a seed with numpy. Tolerance: none —
whole int32 grids (the scratch column too), applied counts, every
sequence array with its padded tail, materialized documents, save()
bytes and the typed error."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import automerge_tpu.native as jax_native
from automerge_tpu.columnar import decode_change_meta, encode_change
from automerge_tpu.fleet import backend as jax_backend
from automerge_tpu.fleet import sequence as js
from automerge_tpu.fleet import sharding as jsh
from automerge_tpu.fleet.tensor_doc import FleetState as JFleetState
from automerge_tpu.fleet.tensor_doc import OpBatch as JOpBatch
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch.fleet import apply as tapply
from automerge_tpu_torch.fleet import backend as torch_backend
from automerge_tpu_torch.fleet import registers as tregisters
from automerge_tpu_torch.fleet import seq_cases as sc
from automerge_tpu_torch.fleet import sequence as ts
from automerge_tpu_torch.fleet import sharding as tsh
from automerge_tpu_torch.fleet.tensor_doc import FleetState, OpBatch
from automerge_tpu_torch.observability import perf as obs_perf
from automerge_tpu.observability import perf as ref_perf

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

_NATIVE_OK = torch_native.available() and jax_native.available()


def _cpu_mesh(n, keys_axis=1, devices=('cpu',)):
    """A mesh of n CPU positions. Two device objects that both name the
    CPU ('cpu', 'cpu:0') take the code paths of a mesh over two cards:
    blocks of their own, peer copies, gathers across devices."""
    return tsh.fleet_mesh([devices[i % len(devices)] for i in range(n)],
                          keys_axis=keys_axis)


TWO_DEVICES = ('cpu', 'cpu:0')


def _random_ops(rng, n_docs, n_keys, lanes):
    """[N, P] op columns: sets and incs on keys [0, n_keys), a tenth of
    the lanes padding; packed ids unique per doc."""
    key = rng.integers(0, n_keys, (n_docs, lanes)).astype(np.int32)
    packed = ((rng.permutation(np.arange(1, 1 + n_docs * lanes))
               .reshape(n_docs, lanes) << 8) |
              rng.integers(0, 3, (n_docs, lanes))).astype(np.int32)
    value = rng.integers(-50, 1000, (n_docs, lanes)).astype(np.int32)
    is_inc = rng.random((n_docs, lanes)) < 0.25
    valid = rng.random((n_docs, lanes)) < 0.9
    return (key, packed, value, ~is_inc, is_inc, valid)


# ---------------------------------------------------------------------------
# sharded_apply (ported from tests/test_fleet.py TestFleetSharding)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,devices', [
    ((8, 1), ('cpu',)), ((4, 2), ('cpu',)), ((2, 4), ('cpu',)),
    ((4, 2), TWO_DEVICES)], ids=['8x1', '4x2', '2x4', '4x2-two-devices'])
def test_sharded_apply_matches_reference(shape, devices):
    """Two batches through the sharded step on a (docs, keys) mesh: the
    whole grids (scratch column included) and the stats equal the JAX
    sharded step's, and the unsharded merge's."""
    docs, keys = shape
    n_docs, n_keys = 16, 15       # +1 scratch -> 16 columns
    rng = np.random.default_rng(sum(shape))
    batches = [_random_ops(rng, n_docs, n_keys, 6) for _ in range(2)]
    jmesh = jsh.fleet_mesh(jax.devices()[:8], keys_axis=keys)
    tmesh = _cpu_mesh(8, keys_axis=keys, devices=devices)
    assert jmesh.devices.shape == shape
    assert tmesh.shape == {'docs': docs, 'keys': keys}
    jstate = jsh.shard_fleet(JFleetState.empty(n_docs, n_keys), jmesh)
    empty = np.zeros((n_docs, n_keys + 1), np.int32)
    tstate = tsh.shard_fleet(FleetState(*(torch.from_numpy(empty.copy())
                                          for _ in range(3))), tmesh)
    plain = FleetState(*(torch.from_numpy(empty.copy()) for _ in range(3)))
    jstep, tstep = jsh.sharded_apply(jmesh), tsh.sharded_apply(tmesh)
    for cols in batches:
        jstate, jstats = jstep(jstate, jsh.shard_ops(
            JOpBatch(*(jnp.asarray(c) for c in cols)), jmesh))
        tops = OpBatch(*(torch.from_numpy(c) for c in cols))
        tstate, tstats = tstep(tstate, tsh.shard_ops(tops, tmesh))
        _, pstats = tapply.apply_op_batch_donated(plain, tops)
        assert int(tstats) == int(jstats) == int(pstats) == \
            int(cols[5].sum())
        for name, j, t, p in zip(('winners', 'values', 'counters'),
                                 (jstate.winners, jstate.values,
                                  jstate.counters), tstate.tensors(),
                                 plain.tensors()):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                          err_msg=name)
            np.testing.assert_array_equal(np.asarray(t), p.numpy(),
                                          err_msg=name)


def test_sharded_apply_key_blocks_keep_their_last_key():
    """Under key sharding a key block's padded lanes write the block's
    own scratch column: the last real key of a block that does not end
    the grid keeps its value (the plain merge sends masked lanes to the
    last column and writes 0 there)."""
    mesh = _cpu_mesh(4, keys_axis=4)
    n_docs, k1 = 1, 8                       # key blocks of 2 columns
    state = FleetState(*(torch.zeros((n_docs, k1), dtype=torch.int32)
                         for _ in range(3)))
    cols = [np.array([[1, 3, 5, 2]], np.int32),
            np.array([[256, 512, 768, 1024]], np.int32),
            np.array([[11, 33, 55, 22]], np.int32),
            np.ones((1, 4), bool), np.zeros((1, 4), bool),
            np.array([[True, True, True, False]])]
    new, stats = tsh.sharded_apply(mesh)(
        tsh.shard_fleet(state, mesh),
        tsh.shard_ops(OpBatch(*(torch.from_numpy(c) for c in cols)), mesh))
    assert int(stats) == 3
    assert np.asarray(new.values).tolist() == [[0, 11, 0, 33, 0, 55, 0, 0]]
    # every non-last key block carries its own scratch column
    assert [tuple(b.shape) for b in new.values.blocks] == \
        [(1, 3), (1, 3), (1, 3), (1, 2)]


# ---------------------------------------------------------------------------
# sharded_seq_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('devices', [('cpu',), TWO_DEVICES],
                         ids=['one-device', 'two-devices'])
def test_sharded_seq_apply_matches_reference(devices):
    rng = np.random.default_rng(3)
    n_docs = 8
    arrays = sc.warm_arrays(rng, n_docs, 24, 4, 6)
    batch = sc.random_batch(rng, arrays, 8)
    jmesh = jsh.fleet_mesh(jax.devices()[:8], keys_axis=2)
    tmesh = _cpu_mesh(8, keys_axis=2, devices=devices)
    jst = jsh.shard_seq(js.SeqState(*(jnp.asarray(a) for a in arrays)),
                        jmesh)
    jops = jsh.shard_seq_ops(js.SeqOpBatch(*(jnp.asarray(c) for c in
                                             batch.columns())), jmesh)
    jnew, jn = jsh.sharded_seq_apply(jmesh)(jst, jops)
    tst = tsh.shard_seq(ts.seq_state_from_numpy(*arrays, device='cpu'),
                        tmesh)
    tnew, tn = tsh.sharded_seq_apply(tmesh)(
        tst, tsh.shard_seq_ops(batch.to('cpu'), tmesh))
    plain, pn = ts.apply_seq_batch(
        ts.seq_state_from_numpy(*arrays, device='cpu'), batch.to('cpu'))
    assert int(tn) == int(jn) == int(pn)
    for name, j, t, p in zip(sc.NAMES, jnew.tree_flatten()[0],
                             tnew.tensors(), plain.tensors()):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(t), p.numpy(),
                                      err_msg=name)
    # the input state is left intact, as the reference's
    for name, t, a in zip(sc.NAMES, tst.tensors(), arrays):
        np.testing.assert_array_equal(np.asarray(t), a, err_msg=name)


# ---------------------------------------------------------------------------
# the long document (ported from tests/test_sequence.py TestLongDocSharding)
# ---------------------------------------------------------------------------

def _long_doc(length, seed=0):
    """The reference's long document (tests/test_sequence.py): `length`
    inserts at random referents by 3 actors, counters rising, in a state
    of odd capacity (length + 61). Built as arrays: each insert carries
    the largest id yet, so it lands right after its referent. Returns
    (the eight arrays, the packed ids)."""
    rng = np.random.default_rng(seed)
    value = rng.integers(97, 123, (1, length), dtype=np.int32)
    actor = rng.integers(0, 3, (1, length), dtype=np.int32)
    packed = (((2 + np.arange(length)) << 8) | actor[0]).astype(np.int32)
    order = [0]                       # slot indices in sequence order
    for i in range(1, length):
        order.insert(order.index(int(rng.integers(0, i))) + 1, i)
    arrays = sc.empty_arrays(1, length + 61, 4)
    elem_id, nxt, reg, _killed, val, _counter, n, _inexact = arrays
    slots = js.SLOT0 + np.arange(length)
    elem_id[0, slots] = packed
    chain = [js.HEAD] + [js.SLOT0 + k for k in order] + [js.END]
    nxt[0, chain[:-1]] = chain[1:]
    reg[0, slots, actor[0]] = packed
    val[0, slots, actor[0]] = value[0]
    n[0] = length
    return arrays, packed[None, :]


def test_long_doc_arrays_equal_the_reference_inserts():
    """The long document built as arrays is the state the JAX engine's
    inserts leave."""
    arrays, packed = _long_doc(40, seed=5)
    rng = np.random.default_rng(5)
    value = rng.integers(97, 123, (1, 40), dtype=np.int32)
    rng.integers(0, 3, (1, 40), dtype=np.int32)
    ref = np.zeros((1, 40), dtype=np.int32)
    for i in range(1, 40):
        ref[0, i] = packed[0, int(rng.integers(0, i))]
    state, applied = js.apply_seq_batch(
        js.SeqState.empty(1, 101),
        js.SeqOpBatch(np.full((1, 40), js.INSERT, np.int32), ref, packed,
                      value))
    assert int(applied) == 40
    for name, j, a in zip(sc.NAMES, state.tree_flatten()[0], arrays):
        np.testing.assert_array_equal(a, np.asarray(j), err_msg=name)


def test_long_doc_sharded_matches_reference():
    """Slot-striped apply + materialize over 8 positions ((4, 2) mesh)
    with an odd capacity (a padded tail): every padded state array, the
    applied count and every materialized array equal the JAX package's,
    and the real prefix equals the unsharded apply's."""
    arrays, packed = _long_doc(500)
    extra = dict(
        kind=np.array([[js.SET, js.DEL]], dtype=np.int32),
        ref=np.array([[int(packed[0, 10]), int(packed[0, 20])]],
                     dtype=np.int32),
        packed=np.array([[(600 << 8) | 0, (601 << 8) | 1]], dtype=np.int32),
        value=np.array([[90, 0]], dtype=np.int32))
    jmesh = jsh.fleet_mesh(jax.devices()[:8], keys_axis=2)
    tmesh = _cpu_mesh(8, keys_axis=2)
    jsharded = jsh.shard_long_seq(
        js.SeqState(*(jnp.asarray(a) for a in arrays)), jmesh)
    tsharded = tsh.shard_long_seq(
        ts.seq_state_from_numpy(*arrays, device='cpu'), tmesh)
    pad = tsharded.elem_id.shape[1] - arrays[0].shape[1]
    assert pad > 0 and tsharded.elem_id.shape[1] % 8 == 0
    for name, j, t in zip(sc.NAMES, jsharded.tree_flatten()[0],
                          tsharded.tensors()):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                      err_msg=f'shard_long_seq {name}')
    jnew, jn = jsh.sharded_long_seq_apply(jmesh)(
        jsharded, js.SeqOpBatch(*extra.values()))
    tnew, tn = tsh.sharded_long_seq_apply(tmesh)(
        tsharded, ts.SeqOpBatch(*extra.values()))
    assert int(tn) == int(jn) == 2
    for name, j, t in zip(sc.NAMES, jnew.tree_flatten()[0],
                          tnew.tensors()):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                      err_msg=f'apply {name}')
    jmat = jsh.sharded_long_seq_materialize(jmesh)(jnew)
    tmat = tsh.sharded_long_seq_materialize(tmesh)(tnew)
    for name, j, t in zip(('vals', 'cnts', 'vis', 'n'), jmat, tmat):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                      err_msg=f'materialize {name}')
    local, _ = ts.apply_seq_batch(
        ts.seq_state_from_numpy(*arrays, device='cpu'),
        ts.SeqOpBatch(*extra.values()))
    lv, _lc, lvis, _ln = ts.materialize(local)
    sv, svis = np.asarray(tmat[0]), np.asarray(tmat[2])
    np.testing.assert_array_equal(sv[:, :lv.shape[1]], lv.numpy())
    np.testing.assert_array_equal(svis[:, :lvis.shape[1]], lvis.numpy())
    assert not svis[:, lvis.shape[1]:].any()
    assert ts.visible_text(local) == js.visible_text(jnew)
    # one device: the stripes are views of one tensor
    assert tnew.nxt.base is not None
    assert all(tsh._is_view_of(b, tnew.nxt.base) for b in tnew.nxt.blocks)


# ---------------------------------------------------------------------------
# DocFleet(mesh=...)
# ---------------------------------------------------------------------------

def test_cap_docs_stable_on_non_pow2_mesh_capacity():
    """As the reference's test_fleet_backend test: a mesh-rounded
    capacity (66 on 6 positions) is kept, growth pow2-then-rounds."""
    jfleet = jax_backend.DocFleet(
        doc_capacity=4, key_capacity=4,
        mesh=Mesh(np.array(jax.devices()[:6]), ('docs',)))
    tfleet = torch_backend.DocFleet(
        doc_capacity=4, key_capacity=4,
        mesh=tsh.FleetMesh(['cpu'] * 6, ('docs',)))
    assert tfleet.device == torch.device('cpu')
    for fleet in (jfleet, tfleet):
        fleet.doc_cap = 66
    for n in (10, 66, 67):
        assert tfleet._cap_docs(n) == jfleet._cap_docs(n)
    assert tfleet._cap_docs(67) == 132
    cap = tfleet._cap_docs(67)
    tfleet.doc_cap = cap
    assert tfleet._cap_docs(cap) == cap


def test_mesh_over_two_devices_raises_typed():
    """A fleet spans one device: a mesh whose docs positions lie on two
    raises ValueError naming the multi-process sync, before any
    allocation (the second device here cannot hold a tensor)."""
    mesh = tsh.FleetMesh([['cpu'], ['meta']], ('docs', 'keys'))
    with pytest.raises(ValueError, match='one process'):
        torch_backend.DocFleet(mesh=mesh)
    with pytest.raises(ValueError, match='not the mesh'):
        torch_backend.DocFleet(mesh=tsh.FleetMesh(['cpu'] * 2, ('docs',)),
                               device='meta')


_ACTORS = ['%02x' % (i + 1) * 16 for i in range(3)]


def _mesh_workload(n_docs, seed=0):
    """Two batches of per-doc changes: sets over 6 keys, a counter with
    incs, deletes (each op preds what it overwrites) from 3 actors."""
    rng = np.random.default_rng(seed)
    batches = [[[] for _ in range(n_docs)] for _ in range(2)]
    for d in range(n_docs):
        vis, heads, max_op, seqs = {}, [], 0, {}
        for b in range(2):
            for _c in range(3):
                actor = _ACTORS[int(rng.integers(0, 3))]
                ops = []
                for _o in range(int(rng.integers(1, 4))):
                    key = 'ctr' if rng.random() < 0.2 else \
                        f'k{int(rng.integers(0, 6))}'
                    pred = sorted(vis.get(key, ()))
                    if key == 'ctr' and pred:
                        op = {'action': 'inc', 'value':
                              int(rng.integers(-5, 6)),
                              'datatype': 'counter'}
                    elif key == 'ctr':
                        op = {'action': 'set', 'value': 1,
                              'datatype': 'counter'}
                    elif pred and rng.random() < 0.2:
                        op = {'action': 'del'}
                    else:
                        op = {'action': 'set',
                              'value': int(rng.integers(0, 1 << 20)),
                              'datatype': 'int'}
                    op.update(obj='_root', key=key, pred=pred)
                    oid = f'{max_op + 1 + len(ops)}@{actor}'
                    if op['action'] != 'inc':
                        vis[key] = set() if op['action'] == 'del' \
                            else {oid}
                    ops.append(op)
                seqs[actor] = seqs.get(actor, 0) + 1
                buf = encode_change({
                    'actor': actor, 'seq': seqs[actor],
                    'startOp': max_op + 1, 'time': 0, 'message': '',
                    'deps': heads, 'ops': ops})
                heads = [decode_change_meta(buf, True)['hash']]
                max_op += len(ops)
                batches[b][d].append(buf)
    return batches


@pytest.mark.parametrize('exact', [False, True], ids=['lww', 'exact'])
def test_mesh_fleet_seam_matches_reference(exact, monkeypatch):
    """The seam on a 4-position mesh fleet against the JAX mesh fleet:
    the grids (or register arrays), materialize_docs and save() bytes are
    equal, the ledger counts equal dispatches per kind, and every
    dispatch is one kernel call per docs block."""
    if not _NATIVE_OK:
        pytest.skip('a native codec is unavailable')
    n_docs = 8
    batches = _mesh_workload(n_docs, seed=int(exact))
    jfleet = jax_backend.DocFleet(
        doc_capacity=n_docs, key_capacity=8, exact_device=exact,
        mesh=Mesh(np.array(jax.devices()[:4]).reshape(4, 1),
                  ('docs', 'keys')))
    tfleet = torch_backend.DocFleet(
        doc_capacity=n_docs, key_capacity=8, exact_device=exact,
        mesh=_cpu_mesh(4))
    calls = []
    kernel = (tregisters, 'register_scan') if exact else \
        (tapply, 'lww_merge')
    real = getattr(*kernel)

    def spy(state, ops, *args, **kwargs):
        calls.append(ops.key_id.shape[0])
        return real(state, ops, *args, **kwargs)
    monkeypatch.setattr(*kernel, spy)
    reads = []
    for be, fleet, perf in ((jax_backend, jfleet, ref_perf),
                            (torch_backend, tfleet, obs_perf)):
        perf.disable_ledger()
        perf.reset_ledger()
        perf.enable_ledger()
        try:
            handles = be.init_docs(n_docs, fleet)
            for batch in batches:
                handles, _ = be.apply_changes_docs(handles, batch,
                                                   mirror=False)
            reads.append((be.materialize_docs(handles),
                          [bytes(be.save(h)) for h in handles],
                          {k: v['dispatches'] for k, v in
                           perf.kernel_snapshot().items()
                           if v['dispatches']}))
        finally:
            perf.disable_ledger()
            perf.reset_ledger()
    assert reads[1][0] == reads[0][0]
    assert reads[1][1] == reads[0][1]
    assert reads[1][2] == reads[0][2]
    assert tfleet.metrics.dispatches == jfleet.metrics.dispatches
    # one kernel call per docs block of each dispatch, a quarter of the
    # rows each
    rows = (tfleet.reg_state.reg if exact else tfleet.state.winners).shape[0]
    assert calls == [rows // 4] * (4 * tfleet.metrics.dispatches)
    if exact:
        jarrs = [np.asarray(a) for a in (
            jfleet.reg_state.reg, jfleet.reg_state.killed,
            jfleet.reg_state.value, jfleet.reg_state.counter,
            jfleet.reg_state.inexact)]
        tarrs = tregisters.register_state_to_numpy(tfleet.reg_state)
    else:
        jarrs = [np.asarray(a) for a in (jfleet.state.winners,
                                         jfleet.state.values,
                                         jfleet.state.counters)]
        tarrs = [t.numpy() for t in tfleet.state.tensors()]
        # the real key columns: the last is the padded lanes' scratch
        jarrs, tarrs = [a[:, :-1] for a in jarrs], [a[:, :-1] for a in tarrs]
    for j, t in zip(jarrs, tarrs):
        np.testing.assert_array_equal(t, j)
