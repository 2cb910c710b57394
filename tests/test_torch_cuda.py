"""Tests of the port's CUDA kernel that need an NVIDIA GPU (marker
`cuda`; they skip without one). The file imports only the port, so it
also runs on a machine without jax:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The hand-written kernel is held against its plain torch version on the
same inputs, and the seam on the card against the seam on the CPU.
Tolerance: none (exact int32 equality on the real key columns [:, :K];
column K is the scratch column and holds garbage by contract)."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.columnar import decode_change_meta, encode_change
from automerge_tpu_torch.fleet import apply
from automerge_tpu_torch.fleet import backend
from automerge_tpu_torch.fleet.merge_kernel import (LAUNCHES, lww_merge,
                                                    lww_merge_plain)
from automerge_tpu_torch.fleet.tensor_doc import (ACTOR_BITS, FleetState,
                                                  OpBatch, state_to_numpy)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def random_cols(rng, n_docs, n_keys, lanes, ctr0=1, inc=True):
    shape = (n_docs, lanes)
    key_id = rng.integers(0, n_keys, shape, dtype=np.int32)
    actor = rng.integers(0, 4, shape, dtype=np.int32)
    ctrs = ctr0 + np.broadcast_to(np.arange(lanes, dtype=np.int32), shape)
    packed = (ctrs.astype(np.int32) << ACTOR_BITS) | actor
    value = rng.integers(-50, 1000, shape, dtype=np.int32)
    is_set = rng.random(shape) < 0.7 if inc else np.ones(shape, bool)
    valid = rng.random(shape) < 0.9
    return [key_id, packed, value, is_set, ~is_set, valid]


def seeded(rng, n_docs, n_keys, device):
    state = FleetState.empty(n_docs, n_keys, device)
    lww_merge_plain(state, OpBatch(*random_cols(rng, n_docs, n_keys, 6))
                    .to(device))
    return state


def clone(state):
    return FleetState(*(t.clone() for t in state.tensors()))


def assert_grids_equal(ref, got, n_keys):
    torch.cuda.synchronize()
    for name, a, b in zip(('winners', 'values', 'counters'),
                          state_to_numpy(ref), state_to_numpy(got)):
        np.testing.assert_array_equal(b[:, :n_keys], a[:, :n_keys],
                                      err_msg=name)


@pytest.mark.parametrize('noinc,fresh', [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_kernel_matches_plain_version(cuda, noinc, fresh):
    """Every variant, with more lanes per doc (1,500) than threads in a
    block."""
    rng = np.random.default_rng(31)
    n_docs, n_keys = 300, 257
    base = seeded(rng, n_docs, n_keys, cuda)
    ops = OpBatch(*random_cols(rng, n_docs, n_keys, 1500, ctr0=7,
                               inc=not noinc)).to(cuda)
    ref, got = clone(base), clone(base)
    before = LAUNCHES['lww_merge']
    rs = lww_merge_plain(ref, ops, noinc=noinc, fresh=fresh)
    gs = lww_merge(got, ops, noinc=noinc, fresh=fresh)
    assert LAUNCHES['lww_merge'] == before + 1
    assert int(rs) == int(gs)
    assert_grids_equal(ref, got, n_keys)


def test_kills_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(37)
    n_docs, n_keys = 64, 40
    base = seeded(rng, n_docs, n_keys, cuda)
    cols = random_cols(rng, n_docs, n_keys, 24, ctr0=7)
    winners = base.winners.cpu().numpy()
    kk = np.zeros((n_docs, 4), np.int32)
    kp = np.zeros((n_docs, 4), np.int32)
    for d in range(n_docs):
        sets = np.flatnonzero(cols[3][d] & cols[5][d])
        live = np.flatnonzero(winners[d, :n_keys])
        if len(sets):
            lane = sets[rng.integers(0, len(sets))]
            kk[d, 0], kp[d, 0] = cols[0][d, lane], cols[1][d, lane]
        if len(live):
            key = live[rng.integers(0, len(live))]
            kk[d, 1], kp[d, 1] = key, winners[d, key]
    ops = OpBatch(*cols).to(cuda)
    kk_t, kp_t = torch.from_numpy(kk).to(cuda), torch.from_numpy(kp).to(cuda)
    ref = clone(base)
    apply.clear_killed(ref, kk_t, kp_t)
    lww_merge_plain(ref, apply.mask_killed_sets(ops, kp_t))
    got, _ = apply.apply_op_batch_kills(base, ops, kk_t, kp_t)
    assert_grids_equal(ref, got, n_keys)


def _seam_batch(n_docs, n_changes, seed):
    """Per-doc change lists: one chain of single-set changes by two
    alternating actors, different keys and values in every doc."""
    rng = np.random.default_rng(seed)
    actors = ['aa' * 16, 'bb' * 16]
    out = []
    for _ in range(n_docs):
        changes, heads, seqs = [], [], [0, 0]
        for c in range(n_changes):
            a = c % 2
            seqs[a] += 1
            buf = encode_change({
                'actor': actors[a], 'seq': seqs[a], 'startOp': c + 1,
                'time': 0, 'message': '', 'deps': heads,
                'ops': [{'action': 'set', 'obj': '_root',
                         'key': f'k{int(rng.integers(0, 30))}',
                         'value': int(rng.integers(1, 1 << 20)),
                         'datatype': 'int', 'pred': []}]})
            heads = [decode_change_meta(buf, True)['hash']]
            changes.append(buf)
        out.append(changes)
    return out


def test_seam_on_the_card_matches_the_cpu(cuda):
    per_doc = _seam_batch(24, 12, seed=3)
    results = {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(doc_capacity=24, key_capacity=31,
                                 device=dev)
        handles = backend.init_docs(24, fleet)
        before = LAUNCHES['lww_merge'], fleet.metrics.dispatches
        handles, _ = backend.apply_changes_docs(handles, per_doc,
                                                mirror=False)
        launched = LAUNCHES['lww_merge'] - before[0]
        dispatched = fleet.metrics.dispatches - before[1]
        assert dispatched == 1
        assert launched == (1 if dev == 'cuda' else 0)
        assert fleet.state.winners.device.type == dev
        results[dev] = (fleet.state, backend.materialize_docs(handles),
                        [bytes(h['state'].save()) for h in handles])
    (cpu_state, cpu_docs, cpu_saves) = results['cpu']
    (gpu_state, gpu_docs, gpu_saves) = results['cuda']
    assert gpu_docs == cpu_docs
    assert gpu_saves == cpu_saves
    assert_grids_equal(cpu_state, gpu_state, gpu_state.winners.shape[1] - 1)
