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
from automerge_tpu_torch.fleet import backend, merge_kernel
from automerge_tpu_torch.fleet.merge_cases import (CORNERS, clone,
                                                   corner_cols, launch_along,
                                                   random_cols, seeded)
from automerge_tpu_torch.fleet.merge_kernel import (LAUNCHES, lww_merge,
                                                    lww_merge_plain)
from automerge_tpu_torch.fleet.tensor_doc import (FleetState, OpBatch,
                                                  state_to_numpy)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


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


def _kills_case(device, p, seed):
    rng = np.random.default_rng(seed)
    n_docs, n_keys = 64, 40
    base = seeded(rng, n_docs, n_keys, device)
    cols = random_cols(rng, n_docs, n_keys, p, ctr0=7)
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
    ops = OpBatch(*cols).to(device)
    kk_t = torch.from_numpy(kk).to(device)
    kp_t = torch.from_numpy(kp).to(device)
    ref = clone(base)
    apply.clear_killed(ref, kk_t, kp_t)
    lww_merge_plain(ref, apply.mask_killed_sets(ops, kp_t))
    before = LAUNCHES['lww_merge']
    got, _ = apply.apply_op_batch_kills(base, ops, kk_t, kp_t)
    assert LAUNCHES['lww_merge'] == before + 1
    assert_grids_equal(ref, got, n_keys)


def test_kills_kernel_matches_plain_version(cuda):
    _kills_case(cuda, 24, seed=37)


def test_wide_kills_kernel_matches_plain_version(cuda):
    """Kills pre-pass + the cta route (P > 32)."""
    _kills_case(cuda, 40, seed=39)


VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize('p', [0, 1, 20, 31, 32, 33, 1500])
@pytest.mark.parametrize('noinc,fresh', VARIANTS)
def test_routes_match_plain_version(cuda, noinc, fresh, p):
    """Every variant on each side of the warp/cta split; fresh batches
    take the fresh route at any P."""
    rng = np.random.default_rng(43 + p)
    n_docs, n_keys = 300, 257
    base = seeded(rng, n_docs, n_keys, cuda)
    ops = OpBatch(*random_cols(rng, n_docs, n_keys, p, ctr0=7,
                               inc=not noinc)).to(cuda)
    plan = merge_kernel._launch_plan(n_docs, p, n_keys + 1, fresh)
    assert plan.route == ('fresh' if fresh else 'warp' if p <= 32 else 'cta')
    ref, got = clone(base), clone(base)
    before = LAUNCHES['lww_merge']
    rs = lww_merge_plain(ref, ops, noinc=noinc, fresh=fresh)
    gs = lww_merge(got, ops, noinc=noinc, fresh=fresh)
    assert LAUNCHES['lww_merge'] == before + 1
    assert int(rs) == int(gs)
    assert_grids_equal(ref, got, n_keys)


def _launch_along(route, state, ops, noinc=False):
    """One kernel launch along `route` whatever the batch's P; returns
    the valid-lane count."""
    before = LAUNCHES['lww_merge']
    stats = launch_along(route, state, ops, noinc)
    assert LAUNCHES['lww_merge'] == before + 1
    return int(stats)


@pytest.mark.parametrize('p', [20, 32])
@pytest.mark.parametrize('noinc', [False, True])
def test_cta_route_at_warp_widths(cuda, noinc, p):
    rng = np.random.default_rng(47 + p)
    n_docs, n_keys = 300, 257
    base = seeded(rng, n_docs, n_keys, cuda)
    ops = OpBatch(*random_cols(rng, n_docs, n_keys, p, ctr0=7,
                               inc=not noinc)).to(cuda)
    ref, got = clone(base), clone(base)
    rs = lww_merge_plain(ref, ops, noinc=noinc)
    assert _launch_along('cta', got, ops, noinc) == int(rs)
    assert_grids_equal(ref, got, n_keys)


@pytest.mark.parametrize('route', ['warp', 'cta', 'fresh'])
@pytest.mark.parametrize('case', CORNERS)
def test_corner_inputs_match_plain_version(cuda, case, route):
    rng = np.random.default_rng(53)
    n_docs, p = 96, 32
    n_keys = 3 if case == 'collision' else 40
    base = seeded(rng, n_docs, n_keys, cuda)
    ops = OpBatch(*corner_cols(case, rng, base, n_keys, p)).to(cuda)
    ref, got = clone(base), clone(base)
    rs = lww_merge_plain(ref, ops, fresh=route == 'fresh')
    assert _launch_along(route, got, ops) == int(rs)
    assert_grids_equal(ref, got, n_keys)


@pytest.mark.parametrize('noinc', [False, True])
def test_fresh_rows_wider_than_a_tile_match_plain_version(cuda, noinc):
    """K+1 = 20,001: the fresh route walks each row in key chunks."""
    rng = np.random.default_rng(59)
    n_docs, n_keys, p = 37, 20_000, 48
    plan = merge_kernel._launch_plan(n_docs, p, n_keys + 1, True)
    assert plan.key_chunk < n_keys + 1
    cols = random_cols(rng, n_docs, n_keys + 1, p, inc=not noinc)
    edges = np.arange(plan.key_chunk, n_keys + 1, plan.key_chunk)
    near = np.concatenate([edges - 1, edges, [0, n_keys - 1, n_keys]])
    for c, x in zip(cols, (near, None, None, True, False, True)):
        if x is not None:
            c[:, :len(near)] = x
    ops = OpBatch(*cols).to(cuda)
    ref = FleetState.empty(n_docs, n_keys, cuda)
    got = FleetState(*(torch.full_like(t, 7) for t in ref.tensors()))
    before = LAUNCHES['lww_merge']
    rs = lww_merge_plain(ref, ops, noinc=noinc, fresh=True)
    gs = lww_merge(got, ops, noinc=noinc, fresh=True)
    assert LAUNCHES['lww_merge'] == before + 1
    assert int(rs) == int(gs)
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
