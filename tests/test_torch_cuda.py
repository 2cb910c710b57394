"""Tests of the port's CUDA kernels that need an NVIDIA GPU (marker
`cuda`; they skip without one). The file imports only the port, so it
also runs on a machine without jax:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Each hand-written kernel is held against its plain torch version on the
same inputs, and the seam, a sync round and an exact-device seam and
a text seam (both device modes) on the card against the same on the
CPU. Tolerance: none (exact int32 equality on
the merge's real key columns [:, :K], whose column K is the scratch
column and holds garbage by contract; equal Bloom bytes and probe
answers; equal hash-index membership and new-key counts, since the
insert kernel's slot layout may differ where rows race for a slot;
equal register arrays, all five; equal sequence arrays, all eight, and
applied counts)."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.columnar import decode_change_meta, encode_change
from automerge_tpu_torch.backend import init_sync_state
from automerge_tpu_torch.fleet import apply
from automerge_tpu_torch.fleet import backend, merge_kernel
from automerge_tpu_torch.fleet import register_cases, register_kernel
from automerge_tpu_torch.fleet import seq_cases, seq_kernel
from automerge_tpu_torch.fleet import sync_cases, sync_driver, sync_kernels
from automerge_tpu_torch.fleet.merge_cases import (CORNERS, clone,
                                                   corner_cols, launch_along,
                                                   random_cols, seeded)
from automerge_tpu_torch.fleet.merge_kernel import (LAUNCHES, lww_merge,
                                                    lww_merge_plain)
from automerge_tpu_torch.fleet.tensor_doc import (FleetState, OpBatch,
                                                  state_to_numpy)

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


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


# ---- the sync plane's kernels ----------------------------------------------

@pytest.mark.parametrize('name', sync_cases.INDEX_CASES)
def test_index_kernels_match_plain_versions(cuda, name):
    """Insert (every key at one start slot, a chain wrapping at cap - 1,
    in-batch duplicates and present keys, the 0.6 load bound, many
    spaces) and probe, kernel against plain version."""
    case = sync_cases.index_case(name, np.random.default_rng(41), cuda)
    before = dict(sync_kernels.LAUNCHES)
    got = sync_cases.index_both(case)
    assert (got['insert'], got['probe'], got['wrong']) == (0, 0, 0), got
    for kernel in ('hashindex_insert', 'hashindex_probe'):
        assert sync_kernels.LAUNCHES[kernel] == before[kernel] + 1


@pytest.mark.parametrize('counts', sorted(sync_cases.BLOOM_COUNTS))
def test_bloom_kernels_match_plain_versions(cuda, counts):
    """Build filters of the given sizes and probe each with its members
    and as many strangers, kernel against plain version."""
    before = dict(sync_kernels.LAUNCHES)
    got = sync_cases.bloom_both(np.random.default_rng(43),
                                sync_cases.BLOOM_COUNTS[counts], cuda)
    assert (got['build'], got['probe'], got['missed']) == (0, 0, 0), got
    for kernel in ('bloom_build', 'bloom_probe'):
        assert sync_kernels.LAUNCHES[kernel] == before[kernel] + 1


@pytest.mark.parametrize('name', sync_cases.BLOOM_PROBE_CASES)
def test_bloom_probe_corners_match_plain_version(cuda, name):
    """The probe alone: every lane a member (all 7 gathers find their
    bit), every filter empty, and a row of more than 2^31 bits, whose
    probe steps keep the uint32 modulo chain; kernel against plain
    version."""
    case = sync_cases.bloom_probe_case(name, np.random.default_rng(44),
                                       cuda)
    before = sync_kernels.LAUNCHES['bloom_probe']
    got = sync_cases.bloom_probe_both(case)
    assert got['probe'] == 0, got
    assert sync_kernels.LAUNCHES['bloom_probe'] == before + 1
    if name == 'all_present':
        assert got['hits'] == got['valid'] == got['lanes']
    elif name == 'all_absent':
        assert got['hits'] == 0
    else:
        assert 0 < got['hits'] < got['valid']


def test_grow_by_migration_on_the_card_matches_the_cpu(cuda):
    """A table that grows twice and drops two dead spaces on the way
    (the migration re-inserts the old table's live rows on the device)
    answers every probe as the same table on the CPU does."""
    from automerge_tpu_torch.fleet import hashindex
    rng = np.random.default_rng(47)
    keys = rng.integers(0, 256, (700, 32), dtype=np.uint8)
    spaces = rng.integers(0, 6, 400).astype(np.int32)
    probe_spaces = rng.integers(0, 7, 700).astype(np.int32)  # 6: never minted
    answers, lengths = {}, {}
    for dev in ('cpu', 'cuda'):
        t = hashindex.HashIndex(capacity=8, device_min=1, load_max=0.5,
                                device=dev)
        for _ in range(6):
            t.new_space()
        before = sync_kernels.LAUNCHES['hashindex_insert']
        for lo in range(0, 400, 100):
            t.insert(spaces[lo:lo + 100], keys[lo:lo + 100])
        assert t.grows >= 2
        t.release_space(0)
        t.release_space(1)
        t.insert(2, keys[400:])             # grows, dropping the dead
        lengths[dev] = (t.cap, t.grows, len(t))
        answers[dev] = t.probe(probe_spaces, keys)
        launched = sync_kernels.LAUNCHES['hashindex_insert'] - before
        # one launch per insert call, one per migration
        assert launched == (0 if dev == 'cpu' else 5 + t.grows)
    assert lengths['cuda'] == lengths['cpu']
    np.testing.assert_array_equal(answers['cuda'], answers['cpu'])


def _sync_round(dev, n_links=64):
    """A fleet of 4 docs serving n_links peer links, each peer soliciting
    a full resend every round (a cold round, then steady rounds); a
    fresh fleet of n_links replicas
    receives the cold round, each replica makes a local edit and
    replies, probing the hub's filter. Returns every message, the
    replicas' saves, and the launches the run made."""
    rows = _seam_batch(4, 6, seed=5)
    fleet = backend.DocFleet(doc_capacity=4, key_capacity=31, device=dev)
    hub = backend.init_docs(4, fleet)
    hub, _ = backend.apply_changes_docs(hub, rows, mirror=False)
    fleet.frontier_index(device_min=1)
    before = dict(sync_kernels.LAUNCHES)
    links = [hub[i % 4] for i in range(n_links)]
    states = [init_sync_state() for _ in range(n_links)]
    msgs = []
    for r in range(3):
        for st in states:          # the peer solicits a full resend
            st.update(theirHeads=[], theirNeed=[],
                      theirHave=[{'lastSync': [], 'bloom': b''}])
        states, out = sync_driver.generate_sync_messages_docs(links, states)
        msgs += out
        if r == 0:
            cold = out
    replica = backend.DocFleet(doc_capacity=n_links, key_capacity=31,
                               device=dev)
    replica.frontier_index(device_min=1)
    peers = backend.init_docs(n_links, replica)
    peer_states = [init_sync_state() for _ in range(n_links)]
    peers, peer_states, _ = sync_driver.receive_sync_messages_docs(
        peers, peer_states, cold)
    assert [bytes(p['state'].save()) for p in peers] == \
        [bytes(hub[i % 4]['state'].save()) for i in range(n_links)]
    edits = [[encode_change({
        'actor': f'{i + 1:032x}', 'seq': 1, 'startOp': 7, 'time': 0,
        'message': '', 'deps': list(p['heads']),
        'ops': [{'action': 'set', 'obj': '_root', 'key': 'local',
                 'value': i, 'datatype': 'int', 'pred': []}]})]
        for i, p in enumerate(peers)]
    peers, _ = backend.apply_changes_docs(peers, edits, mirror=False)
    peer_states, replies = sync_driver.generate_sync_messages_docs(
        peers, peer_states)
    launched = {k: sync_kernels.LAUNCHES[k] - before[k] for k in before}
    saves = [bytes(p['state'].save()) for p in peers]
    return [bytes(m) if m is not None else None
            for m in msgs + replies], saves, launched


def test_sync_round_on_the_card_matches_the_cpu(cuda):
    cpu_msgs, cpu_saves, cpu_launched = _sync_round('cpu')
    gpu_msgs, gpu_saves, gpu_launched = _sync_round('cuda')
    assert gpu_msgs == cpu_msgs
    assert gpu_saves == cpu_saves
    assert not any(cpu_launched.values())
    assert all(gpu_launched.values()), gpu_launched


# ---- the register scan ------------------------------------------------------

@pytest.mark.parametrize('lanes', [0, 1, 5, 20, 31, 32, 33, 3000])
@pytest.mark.parametrize('name', register_cases.CASES)
def test_register_scan_matches_plain_version(cuda, name, lanes):
    """Every corner of fleet/register_cases.py at P = 0, 1, 5, 20, 31,
    32, 33 and 3,000 op lanes per doc (8 actor slots, 4 pred lanes): 32,
    8 and 1 docs to a warp, one tile or two, a second tile of one lane.
    At P = 3,000 the plain version runs on the CPU: its Python loop
    would make ~200,000 small launches on the card."""
    rng = np.random.default_rng(61 + register_cases.CASES.index(name))
    n_docs = 40 if lanes == 3000 else 300
    state, batch = register_cases.case(name, rng, n_docs, 40, 8, lanes, 4)
    before = register_kernel.LAUNCHES['register_scan']
    got = register_cases.both(state, batch, cuda,
                              'cpu' if lanes == 3000 else None)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got
    assert register_kernel.LAUNCHES['register_scan'] == \
        before + (1 if lanes else 0)
    # the kernel's arrival word is back at 0 for the next launch
    assert not any(int(w) for w in register_kernel._ARRIVALS.values())


@pytest.mark.parametrize('name', register_cases.CASES)
def test_register_scan_at_256_actor_slots(cuda, name):
    rng = np.random.default_rng(71 + register_cases.CASES.index(name))
    state, batch = register_cases.case(name, rng, 48, 9, 256, 20, 4)
    got = register_cases.both(state, batch, cuda)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got


@pytest.mark.parametrize('slots', [1, 2, 3, 4, 16])
@pytest.mark.parametrize('name', register_cases.CASES)
def test_register_scan_at_other_slot_widths(cuda, name, slots):
    """The scan at 1, 2, 3, 4 and 16 actor slots (and at 8 and 256
    above)."""
    rng = np.random.default_rng(91 + register_cases.CASES.index(name))
    state, batch = register_cases.case(name, rng, 64, 9, slots, 20, 4)
    got = register_cases.both(state, batch, cuda)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got


@pytest.mark.parametrize('slots', [8, 256])
@pytest.mark.parametrize('d_preds', [1, 6, 9])
@pytest.mark.parametrize('name', register_cases.CASES)
def test_register_scan_pred_widths(cuda, name, d_preds, slots):
    """Fewer preds than the kernel holds in registers (1), and more (6, 9:
    the rest read in chunks of 4)."""
    rng = np.random.default_rng(97 + register_cases.CASES.index(name))
    state, batch = register_cases.case(name, rng, 64, 9, slots, 33,
                                       d_preds)
    got = register_cases.both(state, batch, cuda)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got


def test_exact_seam_on_the_card_matches_the_cpu(cuda):
    """register_cases.exact_seam_changes' three batches (a chain whose
    sets pred their key's standing op; concurrent changes that renumber
    every actor lane, resurrect a deleted key, conflict and set a
    counter; an inc) through DocFleet(exact_device=True) on each
    device."""
    from automerge_tpu_torch.fleet.registers import register_state_to_numpy
    batches = register_cases.exact_seam_changes(12, 30, seed=7)
    n_docs = 24
    results = {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(doc_capacity=n_docs, key_capacity=31,
                                 exact_device=True, device=dev)
        handles = backend.init_docs(n_docs, fleet)
        before = register_kernel.LAUNCHES['register_scan']
        for batch in batches:
            d0 = fleet.metrics.dispatches
            handles, _ = backend.apply_changes_docs(
                handles, [list(batch) for _ in range(n_docs)], mirror=False)
            assert fleet.metrics.dispatches == d0 + 1
        launched = register_kernel.LAUNCHES['register_scan'] - before
        assert launched == (3 if dev == 'cuda' else 0)
        assert fleet.reg_state.reg.device.type == dev
        results[dev] = (backend.materialize_docs(handles),
                        fleet.conflicts_all(), fleet.inexact_slots(),
                        [backend.get_patch(h) for h in handles[:4]],
                        [bytes(h['state'].save()) for h in handles],
                        register_state_to_numpy(fleet.reg_state))
    cpu, gpu = results['cpu'], results['cuda']
    assert gpu[:5] == cpu[:5]
    assert gpu[1][0] and not gpu[2]         # a conflict, nothing inexact
    for a, b in zip(cpu[5], gpu[5]):
        np.testing.assert_array_equal(b, a)


# ---- the sequence scan ------------------------------------------------------

@pytest.mark.parametrize('lanes', [0, 1, 20, 512])
@pytest.mark.parametrize('name', seq_cases.CASES)
def test_seq_scan_matches_plain_version(cuda, name, lanes):
    """Every corner of fleet/seq_cases.py at P = 0, 1, 20 and 512 op lanes
    per doc (4 actor lanes, capacity 64; the 'capacity' case fills its
    rows). At P = 512 the plain version runs on the CPU: its Python loop
    would issue ~60,000 small launches on the card."""
    rng = np.random.default_rng(91 + seq_cases.CASES.index(name))
    n_docs = 24 if lanes == 512 else 64
    state, batch = seq_cases.case(name, rng, n_docs, 64, 4, lanes)
    before = seq_kernel.LAUNCHES['seq_scan']
    got = seq_cases.both(state, batch, cuda, 'cpu' if lanes == 512 else None)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got
    assert seq_kernel.LAUNCHES['seq_scan'] == before + (1 if lanes else 0)


@pytest.mark.parametrize('name', seq_cases.CASES)
def test_seq_scan_at_256_actor_lanes(cuda, name):
    rng = np.random.default_rng(97 + seq_cases.CASES.index(name))
    state, batch = seq_cases.case(name, rng, 16, 40, 256, 20)
    got = seq_cases.both(state, batch, cuda)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got


def _serial_rows_expected(state, batch):
    """Rows the kernel must send to its serial route: rows with a live op
    where `resolve_plain` finds the parallel resolution inexact."""
    from automerge_tpu_torch.fleet.sequence import seq_state_from_numpy
    st = seq_state_from_numpy(*state, device='cpu')
    ops = batch.to('cpu')
    res = seq_kernel.resolve_plain(st, ops)
    live = ((ops.kind >= seq_kernel.INSERT) &
            (ops.kind <= seq_kernel.INC)).any(dim=1)
    return int((live & ~res.exact).sum())


@pytest.mark.parametrize('lanes', [40, 300])
@pytest.mark.parametrize('route', ['resident', 'global'])
@pytest.mark.parametrize('name', seq_cases.CASES)
def test_seq_scan_routes_match_plain_version(cuda, name, route, lanes):
    """Every corner along each route (forced), at P = 40 (two 32-column
    chunks) and 300 (three of phase B's 128-column loads); the rows that
    take the serial route are the ones the plain statement of the
    parallel resolution calls inexact."""
    rng = np.random.default_rng(131 + seq_cases.CASES.index(name))
    state, batch = seq_cases.case(name, rng, 32 if lanes == 40 else 8, 64,
                                  4, lanes)
    got = seq_cases.both(state, batch, cuda, 'cpu' if lanes == 300 else None,
                         route=route)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got
    assert got['route'] == route
    assert got['serial_rows'] == _serial_rows_expected(state, batch)


def test_seq_scan_serial_and_parallel_corners_take_their_routes(cuda):
    for name, serial in (('serial', True), ('capacity', True),
                         ('hot_node', False), ('dup_ids', False)):
        rng = np.random.default_rng(7)
        state, batch = seq_cases.case(name, rng, 16, 64, 4, 40)
        got = seq_cases.both(state, batch, cuda)
        assert got['differ'] == [] and got['max_abs_err'] == 0, got
        assert (got['serial_rows'] > 0) == serial, (name, got)


def test_seq_scan_on_a_class_past_the_resident_route(cuda):
    """Three rows of a class whose rows do not fit a CTA's shared memory:
    the wrapper's plan takes the 'global' route."""
    rng = np.random.default_rng(43)
    state, batch = seq_cases.case('random', rng, 3, seq_cases.GLOBAL_CAPACITY,
                                  4, 30)
    before = seq_kernel.ROUTE_LAUNCHES['global']
    got = seq_cases.both(state, batch, cuda)
    assert got['differ'] == [] and got['max_abs_err'] == 0, got
    assert got['route'] == 'global'
    assert seq_kernel.ROUTE_LAUNCHES['global'] == before + 1


@pytest.mark.parametrize('exact', [False, True])
def test_text_seam_on_the_card_matches_the_cpu(cuda, exact):
    """seq_cases.text_changes' trace (a makeText, then inserts and deletes
    by 3 actors on one chain) and two incremental batches through
    DocFleet on each device: one sequence dispatch (one launch on the
    card) per batch, the same texts, patches, saves and pool arrays."""
    from automerge_tpu_torch.fleet.sequence import seq_state_to_numpy
    batches = seq_cases.text_changes(300, more=(32, 32), seed=5)
    n_docs = 12
    results = {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(doc_capacity=n_docs, key_capacity=4,
                                 exact_device=exact, device=dev)
        handles = backend.init_docs(n_docs, fleet)
        before = seq_kernel.LAUNCHES['seq_scan']
        for batch in batches:
            handles, _ = backend.apply_changes_docs(
                handles, [list(batch) for _ in range(n_docs)], mirror=False)
        launched = seq_kernel.LAUNCHES['seq_scan'] - before
        assert launched == (len(batches) if dev == 'cuda' else 0)
        assert fleet.metrics.fallbacks == 0
        pools = {cls: seq_state_to_numpy(st)
                 for cls, st in fleet.seq_pools.pools.items()}
        results[dev] = (backend.materialize_docs(handles),
                        [backend.get_patch(h) for h in handles[:3]],
                        [bytes(h['state'].save()) for h in handles],
                        fleet.metrics.dispatches, pools)
    cpu, gpu = results['cpu'], results['cuda']
    assert gpu[:4] == cpu[:4]
    assert sorted(gpu[4]) == sorted(cpu[4])
    for cls in cpu[4]:
        for a, b in zip(cpu[4][cls], gpu[4][cls]):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize('exact', [False, True])
def test_load_park_rebuild_on_the_card_matches_the_cpu(cuda, exact):
    """Saved documents (a map of sets, a counter with incs and a delete;
    the text trace of seq_cases) bulk-load through load_docs on each
    device, take one more batch, half of them park and take another, and
    all rebuild into a fresh fleet: the same documents, patches, saves,
    device arrays and dispatches on both. On the card the load launches
    no kernel and migrates no sequence row (every placed row is a fresh
    allocation), and each follow-up batch is one launch."""
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.fleet import load_docs, registers, sequence
    actor = 'aa' * 16
    c1 = encode_change({
        'actor': actor, 'seq': 1, 'startOp': 1, 'time': 0, 'message': '',
        'deps': [], 'ops': [
            {'action': 'set', 'obj': '_root', 'key': 'x', 'value': 1,
             'datatype': 'int', 'pred': []},
            {'action': 'set', 'obj': '_root', 'key': 'c', 'value': 10,
             'datatype': 'counter', 'pred': []},
            {'action': 'set', 'obj': '_root', 'key': 'gone', 'value': 'g',
             'pred': []}]})
    h1 = decode_change_meta(c1, True)['hash']
    c2 = encode_change({
        'actor': actor, 'seq': 2, 'startOp': 4, 'time': 0, 'message': '',
        'deps': [h1], 'ops': [
            {'action': 'inc', 'obj': '_root', 'key': 'c', 'value': 5,
             'pred': [f'2@{actor}']},
            {'action': 'del', 'obj': '_root', 'key': 'gone',
             'pred': [f'3@{actor}']}]})
    mb = host.init()
    mb, _ = host.apply_changes(mb, [c1, c2])
    text = seq_cases.text_changes(300, more=(40, 40), seed=5)
    tb_ = host.init()
    for batch in text[:2]:
        tb_, _ = host.apply_changes(tb_, batch)
    c3 = encode_change({
        'actor': 'bb' * 16, 'seq': 1, 'startOp': 6, 'time': 0, 'message': '',
        'deps': host.get_heads(mb), 'ops': [
            {'action': 'set', 'obj': '_root', 'key': 'x', 'value': 2,
             'datatype': 'int', 'pred': [f'1@{actor}']}]})
    bufs = [bytes(host.save(mb)), bytes(host.save(tb_))] * 4
    follow = [[c3], list(text[2])] * 4
    results = {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(doc_capacity=8, key_capacity=8,
                                 exact_device=exact, device=dev)
        before = (LAUNCHES['lww_merge'], register_kernel.LAUNCHES[
            'register_scan'], seq_kernel.LAUNCHES['seq_scan'])
        handles = load_docs(bufs, fleet)
        assert fleet.metrics.docs_bulk_loaded == len(bufs)
        assert not any(fleet.seq_pools.free.values())   # no migration
        assert (LAUNCHES['lww_merge'], register_kernel.LAUNCHES[
            'register_scan'], seq_kernel.LAUNCHES['seq_scan']) == before
        loaded = (backend.materialize_docs(handles),
                  [bytes(h['state'].save()) for h in handles])
        assert loaded[1] == bufs
        handles, _ = backend.apply_changes_docs(handles, follow,
                                                mirror=False)
        scans = seq_kernel.LAUNCHES['seq_scan'] - before[2]
        merges = (register_kernel.LAUNCHES['register_scan'] - before[1]
                  if exact else LAUNCHES['lww_merge'] - before[0])
        assert (scans, merges) == ((1, 1) if dev == 'cuda' else (0, 0))
        # copies: on the CPU the arrays share the tensors' memory, which
        # the batches below change in place
        if exact:
            arrays = [a.copy() for a in
                      registers.register_state_to_numpy(fleet.reg_state)]
        else:      # the grids' real key columns (column K is scratch)
            arrays = [a[:, :fleet.key_cap].copy()
                      for a in state_to_numpy(fleet.state)]
        pools = {cls: [a.copy() for a in sequence.seq_state_to_numpy(st)]
                 for cls, st in fleet.seq_pools.pools.items()}
        edited = (backend.materialize_docs(handles),
                  [backend.get_patch(h) for h in handles],
                  [bytes(h['state'].save()) for h in handles])
        assert backend.park_docs(handles[:4]) == 4
        more = encode_change({
            'actor': 'bb' * 16, 'seq': 2, 'startOp': 7, 'time': 0,
            'message': '', 'deps': backend.get_heads(handles[0]), 'ops': [
                {'action': 'set', 'obj': '_root', 'key': 'y', 'value': 3,
                 'datatype': 'int', 'pred': []}]})
        handles, _ = backend.apply_changes_docs(
            handles, [[more], [], [more], []] * 2, mirror=False)
        rebuilt = backend.rebuild_docs(
            handles, backend.DocFleet(doc_capacity=8, key_capacity=8,
                                      exact_device=exact, device=dev))
        assert backend.materialize_docs(rebuilt)[4] == \
            backend.materialize_docs(rebuilt)[0]
        results[dev] = (loaded, edited, arrays, pools,
                        backend.materialize_docs(rebuilt),
                        [bytes(h['state'].save()) for h in rebuilt],
                        fleet.metrics.dispatches)
    cpu, gpu = results['cpu'], results['cuda']
    assert gpu[:2] == cpu[:2] and gpu[4:] == cpu[4:]
    for a, b in zip(cpu[2], gpu[2]):
        np.testing.assert_array_equal(b, a)
    assert sorted(gpu[3]) == sorted(cpu[3])
    for cls in cpu[3]:
        for a, b in zip(cpu[3][cls], gpu[3][cls]):
            np.testing.assert_array_equal(b, a)


def _device_arrays(fleet):
    """Copies of the fleet's device state: the registers in exact mode,
    else the LWW grids' real key columns (column K is scratch)."""
    from automerge_tpu_torch.fleet import registers
    if fleet.exact_device:
        return [a.copy() for a in
                registers.register_state_to_numpy(fleet.reg_state)]
    return [a[:, :fleet.key_cap].copy() for a in state_to_numpy(fleet.state)]


@pytest.mark.parametrize('exact', [False, True])
def test_durable_fleet_on_the_card_matches_the_cpu(cuda, tmp_path, exact):
    """The crash harness's journaled workload (12 docs, a checkpoint, a
    journal suffix, a freed doc) run by a DurableFleet on each device:
    the two directories are equal file for file, and each recovers on
    its own device to the same saves and report, the same documents read
    from the device (materialize_docs by durable id) and the same device
    state (the grids, or the registers in exact mode), the card's replay
    launching the merge (or the register scan in exact mode)."""
    import os
    from automerge_tpu_torch.fleet import crash_cases
    from automerge_tpu_torch.fleet.durability import DurableFleet

    def tree(path):
        return {name: open(os.path.join(path, name), 'rb').read()
                for name in sorted(os.listdir(path))}
    results, arrays = {}, {}
    for dev in ('cpu', 'cuda'):
        path = str(tmp_path / dev)
        pre, freed = crash_cases.build_run(path, n_docs=12, seed=1,
                                           free_doc=4, exact_device=exact,
                                           device=dev)
        files = tree(path)
        before = (LAUNCHES['lww_merge'],
                  register_kernel.LAUNCHES['register_scan'])
        mgr, rec, report = DurableFleet.recover(path, exact_device=exact,
                                                device=dev)
        after = (LAUNCHES['lww_merge'],
                 register_kernel.LAUNCHES['register_scan'])
        saves = {did: bytes(h['state'].save()) for did, h in rec.items()}
        assert saves == pre and freed == [4]
        assert mgr.fleet.device.type == dev
        launched = after[1] - before[1] if exact else after[0] - before[0]
        assert (launched > 0) == (dev == 'cuda')
        dids = sorted(rec)
        docs = dict(zip(dids, backend.materialize_docs(
            [rec[did] for did in dids])))
        slots = {did: rec[did]['state']._impl.slot for did in dids}
        results[dev] = (files, saves, repr(report), report.ok, docs, slots)
        arrays[dev] = _device_arrays(mgr.fleet)
        mgr.close()
    assert results['cuda'] == results['cpu']
    assert results['cuda'][3] and results['cuda'][2].count('replayed=0') == 0
    for a, b in zip(arrays['cpu'], arrays['cuda']):
        np.testing.assert_array_equal(b, a)


def test_storage_engine_revives_onto_the_card(cuda, tmp_path):
    """Chunks parked on a disk arena revive into a StorageEngine's
    fleet on the card, equal to the same revive on the CPU (saves, the
    documents read from the device, the grids); the revived docs take
    one more batch (one merge launch on the card) and repark under their
    ids."""
    from automerge_tpu_torch.fleet.storage import StorageEngine
    rows = [[encode_change({
        'actor': f'{d:04x}' * 4, 'seq': 1, 'startOp': 1, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': f'k{d % 3}',
                 'value': d, 'datatype': 'int', 'pred': []}]})]
        for d in range(16)]
    src = backend.DocFleet(device='cpu')
    handles, _ = backend.apply_changes_docs(backend.init_docs(16, src), rows,
                                            mirror=False)
    chunks = [bytes(h['state'].save()) for h in handles]
    results, arrays = {}, {}
    for dev in ('cpu', 'cuda'):
        eng = StorageEngine(path=str(tmp_path / dev), device=dev)
        ids = eng.ingest_chunks(chunks)
        back = eng.revive(ids[4:12])
        assert eng.fleet.state.winners.device.type == dev
        assert [bytes(h['state'].save()) for h in back] == chunks[4:12]
        revived = (backend.materialize_docs(back), _device_arrays(eng.fleet))
        more = [[encode_change({
            'actor': 'ee' * 16, 'seq': 1, 'startOp': 2, 'time': 0,
            'message': '', 'deps': list(h['heads']),
            'ops': [{'action': 'set', 'obj': '_root', 'key': 'z',
                     'value': 1, 'datatype': 'int', 'pred': []}]})]
            for h in back]
        before = LAUNCHES['lww_merge']
        back, _ = backend.apply_changes_docs(back, more, mirror=False)
        assert (LAUNCHES['lww_merge'] - before > 0) == (dev == 'cuda')
        saves = [bytes(h['state'].save()) for h in back]
        edited = (backend.materialize_docs(back), _device_arrays(eng.fleet))
        eng.repark(back, ids[4:12])
        results[dev] = (backend.materialize_docs(eng.revive(ids)), saves,
                        sorted(eng._row_of))
        arrays[dev] = (revived, edited)
        eng.close()
    assert results['cuda'] == results['cpu']
    assert arrays['cpu'][0][0] == [{f'k{d % 3}': d} for d in range(4, 12)]
    for (cpu_docs, cpu_grids), (gpu_docs, gpu_grids) in zip(arrays['cpu'],
                                                            arrays['cuda']):
        assert gpu_docs == cpu_docs
        for a, b in zip(cpu_grids, gpu_grids):
            np.testing.assert_array_equal(b, a)


def test_mixed_round_on_the_card_matches_the_cpu(cuda):
    """64 parked docs with quiet converged peer states (the per-link
    host protocol run to quiescence), 8 of which changed on the hub
    since and whose peers send a new change: receive_sync_messages_mixed
    then generate_sync_messages_mixed on each device. The same 8 docs
    revive, the same messages go out, the revived docs read the same
    from the device (materialize_docs, the grids), and on the card the
    round launches the merge and the four sync kernels (the generate
    builds the hub's filters and probes the peers')."""
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.fleet.storage import StorageEngine
    n, divergent = 64, list(range(0, 64, 8))
    rows = [[encode_change({
        'actor': f'{d:04x}' * 4, 'seq': 1, 'startOp': 1, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': 'k',
                 'value': d, 'datatype': 'int', 'pred': []}]})]
        for d in range(n)]
    chunks = []
    for row in rows:
        hb, _ = host.apply_changes(host.init(), row)
        chunks.append(bytes(host.save(hb)))
    quiet = []
    for chunk in chunks:
        ours, peer = host.load(chunk), host.init()
        s, p = init_sync_state(), init_sync_state()
        for _ in range(10):
            s, m1 = host.generate_sync_message(ours, s)
            if m1 is not None:
                peer, p, _ = host.receive_sync_message(peer, p, m1)
            p, m2 = host.generate_sync_message(peer, p)
            if m2 is not None:
                ours, s, _ = host.receive_sync_message(ours, s, m2)
            if m1 is None and m2 is None:
                break
        quiet.append((s, p, peer))
    msgs = [None] * n
    for j in divergent:
        hub = host.load(chunks[j])
        hub, _ = host.apply_changes(hub, [encode_change({
            'actor': 'f0' * 16, 'seq': 1, 'startOp': 50, 'time': 0,
            'message': '', 'deps': host.get_heads(hub),
            'ops': [{'action': 'set', 'obj': '_root', 'key': 'hub',
                     'value': j, 'datatype': 'int', 'pred': []}]})])
        chunks[j] = bytes(host.save(hub))
        _s, p, peer = quiet[j]
        change = encode_change({
            'actor': f'{j:08x}' + 'e' * 24, 'seq': 1, 'startOp': 100,
            'time': 0, 'message': '', 'deps': host.get_heads(peer),
            'ops': [{'action': 'set', 'obj': '_root', 'key': 'peer',
                     'value': j, 'datatype': 'int', 'pred': []}]})
        peer2, _ = host.apply_changes(host.clone(peer), [change])
        _p, msgs[j] = host.generate_sync_message(
            peer2, dict(p, sentHashes=set(p['sentHashes'])))
    results, arrays = {}, {}
    for dev in ('cpu', 'cuda'):
        eng = StorageEngine(device=dev)
        eng.fleet.frontier_index(device_min=1)
        ids = eng.ingest_chunks(chunks)
        states = [dict(q[0], sentHashes=set(q[0]['sentHashes']))
                  for q in quiet]
        sync_kernels.reset_launches()
        before = LAUNCHES['lww_merge']
        docs, states, _p = sync_driver.receive_sync_messages_mixed(
            eng, ids, states, msgs)
        docs, states, replies = sync_driver.generate_sync_messages_mixed(
            eng, docs, states)
        live = [j for j, d in enumerate(docs) if not isinstance(d, int)]
        launched = [LAUNCHES['lww_merge'] - before] + \
            list(sync_kernels.LAUNCHES.values())
        assert all(launched) if dev == 'cuda' else not any(launched)
        results[dev] = (live, [None if m is None else bytes(m)
                               for m in replies],
                        [bytes(docs[j]['state'].save()) for j in live],
                        len(eng.main),
                        backend.materialize_docs([docs[j] for j in live]))
        arrays[dev] = _device_arrays(eng.fleet)
    assert results['cuda'] == results['cpu']
    assert results['cuda'][0] == divergent and results['cuda'][3] == 56
    assert results['cuda'][4] == [{'k': j, 'hub': j, 'peer': j}
                                  for j in divergent]
    for a, b in zip(arrays['cpu'], arrays['cuda']):
        np.testing.assert_array_equal(b, a)


# ---- the Automerge.* API and the query engine -------------------------------

def _launches():
    return (LAUNCHES['lww_merge'], register_kernel.LAUNCHES['register_scan'],
            seq_kernel.LAUNCHES['seq_scan'])


@pytest.mark.parametrize('exact', [False, True])
def test_api_on_the_card_matches_the_cpu(cuda, exact):
    """api_cases.integration_docs through the port's Automerge.* API with
    a FleetBackend(DocFleet(64 docs, 64 keys)) on each device: the same
    documents, saves, documents read from the device (materialize_docs)
    and device state (the grids' real key columns, or the registers); all
    equal the host backend's documents and saves, and the card's reads
    launched the merge (or the register scan) and the sequence scan."""
    import automerge_tpu_torch as A
    from automerge_tpu_torch import api_cases
    host = api_cases.integration_docs(A)
    names = list(host)
    results, arrays = {}, {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(doc_capacity=64, key_capacity=64,
                                 exact_device=exact, device=dev)
        before = _launches()
        A.set_default_backend(backend.FleetBackend(fleet))
        try:
            docs = api_cases.integration_docs(A)
            read = backend.materialize_docs(
                [A.Frontend.get_backend_state(docs[n]) for n in names])
            saves = [bytes(A.save(docs[n])) for n in names]
        finally:
            A.set_default_backend(A.backend)
        launched = [b - a for a, b in zip(before, _launches())]
        if dev == 'cuda':
            assert launched[1 if exact else 0] > 0 and launched[2] > 0
        else:
            assert not any(launched)
        assert fleet.metrics.promotions == 0
        results[dev] = ([docs[n].to_py() for n in names], saves, read)
        arrays[dev] = _device_arrays(fleet)
    assert results['cuda'] == results['cpu']
    assert results['cuda'][0] == [host[n].to_py() for n in names]
    assert results['cuda'][1] == [bytes(A.save(host[n])) for n in names]
    assert results['cuda'][2] == [api_cases.reading(A, host[n])
                                  for n in names]
    for a, b in zip(arrays['cpu'], arrays['cuda']):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize('exact', [False, True])
def test_materialize_at_on_the_card_matches_the_cpu(cuda, exact):
    """query_history's 64 docs x 6 changes read at the mid frontier in
    one batched materialize_at_docs on each device: one dispatch, the
    same saves, documents read from the device and device state; every
    doc holds k0..k3 = d * 100 + c."""
    from automerge_tpu_torch import api_cases
    from automerge_tpu_torch.query import materialize_at_docs
    n = 64
    batches, _heads, mid = api_cases.query_history(n)
    results, arrays = {}, {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(exact_device=exact, device=dev)
        handles = backend.init_docs(n, fleet)
        for per_doc in batches:
            handles, _ = backend.apply_changes_docs(handles, per_doc,
                                                    mirror=False)
        before, d0 = _launches(), fleet.metrics.dispatches
        outs = materialize_at_docs(handles, mid, fleet=fleet)
        assert fleet.metrics.dispatches == d0 + 1
        launched = [b - a for a, b in zip(before, _launches())]
        assert (launched[1 if exact else 0] == 1) == (dev == 'cuda')
        read = backend.materialize_docs(outs)
        assert read == [{f'k{c}': d * 100 + c for c in range(4)}
                        for d in range(n)]
        results[dev] = ([bytes(h['state'].save()) for h in outs], read,
                        [h['state']._impl.slot for h in outs])
        arrays[dev] = _device_arrays(fleet)
    assert results['cuda'] == results['cpu']
    for a, b in zip(arrays['cpu'], arrays['cuda']):
        np.testing.assert_array_equal(b, a)


def test_quiet_tick_is_one_compare_on_the_card(cuda, monkeypatch):
    """A hub with no device over docs of a fleet on the card: the
    all-quiet tick is one frontier_compare dispatch, run on the fleet's
    device, and no merge dispatch; the CPU fleet's hub answers the
    same."""
    from automerge_tpu_torch import api_cases
    from automerge_tpu_torch.fleet import hashindex
    from automerge_tpu_torch.query import SubscriptionHub
    n = 64
    batches, heads, _mid = api_cases.query_history(n, n_changes=2)
    compare = hashindex.frontier_compare
    seen = []

    def spy(*args, device=None):
        seen.append(torch.device(device).type)
        return compare(*args, device=device)
    monkeypatch.setattr(hashindex, 'frontier_compare', spy)
    results = {}
    for dev in ('cpu', 'cuda'):
        fleet = backend.DocFleet(device=dev)
        handles = backend.init_docs(n, fleet)
        for per_doc in batches:
            handles, _ = backend.apply_changes_docs(handles, per_doc,
                                                    mirror=False)
        hub = SubscriptionHub()
        for d, handle in enumerate(handles):
            hub.register(d, handle)
        for s in range(4 * n):
            hub.subscribe(s % n, cursor=heads[s % n] if s < 2 * n else [])
        first = hub.tick()
        seen.clear()
        n0, d0 = hashindex.dispatch_count(), fleet.metrics.dispatches
        assert hub.tick() == {}
        assert (hashindex.dispatch_count() - n0,
                fleet.metrics.dispatches - d0) == (1, 0)
        assert seen == [dev]
        results[dev] = ({sid: ([bytes(c) for c in ev['changes']],
                               ev['heads']) for sid, ev in first.items()},
                        dict(hub.stats))
    assert results['cuda'] == results['cpu']


# ---- the service (F3) ------------------------------------------------------

SERVICE_LEG = dict(sessions=96, tenants=8, requests=600, seed=5,
                   tick_dt=0.01, collect_saves=True, chaos=True,
                   sync_fraction=0.3)


def test_service_leg_on_the_card_matches_the_cpu(cuda):
    """The same fake-clock chaos leg with its fleet on the card and on the
    CPU: equal reports (but wall time), SLO tallies and session saves,
    and what the card's grids hold for every served doc equal to the CPU
    fleet's; the merge launched on the card."""
    from automerge_tpu_torch import service_cases
    from automerge_tpu_torch.service import DocService
    out = {}
    for dev in ('cpu', 'cuda'):
        kept = []
        real = DocService.__init__

        def init(self, *args, real=real, **kwargs):
            real(self, *args, **kwargs)
            kept.append(self)
        DocService.__init__ = init
        before = LAUNCHES['lww_merge']
        try:
            report = service_cases.run_leg('card', device=dev, **SERVICE_LEG)
        finally:
            DocService.__init__ = real
        svc = kept[0]
        handles = [s.handle for s in svc.sessions.values()]
        out[dev] = (report, svc.slo.tallies(),
                    backend.materialize_docs(handles),
                    LAUNCHES['lww_merge'] - before)
    for key in ('completed_ok', 'rejections', 'untyped_escapes', 'ticks',
                'p99_ms', 'convergence', 'slo_audit', 'session_saves',
                'brownout_transitions'):
        assert out['cuda'][0][key] == out['cpu'][0][key], key
    assert out['cuda'][0]['untyped_escapes'] == 0
    assert out['cuda'][1] == out['cpu'][1]
    assert out['cuda'][2] == out['cpu'][2]
    assert out['cuda'][3] > 0 and out['cpu'][3] == 0


def test_ledger_on_the_card_counts_the_merge_launches(cuda):
    """With the kernel ledger on, every apply_op_batch* dispatch of a
    seam on the card is one lww_merge launch."""
    from automerge_tpu_torch.observability import perf
    fleet = backend.DocFleet(device='cuda')
    handles = backend.init_docs(32, fleet)
    perf.disable_ledger()
    perf.reset_ledger()
    before = LAUNCHES['lww_merge']
    perf.enable_ledger()
    try:
        for rnd in range(3):
            per_doc = [[encode_change({
                'actor': 'ab' * 16, 'seq': rnd + 1, 'startOp': rnd + 1,
                'time': 0, 'message': '', 'deps': [],
                'ops': [{'action': 'set', 'obj': '_root',
                         'key': f'k{d % 5}', 'value': rnd, 'datatype': 'int',
                         'pred': []}]})] for d in range(32)]
            handles, _ = backend.apply_changes_docs(handles, per_doc,
                                                    mirror=False)
        report = perf.kernel_report()
    finally:
        perf.disable_ledger()
        perf.reset_ledger()
    applies = sum(row['dispatches'] for kind, row in report.items()
                  if kind.startswith('apply_op_batch'))
    assert applies == LAUNCHES['lww_merge'] - before == 3
    for kind, row in report.items():
        for sig in row['signatures']:
            assert sig['cost']['bytes accessed'] > 0


def test_lossy_sync_converges_between_card_docs(cuda):
    """Two docs on fleets on the card diverge, then sync_until_quiet over
    LossyLinks that drop, duplicate and reorder: both converge, still
    served from their fleets, equal to the same run on the CPU."""
    from automerge_tpu_torch.fleet.faults import LossyLink, sync_until_quiet
    out = {}
    for dev in ('cpu', 'cuda'):
        pair = []
        for actor in ('aa', 'bb'):
            (h,) = backend.init_docs(1, backend.DocFleet(device=dev))
            (h,), _ = backend.apply_changes_docs([h], [[encode_change({
                'actor': actor * 16, 'seq': s + 1, 'startOp': s + 1,
                'time': 0, 'message': '', 'deps': [],
                'ops': [{'action': 'set', 'obj': '_root',
                         'key': f'{actor}{s}', 'value': s,
                         'datatype': 'int', 'pred': []}]})
                for s in range(6)]], mirror=False)
            pair.append(h)
        fault_p = dict(p_drop=0.2, p_dup=0.1, p_reorder=0.1)
        na, nb, rounds, stats = sync_until_quiet(
            pair[0], pair[1], backend, backend,
            LossyLink(seed=31, budget=10, **fault_p),
            LossyLink(seed=32, budget=10, **fault_p))
        assert backend.get_heads(na) == backend.get_heads(nb)
        assert na['state'].is_fleet and nb['state'].is_fleet
        out[dev] = (backend.materialize_docs([na, nb]), rounds,
                    bytes(backend.save(na)))
    assert out['cuda'] == out['cpu']
    assert len(out['cuda'][0][0]) == 12


def test_sharded_apply_on_a_card_mesh_matches_one_launch(cuda):
    """sharded_apply on a 2 x 2 (docs, keys) mesh of logical positions on
    cuda:0: one lww_merge launch per block, and the gathered grids (the
    scratch column too) and stats equal one unsharded launch."""
    from automerge_tpu_torch.fleet import sharding
    rng = np.random.default_rng(9)
    n, k1, p = 64, 32, 20
    key = rng.integers(0, k1 - 1, (n, p)).astype(np.int32)
    packed = ((np.arange(1, p + 1)[None, :].repeat(n, 0) << 8) |
              rng.integers(0, 4, (n, p))).astype(np.int32)
    inc = rng.random((n, p)) < 0.25
    ops = OpBatch(key, packed, rng.integers(-9, 99, (n, p)).astype(np.int32),
                  ~inc, inc, rng.random((n, p)) < 0.9).to('cuda')
    state = FleetState.empty(n, k1 - 1, 'cuda')
    mesh = sharding.fleet_mesh(['cuda:0'] * 4, keys_axis=2)
    before = LAUNCHES['lww_merge']
    new, stats = sharding.sharded_apply(mesh)(
        sharding.shard_fleet(state, mesh), sharding.shard_ops(ops, mesh))
    assert LAUNCHES['lww_merge'] - before == 4
    ref = FleetState.empty(n, k1 - 1, 'cuda')
    want = lww_merge(ref, ops)
    assert int(stats) == int(want)
    for got, exp in zip(new.tensors(), ref.tensors()):
        np.testing.assert_array_equal(np.asarray(got), exp.cpu().numpy())


def test_single_controller_exchange_on_the_card(cuda):
    """The exchange on 4 positions of one card: inbox[j, i] ==
    outbox[i, j], the rows views of one transposed tensor on the card."""
    from automerge_tpu_torch.fleet import exchange, sharding
    rng = np.random.default_rng(3)
    out = rng.integers(0, 256, (4, 4, 97)).astype(np.uint8)
    lens = rng.integers(0, 98, (4, 4)).astype(np.int32)
    mesh = sharding.FleetMesh(['cuda:0'] * 4, ('peers',))
    before = exchange.LAUNCHES['exchange_all_to_all']
    inbox, in_lens = exchange.exchange_changes(mesh, 'peers', out, lens)
    assert exchange.LAUNCHES['exchange_all_to_all'] - before == 1
    assert inbox.base.device.type == 'cuda'
    np.testing.assert_array_equal(np.asarray(inbox), out.transpose(1, 0, 2))
    np.testing.assert_array_equal(np.asarray(in_lens), lens.T)


def test_world_size_one_nccl_round_on_the_card(cuda):
    """drive_pairwise_sync_multihost over an NCCL group of one rank: the
    chunked round (max_msg 64) runs all_to_all_single on the card and
    converges in the single-controller driver's rounds."""
    import datetime
    import socket
    import torch.distributed as dist
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.fleet import exchange, sharding

    def seeded(i):
        b = host.init()
        b, _ = host.apply_changes(b, [encode_change({
            'actor': f'{i + 1:02x}' * 16, 'seq': 1, 'startOp': 1,
            'time': 0, 'deps': [], 'ops': [{
                'action': 'set', 'obj': '_root', 'key': f'k{i}',
                'value': i, 'datatype': 'int', 'pred': []}]})])
        return b
    single = {i: seeded(i) for i in range(4)}
    want = exchange.drive_pairwise_sync_multihost(
        sharding.FleetMesh(['cuda:0'] * 4, ('docs',)), 'docs', single, host,
        max_msg=64)
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = sharding.fleet_mesh(['cuda:0'] * 4)
        docs = {i: seeded(i) for i in range(4)}
        retries = exchange._sync_stats['sync_retries']
        launches = exchange.LAUNCHES['exchange_all_to_all']
        rounds = exchange.drive_pairwise_sync_multihost(
            mesh, 'docs', docs, host, max_msg=64)
        retries = exchange._sync_stats['sync_retries'] - retries
        launches = exchange.LAUNCHES['exchange_all_to_all'] - launches
    finally:
        dist.destroy_process_group()
    assert rounds == want and retries > 0 and launches > 0
    heads = {tuple(host.get_heads(d)) for d in docs.values()}
    assert heads == {tuple(host.get_heads(single[0]))}
