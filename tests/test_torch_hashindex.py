"""Differential tests of the port's frontier index (fleet/hashindex.py
and the plain versions of its kernels in fleet/sync_kernels.py) against
the JAX package's fleet/hashindex.py, on the same numpy-seeded keys.

On the CPU the port's insert is the JAX claim loop in torch ops, so the
tables must equal the reference's slot for slot (tkey and tspace), the
new-key counts and lengths must agree, and every probe must answer the
same: in-batch duplicates, a collision chain filled to the load bound
that wraps at cap - 1, grow-by-migration with dead spaces reclaimed,
host mode against device mode, the uint32 wraparound of the start
position, `frontier_compare`, a table carried across packages with
`table_from_numpy`, and the fleet wiring (commit staging, slot frees,
the single-doc protocol's probe)."""

import hashlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import automerge_tpu.native as jax_native
import automerge_tpu_torch.native as torch_native
from automerge_tpu.columnar import decode_change_meta, encode_change
from automerge_tpu.fleet import backend as jax_backend
from automerge_tpu.fleet import hashindex as jax_hi
from automerge_tpu_torch.fleet import backend as torch_backend
from automerge_tpu_torch.fleet import hashindex as torch_hi
from automerge_tpu_torch.fleet import sync_kernels

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


CPU = 'cpu'


def _h(i):
    return hashlib.sha256(f'key-{i}'.encode()).hexdigest()


def _colliding_rows(n, cap, pos):
    """n distinct keys whose first word is congruent to `pos` mod cap, so
    every one starts its walk at slot `pos` in space 0."""
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    words = (pos + cap * (np.arange(n, dtype=np.uint64) + 1)) \
        .astype(np.uint32)
    rows[:, :4] = words.view(np.uint8).reshape(n, 4)
    return rows


def _pair(capacity=16, device_min=1, load_max=0.6, spaces=4):
    j = jax_hi.HashIndex(capacity=capacity, device_min=device_min,
                         load_max=load_max)
    t = torch_hi.HashIndex(capacity=capacity, device_min=device_min,
                           load_max=load_max, device=CPU)
    for _ in range(spaces):
        assert j.new_space() == t.new_space()
    return j, t


def _same_table(j, t):
    assert (t.mode, t.cap, t.occupancy, len(t)) == \
        (j.mode, j.cap, j.occupancy, len(j))
    if j.mode == 'device':
        tkey, tspace = torch_hi.table_to_numpy(t)
        np.testing.assert_array_equal(tspace, np.asarray(j._tspace))
        np.testing.assert_array_equal(tkey, np.asarray(j._tkey))


def _insert_both(j, t, spaces, keys):
    nj, nt = j.insert(spaces, keys), t.insert(spaces, keys)
    assert nt == nj
    _same_table(j, t)
    return nt


def _probe_both(j, t, spaces, keys):
    want = j.probe(spaces, keys)
    got = t.probe(spaces, keys)
    np.testing.assert_array_equal(got, want)
    return got


def test_tables_equal_slot_for_slot_with_in_batch_duplicates():
    j, t = _pair(capacity=64)
    rng = np.random.default_rng(0)
    for step in range(4):
        ids = rng.integers(0, 120, 40)             # repeats within a batch
        spaces = rng.integers(0, 4, 40).astype(np.int32)
        spaces[:5] = spaces[5]
        ids[:5] = ids[5]                           # five copies of one key
        _insert_both(j, t, spaces, [_h(i) for i in ids])
    # duplicates of present keys land nothing
    assert _insert_both(j, t, spaces, [_h(i) for i in ids]) == 0
    q = rng.integers(0, 4, 300).astype(np.int32)
    _probe_both(j, t, q, [_h(i) for i in rng.integers(0, 200, 300)])


def test_in_batch_duplicates_land_once():
    j, t = _pair()
    batch = [_h(1)] * 5 + [_h(2)] * 3 + [_h(3)]
    assert _insert_both(j, t, 0, batch) == 3
    assert len(t) == 3
    assert _probe_both(j, t, 0, [_h(1), _h(2), _h(3), _h(4)]).tolist() == \
        [True, True, True, False]


@pytest.mark.parametrize('pos', [5, 63], ids=['mid', 'wraps_at_cap_1'])
def test_collision_chain_filled_to_the_load_bound(pos):
    j, t = _pair(capacity=64, spaces=1)
    rows = _colliding_rows(38, 64, pos)            # 38 <= 0.6 x 64
    assert _insert_both(j, t, 0, rows) == 38
    assert t.cap == 64                             # no grow: at the bound
    tspace = torch_hi.table_to_numpy(t)[1]
    if pos == 63:
        assert tspace[63] == 0 and tspace[0] == 0  # the chain wrapped
    assert _probe_both(j, t, 0, rows).all()
    absent = rows.copy()
    absent[:, 20] ^= 0xFF
    assert not _probe_both(j, t, 0, absent).any()


def test_grow_by_migration_reclaims_dead_spaces():
    j, t = _pair(capacity=8, load_max=0.5, spaces=6)
    rng = np.random.default_rng(3)
    for lo in range(0, 400, 100):
        spaces = rng.integers(0, 6, 100).astype(np.int32)
        _insert_both(j, t, spaces, [_h(i) for i in range(lo, lo + 100)])
    assert t.grows == j.grows >= 2
    for sid in (0, 1):
        j.release_space(sid)
        t.release_space(sid)
    _probe_both(j, t, np.zeros(50, np.int32), [_h(i) for i in range(50)])
    occupied = t.occupancy
    _insert_both(j, t, 2, [_h(10_000 + i) for i in range(300)])
    assert t.occupancy < occupied + 300            # dead keys reclaimed
    q = rng.integers(0, 7, 900).astype(np.int32)  # 6 = never minted
    _probe_both(j, t, q, [_h(i) for i in rng.integers(0, 11_000, 900)])


def test_dead_and_unknown_spaces_answer_false():
    j, t = _pair(spaces=2)
    _insert_both(j, t, 0, [_h(1)])
    assert _probe_both(j, t, 1, [_h(1)]).tolist() == [False]
    j.release_space(0)
    t.release_space(0)
    assert _probe_both(j, t, 0, [_h(1)]).tolist() == [False]
    assert _probe_both(j, t, np.array([999], np.int32),
                       [_h(1)]).tolist() == [False]


def _mode_trace():
    """60 seeded inserts and probes over 4 spaces and 30 keys, and the
    answers the probes must give (membership so far)."""
    rng = np.random.default_rng(7)
    trace = [(int(rng.integers(4)), _h(int(rng.integers(30))),
              bool(rng.random() < 0.5)) for _ in range(60)]
    seen, want = set(), []
    for s, h, is_insert in trace:
        if is_insert:
            seen.add((s, h))
        else:
            want.append((s, h) in seen)
    return trace, want


def _answers_in_mode(device_min):
    trace, want = _mode_trace()
    # 16 slots: the table grows in every mode (and across the promotion)
    j, t = _pair(device_min=device_min)
    out = []
    for s, h, is_insert in trace:
        if is_insert:
            assert t.insert(s, [h]) == j.insert(s, [h])
        else:
            out.append(bool(_probe_both(j, t, s, [h])[0]))
    _same_table(j, t)
    assert out == want
    return t.mode, t.cap


# One test per mode (each a family of its own in the slow audit's
# accounting): each answers as the membership model, so all three answer
# identically. The device tables grow from 16 to 64 slots, the promoted
# one across its promotion.

def test_host_mode_and_device_mode_answer_identically():
    assert _answers_in_mode(10 ** 9) == ('host', 16)


def test_device_mode_answers_as_the_host_mode():
    assert _answers_in_mode(1) == ('device', 64)


def test_mode_promoted_midway_answers_as_the_host_mode():
    assert _answers_in_mode(12) == ('device', 64)


def test_start_position_wraps_like_uint32():
    """uint32(space) * 0x9E3779B9 passes 2^32 from space 2 on: the int64
    masked product must give the JAX uint32 start positions."""
    rng = np.random.default_rng(5)
    spaces = np.array([0, 1, 2, 3, 7, 1000, 2 ** 20 + 1, 2 ** 31 - 1, -1],
                      dtype=np.int32)
    words = rng.integers(0, 1 << 32, (len(spaces), 8), dtype=np.uint64) \
        .astype(np.uint32)
    for cap in (8, 1 << 21, 1 << 30):
        want = np.asarray(jax_hi._start_pos(jnp.asarray(words),
                                            jnp.asarray(spaces), cap))
        got = sync_kernels.start_pos(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(spaces), cap)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (spaces[2:].astype(np.int64) * 0x9E3779B9 >= 1 << 32)[:-1].all()


def test_window_width_does_not_change_the_plain_probe():
    j, t = _pair(capacity=64, spaces=1)
    rows = _colliding_rows(30, 64, 60)
    _insert_both(j, t, 0, rows)
    absent = rows.copy()
    absent[:, 9] ^= 1
    q = np.concatenate([rows, absent])
    prev = torch_hi.set_probe_window(16)
    try:
        for width in (1, 4, 16, 64):
            torch_hi.set_probe_window(width)
            got = t.probe(0, q)
            assert got.tolist() == [True] * 30 + [False] * 30
    finally:
        torch_hi.set_probe_window(prev)


def test_frontier_compare_matches_reference():
    rng = np.random.default_rng(1)
    k = 37
    cur = rng.integers(0, 256, (k, 32)).astype(np.uint8)
    doc = cur.copy()
    doc[::3, 7] ^= 1
    cur_n = rng.integers(0, 3, k).astype(np.int32)
    doc_n = np.where(rng.random(k) < 0.8, cur_n, 1 - np.minimum(cur_n, 1)) \
        .astype(np.int32)
    want = jax_hi.frontier_compare(cur, cur_n, doc, doc_n)
    n0 = torch_hi.dispatch_count()
    got = torch_hi.frontier_compare(cur, cur_n, doc, doc_n, device=CPU)
    assert torch_hi.dispatch_count() - n0 == 1
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    assert torch_hi.frontier_compare(cur[:0], cur_n[:0], doc[:0],
                                     doc_n[:0], device=CPU).shape == (0,)


def test_table_from_numpy_carries_a_table_across():
    """Both packages continue from the SAME table: the reference's after
    two batches, moved into the port with table_from_numpy."""
    j, t = _pair(capacity=32, spaces=3)
    rng = np.random.default_rng(9)
    for lo in (0, 15):
        j.insert(rng.integers(0, 3, 15).astype(np.int32),
                 [_h(i) for i in range(lo, lo + 15)])
    t = torch_hi.table_from_numpy(np.asarray(j._tkey), np.asarray(j._tspace),
                                  n_spaces=3, device=CPU)
    assert len(t) == len(j) and t.cap == j.cap and t.mode == 'device'
    spaces = rng.integers(0, 3, 20).astype(np.int32)
    _insert_both(j, t, spaces, [_h(i) for i in range(25, 45)])
    q = rng.integers(0, 3, 100).astype(np.int32)
    _probe_both(j, t, q, [_h(i) for i in rng.integers(0, 60, 100)])


def test_cpu_index_launches_no_kernel():
    before = dict(sync_kernels.LAUNCHES)
    j, t = _pair()
    _insert_both(j, t, 0, [_h(i) for i in range(9)])
    _probe_both(j, t, 0, [_h(i) for i in range(12)])
    assert sync_kernels.LAUNCHES == before
    assert t._tkey.device.type == 'cpu' and t._tkey.dtype == torch.int32


def test_insert_refuses_a_table_past_its_load_bound():
    tkey = torch.zeros((8, 8), dtype=torch.int32)
    tspace = torch.full((8,), -1, dtype=torch.int32)
    keys = torch.zeros((6, 8), dtype=torch.int32)
    spaces = torch.zeros(6, dtype=torch.int32)
    valid = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError, match='load bound'):
        sync_kernels.hashindex_insert(tkey, tspace, keys, spaces, valid,
                                      max_occupancy=6, load_max=0.6)


# ---- fleet wiring (rides the turbo path: both codecs must load) ----------

def _needs_codecs():
    if not (jax_native.available() and torch_native.available()):
        pytest.skip('a native codec is unavailable (the turbo path and '
                    'the reference comparison need both)')


def _change(actor, seq, deps, key, val):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': seq, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}]})


def _rounds(n_docs, rounds):
    """Per-round per-doc single-change batches extending one chain per
    doc, and each doc's hashes in order."""
    heads = [[] for _ in range(n_docs)]
    batches, history = [], [[] for _ in range(n_docs)]
    for r in range(rounds):
        batch = []
        for d in range(n_docs):
            buf = _change(f'{d + 1:02x}' * 16, r + 1, heads[d], f'k{r}', d)
            heads[d] = [decode_change_meta(buf, True)['hash']]
            history[d].append(heads[d][0])
            batch.append([buf])
        batches.append(batch)
    return batches, history


def test_fleet_index_stages_commits_and_drops_freed_slots():
    _needs_codecs()
    n = 6
    batches, history = _rounds(n, 4)
    universes = []
    for mod, kw in ((jax_backend, {}), (torch_backend, {'device': CPU})):
        fleet = mod.DocFleet(doc_capacity=8, key_capacity=8, **kw)
        handles = mod.init_docs(n, fleet)
        handles, _ = mod.apply_changes_docs(handles, batches[0],
                                            mirror=False)
        fidx = fleet.frontier_index(device_min=1, capacity=64)
        for batch in batches[1:3]:
            handles, _ = mod.apply_changes_docs(handles, batch,
                                                mirror=False)
        universes.append((mod, fleet, fidx, handles))
    q_engines, q_hashes = [], []
    for d in range(n):
        for h in history[d] + history[(d + 1) % n][:2]:
            q_engines.append(d)
            q_hashes.append(h)
    answers = []
    for mod, fleet, fidx, handles in universes:
        engines = [handles[d]['state']._impl for d in q_engines]
        got = fidx.probe_pairs(engines, q_hashes)
        # the single-doc protocol answers from the warm index
        flags = handles[0]['state'].probe_hashes(history[0])
        mod.free_docs(handles[:2])
        answers.append((got.tolist(), list(flags), fidx.table.n_keys,
                        sorted(fidx._spaces.values())))
    assert answers[0] == answers[1]
    got, flags = answers[1][0], answers[1][1]
    assert flags == [True, True, True, False]      # round 4 not applied
    assert sum(got) == 6 * 3 + sum(1 for d in range(n) for h in
                                   history[(d + 1) % n][:2]
                                   if h in history[d][:3])
    _same_table(universes[0][2].table, universes[1][2].table)


def _shared_case_holds(name, cap=None):
    """The corner inputs the card tests and chip_smoke.py hand the
    kernels (fleet/sync_cases.py), through the plain versions here: the
    colliding keys really share one start slot, the batch lands within
    the load bound, and every inserted key is then found."""
    from automerge_tpu_torch.fleet import sync_cases
    case = sync_cases.index_case(name, np.random.default_rng(41), CPU, cap)
    cap = len(case['tspace'])
    if name in ('collide', 'wrap'):
        starts = sync_kernels.start_pos(case['keys'], case['spaces'], cap)
        assert starts.unique().tolist() == [17 if name == 'collide'
                                            else cap - 1]
    tkey, tspace = case['tkey'].clone(), case['tspace'].clone()
    n_new = int(sync_kernels.hashindex_insert_plain(
        tkey, tspace, case['keys'], case['spaces'], case['valid']))
    occupied = int((tspace >= 0).sum())
    assert occupied == case['occupied'] + n_new <= 0.6 * cap
    assert len(sync_cases.members(tkey, tspace)) == occupied
    hit = sync_kernels.hashindex_probe_plain(tkey, tspace, case['keys'],
                                             case['spaces'], case['valid'])
    assert torch.equal(hit, case['valid'])
    # the comparison the card runs, here with the plain versions both sides
    assert sync_cases.index_both(case) == dict(n_new=n_new, insert=0,
                                               probe=0, wrong=0)


# Smaller tables than the card's (the plain claim loop walks a colliding
# chain one key per step; 'dups' has a fixed row count). Each case is a
# family of its own in the slow audit's accounting.

def test_shared_kernel_cases_hold_on_the_cpu():
    _shared_case_holds('dups')


def test_shared_load_bound_case_holds_on_the_cpu():
    _shared_case_holds('load', 1 << 10)


def test_shared_many_spaces_case_holds_on_the_cpu():
    _shared_case_holds('spaces', 1 << 10)


def test_shared_collision_chain_case_holds_on_the_cpu():
    _shared_case_holds('collide', 128)


def test_shared_wrapping_chain_case_holds_on_the_cpu():
    _shared_case_holds('wrap', 128)


def test_shared_window_wrap_case_holds_on_the_cpu():
    _shared_case_holds('window_wrap', 128)


def test_shared_claim_race_case_holds_on_the_cpu():
    _shared_case_holds('claim_race', 128)


def test_shared_busy_twin_case_holds_on_the_cpu():
    _shared_case_holds('busy_twin', 256)


def test_shared_one_batch_case_holds_on_the_cpu():
    _shared_case_holds('one_batch', 1 << 10)


def test_index_wrappers_refuse_malformed_inputs():
    tkey = torch.zeros((12, 8), dtype=torch.int32)
    tspace = torch.full((12,), -1, dtype=torch.int32)
    keys = torch.zeros((3, 8), dtype=torch.int32)
    spaces = torch.zeros(3, dtype=torch.int32)
    valid = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match='power of two'):
        sync_kernels.hashindex_probe(tkey, tspace, keys, spaces, valid)
    with pytest.raises(ValueError, match='keys'):
        sync_kernels.hashindex_probe(tkey[:8], tspace[:8], keys[:, :4],
                                     spaces, valid)
    with pytest.raises(ValueError, match='spaces'):
        sync_kernels.hashindex_insert(tkey[:8], tspace[:8], keys,
                                      spaces.long(), valid, 3, 0.6)


def test_index_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        torch_hi.HashIndex()
    with pytest.raises(RuntimeError, match='CUDA'):
        torch_hi.frontier_compare(np.zeros((1, 32), np.uint8),
                                  np.zeros(1, np.int32),
                                  np.zeros((1, 32), np.uint8),
                                  np.zeros(1, np.int32))
