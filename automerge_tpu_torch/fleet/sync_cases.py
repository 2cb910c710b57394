"""Seeded inputs for holding the sync plane's CUDA kernels to their plain
versions (fleet/sync_kernels.py), shared by the card tests
(tests/test_torch_cuda.py) and chip_smoke.py.

- `index_case(name, rng, device)`: a hash-index insert at one corner:
  'collide' (every key starts its walk at one slot), 'wrap' (the same,
  at slot cap - 1, so the chain wraps), 'dups' (in-batch duplicates and
  keys already in the table), 'load' (a quarter-full table filled to
  the 0.6 load bound), 'spaces' (many spaces, keys shared across them),
  and the insert's 8-slot windows: 'window_wrap', 'claim_race',
  'busy_twin', 'one_batch' (see `index_case`).
- `index_both(case)`: the case's insert, then a probe of its keys and
  of strangers that differ from them in word 5, 7 or 1 only (the same
  start slot and space), through the kernels and through the plain
  versions; returns the disagreements.
- `members(tkey, tspace)` / `same_members(...)`: a table's (space, key)
  rows, sorted: the kernel's slot layout may differ from the plain
  version's where rows race for a slot, its membership may not.
- `bloom_both(rng, counts, device)`: filters for hash lists of the given
  entry counts (`BLOOM_COUNTS`: skewed sizes, empty rows, rows on and
  across 16-byte edges, padding rows and a zero tail, the longest row
  one shared-memory window holds and a longer one) built and
  probed through the kernels and through the plain versions; returns the
  disagreements. `bloom_layout(counts)` is the flat layout alone.
- `bloom_probe_case(name, rng, device)` / `bloom_probe_both(case)`: the
  probe alone at the corners `BLOOM_PROBE_CASES`: 'all_present' (every
  lane a member of its row's filter, so all 7 gathers of every lane
  find their bit), 'all_absent' (every filter empty of bits) and
  'past_2_31' (a row of more than 2^31 bits, 268 MB, beside small
  ones); returns the disagreements.
"""

import numpy as np
import torch

from . import bloom, sync_kernels

LOAD_MAX = 0.6
_M32 = 0xFFFFFFFF


def random_words(rng, n):
    """[n, 8] uint32 key words (32-byte hashes)."""
    return rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64) \
        .astype(np.uint32)


def colliding_words(rng, n, cap, pos, space):
    """[n, 8] distinct keys that all start their walk at slot `pos` of a
    cap-slot table in `space`."""
    words = random_words(rng, n)
    mix = (space * sync_kernels.GOLD) & _M32
    first = (pos + cap * np.arange(1, n + 1, dtype=np.uint64)) & _M32
    words[:, 0] = (first ^ mix).astype(np.uint32)
    return words


def empty_table(cap, device):
    return (torch.zeros((cap, 8), dtype=torch.int32, device=device),
            torch.full((cap,), -1, dtype=torch.int32, device=device))


def _tensors(words, spaces, valid, device):
    return (torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
            .to(device),
            torch.from_numpy(np.asarray(spaces, dtype=np.int32)).to(device),
            torch.from_numpy(np.asarray(valid, dtype=bool)).to(device))


INDEX_CASES = ('collide', 'wrap', 'dups', 'load', 'spaces', 'window_wrap',
               'claim_race', 'busy_twin', 'one_batch')


INDEX_CAPS = {'collide': 1024, 'wrap': 1024, 'dups': 4096, 'load': 1 << 16,
              'spaces': 1 << 14, 'window_wrap': 1024, 'claim_race': 1024,
              'busy_twin': 4096, 'one_batch': 1 << 18}


def index_case(name, rng, device, cap=None):
    """dict(tkey, tspace, keys, spaces, valid, occupied): a starting
    table (`occupied` slots in use) and a batch to insert into it. The
    table has INDEX_CAPS[name] slots unless `cap` (a power of two) says
    otherwise. Beyond the corners named in the module docstring:
    'window_wrap' (keys starting in each of the last 7 slots, so the
    insert's first 8-slot window wraps at cap - 1), 'claim_race' (three
    slots in use, then keys starting at each of them, all racing for the
    first empty slot after them), 'busy_twin' (colliding keys, each 8
    times in the batch, so twins meet each other's claimed, unpublished
    slot) and 'one_batch' (an empty table filled to the 0.6 load bound
    in one batch)."""
    cap = cap or INDEX_CAPS[name]
    tkey, tspace = empty_table(cap, device)
    occupied = 0
    if name in ('collide', 'wrap'):
        n = int(LOAD_MAX * cap)
        pos = 17 if name == 'collide' else cap - 1
        words = colliding_words(rng, n, cap, pos, 3)
        spaces = np.full(n, 3, np.int32)
    elif name == 'dups':
        # a quarter of the keys already present; every key 4 times over
        base = random_words(rng, 400)
        pre = _tensors(base[:100], np.ones(100, np.int32), np.ones(100, bool),
                       device)
        sync_kernels.hashindex_insert_plain(tkey, tspace, *pre)
        occupied = 100
        pick = rng.integers(0, 400, 1600)
        words, spaces = base[pick], np.ones(1600, np.int32)
    elif name == 'load':
        quarter = cap // 4
        pre = _tensors(random_words(rng, quarter),
                       rng.integers(0, 8, quarter), np.ones(quarter, bool),
                       device)
        sync_kernels.hashindex_insert_plain(tkey, tspace, *pre)
        occupied = quarter
        n = int(LOAD_MAX * cap) - quarter
        words, spaces = random_words(rng, n), rng.integers(0, 8, n)
    elif name == 'window_wrap':
        per = max(1, int(LOAD_MAX * cap) // 14)
        words = np.concatenate([colliding_words(rng, per, cap, cap - k, 5)
                                for k in range(1, 8)])
        spaces = np.full(len(words), 5, np.int32)
    elif name == 'claim_race':
        pos = cap // 2
        pre = _tensors(colliding_words(rng, 3, cap, pos, 7),
                       np.full(3, 7, np.int32), np.ones(3, bool), device)
        sync_kernels.hashindex_insert_plain(tkey, tspace, *pre)
        occupied = 3
        per = max(1, int(LOAD_MAX * cap) // 6)
        words = np.concatenate([colliding_words(rng, per, cap, pos + k, 7)
                                for k in range(3)])
        spaces = np.full(len(words), 7, np.int32)
    elif name == 'busy_twin':
        distinct = colliding_words(rng, int(LOAD_MAX * cap) // 16, cap, 100,
                                   2)
        words = distinct[rng.permutation(np.repeat(np.arange(len(distinct)),
                                                   8))]
        spaces = np.full(len(words), 2, np.int32)
    elif name == 'one_batch':
        n = int(LOAD_MAX * cap)
        words, spaces = random_words(rng, n), rng.integers(0, 1000, n)
    else:
        n = int(0.5 * cap)
        shared = random_words(rng, n // 16)
        words = shared[rng.integers(0, len(shared), n)]
        spaces = rng.integers(0, 4096, n)
    valid = np.ones(len(words), bool)
    valid[::97] = False                      # a few invalid rows
    keys, spaces_t, valid_t = _tensors(words, spaces, valid, device)
    return dict(tkey=tkey, tspace=tspace, keys=keys, spaces=spaces_t,
                valid=valid_t, occupied=occupied)


ABSENT_WORDS = (5, 7, 1)     # the word of a key flipped to make a stranger


def index_both(case):
    """The case's insert, then a probe of its keys and of three times as
    many absent ones (a bit of word 5, 7 or 1 of each key flipped: each
    stranger starts at its key's slot in its key's space, so the probe
    kernel's key loaded with the start slot's space, where that is the
    key's own, must not count as a hit), by the kernels and by the plain
    versions, each on its own copy of the table. Returns the kernels'
    new-key count and the disagreements, each 0 when the kernels hold:
    'insert' (the new-key counts or the memberships differ), 'probe' (rows
    whose answers differ) and 'wrong' (rows that the kernel's probe, or
    the plain probe on the kernel's table, answers wrongly: an inserted
    key not found, an absent key found)."""
    absent = []
    for word in ABSENT_WORDS:
        stranger = case['keys'].clone()
        stranger[:, word] ^= 1
        absent.append(stranger)
    k = len(ABSENT_WORDS)
    probe = (torch.cat([case['keys']] + absent),
             case['spaces'].repeat(k + 1),
             torch.cat([case['valid']] +
                       [torch.ones_like(case['valid'])] * k))
    insert = (case['keys'], case['spaces'], case['valid'])
    kt, ks = case['tkey'].clone(), case['tspace'].clone()
    kn = int(sync_kernels.hashindex_insert(
        kt, ks, *insert, case['occupied'] + int(case['valid'].sum()),
        LOAD_MAX))
    hit = sync_kernels.hashindex_probe(kt, ks, *probe)
    plain_on_kernel = sync_kernels.hashindex_probe_plain(kt, ks, *probe)
    pt, ps = case['tkey'].clone(), case['tspace'].clone()
    pn = int(sync_kernels.hashindex_insert_plain(pt, ps, *insert))
    plain_hit = sync_kernels.hashindex_probe_plain(pt, ps, *probe)
    expect = torch.cat([case['valid']] +
                       [torch.zeros_like(case['valid'])] * k)
    return dict(n_new=kn,
                insert=int(kn != pn or not same_members(kt, ks, pt, ps)),
                probe=int((hit != plain_hit).sum()),
                wrong=int((hit != expect).sum() +
                          (plain_on_kernel != expect).sum()))


def members(tkey, tspace):
    """[m, 9] int64: the table's (space, key words) rows, sorted."""
    occ = tspace >= 0
    rows = torch.cat([tspace[occ].view(-1, 1).long(),
                      tkey[occ].long() & _M32], dim=1).cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]


def same_members(tkey_a, tspace_a, tkey_b, tspace_b):
    a, b = members(tkey_a, tspace_a), members(tkey_b, tspace_b)
    return a.shape == b.shape and bool((a == b).all())


BLOOM_COUNTS = {
    'skewed': [1, 300, 7, 0, 42, 0, 0, 150, 3, 64, 9, 0, 1, 2, 255, 1000],
    'uniform': [8] * 5000,
    # H = 2,048: one row per build CTA (sync_kernels.bloom_plan), rows of
    # 2,048 B (1,638 entries) and around it, so CTA edges fall at and
    # beside 16-byte edges and rows straddle them
    'cta_edges': [1638, 1638, 8, 1636, 3, 1639, 2, 0, 1, 820, 818, 1638],
    # one row of 15,000 B, between small ones
    'spanning': [3, 12000, 5, 0, 17],
    # 9 rows padded to 16 with empty rows, and a zero tail past the rows
    # (2,066 B of filters in a 4,096 B output)
    'padding': [1] * 9 + [1638],
    # the longest row one shared-memory window holds (WINDOW_CAP - 16
    # bytes), 12 bytes from a 16-byte edge; and a longer one that takes
    # two windows
    'window_cap': [9, 163827, 1],
    'past_cap': [200000, 2, 0, 4],
}


def bloom_layout(counts):
    """(row_bits, bit_off, total_bits, H) of the flat layout the batched
    build gives lists of these entry counts (bloom.flat_build_lanes)."""
    _w, _v, row_bits, bit_off, total_bits, _b = bloom.flat_build_lanes(
        [['00' * 32] * c for c in counts])
    return (torch.from_numpy(row_bits.astype(np.int64)),
            torch.from_numpy(bit_off.astype(np.int64)), total_bits,
            _w.shape[1])


def bloom_both(rng, counts, device):
    """Filters for random hash lists of the given entry counts, built,
    then probed (the kernel's filters) with each row's members and as
    many strangers, by the kernels and by the plain versions. Returns the filter count and
    bytes, and the disagreements, each 0 when the kernels hold: 'build'
    (the largest difference of a packed byte), 'probe' (lanes whose
    answers differ) and 'missed' (members the kernel's probe did not
    find)."""
    lists = [[rng.bytes(32).hex() for _ in range(c)] for c in counts]
    words, valid, row_bits, bit_off, total_bits, byte_off = \
        bloom.flat_build_lanes(lists)
    words, valid, row_bits, bit_off = bloom.lanes_to(words, valid, row_bits,
                                                     bit_off, device)
    lists = [row for row in lists if row]
    got = sync_kernels.bloom_build(words, valid, row_bits, bit_off,
                                   total_bits)
    want = sync_kernels.bloom_build_plain(words, valid, row_bits, bit_off,
                                          total_bits)
    probe_lists = [row + [rng.bytes(32).hex() for _ in row] for row in lists]
    filters = [got[off:off + bloom.num_filter_bits(len(row)) // 8]
               .cpu().numpy() for off, row in zip(byte_off, lists)]
    flat, words, valid, row_bits, byte_off = bloom.flat_probe_lanes(
        filters, probe_lists)
    words, valid, row_bits, byte_off = bloom.lanes_to(words, valid, row_bits,
                                                      byte_off, device)
    flat = torch.from_numpy(flat).to(device)
    hit = sync_kernels.bloom_probe(flat, row_bits, byte_off, words, valid)
    plain_hit = sync_kernels.bloom_probe_plain(flat, row_bits, byte_off,
                                               words, valid)
    missed = sum(int((~hit[k, :len(row)]).sum())
                 for k, row in enumerate(lists))
    return dict(filters=len(lists), bytes=total_bits // 8,
                build=int((got.int() - want.int()).abs().max()),
                probe=int((hit != plain_hit).sum()), missed=missed)


BLOOM_PROBE_CASES = ('all_present', 'all_absent', 'past_2_31')
BIG_ROW_BITS = (1 << 31) + (1 << 20)      # 268,566,528 bytes


def bloom_probe_case(name, rng, device):
    """The probe's inputs (flat, row_bits, byte_off, words, valid) at one
    corner of BLOOM_PROBE_CASES: 'all_present', 1,024 filters of 16
    random members each, probed with their members (16 lanes a row, the
    sync path's width); 'all_absent', 1,024 filters of 20 zero bytes
    probed with 16 random hashes each; 'past_2_31', a row of BIG_ROW_BITS
    bits (each bit set with probability 7/8, so about 0.39 of the lanes
    find all 7 bits) between two rows of 80 bits, 8 random lanes each."""
    if name == 'all_present':
        lists = [[rng.bytes(32).hex() for _ in range(16)]
                 for _ in range(1024)]
        words, valid, row_bits, bit_off, total_bits, byte_off = \
            bloom.flat_build_lanes(lists)
        packed = sync_kernels.bloom_build(
            *bloom.lanes_to(words, valid, row_bits, bit_off, device),
            total_bits)
        filters = [packed[off:off + bloom.num_filter_bits(16) // 8]
                   .cpu().numpy() for off in byte_off]
        flat, words, valid, row_bits, byte_off = bloom.flat_probe_lanes(
            filters, lists)
    elif name == 'all_absent':
        lists = [[rng.bytes(32).hex() for _ in range(16)]
                 for _ in range(1024)]
        filters = [np.zeros(20, dtype=np.uint8)] * len(lists)
        flat, words, valid, row_bits, byte_off = bloom.flat_probe_lanes(
            filters, lists)
    elif name == 'past_2_31':
        h = 8
        words = rng.integers(0, 1 << 32, (3, h, 3), dtype=np.uint64) \
            .astype(np.uint32)
        valid = np.ones((3, h), dtype=bool)
        big = BIG_ROW_BITS // 8
        row_bits = np.array([80, BIG_ROW_BITS, 80], dtype=np.int64)
        byte_off = np.array([0, 16, 16 + big], dtype=np.int64)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(1 << 31)))
        flat = torch.randint(0, 256, (16 + big + 16,), dtype=torch.uint8,
                             device=device, generator=gen)
        for _ in range(2):
            flat |= torch.randint(0, 256, flat.shape, dtype=torch.uint8,
                                  device=device, generator=gen)
        words, valid, row_bits, byte_off = bloom.lanes_to(
            words, valid, row_bits, byte_off, device)
        return flat, row_bits, byte_off, words, valid
    else:
        raise ValueError(f'unknown Bloom probe case {name!r}')
    words, valid, row_bits, byte_off = bloom.lanes_to(
        words, valid, row_bits, byte_off, device)
    return torch.from_numpy(flat).to(device), row_bits, byte_off, words, \
        valid


def bloom_probe_both(case):
    """The case through the probe kernel and its plain version. Returns
    the lanes, the valid lanes, the kernel's hits and 'probe', the lanes
    whose answers differ (0 when the kernel holds)."""
    hit = sync_kernels.bloom_probe(*case)
    plain_hit = sync_kernels.bloom_probe_plain(*case)
    return dict(lanes=hit.numel(), valid=int(case[4].sum()),
                hits=int(hit.sum()), probe=int((hit != plain_hit).sum()))
