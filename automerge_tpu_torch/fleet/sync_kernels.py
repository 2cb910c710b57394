"""The sync plane's device kernels: hand-written CUDA kernels and their
plain versions.

Four kernels, each the port of a jax.jit kernel of the JAX package
(csrc/bloom.cu and csrc/hashindex.cu say what bounds each on an H100
and what their design does about it):

- `bloom_build(words, valid, row_bits, bit_off, total_bits)`: the flat
  packed Bloom build (automerge_tpu/fleet/bloom.py `_build_flat_packed`).
  Returns the [total_bits / 8] uint8 LSB-first packed filters. Rows are
  whole bytes in bit_off order without overlap, padded rows at the end
  (bloom.flat_build_lanes), and H is a power of two: each CTA of the
  kernel builds a group of rows in shared memory and stores its bytes
  once (`bloom_plan`, `bloom_groups_plain`), so the output is allocated
  with torch.empty. `probe_indexes_stepped` is its modulo rule.
- `bloom_probe(flat, row_bits, byte_off, words, valid)`: the flat packed
  probe (bloom.py `_probe_flat_packed`). Returns [rows, H] bool. The
  kernel gathers a lane's 7 bytes at once; its steps after the first
  three moduli follow `probe_indexes_stepped`.
- `hashindex_insert(tkey, tspace, keys, spaces, valid, max_occupancy,
  load_max)`: the open-addressing insert (automerge_tpu/fleet/
  hashindex.py `_insert_kernel`), in place. Returns the number of new
  keys as a 0-d int32 tensor.
- `hashindex_probe(tkey, tspace, keys, spaces, valid, window)`: exact
  membership (hashindex.py `_probe_kernel`). Returns [n] bool.

Torch has little uint32 arithmetic, so uint32 words ride as int32 bit
patterns: Bloom words [rows, H, 3] int32, hash-index keys [n, 8] int32
and the table's tkey [cap, 8] int32. Row capacities and offsets are
int64.

Routing is by the tensors' device: CUDA tensors launch the kernel (built
with nvcc for sm_90a on first use, see cuda_build.py); CPU tensors run
the plain version, the same function in torch ops (the plain versions
also run on CUDA tensors when called by name, as chip_smoke.py does to
hold the kernels to them). There is no fallback between the two: a
build or launch failure raises. `LAUNCHES[name]` counts kernel launches
and nothing else.

The plain insert reproduces the JAX claim loop (a scatter-min claim per
empty slot, lowest row wins), so on the CPU its tables equal the JAX
package's slot for slot. The kernel claims each key's first empty slot
in walk order with an atomic, so its slot layout may differ where two
rows of one batch race for a slot, while membership, the count of new
keys and the table's length agree, and both probes find every key it
placed.
"""

import ctypes

import torch

from . import cuda_build

NUM_PROBES = 7
GOLD = 0x9E3779B9        # Fibonacci-hash mix of the space id
_M32 = 0xFFFFFFFF
BITS_PER_ENTRY = 10      # the reference's filter sizing (bloom.py)
BUILD_LANES = 1024       # lanes per CTA of the build kernel (4 a thread)
BUILD_THREADS = 256      # threads per CTA of the build kernel
WINDOW_CAP = 200 * 1024  # the build's shared-memory window, at most

LAUNCHES = {'bloom_build': 0, 'bloom_probe': 0, 'hashindex_insert': 0,
            'hashindex_probe': 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare_bloom(lib):
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bloom_build_launch.argtypes = [ptr] * 5 + [i64, ctypes.c_int, i64,
                                                   i64, i64, ptr]
    lib.bloom_build_launch.restype = ctypes.c_int
    lib.bloom_probe_launch.argtypes = [ptr] * 6 + [i64, i64, ptr]
    lib.bloom_probe_launch.restype = ctypes.c_int


def _declare_hashindex(lib):
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.hashindex_insert_launch.argtypes = [ptr, ptr, i64, ptr, ptr, ptr,
                                            i64, ptr, ptr]
    lib.hashindex_insert_launch.restype = ctypes.c_int
    lib.hashindex_probe_launch.argtypes = [ptr, ptr, i64, ptr, ptr, ptr,
                                           i64, ptr, ptr]
    lib.hashindex_probe_launch.restype = ctypes.c_int


def build_bloom():
    """Compile csrc/bloom.cu (once per source content) and load it."""
    return cuda_build.load('bloom', _declare_bloom)


def build_hashindex():
    """Compile csrc/hashindex.cu (once per source content) and load it."""
    return cuda_build.load('hashindex', _declare_hashindex)


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous {dtype} '
                         f'{list(shape)} tensor on {dev}, got {t.dtype} '
                         f'{list(t.shape)} on {t.device}')
    if dev.type == 'cuda' and t.data_ptr() % 16:
        raise ValueError(f'{name}: the kernel needs 16-byte aligned data')


def _route(dev, what):
    """True: launch the kernel; False: run the plain version."""
    if dev.type == 'cpu':
        return False
    if dev.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {dev}')
    return True


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')


# ---- Bloom ---------------------------------------------------------------

def _check_bloom(words, valid, row_bits, offs):
    dev = words.device
    rows, h = words.shape[0], words.shape[1]
    _check('words', words, torch.int32, (rows, h, 3), dev)
    _check('valid', valid, torch.bool, (rows, h), dev)
    _check('row_bits', row_bits, torch.int64, (rows,), dev)
    _check('offsets', offs, torch.int64, (rows,), dev)
    return dev, rows, h


def bloom_plan(rows, h):
    """The build kernel's launch: (group, window, ctas). One CTA per
    `group` rows (BUILD_LANES / H of them, 1 to BUILD_THREADS); `window`
    bytes of shared memory each, enough for a group of the longest rows a
    hash axis of H lanes admits (BITS_PER_ENTRY bits an entry) from any
    byte alignment, rounded to 16 bytes, at most WINDOW_CAP: a longer row
    takes one pass over its lanes per window."""
    group = max(1, min(BUILD_THREADS, BUILD_LANES // h))
    longest = (h * BITS_PER_ENTRY + 7) // 8
    window = min(WINDOW_CAP, (group * longest + 15 + 15) // 16 * 16)
    return group, window, max(1, -(-rows // group))


def bloom_build(words, valid, row_bits, bit_off, total_bits):
    """The packed flat filters: bit bit_off[r] + p of a [total_bits]
    vector is set for every probe p of every valid lane of row r. Rows
    are whole bytes, laid out in bit_off order without overlap, as
    bloom.flat_build_lanes lays them out (padded rows start at
    total_bits); H is a power of two."""
    dev, rows, h = _check_bloom(words, valid, row_bits, bit_off)
    total_bits = int(total_bits)
    if total_bits % 32 or total_bits <= 0:
        raise ValueError('bloom_build: total_bits must be a positive '
                         'multiple of 32 (a power of two >= 64)')
    if h <= 0 or h & (h - 1):
        raise ValueError(f'bloom_build: the hash axis ({h} lanes) must be a '
                         f'power of two')
    if not _route(dev, 'bloom_build'):
        return bloom_build_plain(words, valid, row_bits, bit_off, total_bits)
    lib = build_bloom()
    group, window, _ctas = bloom_plan(rows, h)
    out = torch.empty(total_bits // 8, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.bloom_build_launch(
            words.data_ptr(), valid.data_ptr(), row_bits.data_ptr(),
            bit_off.data_ptr(), out.data_ptr(), rows, h.bit_length() - 1,
            group, total_bits // 8, window,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'bloom_build')
    LAUNCHES['bloom_build'] += 1
    return out


def bloom_probe(flat, row_bits, byte_off, words, valid):
    """[rows, H] bool: every probe bit of the lane is set in its row's
    filter (the bytes of `flat` from byte_off[r]), and the lane valid."""
    dev, rows, h = _check_bloom(words, valid, row_bits, byte_off)
    _check('flat', flat, torch.uint8, (flat.shape[0],), dev)
    if not _route(dev, 'bloom_probe'):
        return bloom_probe_plain(flat, row_bits, byte_off, words, valid)
    lib = build_bloom()
    out = torch.empty((rows, h), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.bloom_probe_launch(
            flat.data_ptr(), row_bits.data_ptr(), byte_off.data_ptr(),
            words.data_ptr(), valid.data_ptr(), out.data_ptr(), rows, h,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'bloom_probe')
    if rows * h:
        LAUNCHES['bloom_probe'] += 1
    return out


def probe_indexes_plain(words, row_bits):
    """[rows, H, 7] int64 probe positions (bloom.py `_probe_indexes`):
    uint32 triple hashing mod row_bits, in int64 on values below 2^32
    with the additions wrapped to 32 bits as uint32 arithmetic wraps."""
    m = row_bits.view(-1, 1)
    w = words.long() & _M32
    x, y, z = w[..., 0] % m, w[..., 1] % m, w[..., 2] % m
    probes = [x]
    for _ in range(1, NUM_PROBES):
        x = ((x + y) & _M32) % m
        y = ((y + z) & _M32) % m
        probes.append(x)
    return torch.stack(probes, dim=-1)


def probe_indexes_stepped(words, row_bits):
    """probe_indexes_plain by the build kernel's rule: after the three
    first moduli, a step (x + y) % m with x, y < m is x + y - m where
    x + y >= m, exact while m <= 2^31 (the sum stays below 2^32); a row
    with m > 2^31 keeps the modulo of the uint32 sum, which wraps first.
    Returns the same [rows, H, 7] int64 positions."""
    m = row_bits.view(-1, 1)
    w = words.long() & _M32
    x, y, z = w[..., 0] % m, w[..., 1] % m, w[..., 2] % m
    small = m <= 1 << 31

    def step(a, b):
        s = a + b
        return torch.where(small, torch.where(s >= m, s - m, s),
                           (s & _M32) % m)

    probes = [x]
    for _ in range(1, NUM_PROBES):
        x, y = step(x, y), step(y, z)
        probes.append(x)
    return torch.stack(probes, dim=-1)


def bloom_groups_plain(bit_off, row_bits, total_bits, group):
    """The build kernel's split of the output among its CTAs, in torch
    ops: CTA c holds rows [c * group, (c + 1) * group) and writes bytes
    [own_lo[c], own_hi[c]), from its first row's start (0 for the first
    CTA) to the next CTA's first row's start (the output's end for the
    last), clipped to the output; [own_lo[c], rows_end[c]) through its
    shared-memory window, up to the end of its last live row (a row that
    starts inside the output), and zeros after it. Returns (own_lo,
    rows_end, own_hi), [ctas] int64 each."""
    total = int(total_bits) // 8
    rows = len(bit_off)
    starts = (bit_off >> 3).clamp(max=total)
    ends = (bit_off + row_bits) >> 3
    first = torch.arange(0, max(rows, 1), group, dtype=torch.int64,
                         device=bit_off.device)
    after = (first + group).clamp(max=rows)
    edge = torch.cat([starts, starts.new_full((1,), total)])
    own_lo = edge[first.clamp(max=rows)]
    own_lo[0] = 0
    own_hi = edge[after]
    # live rows (starting inside the output) counted per group
    live = torch.cat([starts.new_zeros(1), (starts < total).long().cumsum(0)])
    n_live = live[after] - live[first.clamp(max=rows)]
    rows_end = torch.where(n_live > 0, ends[(first + n_live - 1).clamp(
        min=0, max=max(rows - 1, 0))] if rows else own_lo, own_lo)
    return own_lo, rows_end, own_hi


def bloom_build_plain(words, valid, row_bits, bit_off, total_bits):
    """bloom_build in torch ops (scatter of every probe, then LSB-first
    bit packing, following bloom.py `_build_flat_packed`)."""
    dev = words.device
    idx = bit_off.view(-1, 1, 1) + probe_indexes_plain(words, row_bits)
    idx = torch.where(valid.unsqueeze(-1), idx, total_bits)
    bits = torch.zeros(total_bits + 1, dtype=torch.uint8, device=dev)
    bits[idx.reshape(-1)] = 1
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    packed = (bits[:total_bits].view(-1, 8).int() * weights).sum(dim=-1)
    return packed.to(torch.uint8)


def bloom_probe_plain(flat, row_bits, byte_off, words, valid):
    """bloom_probe in torch ops (byte gather and bit test, following
    bloom.py `_probe_flat_packed`)."""
    probes = probe_indexes_plain(words, row_bits)
    byte = flat[byte_off.view(-1, 1, 1) + (probes >> 3)].long()
    hit = ((byte >> (probes & 7)) & 1) == 1
    return hit.all(dim=-1) & valid


# ---- the hash index ------------------------------------------------------

def _check_index(tkey, tspace, keys, spaces, valid):
    dev = tkey.device
    cap, n = tkey.shape[0], keys.shape[0]
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f'hash index: capacity {cap} is not a power of two')
    _check('tkey', tkey, torch.int32, (cap, 8), dev)
    _check('tspace', tspace, torch.int32, (cap,), dev)
    _check('keys', keys, torch.int32, (n, 8), dev)
    _check('spaces', spaces, torch.int32, (n,), dev)
    _check('valid', valid, torch.bool, (n,), dev)
    return dev, cap, n


def start_pos(keys, spaces, cap):
    """hashindex.py `_start_pos`: (key[0] ^ uint32(space) * GOLD) mod cap,
    in int64 masked to 32 bits (a space below 2^31 times GOLD stays
    below 2^63, and a negative space keeps its low 32 bits)."""
    mix = (keys[:, 0].long() & _M32) ^ ((spaces.long() * GOLD) & _M32)
    return mix & (cap - 1)


def hashindex_insert(tkey, tspace, keys, spaces, valid, max_occupancy,
                     load_max):
    """Insert the valid (space, key) rows into the table in place;
    duplicates (in the table or in the batch) land once. Returns the
    number of new keys as a 0-d int32 tensor. `max_occupancy` bounds the
    slots in use after the call (slots in use before it plus the valid
    rows); it must stay within load_max of the capacity, which is what
    makes every walk end at an empty slot."""
    dev, cap, n = _check_index(tkey, tspace, keys, spaces, valid)
    if not 0 < load_max < 1 or max_occupancy > load_max * cap:
        raise ValueError(f'hashindex_insert: {max_occupancy} keys exceed '
                         f'the load bound {load_max} of {cap} slots')
    if not _route(dev, 'hashindex_insert'):
        return hashindex_insert_plain(tkey, tspace, keys, spaces, valid)
    if cap < 8:
        raise ValueError('hashindex_insert: the kernel walks 8-slot '
                         f'sectors and needs at least 8 slots, not {cap}')
    lib = build_hashindex()
    n_new = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hashindex_insert_launch(
            tkey.data_ptr(), tspace.data_ptr(), cap, keys.data_ptr(),
            spaces.data_ptr(), valid.data_ptr(), n, n_new.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'hashindex_insert')
    if n:
        LAUNCHES['hashindex_insert'] += 1
    return n_new[0]


def hashindex_probe(tkey, tspace, keys, spaces, valid, window=16):
    """[n] bool: the valid row's (space, key) is in the table. `window`
    shapes only the plain version's gather (the answer is the same)."""
    dev, cap, n = _check_index(tkey, tspace, keys, spaces, valid)
    if not _route(dev, 'hashindex_probe'):
        return hashindex_probe_plain(tkey, tspace, keys, spaces, valid,
                                     window)
    lib = build_hashindex()
    out = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.hashindex_probe_launch(
            tkey.data_ptr(), tspace.data_ptr(), cap, keys.data_ptr(),
            spaces.data_ptr(), valid.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'hashindex_probe')
    if n:
        LAUNCHES['hashindex_probe'] += 1
    return out


def hashindex_insert_plain(tkey, tspace, keys, spaces, valid):
    """hashindex_insert in torch ops: the JAX claim loop of
    hashindex.py `_insert_kernel`. Each step a pending row stops on a
    match, claims its empty slot if it is the lowest pending row there
    (scatter-min), or moves past an occupied slot of another key; a row
    that lost a claim retries the same slot and so meets the winner's
    key. In place; returns the new-key count as a 0-d int32 tensor."""
    dev = tkey.device
    cap, n = tkey.shape[0], keys.shape[0]
    row = torch.arange(n, dtype=torch.int64, device=dev)
    pos = start_pos(keys, spaces, cap)
    pending = valid.clone()
    n_new = torch.zeros((), dtype=torch.int32, device=dev)
    while bool(pending.any()):
        slot_space = tspace[pos]
        occ = slot_space >= 0
        match = pending & occ & (slot_space == spaces) & \
            (tkey[pos] == keys).all(dim=-1)
        pending = pending & ~match
        want = pending & ~occ
        claim = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(want, pos, cap), row, 'amin')
        won = want & (claim[pos] == row)
        wpos = pos[won]
        tkey[wpos] = keys[won]
        tspace[wpos] = spaces[won]
        n_new += won.sum(dtype=torch.int32)
        pending = pending & ~won
        advance = pending & occ & ~match
        pos = torch.where(advance, (pos + 1) & (cap - 1), pos)
    return n_new


def hashindex_probe_plain(tkey, tspace, keys, spaces, valid, window=16):
    """hashindex_probe in torch ops, as hashindex.py `_probe_kernel`
    computes it: the first `window` slots of every chain in one gather,
    then a serial walk for the rows still undecided."""
    dev = tkey.device
    cap = tkey.shape[0]
    wrap = cap - 1
    pos0 = start_pos(keys, spaces, cap)
    w = torch.arange(window, dtype=torch.int64, device=dev)
    win = (pos0.view(-1, 1) + w.view(1, -1)) & wrap
    slot_space = tspace[win]
    occ = slot_space >= 0
    match = occ & (slot_space == spaces.view(-1, 1)) & \
        (tkey[win] == keys.view(-1, 1, 8)).all(dim=-1)
    big = window + 1
    first_match = torch.where(match, w, big).min(dim=1).values
    first_empty = torch.where(~occ, w, big).min(dim=1).values
    found = valid & (first_match < first_empty)
    active = valid & (first_match == big) & (first_empty == big)
    pos = (pos0 + window) & wrap
    while bool(active.any()):
        s = tspace[pos]
        occ = s >= 0
        hit = active & occ & (s == spaces) & (tkey[pos] == keys).all(dim=-1)
        found = found | hit
        active = active & occ & ~hit
        pos = torch.where(active, (pos + 1) & wrap, pos)
    return found
