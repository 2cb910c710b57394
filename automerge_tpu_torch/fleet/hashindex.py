"""Device-resident frontier index: ONE open-addressing hash table over
32-byte change hashes, serving exact membership for the sync plane and
the subscription hub's quiet-tick frontier compare (torch port of
automerge_tpu/fleet/hashindex.py).

The batched insert and probe are the hand-written CUDA kernels of
fleet/sync_kernels.py (`hashindex_insert`, `hashindex_probe`); the
frontier compare is elementwise, plain torch ops on the table's device.
The table lives on the device the caller names (`HashIndex(device=)`,
CUDA unless asked otherwise; a fleet's index lives on the fleet's
device). `table_from_numpy` / `table_to_numpy` carry a table across
packages, as tensor_doc's state_from_numpy does for the grids.

The reference's description follows.

The sync protocol's membership questions (``theirHave`` lastSync
reconciliation, received-heads lookup, incoming-change dedup) ride
per-document Python dicts today — O(1) per probe, but each probe forces
the doc's hash-graph dicts to exist (``_ensure_graph``), which is
O(history) to build, and the per-peer probe loops are host work that
grows with the fleet. Following WarpSpeed (PAPERS.md, the technique
source for concurrent GPU open-addressing tables), this module keeps the
whole fleet's (doc, hash) membership in ONE fixed-capacity open-
addressing table with batched insert/probe kernels: a full
round's probes are one device dispatch regardless of history length or
peer count — the same O(1)-dispatch property round 6 won for Bloom
build/probe (fleet/bloom.py), extended to exact membership.

Layout and algorithm
--------------------

- Keys are (space, hash) pairs: the 32-byte SHA-256 hash as eight
  little-endian uint32 lanes plus an int32 *space* id. Spaces are
  namespaces (one per doc slot, minted monotonically, never reused) so
  one physical table serves every doc without cross-doc false hits.
- Linear probing over a power-of-two capacity. The batched insert
  resolves intra-batch collisions with a claim: each row claims its
  empty slot with an atomic compare-and-swap (the plain version: a
  scatter-min of row index, lowest row wins), and a loser re-probes the
  same slot — a loser carrying the SAME key then terminates on the match
  instead of double-inserting. Duplicate inserts are therefore
  idempotent by construction, in-batch and across batches.
- Tombstone-free deletion: ``release_space`` only marks the space dead
  (host-side bitmap). Dead keys stay physically resident — probes mask
  dead spaces host-side — and are reclaimed wholesale at the next
  grow-by-migration, which re-inserts only live-space keys into the
  doubled table (one dispatch). No tombstones, no probe-chain breaks.
- Host fallback for the tiny-N case: below ``device_min`` total keys the
  spaces live as plain Python sets (zero dispatches, faster than a
  device round-trip); the first insert crossing the threshold migrates
  everything device-side in one dispatch.

``frontier_compare`` is the second consumer: one dispatch comparing K
cursor head rows against K doc head rows (the ``_DocCols`` columnar
head32/head_n lanes), collapsing the subscription hub's 10k-subscriber
quiet tick into a single device call (query/subscriptions.py).

The module registers dispatch/memory/health sources like fleet/bloom.py
does; `sync_kernels.LAUNCHES` counts the kernels' launches.
"""

import weakref

import numpy as np
import torch

from . import sync_kernels
from .tensor_doc import resolve_device

__all__ = ['HashIndex', 'FleetFrontierIndex', 'PeerSentSet',
           'flush_peer_sets', 'probe_peer_sets', 'release_sent_hashes',
           'release_sync_state', 'frontier_compare', 'hashes_to_rows',
           'engine_hash_population', 'dispatch_count', 'probe_window',
           'set_probe_window', 'table_from_numpy', 'table_to_numpy']

# Device dispatches issued by the batched insert/probe/compare entry
# points since import — the frontier-index twin of bloom.dispatch_count()
# (the table serves host-side protocol drivers, which have no fleet
# dispatch counter in scope). bench.py and the quiet-tick pin tests diff
# this around a round.
_dispatches = 0


def dispatch_count():
    """Monotonic count of frontier-index device dispatches (insert +
    probe + migrate + frontier compare)."""
    return _dispatches


# AUTOMERGE_TPU_FRONTIER_INDEX=0 pins the classic host-dict membership
# path EVERYWHERE the index would otherwise serve — the batched driver
# AND the single-doc protocol (backend/sync.py known_hash_flags routes
# through _FlatEngine.probe_hashes, which consults this) — the bench's
# old-path contrast leg and a debugging escape hatch. Default on.
import os as _os  # noqa: E402
_frontier_enabled = _os.environ.get('AUTOMERGE_TPU_FRONTIER_INDEX') != '0'


def frontier_enabled():
    return _frontier_enabled


def set_frontier_enabled(on):
    """Toggle frontier-index routing (bench / debugging; returns the
    previous setting). Covers the batched sync driver and the warm
    single-doc probe path alike."""
    global _frontier_enabled
    prev = _frontier_enabled
    _frontier_enabled = bool(on)
    return prev


def _env_int(name, default, lo, hi):
    try:
        val = int(_os.environ.get(name, '') or default)
    except ValueError:
        val = default
    return max(lo, min(hi, val))


# The windowed-probe width and the host/device crossover were both tuned
# in the JAX package against XLA-CPU dispatch overhead (a while_loop
# iteration costs ~0.1 ms there). The CUDA probe walks each chain and has
# no window; the plain version keeps it (the answer does not depend on
# it). Both stay env-tunable, as the API has them.
_DEF_PROBE_WINDOW = 16
_DEF_DEVICE_MIN = 4096
_probe_window = _env_int('AUTOMERGE_TPU_PROBE_WINDOW',
                         _DEF_PROBE_WINDOW, 1, 1024)
_default_device_min = _env_int('AUTOMERGE_TPU_DEVICE_MIN',
                               _DEF_DEVICE_MIN, 0, 1 << 30)


def probe_window():
    """Current windowed-probe width (slots gathered per probe before the
    serial tail walk). Set via AUTOMERGE_TPU_PROBE_WINDOW or
    ``set_probe_window``."""
    return _probe_window


def set_probe_window(width):
    """Set the probe window width (bench sweep / on-chip retune);
    returns the previous width. Only the plain probe reads it."""
    global _probe_window
    prev = _probe_window
    _probe_window = max(1, min(1024, int(width)))
    return prev


from ..observability import (register_dispatch_source,  # noqa: E402
                             register_mem_source)
from ..observability.metrics import Counters  # noqa: E402
from ..observability.spans import spanned as _spanned  # noqa: E402
register_dispatch_source('hashindex', dispatch_count)

_stats = Counters({
    'hashindex_inserts': 0,       # keys newly landed in a table
    'hashindex_probes': 0,        # membership questions answered
    'hashindex_migrations': 0,    # grow-by-migration passes
    'hashindex_promotions': 0,    # host-mode tables promoted to device
    'hashindex_backfills': 0,     # doc registrations (history backfills)
    'hashindex_peer_spaces': 0,   # peer sentHashes spaces minted
    'hashindex_peer_releases': 0,  # peer spaces handed back
})
from ..observability import register_health_source  # noqa: E402
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])

_live_indexes = weakref.WeakSet()
_live_peer_sets = weakref.WeakSet()


def _index_bytes():
    total = 0
    for ix in list(_live_indexes):
        total += ix.resident_bytes()
    for ps in list(_live_peer_sets):
        total += ps.staged_bytes()
    return total


register_mem_source('hashindex_bytes', _index_bytes)


def _pow2(n, floor=1):
    out = max(int(floor), 1)
    n = int(n)
    while out < n:
        out *= 2
    return out


def hashes_to_rows(hashes):
    """Normalize hash input to an [N, 32] uint8 array: accepts a list of
    hex strings, a list of 32-byte buffers, or an [N, 32] uint8 array
    (returned as-is). One C-level hex decode for the whole batch."""
    if isinstance(hashes, np.ndarray):
        if hashes.dtype != np.uint8 or hashes.ndim != 2 or \
                hashes.shape[1] != 32:
            raise ValueError('hash array must be [N, 32] uint8')
        return hashes
    if not hashes:
        return np.zeros((0, 32), dtype=np.uint8)
    first = hashes[0]
    if isinstance(first, str):
        raw = bytes.fromhex(''.join(hashes))
    else:
        raw = b''.join(bytes(h) for h in hashes)
    if len(raw) != 32 * len(hashes):
        raise ValueError('hashes must be 256 bits')
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(hashes), 32)


def _rows_to_words(rows):
    """[N, 32] uint8 -> [N, 8] uint32 key lanes (little-endian words)."""
    return np.ascontiguousarray(rows).view('<u4').reshape(len(rows), 8)


def _compare(cur32, cur_n, doc32, doc_n):
    """Quiet iff the cursor frontier equals the doc frontier: head
    counts agree AND (both empty, or the single head32 rows are byte
    equal). Counts past 1 (multi-head) are NEVER quiet here — those
    classes are host residue; answering False routes them there.
    Elementwise torch ops (hashindex.py `_compare_kernel`)."""
    eq = (cur32 == doc32).all(dim=-1)
    return (cur_n == doc_n) & ((cur_n == 0) | ((cur_n == 1) & eq))


def _pad_batch(words, spaces, valid, floor=8):
    n = len(spaces)
    n_pad = _pow2(n, floor=floor)
    if n_pad == n:
        return words, spaces, valid
    words = np.concatenate(
        [words, np.zeros((n_pad - n, 8), dtype=np.uint32)])
    spaces = np.concatenate(
        [spaces, np.full(n_pad - n, -1, dtype=np.int32)])
    valid = np.concatenate([valid, np.zeros(n_pad - n, dtype=bool)])
    return words, spaces, valid


@_spanned('frontier_compare')
def frontier_compare(cur32, cur_n, doc32, doc_n, device=None):
    """ONE device dispatch answering K frontier-equality questions:
    ``out[k]`` is True iff cursor frontier k (head32 row + head count,
    0 = empty, 1 = the row) equals doc frontier k. Inputs are numpy
    ([K, 32] uint8 and [K] int32-ish); rows are pow2-padded. Counts
    other than 0/1 must be resolved host-side by the caller. Runs on
    `device` (CUDA unless the caller asks otherwise)."""
    global _dispatches
    k = len(cur_n)
    if k == 0:
        return np.zeros(0, dtype=bool)
    k_pad = _pow2(k, floor=8)
    c32 = np.zeros((k_pad, 32), dtype=np.uint8)
    c32[:k] = cur32
    d32 = np.zeros((k_pad, 32), dtype=np.uint8)
    d32[:k] = doc32
    cn = np.full(k_pad, -2, dtype=np.int32)
    cn[:k] = cur_n
    dn = np.full(k_pad, -3, dtype=np.int32)
    dn[:k] = doc_n
    dev = resolve_device(device)
    out = _compare(*(torch.from_numpy(a).to(dev) for a in (c32, cn, d32,
                                                            dn)))
    _dispatches += 1
    return out.cpu().numpy()[:k]


# ---- the table -------------------------------------------------------

class HashIndex:
    """Open-addressing exact-membership table over (space, 32-byte hash)
    keys. See the module docstring for the layout. Host mode (plain
    sets) below ``device_min`` total keys; device mode past it; both
    modes answer identically (the adversarial suite pins it)."""

    def __init__(self, capacity=1024, device_min=None, load_max=0.6,
                 device=None):
        if load_max <= 0 or load_max >= 1:
            raise ValueError('load_max must be in (0, 1)')
        # the torch device of the table (CUDA unless the caller asks)
        self.device = resolve_device(device)
        # None -> AUTOMERGE_TPU_DEVICE_MIN (default 4096) so the
        # host/device crossover is re-tunable on-chip without code
        self.device_min = _default_device_min if device_min is None \
            else int(device_min)
        self.load_max = float(load_max)
        self.cap = _pow2(capacity, floor=8)
        self._tkey = None          # [cap, 8] int32 bits of uint32 (device)
        self._tspace = None        # [cap] int32, -1 = empty (device)
        self.occupancy = 0         # physical slots used (incl. dead keys)
        self.n_keys = 0            # live keys (dead spaces excluded)
        self._next_space = 0
        self._live = np.zeros(64, dtype=bool)   # space id -> alive
        self._sets = {}            # host mode: space -> set of 32-byte keys
        self.grows = 0
        _live_indexes.add(self)

    # -- introspection -------------------------------------------------

    @property
    def mode(self):
        return 'host' if self._sets is not None else 'device'

    def resident_bytes(self):
        if self._sets is not None:
            # sets of 32-byte bytes objects: ~80 B object overhead each
            return sum(len(s) for s in self._sets.values()) * 112
        return self.cap * (8 * 4 + 4)

    def __len__(self):
        return self.n_keys

    # -- spaces --------------------------------------------------------

    def new_space(self):
        """Mint a fresh namespace id (never reused)."""
        sid = self._next_space
        self._next_space += 1
        if sid >= len(self._live):
            grown = np.zeros(_pow2(sid + 1, floor=64), dtype=bool)
            grown[:len(self._live)] = self._live
            self._live = grown
        self._live[sid] = True
        if self._sets is not None:
            self._sets[sid] = set()
        return sid

    def release_space(self, sid):
        """Tombstone-free delete of a whole namespace: the space is
        marked dead now (probes mask it host-side); its physical slots
        are reclaimed at the next grow-by-migration."""
        if sid < 0 or sid >= self._next_space or not self._live[sid]:
            return
        self._live[sid] = False
        if self._sets is not None:
            self.n_keys -= len(self._sets.pop(sid, ()))
            self.occupancy = self.n_keys
        # device mode: n_keys for the dead space is unknown per space;
        # the migration recount restores exactness. Until then n_keys is
        # an upper bound, which only ever grows the table early.

    def live_spaces(self):
        return [int(s) for s in np.flatnonzero(self._live)]

    # -- inserts / probes ----------------------------------------------

    def _space_vec(self, spaces, n):
        if np.isscalar(spaces):
            return np.full(n, int(spaces), dtype=np.int32)
        out = np.asarray(spaces, dtype=np.int32)
        if len(out) != n:
            raise ValueError('spaces and hashes must align')
        return out

    def insert(self, spaces, hashes):
        """Insert N (space, hash) pairs — duplicates are no-ops. ONE
        device dispatch in device mode. `spaces` is an int array or a
        scalar broadcast over the batch; `hashes` as in
        ``hashes_to_rows``. Returns the number of NEW keys landed."""
        rows = hashes_to_rows(hashes)
        n = len(rows)
        if n == 0:
            return 0
        spaces = self._space_vec(spaces, n)
        valid = (spaces >= 0) & (spaces < self._next_space) & \
            self._live[np.clip(spaces, 0, len(self._live) - 1)]
        if self._sets is not None and \
                self.n_keys + n <= self.device_min:
            new = 0
            for i in np.flatnonzero(valid).tolist():
                s = self._sets[int(spaces[i])]
                k = rows[i].tobytes()
                if k not in s:
                    s.add(k)
                    new += 1
            self.n_keys += new
            self.occupancy = self.n_keys
            if new:
                _stats.inc('hashindex_inserts', new)
            return new
        if self._sets is not None:
            self._promote()
        self._ensure_capacity(self.occupancy + n)
        new = self._device_insert(_rows_to_words(rows), spaces, valid)
        if new:
            _stats.inc('hashindex_inserts', new)
        return new

    def probe(self, spaces, hashes):
        """[N] bool exact membership — ONE device dispatch in device
        mode. Unknown/dead spaces answer False."""
        rows = hashes_to_rows(hashes)
        n = len(rows)
        if n == 0:
            return np.zeros(0, dtype=bool)
        spaces = self._space_vec(spaces, n)
        valid = (spaces >= 0) & (spaces < self._next_space) & \
            self._live[np.clip(spaces, 0, len(self._live) - 1)]
        _stats.inc('hashindex_probes', n)
        if self._sets is not None:
            out = np.zeros(n, dtype=bool)
            for i in np.flatnonzero(valid).tolist():
                out[i] = rows[i].tobytes() in self._sets[int(spaces[i])]
            return out
        global _dispatches
        words, spaces_p, valid_p = _pad_batch(
            _rows_to_words(rows), spaces, valid)
        hit = sync_kernels.hashindex_probe(
            self._tkey, self._tspace, *self._to_device(words, spaces_p,
                                                       valid_p),
            window=_probe_window)
        _dispatches += 1
        return hit.cpu().numpy()[:n]

    # -- device plumbing -----------------------------------------------

    def _alloc_table(self, cap):
        return (torch.zeros((cap, 8), dtype=torch.int32, device=self.device),
                torch.full((cap,), -1, dtype=torch.int32, device=self.device))

    def _to_device(self, words, spaces, valid):
        """Host key lanes ([n, 8] uint32, [n] int32, [n] bool) as the
        kernels' device tensors (uint32 words as int32 bit patterns)."""
        return (torch.from_numpy(np.array(words, dtype=np.uint32)
                                 .view(np.int32)).to(self.device),
                torch.from_numpy(np.array(spaces, dtype=np.int32))
                .to(self.device),
                torch.from_numpy(np.array(valid, dtype=bool))
                .to(self.device))

    def _device_insert(self, words, spaces, valid):
        words, spaces, valid = _pad_batch(words, spaces, valid)
        return self._insert_lanes(*self._to_device(words, spaces, valid))

    def _insert_lanes(self, keys, spaces, valid):
        """Insert device key lanes ([n, 8] int32, [n] int32, [n] bool):
        one dispatch; returns the number of new keys."""
        global _dispatches
        # the kernel's walks end because the table stays under load_max
        # (_ensure_capacity sized it for every valid row)
        n_new = sync_kernels.hashindex_insert(
            self._tkey, self._tspace, keys, spaces, valid,
            max_occupancy=self.occupancy + int(valid.sum()),
            load_max=self.load_max)
        _dispatches += 1
        new = int(n_new)
        self.occupancy += new
        self.n_keys += new
        return new

    def _promote(self):
        """Host sets -> device table, one insert dispatch."""
        sets, self._sets = self._sets, None
        self._ensure_capacity(self.n_keys, alloc_only=True)
        total = sum(len(s) for s in sets.values())
        self.occupancy = self.n_keys = 0
        _stats.inc('hashindex_promotions')
        if not total:
            return
        rows = np.zeros((total, 32), dtype=np.uint8)
        spaces = np.zeros(total, dtype=np.int32)
        k = 0
        for sid, keys in sets.items():
            for key in keys:
                rows[k] = np.frombuffer(key, dtype=np.uint8)
                spaces[k] = sid
                k += 1
        self._device_insert(_rows_to_words(rows), spaces,
                            np.ones(total, dtype=bool))

    def _ensure_capacity(self, need, alloc_only=False):
        """Grow (pow2) so `need` keys fit under load_max; migration
        re-inserts only LIVE-space keys (dead spaces reclaimed here)."""
        cap = self.cap
        while need > self.load_max * cap:
            cap *= 2
        if self._tkey is None:
            self.cap = cap
            self._tkey, self._tspace = self._alloc_table(cap)
            return
        if cap == self.cap:
            return
        old_key, old_space = self._tkey, self._tspace
        self.cap = cap
        self._tkey, self._tspace = self._alloc_table(cap)
        old_occ = self.occupancy
        self.occupancy = 0
        if alloc_only or old_occ == 0:
            return
        # the live-space mask is built where the old table lies, so the
        # migration re-inserts it without a round trip through the host
        live = torch.from_numpy(self._live[:max(self._next_space, 1)]) \
            .to(self.device)
        valid = (old_space >= 0) & \
            live[old_space.long().clamp(0, len(live) - 1)]
        migrated = self._insert_lanes(old_key, old_space, valid)
        self.n_keys = migrated   # exact live recount
        self.grows += 1
        _stats.inc('hashindex_migrations')


# ---- peer sent-spaces ------------------------------------------------

def _release_peer_space(table, sid):
    table.release_space(sid)
    _stats.inc('hashindex_peer_releases')


class PeerSentSet:
    """One peer link's ``sentHashes`` as a *peer-space* of a shared
    ``HashIndex``: a set-like duck type (``in`` / ``add``) whose adds
    STAGE host-side (hex strings, bounded by sent volume) until
    ``flush_peer_sets`` lands every link's backlog in ONE batched
    insert per shard round. Space ids are minted monotonically and
    never reused, so a reconnecting peer can never inherit a
    predecessor's sent set; ``release()`` — and GC, via the finalizer,
    for states dropped without ceremony — hands the space back for the
    next grow-by-migration to reclaim.

    Unlike the plain-set path, the object is shared BY IDENTITY across
    sync-state generations: the classic ``set(sent_hashes)``
    copy-on-write only shielded the OLD state dict, which no caller
    ever re-generates from, and the promotion itself snapshots the old
    plain set — so membership answers are unchanged."""

    __slots__ = ('table', 'sid', '_staged', '_finalizer', '__weakref__')

    def __init__(self, table, seed=()):
        self.table = table
        self.sid = table.new_space()
        self._staged = set(seed)
        self._finalizer = weakref.finalize(
            self, _release_peer_space, table, self.sid)
        _stats.inc('hashindex_peer_spaces')
        _live_peer_sets.add(self)

    @property
    def alive(self):
        return self._finalizer.alive

    def __contains__(self, hash_hex):
        if hash_hex in self._staged:
            return True
        return bool(self.table.probe(self.sid, [hash_hex])[0])

    def add(self, hash_hex):
        self._staged.add(hash_hex)

    def stage_many(self, hashes):
        self._staged.update(hashes)

    def contains_many(self, hashes):
        """[N] bool membership without flushing: staged hashes answer
        host-side, the remainder in one probe."""
        out = np.zeros(len(hashes), dtype=bool)
        rest = []
        for i, h in enumerate(hashes):
            if h in self._staged:
                out[i] = True
            else:
                rest.append(i)
        if rest:
            out[rest] = self.table.probe(
                self.sid, [hashes[i] for i in rest])
        return out

    def flush(self):
        """Land this one link's staged rows (prefer the module-level
        ``flush_peer_sets`` — it batches N links into one insert)."""
        flush_peer_sets([self])

    def release(self):
        """Disconnect / reset: hand the space back (idempotent)."""
        if self._finalizer.alive:
            self._staged.clear()
            self._finalizer()

    def staged_bytes(self):
        # staged hex strings: ~112 B apiece (64-char str + set slot)
        return len(self._staged) * 112


def flush_peer_sets(peer_sets):
    """Land every staged (peer-space, hash) row across N links in ONE
    batched insert per underlying table — THE per-shard-round insert of
    the sync fabric. Returns the number of new keys landed."""
    by_table = {}
    for ps in peer_sets:
        if isinstance(ps, PeerSentSet) and ps._staged and ps.alive:
            by_table.setdefault(id(ps.table), (ps.table, []))[1].append(ps)
    landed = 0
    for table, group in by_table.values():
        spaces, hex_list = [], []
        for ps in group:
            staged = sorted(ps._staged)
            ps._staged.clear()
            spaces.extend([ps.sid] * len(staged))
            hex_list.extend(staged)
        landed += table.insert(np.asarray(spaces, dtype=np.int32),
                               hex_list)
    return landed


def release_sent_hashes(obj):
    """Hand back the peer-space behind a ``sentHashes`` value (no-op for
    plain sets). Call wherever a link's sync state is discarded —
    disconnect, ``reset=True``, stall reset — the GC finalizer would get
    there eventually; deterministic release gets there now."""
    if isinstance(obj, PeerSentSet):
        obj.release()


def release_sync_state(state):
    """``release_sent_hashes`` over a whole sync-state dict."""
    if isinstance(state, dict):
        release_sent_hashes(state.get('sentHashes'))


def probe_peer_sets(peer_sets, hash_lists):
    """Fused sentHashes filter: ``out[i][j]`` is True iff
    ``hash_lists[i][j]`` was already sent on link ``peer_sets[i]``.
    Every link's staged backlog flushes first (at most one insert per
    table), then ALL links' questions ride one probe dispatch per
    table. Released links answer all-False (their space is dead)."""
    flush_peer_sets(peer_sets)
    out = [np.zeros(len(hs), dtype=bool) for hs in hash_lists]
    by_table = {}
    for i, (ps, hs) in enumerate(zip(peer_sets, hash_lists)):
        if hs and isinstance(ps, PeerSentSet):
            by_table.setdefault(id(ps.table), (ps.table, []))[1].append(i)
    for table, idxs in by_table.values():
        spaces, hex_list, owner = [], [], []
        for i in idxs:
            hs = list(hash_lists[i])
            spaces.extend([peer_sets[i].sid] * len(hs))
            hex_list.extend(hs)
            owner.extend([(i, j) for j in range(len(hs))])
        hit = table.probe(np.asarray(spaces, dtype=np.int32), hex_list)
        for (i, j), h in zip(owner, hit):
            out[i][j] = bool(h)
    return out


# ---- fleet wiring ----------------------------------------------------

def engine_hash_population(engine):
    """Every APPLIED change hash (hex) of a backend engine, WITHOUT
    building the hash-graph query dicts: materialized graph keys, then
    deferred records served from their cheapest lane — the native
    extractor's hash array for a parked prefix, the turbo parser's
    hash32 lanes for pending seam segments — with a per-change header
    decode only for records that have neither. Queued (causally
    premature) changes are excluded, matching get_change_by_hash."""
    out = list(engine.change_index_by_hash.keys())
    pending = getattr(engine, '_doc_pending', None)
    if pending is not None:
        # fills _doc_hashes via the native extractor when available;
        # today's sync rounds materialize these docs anyway (the graph
        # walk in get_change_hashes), so this forces nothing new
        engine._materialize_doc()
    doc_hashes = getattr(engine, '_doc_hashes', None)
    doc_decoded = getattr(engine, '_doc_decoded', None)
    for entry in engine._deferred:
        if len(entry) == 3:
            _index, batch, i = entry
            idxs = i if isinstance(i, (list, tuple, range)) else [i]
            hash_of = getattr(batch, 'hash_hex', None)
            eng_ref = getattr(batch, 'engine', None)
            for j in idxs:
                j = int(j)
                if eng_ref is engine and doc_hashes is not None and \
                        j < len(doc_hashes):
                    out.append(doc_hashes[j])
                elif eng_ref is engine and doc_decoded is not None and \
                        j < len(doc_decoded):
                    out.append(doc_decoded[j]['hash'])
                elif hash_of is not None:
                    out.append(hash_of(j))
                else:
                    out.append(batch.resolve(j)[0])
        else:
            out.append(entry[1])
    return out


class FleetFrontierIndex:
    """The per-fleet membership view over one ``HashIndex``: doc slots
    map to table spaces, commits STAGE their (slot, hash32) rows host-
    side (no dispatch on the commit fast path), and the next probe
    flushes the backlog in one insert dispatch. Registration backfills a
    doc's existing history once (cheap lanes, see
    ``engine_hash_population``); slot frees release the space
    (reclaimed at the next migration — tombstone-free)."""

    def __init__(self, fleet, device_min=None, capacity=1024):
        self._fleet_ref = weakref.ref(fleet)
        self.table = HashIndex(capacity=capacity, device_min=device_min,
                               device=fleet.device)
        self._spaces = {}          # slot -> space id
        self._staged = []          # (slot int, [n,32] uint8) batches
        self._staged_hex = []      # (slot, hex hash) singles

    # -- registration --------------------------------------------------

    def space_of(self, engine, register=True):
        """The engine's space id, registering (with a one-time history
        backfill) on first use. Returns None for unregistered engines
        when register=False."""
        slot = engine.slot
        sid = self._spaces.get(slot)
        if sid is not None:
            return sid
        if not register:
            return None
        sid = self.table.new_space()
        self._spaces[slot] = sid
        hashes = engine_hash_population(engine)
        _stats.inc('hashindex_backfills')
        if hashes:
            self.table.insert(sid, hashes_to_rows(hashes))
        return sid

    def registered(self, engine):
        return engine.slot in self._spaces

    def drop_slots(self, slots):
        """Slot free/reuse: release the spaces and purge staged rows so
        a recycled slot can never inherit its previous tenant's keys.
        Staged COMMIT batches carry an ndarray of slots per entry, so
        the purge masks per ROW — a batch mixing freed and live docs
        keeps exactly the live docs' rows."""
        gone = np.fromiter((int(s) for s in slots), dtype=np.int64,
                           count=len(slots))
        gone_set = set(gone.tolist())
        if self._staged:
            kept = []
            for slot_arr, rows in self._staged:
                mask = ~np.isin(slot_arr, gone)
                if mask.all():
                    kept.append((slot_arr, rows))
                elif mask.any():
                    kept.append((slot_arr[mask], rows[mask]))
            self._staged = kept
        if self._staged_hex:
            self._staged_hex = [(s, h) for s, h in self._staged_hex
                                if s not in gone_set]
        for slot in slots:
            sid = self._spaces.pop(slot, None)
            if sid is not None:
                self.table.release_space(sid)

    # -- staging (the commit-seam hook) --------------------------------

    def stage_rows(self, slots, hash32):
        """Host-side append of a commit batch's (slot, hash32) rows:
        numpy only, no dispatch — the next probe flushes. `slots` is an
        int array aligned with `hash32` [n, 32] uint8."""
        if len(hash32):
            self._staged.append((np.asarray(slots, dtype=np.int64).copy(),
                                 np.asarray(hash32, dtype=np.uint8).copy()))

    def stage_one(self, slot, hash_hex):
        self._staged_hex.append((int(slot), hash_hex))

    def flush(self):
        """Land every staged row in ONE insert dispatch. Rows for
        unregistered slots are dropped (their history backfills in full
        at registration, so nothing is lost)."""
        if not self._staged and not self._staged_hex:
            return
        staged, self._staged = self._staged, []
        staged_hex, self._staged_hex = self._staged_hex, []
        rows_list, space_list = [], []
        for slots, rows in staged:
            sids = np.array([self._spaces.get(int(s), -1) for s in slots],
                            dtype=np.int32)
            keep = sids >= 0
            if keep.any():
                rows_list.append(rows[keep])
                space_list.append(sids[keep])
        if staged_hex:
            sids = np.array([self._spaces.get(s, -1)
                             for s, _ in staged_hex], dtype=np.int32)
            keep = sids >= 0
            if keep.any():
                rows_list.append(hashes_to_rows(
                    [h for (_s, h), k in zip(staged_hex, keep) if k]))
                space_list.append(sids[keep])
        if rows_list:
            self.table.insert(np.concatenate(space_list),
                              np.concatenate(rows_list))

    # -- probes --------------------------------------------------------

    def probe_pairs(self, engines, hashes):
        """[N] bool membership for N (engine, hex hash) pairs in ONE
        dispatch (plus at most one staged-insert flush). Engines are
        registered (backfilled) on first sight."""
        self.flush()
        spaces = np.fromiter((self.space_of(e) for e in engines),
                             dtype=np.int32, count=len(engines))
        return self.table.probe(spaces, hashes_to_rows(list(hashes)))

    def resident_bytes(self):
        staged = sum(r.nbytes + s.nbytes for s, r in self._staged)
        return self.table.resident_bytes() + staged


# ---- carrying a table across packages --------------------------------

def table_from_numpy(tkey, tspace, n_spaces=None, device=None):
    """A device-mode HashIndex holding a copy of the table (tkey [cap, 8]
    uint32, tspace [cap] int32, -1 = empty) on `device` — the
    counterpart of tensor_doc.state_from_numpy, so two packages can
    start from the same table. Spaces 0 .. n_spaces - 1 (default: one
    past the largest space present) are minted live."""
    tkey = np.ascontiguousarray(tkey, dtype=np.uint32)
    tspace = np.ascontiguousarray(tspace, dtype=np.int32)
    cap = len(tspace)
    if tkey.shape != (cap, 8) or cap & (cap - 1):
        raise ValueError('table_from_numpy: expected tkey [cap, 8] and '
                         'tspace [cap] with cap a power of two')
    ix = HashIndex(capacity=cap, device=device)
    if ix.cap != cap:
        raise ValueError(f'table_from_numpy: capacity {ix.cap} != {cap}')
    ix._sets = None
    ix._tkey = torch.from_numpy(tkey.view(np.int32).copy()).to(ix.device)
    ix._tspace = torch.from_numpy(tspace.copy()).to(ix.device)
    if n_spaces is None:
        n_spaces = int(tspace.max(initial=-1)) + 1
    for _ in range(n_spaces):
        ix.new_space()
    ix.occupancy = ix.n_keys = int((tspace >= 0).sum())
    return ix


def table_to_numpy(index):
    """(tkey [cap, 8] uint32, tspace [cap] int32) of a device-mode
    HashIndex, as host arrays."""
    if index._tkey is None:
        raise ValueError('table_to_numpy: the index holds no device table')
    return (index._tkey.cpu().numpy().view(np.uint32),
            index._tspace.cpu().numpy())
