"""Delta+main storage engine: park ten million cold documents per host.

This is the torch port's copy of automerge_tpu/fleet/storage.py. Its one
difference is the `device=` keyword of `StorageEngine(...)` and
`StorageEngine.open(...)`: the torch device of the delta DocFleet built
when no `fleet` is given (CUDA unless the caller names another). Revive
loads parked chunks through the port's `load_docs`; the arena's on-disk
format is the reference's, byte for byte. The reference's description
follows.

The fleet's in-memory footprint has two very different tenants. LIVE
documents (the write-optimized **delta**) need device rows, causal state,
host change logs, and journal hooks. COLD documents need none of that:
their entire identity is one compressed document chunk plus a few dozen
bytes of causal state — and every read those docs actually get (heads,
clock, maxOp, change count, "are we in sync?") is answerable straight
from the chunk header and metadata columns (LSM-OPD: compute on
compressed data; `columnar.DocChunkView`).

This module is the read-optimized **main** for those cold documents,
split into two tiers:

- A **RAM-resident causal index**: per-doc causal state in fleet-level
  arrays (heads in one byte arena + offset arrays, clocks as flat
  (actor, seq) runs against an interned actor table, maxOp/n_changes as
  integer lanes) — ~100-130 B/doc, and the ONLY thing `heads`/`clock`/
  `contains_head`/`needs_sync` ever touch. Sync-gate probes for parked
  docs never fault a page.
- An **on-disk segment arena** (fleet/segment.py) holding the chunk
  bytes themselves: parked chunks append to mmap'd CRC-framed segment
  files, reads come back as zero-copy ``memoryview``s into the map
  (served off the page cache), vacuum is a segment rewrite + atomic
  manifest swap that is crash-safe at every byte (kill mid-vacuum
  recovers byte-identical). Pass ``path=None`` for yesterday's fully
  RAM-resident arena (ephemeral stores, tests, rebalance staging).

With the chunk bytes on disk, the 1M-docs-per-host ceiling becomes a
disk number: RSS holds the causal lanes only (tests/test_storage_tier.py
asserts the ceiling; bench.py's ``storage_tier`` section measures
park/revive/materialize against the RAM-resident baseline).

``StorageEngine`` is the policy layer binding a live ``DocFleet`` to a
``MainStore``: ``park`` demotes cold fleet docs (canonical chunk via
``save()``, round-trip-validated by the native extractor, device slots
freed), ``revive`` promotes them back through the bulk loader (one
native parse over the mapped views + batched dispatches), and causal
reads route to the columnar lanes without touching chunk bytes at all.
Tiering POLICY — when to park, when to vacuum, how brownout pressure
defers compaction — lives in fleet/tiering.py as a cost model, replacing
the fixed ``dead_fraction`` byte trigger (which remains as the default
standalone policy).

Durability composition: parking a journaled doc frees it from the
journal's registry (the standard FREE record) — its bytes now live in
the main store's segment arena, whose manifest/frame discipline makes
parked docs recoverable via ``StorageEngine.open``; reviving through a
``DurableFleet``'s ``load_docs`` re-journals the chunk as the doc's
baseline. The incremental per-doc compaction that keeps checkpoint cost
proportional to churn lives in fleet/durability.py.
"""

import sys
import weakref
from operator import index as _op_index

import numpy as np

from ..columnar import DocChunkView
from ..errors import MalformedDocument
from ..observability.metrics import Counters, register_health_source
from ..observability.perf import register_mem_source
from ..observability.spans import span as _span
from .segment import RamArena, SegmentArena

__all__ = ['MainStore', 'StorageEngine']

_stats = Counters({
    'storage_auto_vacuums': 0,   # policy-triggered vacuums (threshold or model)
    'storage_parked_syncs_skipped': 0,   # sync rounds served parked
    'storage_recovered_docs': 0,         # docs rebuilt by MainStore.open
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])

# memory-watermark tiers: RESIDENT bytes (causal lanes + RAM arenas) vs
# the mapped on-disk arena — the split the cost-based tiering plane and
# the RSS-ceiling acceptance both budget against
_live_stores = weakref.WeakSet()
register_mem_source(
    'mainstore_bytes',
    lambda: sum(s.resident_bytes() for s in list(_live_stores)))
register_mem_source(
    'mainstore_disk_bytes',
    lambda: sum(s.disk_bytes() for s in list(_live_stores)))


class _I64:
    """Growable integer lane (amortized-doubling numpy array)."""

    __slots__ = ('data', 'n')

    def __init__(self, dtype=np.int64):
        self.data = np.zeros(16, dtype=dtype)
        self.n = 0

    def _grow(self, need):
        cap = len(self.data)
        while cap < need:
            cap *= 2
        grown = np.zeros(cap, dtype=self.data.dtype)
        grown[:self.n] = self.data[:self.n]
        self.data = grown

    def append(self, value):
        if self.n == len(self.data):
            self._grow(self.n + 1)
        self.data[self.n] = value
        self.n += 1

    def extend(self, values):
        need = self.n + len(values)
        if need > len(self.data):
            self._grow(need)
        self.data[self.n:need] = values
        self.n = need

    def reserve(self, n):
        """Pre-size for n MORE rows (kills doubling slack on bulk
        ingest — the 10M-doc RSS budget assumes reserved lanes)."""
        need = self.n + n
        if need > len(self.data):
            grown = np.zeros(need, dtype=self.data.dtype)
            grown[:self.n] = self.data[:self.n]
            self.data = grown

    @property
    def nbytes(self):
        return int(self.data.nbytes)


class _IdMap:
    """Dense doc-id -> row map. Engine ids are monotonic and never
    recycled, so a growable int64 lane (-1 = absent) replaces the Python
    dict — ~8 B/id instead of ~70: at 10M parked docs the difference
    between the id indirection fitting the RSS ceiling or dominating
    it."""

    __slots__ = ('_rows', '_live')

    def __init__(self):
        self._rows = _I64()
        self._live = 0

    def __setitem__(self, doc_id, row):
        rows = self._rows
        if doc_id >= rows.n:
            if doc_id >= len(rows.data):
                rows._grow(doc_id + 1)
            rows.data[rows.n:doc_id + 1] = -1
            rows.n = doc_id + 1
        elif rows.data[doc_id] >= 0:
            self._live -= 1
        rows.data[doc_id] = row
        self._live += 1

    def get(self, doc_id, default=None):
        try:
            doc_id = _op_index(doc_id)   # numpy ints keep working, like
        except TypeError:                # the dict this lane replaced
            return default
        if 0 <= doc_id < self._rows.n:
            row = int(self._rows.data[doc_id])
            if row >= 0:
                return row
        return default

    def pop(self, doc_id):
        row = self.get(doc_id)
        if row is None:
            raise KeyError(doc_id)
        self._rows.data[doc_id] = -1
        self._live -= 1
        return row

    def update(self, pairs):
        for doc_id, row in pairs:
            self[doc_id] = row

    def __contains__(self, doc_id):
        return self.get(doc_id) is not None

    def __len__(self):
        return self._live

    def __iter__(self):
        data, n = self._rows.data, self._rows.n
        return (i for i in range(n) if data[i] >= 0)

    def items(self):
        data, n = self._rows.data, self._rows.n
        return ((i, int(data[i])) for i in range(n) if data[i] >= 0)

    def copy(self):
        fresh = _IdMap()
        fresh._rows = _I64()
        fresh._rows._grow(max(self._rows.n, 1))
        fresh._rows.data[:self._rows.n] = self._rows.data[:self._rows.n]
        fresh._rows.n = self._rows.n
        fresh._live = self._live
        return fresh

    @property
    def nbytes(self):
        return self._rows.nbytes


class _ByteLane:
    """Growable byte arena with reserve (the heads arena)."""

    __slots__ = ('data', 'n')

    def __init__(self):
        self.data = bytearray(64)
        self.n = 0

    def extend(self, b):
        need = self.n + len(b)
        if need > len(self.data):
            cap = len(self.data)
            while cap < need:
                cap *= 2
            self.data.extend(bytes(cap - len(self.data)))
        self.data[self.n:need] = b
        self.n = need

    def reserve(self, extra):
        need = self.n + extra
        if need > len(self.data):
            self.data.extend(bytes(need - len(self.data)))

    @property
    def nbytes(self):
        return len(self.data)


class MainStore:
    """Columnar causal index over a chunk arena (RAM or mmap'd disk).

    Row ids are dense ints assigned by ``add`` and never recycled until
    ``vacuum`` (discarded rows leave arena garbage that vacuum reclaims;
    ``dead_fraction``/``garbage_bytes`` expose the trigger signals). All
    causal reads are O(row) array lookups — no chunk bytes are touched;
    ``chunk(row)`` returns a zero-copy view into the arena."""

    # contains_head satellite: past this row count a per-store 8-byte
    # head-prefix set short-circuits miss probes O(1) (the parked sync
    # gate's common case at fleet scale) instead of the per-row scan
    PREFIX_MIN_ROWS = 4096

    def __init__(self, path=None, segment_bytes=None, _arena=None):
        if _arena is not None:
            self._arena = _arena
        elif path is not None:
            kw = {} if segment_bytes is None else \
                {'segment_bytes': segment_bytes}
            self._arena = SegmentArena(path, **kw)
        else:
            self._arena = RamArena()
        self.path = path
        self._seg = _I64(np.int32)       # row -> arena segment (-1 dead)
        self._off = _I64(np.int32)       # row -> payload offset in segment
        self._len = _I64(np.int32)       # row -> payload length
        self._tag = _I64()               # row -> stable tag (arena frames)
        self._heads_arena = _ByteLane()  # 32 B per head, concatenated
        self._heads_off = _I64()
        self._heads_n = _I64(np.int32)
        self._clock_actor = _I64(np.int32)   # interned actor index
        self._clock_seq = _I64()
        self._clock_off = _I64()
        self._clock_n = _I64(np.int32)
        self._max_op = _I64()
        self._n_changes = _I64(np.int32)
        self.actors = []                # interned actor hex strings
        self._actor_index = {}
        self._live = 0
        self._next_tag = 0
        self._dead_head_bytes = 0
        self._dead_clock_rows = 0
        # prefix short-circuit state: a SORTED uint64 array (lazily
        # built past PREFIX_MIN_ROWS, vectorized off the heads arena,
        # counted in resident_bytes) + a bounded overflow set for
        # prefixes added since the last fold
        self._head_prefixes = None
        self._prefix_overflow = set()
        _live_stores.add(self)          # memory-watermark tier (perf.py)

    def __len__(self):
        return self._live

    @property
    def n_rows(self):
        return self._seg.n

    @classmethod
    def open(cls, path, segment_bytes=None, check=False):
        """Recover a disk-backed store from its segment arena: manifest
        epoch + CRC frame scan select the live chunks (fleet/segment.py),
        then the causal lanes rebuild compute-on-compressed (DocChunkView
        header reads — op columns stay cold bytes on disk). Returns
        ``(store, tags)`` with ``tags[i]`` the stable tag of row ``i``.
        A chunk the view cannot decode (torn past its CRC — shouldn't
        happen — or a hostile writer) is dropped, not fatal."""
        kw = {} if segment_bytes is None else {'segment_bytes': segment_bytes}
        arena, records = SegmentArena.open(path, **kw)
        store = cls(path=path, _arena=arena)
        tags = []
        max_tag = -1
        for tag, (seg, off, ln) in records.items():
            try:
                view = arena.view(seg, off, ln)
                dcv = DocChunkView(view, check=check)
                store._install_row(seg, off, ln, tag, dcv.heads, dcv.clock,
                                   dcv.max_op, dcv.n_changes)
            except MalformedDocument:
                continue
            tags.append(tag)
            max_tag = max(max_tag, tag)
        store._next_tag = max_tag + 1
        _stats.inc('storage_recovered_docs', len(tags))
        return store, tags

    def reserve(self, n_docs, head_bytes=None, clock_rows=None):
        """Pre-size every lane for n_docs more rows (bulk ingest)."""
        for lane in (self._seg, self._off, self._len, self._tag,
                     self._heads_off, self._heads_n, self._clock_off,
                     self._clock_n, self._max_op, self._n_changes):
            lane.reserve(n_docs)
        self._heads_arena.reserve(head_bytes if head_bytes is not None
                                  else 32 * n_docs)
        rows = clock_rows if clock_rows is not None else n_docs
        self._clock_actor.reserve(rows)
        self._clock_seq.reserve(rows)

    def resident_bytes(self):
        """RAM-resident bytes of this store: the causal lanes plus any
        RAM-arena payload — what counts against the RSS ceiling. Disk-
        backed chunk bytes are NOT here (see ``disk_bytes``); they live
        on the page cache."""
        total = self._heads_arena.nbytes + self._arena.resident_bytes()
        for col in (self._seg, self._off, self._len, self._tag,
                    self._heads_off, self._heads_n, self._clock_actor,
                    self._clock_seq, self._clock_off, self._clock_n,
                    self._max_op, self._n_changes):
            total += col.nbytes
        if self._head_prefixes is not None:
            # the prefix index is resident too (~8 B/head + the
            # overflow set's object overhead)
            total += self._head_prefixes.nbytes + \
                64 * len(self._prefix_overflow)
        return total

    def disk_bytes(self):
        """On-disk segment bytes (0 for RAM-arena stores)."""
        return self._arena.disk_bytes()

    @property
    def garbage_bytes(self):
        """Arena bytes a vacuum would reclaim — the cost model's
        read-latency/recovery-debt input."""
        return self._arena.garbage_bytes

    @property
    def dead_lane_bytes(self):
        """RAM-RESIDENT bytes pinned by discarded rows (their heads in
        the arena, clock runs, and per-row lane slots) that only a
        vacuum reclaims — the resident side of the cost model's garbage
        input: without it a store of many small dead chunks could sit
        at dead_fraction ~1.0 leaking the causal index forever."""
        dead_rows = self.n_rows - self._live
        return (self._dead_head_bytes + 12 * self._dead_clock_rows +
                64 * dead_rows)

    def _intern_actor(self, hexa):
        idx = self._actor_index.get(hexa)
        if idx is None:
            idx = len(self.actors)
            self.actors.append(hexa)
            self._actor_index[hexa] = idx
        return idx

    def _install_row(self, seg, off, ln, tag, heads, clock, max_op,
                     n_changes):
        row = self._seg.n
        self._seg.append(seg)
        self._off.append(off)
        self._len.append(ln)
        self._tag.append(tag)
        self._heads_off.append(self._heads_arena.n)
        self._heads_n.append(len(heads))
        for h in sorted(heads):
            hb = bytes.fromhex(h)
            self._heads_arena.extend(hb)
            if self._head_prefixes is not None:
                self._prefix_overflow.add(
                    int.from_bytes(hb[:8], sys.byteorder))
        self._clock_off.append(self._clock_actor.n)
        self._clock_n.append(len(clock))
        for hexa in sorted(clock):
            self._clock_actor.append(self._intern_actor(hexa))
            self._clock_seq.append(int(clock[hexa]))
        self._max_op.append(int(max_op))
        self._n_changes.append(int(n_changes))
        self._live += 1
        return row

    def add(self, chunk, heads, clock, max_op, n_changes, tag=None):
        """Store one parked doc; returns its row id. `heads` are hex
        strings, `clock` {actor_hex: seq}. `tag` is the stable id the
        arena frames (and recovery) know the doc by — callers with their
        own id space (StorageEngine) pass theirs."""
        if tag is None:
            tag = self._next_tag
        self._next_tag = max(self._next_tag, tag + 1)
        seg, off, ln = self._arena.append(tag, chunk)
        return self._install_row(seg, off, ln, tag, heads, clock, max_op,
                                 n_changes)

    def add_chunk(self, chunk, check=True, tag=None):
        """Store a chunk deriving its causal row compute-on-compressed
        (DocChunkView: header heads + change-meta columns only). Raises
        MalformedDocument on undecodable bytes."""
        view = DocChunkView(chunk, check=check)
        return self.add(chunk, view.heads, view.clock, view.max_op,
                        view.n_changes, tag=tag)

    def add_many(self, chunks, rows, tags):
        """Bulk add with pre-computed causal rows: ONE batched arena
        write for the chunk bytes (SegmentArena.append_many), then the
        lane installs. Returns row ids aligned with the inputs."""
        if tags is None:
            tags = list(range(self._next_tag, self._next_tag + len(chunks)))
        addrs = self._arena.append_many(tags, chunks)
        out = []
        for (seg, off, ln), tag, (heads, clock, max_op, n_changes) in \
                zip(addrs, tags, rows):
            self._next_tag = max(self._next_tag, tag + 1)
            out.append(self._install_row(seg, off, ln, tag, heads, clock,
                                         max_op, n_changes))
        return out

    def _check(self, row):
        if not (0 <= row < self._seg.n) or self._seg.data[row] < 0:
            raise KeyError(f'no parked doc at row {row}')

    def tag(self, row):
        self._check(row)
        return int(self._tag.data[row])

    def chunk(self, row):
        """The parked chunk as a ZERO-COPY memoryview into the arena
        (an mmap'd segment for disk-backed stores: reading it is a page-
        cache access, holding it pins the mapping across vacuums)."""
        self._check(row)
        return self._arena.view(int(self._seg.data[row]),
                                int(self._off.data[row]),
                                int(self._len.data[row]))

    def heads(self, row):
        self._check(row)
        off = int(self._heads_off.data[row])
        n = int(self._heads_n.data[row])
        arena = self._heads_arena.data
        return [arena[off + 32 * i:off + 32 * (i + 1)].hex()
                for i in range(n)]

    def clock(self, row):
        self._check(row)
        off = int(self._clock_off.data[row])
        n = int(self._clock_n.data[row])
        return {self.actors[int(self._clock_actor.data[off + i])]:
                int(self._clock_seq.data[off + i]) for i in range(n)}

    def max_op(self, row):
        self._check(row)
        return int(self._max_op.data[row])

    def n_changes(self, row):
        self._check(row)
        return int(self._n_changes.data[row])

    def _build_prefixes(self):
        """Vectorized fold of the heads arena (EVERY head ever
        appended, dead rows' included — stale entries only cost a
        fall-through to the exact scan) into one sorted uint64 array:
        ~8 B/head of accountable numpy memory instead of a Python set,
        and a few hundred ms at 10M heads instead of a per-head loop."""
        n = (self._heads_arena.n // 32) * 32
        if n == 0:
            self._head_prefixes = np.zeros(0, dtype=np.uint64)
        else:
            raw = np.frombuffer(self._heads_arena.data, dtype=np.uint8,
                                count=n)
            self._head_prefixes = np.unique(
                raw.reshape(-1, 32)[:, :8].copy().view(np.uint64).ravel())
        self._prefix_overflow = set()

    def contains_head(self, row, hash_hex):
        """Sync-membership probe against the columnar heads arena —
        no chunk decode, no Python per-head strings on the hot path.
        Past PREFIX_MIN_ROWS rows, a store-wide 8-byte head-prefix
        index (sorted uint64 array + recent-adds overflow set)
        short-circuits misses in O(log heads) (discards leave stale
        prefixes behind — a false HIT only falls through to the exact
        row scan, never a wrong answer; vacuum rebuilds it clean)."""
        self._check(row)
        needle = bytes.fromhex(hash_hex)
        if self._seg.n > self.PREFIX_MIN_ROWS:
            if self._head_prefixes is None:
                self._build_prefixes()
            elif len(self._prefix_overflow) > 4096:
                self._build_prefixes()      # fold recent adds back in
            p = int.from_bytes(needle[:8], sys.byteorder)
            if p not in self._prefix_overflow:
                i = int(np.searchsorted(self._head_prefixes, p))
                if i >= len(self._head_prefixes) or \
                        int(self._head_prefixes[i]) != p:
                    return False
        off = int(self._heads_off.data[row])
        n = int(self._heads_n.data[row])
        arena = self._heads_arena.data
        return any(arena[off + 32 * i:off + 32 * (i + 1)] == needle
                   for i in range(n))

    def covers_heads(self, row, their_heads):
        """True when every hash in `their_heads` is one of row's heads —
        the parked-doc 'already in sync' fast path."""
        return all(self.contains_head(row, h) for h in their_heads)

    def discard(self, row):
        """Drop a row; returns its chunk (for disk arenas a still-valid
        view — the bytes stay in the segment until vacuum). Disk-backed
        stores record a tombstone frame; the StorageEngine flushes it at
        the end of the batched operation (process-kill safe), and
        ``sync()`` closes the OS-crash window."""
        self._check(row)
        off = int(self._off.data[row])
        ln = int(self._len.data[row])
        if isinstance(self._arena, RamArena):
            chunk = self._arena._items[off]
            self._arena.discard_slot(off)
        else:
            chunk = self._arena.view(int(self._seg.data[row]), off, ln)
        self._arena.tombstone(int(self._tag.data[row]), ln)
        self._seg.data[row] = -1
        self._dead_head_bytes += 32 * int(self._heads_n.data[row])
        self._dead_clock_rows += int(self._clock_n.data[row])
        self._live -= 1
        return chunk

    @property
    def dead_fraction(self):
        total = self._seg.n
        return (total - self._live) / total if total else 0.0

    @property
    def chunk_bytes(self):
        return self._arena.data_bytes

    def vacuum(self):
        """Compact: rewrite live chunks into a fresh arena epoch and
        rebuild the causal lanes, dropping discarded rows. For disk
        stores this is the segment rewrite + ATOMIC manifest swap —
        crash-safe at every byte, and views held across the swap stay
        valid (fleet/segment.py). Returns {old_row: new_row}."""
        writer = self._arena.rewrite_begin()
        fresh = MainStore(_arena=writer)
        fresh.path = self.path
        fresh.actors = self.actors
        fresh._actor_index = self._actor_index
        remap = {}
        for row in range(self._seg.n):
            if self._seg.data[row] < 0:
                continue
            remap[row] = fresh.add(
                self.chunk(row), self.heads(row), self.clock(row),
                self.max_op(row), self.n_changes(row), tag=self.tag(row))
        self._arena.rewrite_commit(writer)
        next_tag = max(self._next_tag, fresh._next_tag)
        for name in ('_seg', '_off', '_len', '_tag', '_heads_arena',
                     '_heads_off', '_heads_n', '_clock_actor', '_clock_seq',
                     '_clock_off', '_clock_n', '_max_op', '_n_changes',
                     '_live', '_dead_head_bytes', '_dead_clock_rows',
                     '_arena'):
            setattr(self, name, getattr(fresh, name))
        self._next_tag = next_tag
        self._head_prefixes = None      # rebuilt on demand, now clean
        self._prefix_overflow = set()
        _live_stores.discard(fresh)     # its lanes moved into self
        return remap

    def flush(self):
        self._arena.flush()

    def sync(self):
        self._arena.sync()

    def close(self):
        self._arena.close()
        _live_stores.discard(self)

    def memory_stats(self):
        """Byte accounting: chunk payload vs per-doc overhead. For disk
        stores `chunk_bytes`/`disk_bytes` are MAPPED, not resident — the
        acceptance signal is resident_per_doc: what RSS pays per parked
        doc (the causal index), with the chunk bytes a disk number."""
        lanes = (self._seg.nbytes + self._off.nbytes + self._len.nbytes +
                 self._tag.nbytes + self._heads_off.nbytes +
                 self._heads_n.nbytes + self._clock_off.nbytes +
                 self._clock_n.nbytes + self._max_op.nbytes +
                 self._n_changes.nbytes)
        arenas = (self._heads_arena.nbytes + self._clock_actor.nbytes +
                  self._clock_seq.nbytes)
        ram_arena = isinstance(self._arena, RamArena)
        # RAM arena: list slot (8 B pointer) + bytes-object header (~33 B)
        obj_overhead = (8 * self.n_rows + 33 * self._live) if ram_arena \
            else 0
        overhead = lanes + arenas + obj_overhead
        resident = overhead + self._arena.resident_bytes()
        return {
            'n_docs': self._live,
            'chunk_bytes': self._arena.data_bytes,
            'disk_bytes': self.disk_bytes(),
            'garbage_bytes': self._arena.garbage_bytes,
            'causal_arena_bytes': arenas,
            'lane_bytes': lanes,
            'overhead_bytes': overhead,
            'overhead_per_doc': overhead / self._live if self._live else 0.0,
            'resident_bytes': resident,
            'resident_per_doc': resident / self._live if self._live else 0.0,
            'total_bytes': self._arena.data_bytes + overhead,
            'dead_fraction': self.dead_fraction,
            'n_actors': len(self.actors),
        }


class StorageEngine:
    """Delta (live DocFleet) + main (MainStore) with park/revive policy
    and compute-on-compressed reads for the parked tier.

    Doc ids handed out by ``park``/``ingest_chunks`` are STABLE: an
    id→row indirection lets the engine vacuum the main store underneath
    its callers without invalidating anything a caller holds. Vacuum
    POLICY is pluggable: the default standalone trigger is the classic
    ``vacuum_dead_fraction`` byte threshold; pass ``cost_model`` (a
    fleet/tiering.py ``CostModel``) to replace it with the write-amp vs
    read-latency vs recovery-debt decision, or ``vacuum_dead_fraction=
    None`` to drive ``vacuum_now`` by hand / from a TieringController.

    ``path=`` puts the chunk arena on disk (mmap-backed, crash-safe —
    see MainStore); ``StorageEngine.open(path)`` recovers engine ids and
    causal lanes after a crash.

    ``device`` (the port's one difference from the reference) is the
    torch device of the delta DocFleet built here: CUDA unless the
    caller names another; ignored when ``fleet`` is given."""

    # don't churn tiny stores: below this row count a vacuum saves noise
    VACUUM_MIN_ROWS = 8

    def __init__(self, fleet=None, vacuum_dead_fraction=0.5, path=None,
                 segment_bytes=None, cost_model=None, device=None):
        from .backend import DocFleet
        self.fleet = fleet if fleet is not None else DocFleet(device=device)
        self.main = MainStore(path=path, segment_bytes=segment_bytes)
        self.vacuum_dead_fraction = vacuum_dead_fraction
        self.cost_model = cost_model
        # brownout pressure stage for the cost model's write-cost
        # multiplier — kept current by the TieringController's tick, so
        # discard-churn vacuums BETWEEN ticks defer under pressure too
        self.pressure_stage = 0
        self.vacuums = 0
        self._row_of = _IdMap()      # stable doc id -> main-store row
        self._next_id = 0

    @classmethod
    def open(cls, path, fleet=None, segment_bytes=None,
             vacuum_dead_fraction=0.5, cost_model=None, check=False,
             device=None):
        """Recover a disk-backed engine: the arena's live records become
        parked docs under their original stable ids (``device`` as in
        the constructor)."""
        eng = cls(fleet=fleet, vacuum_dead_fraction=vacuum_dead_fraction,
                  cost_model=cost_model, device=device)
        eng.main.close()
        eng.main, tags = MainStore.open(path, segment_bytes=segment_bytes,
                                        check=check)
        eng._row_of = _IdMap()
        eng._row_of.update((tag, row) for row, tag in enumerate(tags))
        eng._next_id = max(eng._row_of, default=-1) + 1
        return eng

    def adopt_main(self, other):
        """MOVE another engine's main store and its stable-id space here
        (e.g. rebinding parked docs to a durable fleet's engine): ids the
        other engine handed out stay valid on THIS engine, and the donor
        resets to empty. Ownership transfers whole — two engines sharing
        one store would race their id maps the first time either
        auto-vacuums (the vacuum rebinds the map it knows about and
        strands the other's rows) — and only into an EMPTY engine: the
        adopter's own id space would otherwise silently alias the
        donor's."""
        if self._row_of or self.main.n_rows:
            raise ValueError('adopt_main requires an empty adopter: this '
                             'engine already holds parked docs whose ids '
                             'would alias the adopted ones')
        self.main.close()
        self.main = other.main
        self._row_of = other._row_of.copy()
        self._next_id = other._next_id
        other.main = MainStore(path=None)
        other._row_of = _IdMap()
        other._next_id = 0

    def _claim_id(self, doc_id=None):
        if doc_id is None:
            doc_id = self._next_id
        self._next_id = max(self._next_id, doc_id + 1)
        return doc_id

    def _row(self, doc_id):
        row = self._row_of.get(doc_id)
        if row is None:
            raise KeyError(f'no parked doc {doc_id}')
        return row

    def _discard(self, doc_ids):
        for doc_id in doc_ids:
            self.main.discard(self._row_of.pop(doc_id))
        # tombstones leave the user-space buffer NOW: a process kill
        # after this batch cannot resurrect the discarded docs (the
        # OS-crash window stays open until sync(), like the journal's
        # group-commit loss window)
        self.main.flush()
        self._maybe_vacuum()

    def vacuum_now(self):
        """Compact the main store (segment rewrite + atomic swap for
        disk arenas), preserving every outstanding doc id."""
        with _span('storage_vacuum', docs=len(self.main)):
            remap = self.main.vacuum()
        rebound = _IdMap()
        rebound.update((doc_id, remap[row])
                       for doc_id, row in self._row_of.items())
        self._row_of = rebound
        self.vacuums += 1
        _stats.inc('storage_auto_vacuums')
        return True

    def _maybe_vacuum(self, stage=None):
        if self.main.n_rows < self.VACUUM_MIN_ROWS:
            return False
        model = self.cost_model
        if model is not None:
            if stage is None:
                stage = self.pressure_stage
            if not model.vacuum_due(self.main, stage=stage):
                return False
            return self.vacuum_now()
        threshold = self.vacuum_dead_fraction
        if threshold is None or self.main.dead_fraction < threshold:
            return False
        return self.vacuum_now()

    # -- demotion -------------------------------------------------------

    def park(self, handles, ids=None):
        """Demote fleet documents into the main store: canonical chunk
        (round-trip-validated — a doc whose history cannot reproduce
        from its chunk stays live), causal state into the columnar
        arrays, chunk bytes appended to the arena, device slots freed in
        one batched call. Returns a list aligned with `handles`: the
        doc's main-store id, or None where the doc was skipped (queued
        changes, non-fleet, failed validation). Skipped handles stay
        live and usable. `ids` (internal) parks each doc under a caller-
        chosen id — the repark path."""
        from . import backend as fleet_backend
        from .backend import FleetDoc, _validate_doc_chunks

        out = [None] * len(handles)
        to_free = []
        ready = []          # (input index, handle, state, chunk, n)
        pending = []        # (input index, handle, state, chunk) to batch
        with _span('storage_park', docs=len(handles)):
            for i, handle in enumerate(handles):
                state = handle.get('state')
                if handle.get('frozen') or not isinstance(state, FleetDoc) \
                        or not state.is_fleet:
                    continue
                impl = state._impl
                if impl.queue:
                    continue
                if impl._doc_pending is not None and not impl._changes:
                    # already parked in-fleet with no delta tail: the
                    # chunk is the validated canonical form
                    ready.append((i, handle, state, impl._doc_pending,
                                  impl._parked_n))
                else:
                    pending.append((i, handle, state, bytes(state.save())))
            # ONE batched validation (native pool fan-out) for every doc
            # that needs it
            counts = _validate_doc_chunks([c for _i, _h, _s, c in pending])
            for (i, handle, state, chunk), n in zip(pending, counts):
                if n is not None:
                    ready.append((i, handle, state, chunk, n))
            for i, handle, state, chunk, n in ready:
                doc_id = self._claim_id(None if ids is None else ids[i])
                self._row_of[doc_id] = self.main.add(
                    chunk, state.heads, state.clock, state.max_op, n,
                    tag=doc_id)
                out[i] = doc_id
                to_free.append(handle)
            # On a JOURNALED fleet, free_docs will emit FREE records the
            # journal fsyncs on its own cadence — the chunk bytes must
            # be AT LEAST as durable before that can happen, or an OS
            # crash between the two loses the doc from both tiers. So:
            # fsync when a journal is attached, flush (process-kill
            # safety) otherwise.
            if to_free and getattr(self.fleet, 'journal', None) is not None:
                self.main.sync()
            else:
                self.main.flush()
            if to_free:
                fleet_backend.free_docs(to_free)
        return out

    def ingest_chunks(self, chunks, check=True, rows=None):
        """Admit saved document chunks straight into the main store —
        no fleet slot, no engine, no decode of op columns: causal state
        comes from the chunk itself (DocChunkView), or from `rows`
        (pre-computed ``(heads, clock, max_op, n_changes)`` tuples — the
        bulk-ingest fast path when the caller already knows them).
        Returns main-store ids. Raises MalformedDocument for undecodable
        bytes (the batch up to that point is kept)."""
        if rows is not None and len(rows) != len(chunks):
            # a short rows list would append every chunk to the durable
            # arena but install only len(rows) — orphan records that
            # recovery would resurrect; fail loudly instead
            raise ValueError(f'rows ({len(rows)}) and chunks '
                             f'({len(chunks)}) must align')
        with _span('storage_ingest', docs=len(chunks)):
            err = None
            if rows is None:
                rows = []
                for c in chunks:
                    try:
                        v = DocChunkView(c, check=check)
                    except MalformedDocument as exc:
                        err = exc
                        break
                    rows.append((v.heads, v.clock, v.max_op, v.n_changes))
                chunks = chunks[:len(rows)]
            ids = [self._claim_id() for _ in chunks]
            row_ids = self.main.add_many(chunks, rows, tags=ids)
            self._row_of.update(zip(ids, row_ids))
            self.main.flush()       # process-kill safe once we return
            if err is not None:
                raise err
            return ids

    # -- promotion ------------------------------------------------------

    def revive(self, ids, durable=None):
        """Promote parked docs back into the live fleet through the bulk
        loader (one native parse straight off the arena's mapped views +
        batched dispatches; history stays lazily parked on the revived
        engines). `durable` is an optional DurableFleet manager —
        revived docs journal their chunk as a baseline through its
        load_docs. Returns backend handles in id order; the docs leave
        the main store (the vacuum policy may compact the arenas
        afterwards — ids held for OTHER docs stay valid)."""
        chunks = [self.main.chunk(self._row(i)) for i in ids]
        with _span('storage_revive', docs=len(ids)):
            if durable is not None:
                handles = durable.load_docs(chunks)
            else:
                from .loader import load_docs
                handles = load_docs(chunks, self.fleet)
            del chunks      # release the arena views before any vacuum
            self._discard(ids)
        return handles

    def discard(self, ids):
        """Drop parked docs outright (no revive); returns their chunks
        (copied — the rows are gone, so views would dangle across the
        next vacuum). Vacuum policy applies."""
        chunks = [bytes(self.main.chunk(self._row(i))) for i in ids]
        self._discard(ids)
        return chunks

    def repark(self, handles, ids):
        """Return just-revived docs to the store under their ORIGINAL
        ids — the abort path of a round that revived docs and then
        raised before serving them (mixed sync deadline/decode aborts):
        the caller's ids must stay valid because the caller never sees
        the handles. Freshly revived docs re-park through the
        already-parked fast path (chunk verbatim, no re-validation), and
        the arena frames carry the original ids (crash-consistent)."""
        self.park(handles, ids=ids)

    # -- compute-on-compressed reads -----------------------------------

    def chunk(self, doc_id):
        return self.main.chunk(self._row(doc_id))

    def heads(self, doc_id):
        return self.main.heads(self._row(doc_id))

    def clock(self, doc_id):
        return self.main.clock(self._row(doc_id))

    def max_op(self, doc_id):
        return self.main.max_op(self._row(doc_id))

    def n_changes(self, doc_id):
        return self.main.n_changes(self._row(doc_id))

    def contains_head(self, doc_id, hash_hex):
        return self.main.contains_head(self._row(doc_id), hash_hex)

    def covers_heads(self, doc_id, their_heads):
        return self.main.covers_heads(self._row(doc_id), their_heads)

    def needs_sync(self, doc_id, their_heads):
        """Parked-doc sync gate: False when the peer's heads equal ours
        (nothing to exchange — the doc can stay parked); True otherwise
        (revive before running a real sync round)."""
        ours = set(self.main.heads(self._row(doc_id)))
        return set(their_heads) != ours

    def close(self):
        self.main.close()

    def memory_stats(self):
        return self.main.memory_stats()
