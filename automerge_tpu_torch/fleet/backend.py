"""The device-routed backend: Automerge's Backend contract over the fleet.

This is the torch port of automerge_tpu/fleet/backend.py. The fleet's
grids are torch tensors on one device (`DocFleet(device=...)`, CUDA by
default). Every LWW merge dispatch is the hand-written CUDA merge kernel
(fleet/merge_kernel.py); with `exact_device=True` the fleet keeps the
multi-value register state instead, and every dispatch is the
hand-written CUDA register scan (fleet/register_kernel.py). Text and
list objects live in size-class pools of sequence rows
(fleet/sequence.py), and every sequence dispatch is the hand-written CUDA
RGA scan (fleet/seq_kernel.py), in both device modes. Saved documents
bulk-load through fleet/loader.py, and `park_docs` / `rebuild_docs`
keep the reference's parked form and rebuild. The module is a copy of
the reference with the device calls swapped. Durability journals
(fleet/durability.py) attach as in the reference, and `rebuild_docs`
moves a source journal across as the reference does. With a mesh
(`DocFleet(mesh=...)`, a fleet/sharding.py `FleetMesh` whose positions
share one device) the capacity is a multiple of the docs axis and every
grid and register dispatch is one kernel launch per docs block, over
that block's rows. A fleet spans one device: a mesh whose positions lie
on several devices, or in several processes, raises ValueError — across
cards run one process (and fleet) per card and sync the shards with
fleet/exchange.py `drive_pairwise_sync_multihost`.

The reference's description follows.

This is the `setDefaultBackend` drop-in (ref src/automerge.js:147-149,
test/wasm.js:24-25): documents created through this module keep their bulk
CRDT state — per-key LWW winners, values, counter accumulators — in the
shared device fleet (automerge_tpu_torch.fleet.tensor_doc.FleetState), where change
application is a batched scatter-max/scatter-add dispatch over every document
at once. The host keeps only what is inherently host work:

- the hash graph + causal gate (HashGraph — same machinery as the host OpSet,
  ref new.js:1550-1597),
- a per-document *mirror* of visible ops per key, from which exact reference
  patches (conflict sets, counter accumulation, ref new.js:884-1040) are
  produced without touching the device,
- wire encode/decode.

Map trees (nested maps/tables, keyed by two-level (objectId, key) interned
grid columns), sequence objects (Text/lists, as device RGA rows), and
objects nested inside sequences (rows-in-lists: the element value links to
the child object, which interns like any registered object) all stay
fleet-resident. Documents whose changes leave that subset (packed-counter
overflow on sequence paths, oversized actor populations) transparently
*promote*: their change log replays into the host OpSet engine and every
later call delegates to it, so the full reference semantics are always
available — the fleet path is an accelerator, never a semantic fork.
`link` ops reject loudly in the pre-scan (see PARITY.md).

Scale notes: one fleet packs up to 256 actors (tensor_doc.ACTOR_BITS); actor
numbers are kept in actor-hex sort order so the device's packed-opId
scatter-max resolves Lamport ties identically to the reference's
lamportCompare (frontend/apply_patch.js:33-42) — when a new actor lands
between existing ones, the fleet renumbers by remapping the low bits of the
winners tensor in one dispatch.
"""

import collections
import contextlib
import copy
import gc
import hashlib
import time
import weakref

import numpy as np
import torch

from .. import native
from ..native import (ACTOR_MASK, FLAG_ELEM_MAKE_TABLE, FLAG_ELEM_MAKE_TEXT,
                      FLAG_INC, FLAG_MAKE_TABLE, FLAG_MAKE_TEXT, FLAG_SET,
                      FLAG_SEQ_DEL, FLAG_SEQ_INC, FLAG_SEQ_INSERT,
                      FLAG_SEQ_SET)
from ..backend.hash_graph import HashGraph, decode_change_buffers
from ..errors import (AutomergeError, DanglingPred, DocError, DuplicateOpId,
                      InvalidChange, MalformedChange, as_wire_error)
from ..observability import (Counters, Metrics, register_health_source,
                             register_mem_source)
from ..observability import hist as _hist
from ..observability import recorder as _flight
from ..observability.spans import (span as _span, span_seq as _span_seq,
                                   spanned as _spanned)

# live fleets for the memory-watermark tier (see _fleet_bytes below,
# which must stay below this line since DocFleet.__init__ registers
# here); a WeakSet so an abandoned fleet leaves the gauge with the fleet
_live_fleets = weakref.WeakSet()
from ..backend.op_set import OpSet
from ..columnar import decode_change, OBJECT_TYPE
from .tensor_doc import (ACTOR_BITS, CTR_LIMIT, FleetState, MAX_ACTORS,
                         TOMBSTONE, pack_op_id, resolve_device)
from .ingest import KeyInterner


def _mesh_device(mesh, device):
    """The one device of a mesh fleet: every position of `mesh` must be
    this process's and lie on one device (`device`, where given)."""
    from .sharding import process_rank
    devs = set(mesh.devices.reshape(-1).tolist())
    ranks = set(int(r) for r in mesh.ranks.reshape(-1))
    if len(devs) != 1 or ranks != {process_rank(mesh.group)}:
        raise ValueError(
            f'DocFleet keeps its grids on one device, but this mesh\'s '
            f'positions span devices {sorted(map(str, devs))} in ranks '
            f'{sorted(ranks)}: run one process (and fleet) per card and '
            f'sync the shards with fleet.exchange.'
            f'drive_pairwise_sync_multihost')
    (dev,) = devs
    if device is not None and torch.device(device) != dev:
        raise ValueError(f'DocFleet: device {device} is not the mesh\'s '
                         f'device {dev}')
    return dev


_FLAT_ACTIONS = ('set', 'del', 'inc')
_SEQ_MAKE = ('makeText', 'makeList')

# Turbo commits park their log appends as lazily-folded _SeamSegs; past
# this many outstanding records the fleet folds everything (bounds the
# rowmap overhead on write-only workloads that never read history).
_SEAM_FOLD_LIMIT = 64



def _code_points(vals):
    """''.join(chr(v) for v in vals) for an int array of code points,
    decoded in one call (a whole text row at once)."""
    try:
        return np.asarray(vals, dtype='<u4').tobytes().decode('utf-32-le')
    except UnicodeDecodeError:
        return ''.join(chr(int(v)) for v in vals)


class _Unsupported(Exception):
    """An op outside the fleet-resident subset: promote to the host engine."""


class _SeqLink:
    """Value-table entry marking a root-map key whose value is a sequence
    object (Text/list) living in the fleet's SeqState rows. Bulk reads
    resolve it to the rendered sequence; the host mirror remains the exact
    source for patches."""

    __slots__ = ('object_id',)

    def __init__(self, object_id):
        self.object_id = object_id

    def __repr__(self):
        return f'_SeqLink({self.object_id})'

    def __eq__(self, other):
        return isinstance(other, _SeqLink) and \
            other.object_id == self.object_id

    def __hash__(self):
        return hash(('_SeqLink', self.object_id))


_MAP_MAKE = ('makeMap', 'makeTable')

# Deferred host-winner-mirror backlog cap (rows) before a forced fold; see
# DocFleet._pending_winner_rows
_WINNER_FOLD_LIMIT = 1 << 20


class _ValueTable(list):
    """Boxed-value store with dedup interning: the table grows with the
    number of DISTINCT values, not with op count (repeated strings across a
    long change log were an unbounded leak). Unhashable payloads append
    without dedup."""

    def __init__(self):
        super().__init__()
        self.index = {}

    def intern(self, value):
        # Key by (type, value): Python equality conflates True/1/1.0 etc.,
        # and a boxed 1.0 must not read back as an earlier doc's True
        key = (type(value), value)
        try:
            idx = self.index.get(key)
            hashable = True
        except TypeError:
            idx = None
            hashable = False
        if idx is not None:
            return idx
        idx = len(self)
        self.append(value)
        if hashable:
            self.index[key] = idx
        return idx


class _MapLink:
    """Value-table entry marking a key whose value is a nested map/table
    object. The nested object's own keys live in the same [docs, keys] grid
    under composite (objectId, key) interned columns (the two-level
    interning of the reference's objectMeta ancestry, ref new.js:1461-1528),
    so map trees stay fleet-resident."""

    __slots__ = ('object_id', 'kind')

    def __init__(self, object_id, kind='map'):
        self.object_id = object_id
        self.kind = kind

    def __repr__(self):
        return f'_MapLink({self.object_id}, {self.kind})'

    def __eq__(self, other):
        return isinstance(other, _MapLink) and \
            other.object_id == self.object_id and other.kind == self.kind

    def __hash__(self):
        return hash(('_MapLink', self.object_id, self.kind))


def _leaf_value(leaf):
    """Render a whole-doc patch leaf to a plain Python value: value leaves
    unwrap; list/text object patches replay their edits (whole-doc patches
    contain only insert/multi-insert/update/remove shapes); map patches
    resolve per-key Lamport winners."""
    if not isinstance(leaf, dict):
        return leaf
    if leaf.get('type') == 'value':
        return leaf.get('value')
    if 'objectId' not in leaf:
        return leaf
    if leaf.get('type') in ('list', 'text'):
        out = []
        for edit in leaf.get('edits', []):
            action = edit['action']
            if action == 'insert':
                out.insert(edit['index'], _leaf_value(edit['value']))
            elif action == 'multi-insert':
                out[edit['index']:edit['index']] = list(edit['values'])
            elif action == 'update':
                out[edit['index']] = _leaf_value(edit['value'])
            elif action == 'remove':
                del out[edit['index']:edit['index'] + edit.get('count', 1)]
        if leaf['type'] == 'text':
            return ''.join(str(v) for v in out)
        return out
    from ..common import lamport_key
    doc = {}
    for key, candidates in leaf.get('props', {}).items():
        if candidates:
            winner = max(candidates.keys(), key=lamport_key)
            doc[key] = _leaf_value(candidates[winner])
    return doc


class _SortedActorTable:
    """Actor interning that keeps numbers equal to the actor-hex sort rank,
    so packed opIds order exactly like the reference's Lamport comparison.
    Inserting an actor that sorts before existing ones renumbers; the caller
    applies the returned permutation to any device state."""

    def __init__(self):
        self.actors = []          # sorted actor hex strings
        self.index = {}           # actor -> current number

    def __len__(self):
        return len(self.actors)

    def intern(self, actor):
        num = self.index.get(actor)
        if num is None:
            raise KeyError(f'actor {actor} not pre-registered with the fleet')
        return num

    def insert_many(self, new_actors):
        """Insert actors; returns an old->new permutation array if existing
        numbers changed, else None."""
        fresh = sorted(set(a for a in new_actors if a not in self.index))
        if not fresh:
            return None
        if len(self.actors) + len(fresh) > MAX_ACTORS:
            raise ValueError(
                f'fleet actor table overflow (> {MAX_ACTORS} actors); '
                f'use separate fleets or the host backend')
        old_order = list(self.actors)
        self.actors = sorted(self.actors + fresh)
        self.index = {a: i for i, a in enumerate(self.actors)}
        if not old_order:
            return None
        perm = np.array([self.index[a] for a in old_order], dtype=np.int32)
        if np.array_equal(perm, np.arange(len(old_order), dtype=np.int32)):
            return None
        return perm


def _pow2(n):
    cap = 1
    while cap < n:
        cap *= 2
    return cap


class _SeqRuns:
    """A batch of sequence ops laid out by device row, the input of
    DocFleet._dispatch_seq: row `rows[i]` takes the `lens[i]` ops from
    `starts[i]` on, in apply order, and no row has two runs. One entry an
    op in `kind`, `ref`, `packed`, `value`, `flag` (bool) and in each of
    the SEQ_PRED_LANES columns of `preds` (None for a lane no op fills).
    Input whose runs repeat a row (two objects of one doc interleaved, an
    op list in another order) takes a stable sort of its runs into that
    shape; `sorted` says it did."""

    __slots__ = ('rows', 'lens', 'starts', 'kind', 'ref', 'packed', 'value',
                 'preds', 'flag', 'sorted')

    def __init__(self, rows, lens, kind, ref, packed, value, preds, flag):
        self.rows, self.lens = rows, lens
        self.starts = np.cumsum(lens) - lens
        self.kind, self.ref, self.packed, self.value = kind, ref, packed, value
        self.preds, self.flag = tuple(preds), flag
        self.sorted = len(rows) > 1 and int(np.bincount(rows).max()) > 1
        if self.sorted:
            self._sort()

    @classmethod
    def from_tuples(cls, seq_ops):
        """(row, kind, ref, packed, value, pred0..D-1, flag) op tuples."""
        from .sequence import SEQ_PRED_LANES as D
        arr = np.asarray(seq_ops, dtype=np.int64).reshape(-1, 6 + D)
        row = arr[:, 0]
        starts = np.flatnonzero(np.diff(row, prepend=row[:1] - 1))
        return cls(row[starts], np.diff(np.r_[starts, len(row)]),
                   arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4],
                   [arr[:, 5 + d] for d in range(D)], arr[:, 5 + D] != 0)

    def __len__(self):
        return len(self.kind)

    def _sort(self):
        # a stable sort of the runs by row keeps each row's ops in apply
        # order, as a stable sort of the ops by row would
        order = np.argsort(self.rows, kind='stable')
        rows, lens = self.rows[order], self.lens[order]
        src = np.repeat(self.starts[order] - (np.cumsum(lens) - lens),
                        lens) + np.arange(len(self))
        first = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
        self.rows, self.lens = rows[first], np.add.reduceat(lens, first)
        self.starts = np.cumsum(self.lens) - self.lens
        self.kind, self.ref, self.packed, self.value, self.flag = (
            c[src] for c in (self.kind, self.ref, self.packed, self.value,
                             self.flag))
        self.preds = tuple(None if p is None else p[src] for p in self.preds)


def _pack_seq_class(ops, r_cap, idx_r, sel):
    """The [r_cap, width] SeqOpBatch of one size class from a _SeqRuns:
    the runs that `sel` picks (all when None) at their rows' pool indices
    `idx_r`. Each op's place, pool index * width + its place in its run,
    is computed once; every column is written into its zeroed array by one
    1-D scatter, cast to the batch's dtype as it goes."""
    from .sequence import SeqOpBatch, SEQ_PRED_LANES as D
    lens, starts, idx = (ops.lens, ops.starts, idx_r) if sel is None else \
        (ops.lens[sel], ops.starts[sel], idx_r[sel])
    width = max(int(lens.max()), 1)
    first = np.cumsum(lens) - lens     # each run's first op in this batch
    at = np.arange(int(lens.sum()))
    dest = np.repeat(idx * width - first, lens) + at
    src = None if sel is None else np.repeat(starts - first, lens) + at

    def scatter(col, out):
        flat = out.reshape(-1)
        flat[dest] = col if src is None else col[src]
        return out

    preds = np.zeros((r_cap, width, D), dtype=np.int32)
    lanes = preds.reshape(r_cap * width, D)
    for d, col in enumerate(ops.preds):
        if col is not None:
            scatter(col, lanes[:, d])
    return SeqOpBatch(
        *(scatter(col, np.zeros((r_cap, width), dtype=np.int32))
          for col in (ops.kind, ops.ref, ops.packed, ops.value)),
        preds, scatter(ops.flag, np.zeros((r_cap, width), dtype=bool)))


class DocFleet:
    """The shared device state for a fleet of flat documents.

    Capacity (doc slots, key-grid width) grows in powers of two so XLA
    recompiles O(log n) times as the fleet grows. Change buffers enqueue per
    slot and land on the device in one batched ingest + one merge dispatch
    per flush (lazy: reads flush first)."""

    def __init__(self, doc_capacity=64, key_capacity=64,
                 exact_device=False, actor_slot_capacity=8, d_preds=4,
                 mesh=None, device=None):
        # Optional fleet/sharding.py FleetMesh with a 'docs' axis, its
        # positions on one device: the capacity is a docs-axis multiple
        # and every grid/register dispatch is one launch per docs block
        # (the reference's SPMD dispatch over the docs axis). Sequence
        # pools stay unsplit: the RGA pointer walk is a per-document
        # scan and their row axis is not slot-aligned. mesh=None
        # (default) is one launch per dispatch.
        self.mesh = mesh
        # The torch device every grid lives on (CUDA unless asked; a
        # mesh's own device with a mesh)
        self.device = resolve_device(device) if mesh is None else \
            _mesh_device(mesh, device)
        self.keys = KeyInterner()
        self.actors = _SortedActorTable()
        self.value_table = _ValueTable()   # non-inline values, -(i + 2) refs
        # Packed-opId counter rebasing (round-2 VERDICT item 9): the int32
        # packing holds counters < 2^23, but a slot's counters may grow
        # without bound. ctr_base[slot] is subtracted before packing; when
        # a slot's window fills, _rebase_slot shifts its live winners down
        # in one device op. Slots whose LIVE counter spread exceeds the
        # window (or that receive sub-window stragglers after a rebase)
        # land in grid_overflow: their grid rows stop being authoritative
        # and bulk reads fall back to the host mirror.
        self.ctr_base = {}        # slot -> int counter base (default 0)
        self.grid_overflow = set()
        self.state = None         # FleetState, allocated on first flush
        # Host mirror of the grid's scatter-max winners (LWW mode only,
        # same packing basis per path). The device counter cell cannot
        # attribute an inc to its pred (apply.py's documented corner: an
        # inc whose pred lost the key is credited to the winner), so every
        # flush checks each inc's pred against the post-batch winner here
        # and flags mismatching slots into grid_overflow — reads for those
        # slots fall back to the exact host mirror instead of serving the
        # over-counted cell. Exact-device mode needs none of this (the
        # register engine applies pred kills exactly).
        self.host_winners = None  # np.int32 [doc_cap, key_cap + 1]
        # Slots whose history contains any delete: bulk reads route to
        # the exact host mirror. The single-winner grid cannot resurrect
        # a concurrent LOSER it never stored, and per-cell visible-op
        # accounting is unsound under shared preds (two concurrent ops
        # may pred the same target) and same-batch supersession chains —
        # so ANY kill lane flags its slot here, bluntly and soundly.
        # Unlike grid_overflow this does NOT block the turbo apply path:
        # packing stays trustworthy, only reads fall back.
        self.del_fallback = set()
        # Per-slot index of every map-key op row ever applied, as sorted
        # int64 combos (key_id << 32) | packed — the turbo path's
        # dangling-pred oracle (ref op_set.py: a pred must name a non-del
        # row on its key; ref new.js rejects invalid op references during
        # the merge). Fed by every ingest path; slots whose ops landed
        # without indexing (bulk document loads) are marked incomplete
        # and skip validation rather than risk a false reject — their
        # dangling preds surface at the next mirror rebuild as before.
        # ~8 bytes/op of host memory, vs the ~60+ bytes/op change log.
        self._op_index = {}            # slot -> sorted np.int64 combos
        self._op_index_pending = []    # [(slots, combos)] flat batches
        self._op_index_incomplete = set()
        # Set rows fold into host_winners lazily: inc-free batches (the
        # common case) just append their arrays here, and the scatter-max
        # replays only when an inc needs checking, a maintenance op
        # (rebase/remap/clone/free/load) touches the mirror, or the
        # backlog passes _WINNER_FOLD_LIMIT rows
        # [(kill_doc, kill_key, kill_packed, set_doc, set_key,
        #   set_packed) array 6-tuples], one entry per dispatched batch
        self._pending_winner_rows = []
        self._pending_winner_count = 0
        # exact_device=True stores the device state in the multi-value
        # register engine (fleet/registers.py) instead of the LWW
        # scatter-max grid: conflict sets, set-vs-delete resurrection, and
        # counter semantics become exact on device, at ordered-scan cost
        self.exact_device = exact_device
        self.reg_state = None     # RegisterState, allocated on first flush
        self.actor_slot_cap = actor_slot_capacity
        self.d_preds = d_preds
        self.doc_cap = doc_capacity
        self.key_cap = key_capacity
        self.n_slots = 0
        self.free_slots = []
        # bumped by every free_slots_batch: slot-indexed caches outside
        # the fleet (the subscription hub's frontier-scan plan) key on it
        # so a freed/recycled slot can never serve a stale row
        self.free_epoch = 0
        self.pending = []         # (slot, [change buffers])
        self.pending_actors = set()
        # Struct-of-arrays doc state (heads/clock/max_op/stale/...): the
        # turbo commit scatters whole batches into these columns; the
        # engines' attributes are property views onto their slot row.
        self.doc_cols = _DocCols(doc_capacity)
        # slot -> live engine — lets the seam-cap fold reach pending
        # docs without a handle. A PLAIN dict (a WeakValueDictionary
        # measured 40x slower per store, ~40 ms per 10k-doc init):
        # entries are popped by every slot-free path (free_docs /
        # free_slot / promote), so an engine outlives its handles only
        # until its slot is freed or reused — and an abandoned FLEET
        # takes the whole registry down with it.
        self._engines = {}
        # Lazily-folded turbo-commit log segments (see _SeamSegs) and
        # the clock-actor registry backing the _DocCols clock lanes
        self._pend_seams = []
        self._ck_reg = {}         # actor hex -> clock-actor id
        self._ck_names = []       # clock-actor id -> actor hex
        # False until any inc lane (or bulk-loaded counter cell) lands:
        # while False, set-only batches take the specialized no-inc
        # merge kernel (apply.py) that skips the counter grid passes
        self._counters_touched = False
        self.metrics = Metrics()  # per-dispatch counters (observability.py)
        _live_fleets.add(self)    # memory-watermark tier (perf.py)
        # Sequence-object fleet: one device row per (doc slot, objectId).
        # Text/list CRDT state lives in pow2 size-class pools of SeqStates
        # (fleet/sequence.py SeqPools) so memory follows each document's
        # own length — one long document no longer pads the whole fleet.
        from .sequence import SeqPools
        self.seq_elem_cap = 64    # base (smallest) class capacity
        self.seq_pools = SeqPools(self.seq_elem_cap, device=self.device)
        self.seq_rows = []        # row -> {'slot','object_id','type'} | None
        self.seq_place = []       # row -> (cls, idx) | None (unwritten)
        self.seq_len = []         # row -> host upper bound on elements
        self.seq_free = []
        self.slot_seq = {}        # slot -> {objectId: row}
        # Optional durability hook (fleet/durability.py ChangeJournal):
        # when attached, the mutation seams — FleetDoc.apply_changes, the
        # turbo batch commit, free/clone — journal accepted change bytes
        # through it, so sync rounds and batched applies are crash-durable
        # without callers doing anything per call.
        self.journal = None
        # Device-resident frontier index (fleet/hashindex.py): exact
        # (slot, change-hash) membership for the sync plane. Created
        # lazily by the first batched sync round (frontier_index());
        # while None the commit seams pay a single attribute check.
        self._hash_index = None

    def frontier_index(self, create=True, **kwargs):
        """The fleet's FleetFrontierIndex (fleet/hashindex.py), created
        on first use. The commit seams stage every accepted change hash
        into it host-side once it exists; sync rounds flush + probe in
        one dispatch each."""
        if self._hash_index is None and create:
            from .hashindex import FleetFrontierIndex
            self._hash_index = FleetFrontierIndex(self, **kwargs)
        return self._hash_index

    def _cap_docs(self, n_docs):
        """Doc-capacity sizing shared by the grid and register allocators:
        pow2 growth, raised to a multiple of the mesh docs axis so every
        docs block has the same rows (a bare pow2 fails on e.g. a
        6-position axis). An already-sufficient mesh-aligned capacity is
        returned unchanged: on a non-pow2 mesh the stored doc_cap is
        itself non-pow2 (e.g. 66 on a 6-position axis), and re-deriving
        pow2 from it (128 -> 132) would regrow state ~2x on every call. A
        constructor doc_capacity that is NOT yet a mesh multiple still
        rounds up."""
        m = self.mesh.shape.get('docs', 1) if self.mesh is not None else 1
        if n_docs <= self.doc_cap and self.doc_cap % m == 0:
            return self.doc_cap
        need = max(_pow2(max(n_docs, 1)), self.doc_cap)
        return ((need + m - 1) // m) * m

    def _split(self, n_rows):
        """The `blocks` keyword of a dispatch over an n_rows state: on a
        mesh fleet the [lo, hi) rows of each position of the docs axis,
        one kernel launch each; none (one launch) without a split."""
        m = self.mesh.shape.get('docs', 1) if self.mesh is not None else 1
        if m == 1:
            return {}
        step = -(-n_rows // m)
        return {'blocks': tuple((lo, min(lo + step, n_rows))
                                for lo in range(0, n_rows, step))}

    @property
    def dispatches(self):
        return self.metrics.dispatches

    def attach_journal(self, journal):
        """Attach (or detach, with None) a durability journal; the
        mutation-seam hooks consult it on every accepted batch."""
        self.journal = journal

    def memory_stats(self):
        """Device-state byte accounting per component: the LWW grid or
        register state, and each sequence size-class pool (observability
        for capacity planning; host-side shapes only, no transfers)."""
        out = {'total': 0}
        if self.state is not None:
            out['lww_grid'] = self.state.nbytes()
        if self.host_winners is not None:
            # host-RAM mirror for counter-attribution checks (not device)
            out['host_winner_mirror'] = int(self.host_winners.nbytes)
        if self._op_index or self._op_index_pending:
            # host-RAM dangling-pred oracle: 8 bytes per applied op row
            out['op_index'] = int(
                sum(a.nbytes for a in self._op_index.values()) +
                sum(p[1].nbytes for p in self._op_index_pending))
        if self.reg_state is not None:
            out['registers'] = self.reg_state.nbytes()
        pools = {}
        for cls, st in sorted(self.seq_pools.pools.items()):
            pools[cls] = {'capacity': st.capacity,
                          'rows': int(st.elem_id.shape[0]),
                          'actor_lanes': int(st.actor_slots),
                          'bytes': st.nbytes()}
        if pools:
            out['seq_pools'] = pools
        if self.journal is not None:
            # durability accounting: what is buffered in RAM awaiting the
            # next group commit, and what the OS holds but has not yet
            # fsynced (the crash-loss window)
            out['journal'] = self.journal.stats()
        out['total'] = out.get('lww_grid', 0) + out.get('registers', 0) + \
            sum(p['bytes'] for p in pools.values())
        out['value_table_entries'] = len(self.value_table)
        return out

    # -- slot management ------------------------------------------------

    def alloc_slot(self):
        if self.free_slots:
            slot = self.free_slots.pop()
        else:
            slot = self.n_slots
            self.n_slots += 1
        self.doc_cols.ensure(self.n_slots)
        self.doc_cols.reset_rows([slot])
        return slot

    def alloc_slots(self, n):
        """Allocate n slots in one call (recycled slots first, in the same
        LIFO order alloc_slot would hand them out, then fresh ones) —
        init_docs' O(1) bookkeeping instead of n alloc_slot calls."""
        if n <= 0:
            return []
        out = []
        if self.free_slots:
            k = min(len(self.free_slots), n)
            out = self.free_slots[-k:][::-1]
            del self.free_slots[-k:]
        rest = n - len(out)
        if rest:
            base = self.n_slots
            out.extend(range(base, base + rest))
            self.n_slots = base + rest
        self.doc_cols.ensure(self.n_slots)
        self.doc_cols.reset_rows(out)
        return out

    def free_slot(self, slot):
        self.free_slots_batch([slot])

    def free_slots_batch(self, slots):
        """Release a batch of slots: all host-side bookkeeping in one pass
        and the device rows zeroed in ONE dispatch per engine kind
        (`_zero_rows`) — freeing n docs used to rewrite the whole grid n
        times over (the per-doc `.at[slot].set(0)` chain)."""
        if not slots:
            return
        if self.pending:
            gone = set(slots)
            self.pending = [(s, b) for (s, b) in self.pending
                            if s not in gone]
        if self._pend_seams:
            # un-folded turbo appends die with the doc: a recycled slot
            # must never fold a previous tenant's segments
            for seg in self._pend_seams:
                for slot in slots:
                    seg.rowmap.pop(slot, None)
            self._pend_seams = [s for s in self._pend_seams if s.rowmap]
        self._index_consolidate()
        if self._hash_index is not None:
            # release the slots' membership spaces (and purge staged
            # rows) so a recycled slot never inherits its previous
            # tenant's change hashes
            self._hash_index.drop_slots(slots)
        seq_zero = []
        for slot in slots:
            eng = self._engines.pop(slot, None)
            if eng is not None:
                # sever the dead engine from the shared columns: every
                # freeing path nulls its handle's _impl, so nothing
                # legitimate touches it again — but a leaked raw
                # reference must fail LOUDLY (a non-integer slot makes
                # every column index raise) rather than alias the
                # slot's next tenant. slot=None would be WORSE than
                # stale: numpy None-indexing broadcasts, so a setter
                # would overwrite whole columns.
                eng.slot = 'freed'
        for slot in slots:
            self.ctr_base.pop(slot, None)
            self.grid_overflow.discard(slot)
            self.del_fallback.discard(slot)
            self._op_index.pop(slot, None)
            self._op_index_incomplete.discard(slot)
            rows = self.slot_seq.pop(slot, {})
            if rows:
                seq_zero.extend(rows.values())
                for row in rows.values():
                    self.seq_rows[row] = None
                    self.seq_free.append(row)
        self._zero_rows(slots)
        if seq_zero:
            self._zero_seq_rows(seq_zero)
        self.free_slots.extend(slots)
        self.free_epoch += 1

    def _fold_all_pending(self):
        """Fold every doc's pending turbo-commit segments into the real
        logs — the amortized eager path bounding seam-record memory on
        write-heavy workloads that never read history (the hot path
        stays O(1); this runs once per _SEAM_FOLD_LIMIT commits)."""
        for seg in list(self._pend_seams):
            for slot in list(seg.rowmap):
                eng = self._engines.get(slot)
                if eng is None:
                    seg.rowmap.pop(slot, None)
                else:
                    eng._fold_pending()
        self._pend_seams = [s for s in self._pend_seams if s.rowmap]

    def clone_slot(self, src):
        self.flush()
        dst = self.alloc_slot()
        # Counter-window state travels with the row copy: without it a
        # clone of a rebased/overflowed slot would read its grid row with
        # the wrong base (or as authoritative when it is not)
        if src in self.ctr_base:
            self.ctr_base[dst] = self.ctr_base[src]
        if src in self.grid_overflow:
            self.grid_overflow.add(dst)
        if src in self.del_fallback:
            self.del_fallback.add(dst)
        if src in self._op_index_incomplete:
            self._op_index_incomplete.add(dst)
        self._index_consolidate()
        src_idx = self._op_index.get(src)
        if src_idx is not None:
            self._op_index[dst] = src_idx.copy()
        copies = {}    # cls -> ([src idx], [dst idx])
        lanes = self._seq_lane_width()
        for oid, row in list(self.slot_seq.get(src, {}).items()):
            info = self.seq_rows[row]
            dst_row = self._alloc_seq_row(dst, oid, info['type'])
            place = self.seq_place[row]
            if place is not None:
                idx = self.seq_pools.alloc(place[0], lanes)
                self.seq_place[dst_row] = (place[0], idx)
                self.seq_len[dst_row] = self.seq_len[row]
                srcs, dsts = copies.setdefault(place[0], ([], []))
                srcs.append(place[1])
                dsts.append(idx)
        for cls, (srcs, dsts) in copies.items():
            self.seq_pools.copy_rows(cls, srcs, cls, dsts)
        if self.state is not None and src < self.state.winners.shape[0]:
            self._ensure_capacity(n_docs=dst + 1, n_keys=len(self.keys))
            for t in self.state.tensors():
                t[dst] = t[src]
            if self.host_winners is not None:
                self._fold_pending_winners()
                self.host_winners[dst] = self.host_winners[src]
        if self.reg_state is not None and src < self.reg_state.reg.shape[0]:
            self._ensure_reg_capacity(n_docs=dst + 1, n_keys=len(self.keys))
            for t in self.reg_state.tensors():
                t[dst] = t[src]
        return dst

    def _zero_rows(self, slots):
        """Zero a batch of slots' grid rows in ONE in-place row fill per
        grid, counted as one dispatch in metrics.dispatches."""
        arr = np.asarray(list(slots), dtype=np.int64)
        if not len(arr):
            return
        if self.state is not None:
            sel = arr[arr < self.state.winners.shape[0]]
            if len(sel):
                from .apply import zero_doc_rows_donated
                zero_doc_rows_donated(self.state, torch.from_numpy(sel))
                self.metrics.dispatches += 1
                if self.host_winners is not None:
                    self._fold_pending_winners()
                    self.host_winners[sel] = 0
        if self.reg_state is not None:
            sel = arr[arr < self.reg_state.reg.shape[0]]
            if len(sel):
                from .registers import zero_register_rows_donated
                zero_register_rows_donated(self.reg_state,
                                           torch.from_numpy(sel))
                self.metrics.dispatches += 1

    # -- sequence rows ---------------------------------------------------

    def _alloc_seq_row(self, slot, object_id, type_):
        info = {'slot': slot, 'object_id': object_id, 'type': type_}
        if self.seq_free:
            row = self.seq_free.pop()
            self.seq_rows[row] = info
            self.seq_place[row] = None
            self.seq_len[row] = 0
        else:
            row = len(self.seq_rows)
            self.seq_rows.append(info)
            self.seq_place.append(None)
            self.seq_len.append(0)
        self.slot_seq.setdefault(slot, {})[object_id] = row
        return row

    def _seq_lane_width(self):
        return _pow2(max(len(self.actors), 4))

    def _seq_need(self, row, need_len):
        """The size class for placing `row` at need_len elements — the ONE
        sizing policy driving both the reserve() pre-pass and
        _place_seq_row, so they cannot drift (_place_seq_runs' vectorised
        check applies the same rule through SeqPools.cls_for_many)."""
        return self.seq_pools.cls_for(max(self.seq_len[row], need_len, 1))

    def _place_seq_row(self, row, need_len):
        """Ensure row has a device placement with capacity >= need_len,
        migrating up a size class when it outgrows its current one.
        Returns (cls, idx)."""
        need_cls = self._seq_need(row, need_len)
        self.seq_len[row] = max(self.seq_len[row], need_len, 1)
        pools = self.seq_pools
        place = self.seq_place[row]
        lanes = self._seq_lane_width()
        if place is None:
            idx = pools.alloc(need_cls, lanes)
            place = (need_cls, idx)
        elif need_cls > place[0]:
            idx = pools.migrate(place[0], place[1], need_cls, lanes)
            place = (need_cls, idx)
            self.metrics.seq_migrations += 1
        self.seq_place[row] = place
        return place

    def seq_row_inexact(self, row):
        """Host read of one device row's inexact flag (False when the row
        was never written)."""
        place = self.seq_place[row] if row < len(self.seq_place) else None
        if place is None:
            return False
        st = self.seq_pools.state(place[0])
        return bool(st.inexact[place[1]])

    def _zero_seq_rows(self, rows):
        by_cls = {}
        for row in rows:
            place = self.seq_place[row] if row < len(self.seq_place) \
                else None
            if place is not None:
                by_cls.setdefault(place[0], []).append(place[1])
                self.seq_place[row] = None
            if row < len(self.seq_len):
                self.seq_len[row] = 0
        if by_cls:
            self.seq_pools.release_rows(by_cls)

    @_spanned('actor_remap')
    def _remap_seq_actors(self, perm):
        """Renumber the actor bits of packed elemIds/register opIds in every
        sequence pool after a sorted-order actor insertion, permuting the
        actor-lane axis the same way (lanes are indexed by actor number,
        like _remap_reg_actors; machinery shared via _lane_permutation)."""
        if not self.seq_pools.pools:
            return
        from .sequence import SeqState
        # Grow every pool's lane axis FIRST (same rationale as
        # _remap_reg_actors)
        self.seq_pools.ensure_lanes(self._seq_lane_width())
        self.metrics.remaps += 1
        for cls, st in list(self.seq_pools.pools.items()):
            move, renum = self._lane_permutation(perm, st.reg.shape[2])
            self.seq_pools.pools[cls] = SeqState(
                renum(st.elem_id), st.nxt,
                renum(move(st.reg, 0)), move(st.killed, False),
                move(st.val, 0), move(st.counter, 0), st.n, st.inexact)

    def _intern_value(self, value):
        """Inline int32 in [0, 2^31) or a value-table ref -(i + 2)."""
        if isinstance(value, int) and not isinstance(value, bool) and \
                0 <= value < (1 << 31):
            return value
        return self._intern_value_boxed(value)

    def _intern_seq_value(self, type_, op):
        """Sequence-element payload: text rows store single-char codepoints
        inline (table refs are negative, so the two never collide); list
        rows store plain non-negative int32s inline; everything else goes
        through the value table. uint/counter/timestamp/float64 payloads
        box with their datatype (TypedValue) so device-served patches keep
        exact datatype leaves — the same rule as the map register paths."""
        value = op.get('value')
        datatype = op.get('datatype')
        if type_ == 'text' and datatype is None and \
                isinstance(value, str) and len(value) == 1:
            return ord(value)
        if type_ == 'text' and datatype in (None, 'int'):
            # non-char text payloads box raw (never inline: a text lane's
            # non-negative ints mean code points)
            return self._intern_value_boxed(value)
        return self._intern_typed(value, datatype)

    def _intern_value_boxed(self, value):
        return -(self.value_table.intern(value) + 2)

    def _intern_typed(self, value, datatype):
        """THE datatype-boxing rule for device value lanes (one source of
        truth for the per-op and turbo ingest paths): payloads whose wire
        datatype an int32 lane can't carry ('uint', 'counter',
        'timestamp', 'float64', …) box as TypedValue so device-served
        patches keep exact datatype leaves; plain ints in range stay
        inline; everything else boxes raw."""
        from .registers import TypedValue
        if not isinstance(datatype, str):
            # int datatype tags (bytes / unknown wire types,
            # columnar.decode_value) box raw: their patch leaves are
            # mirror territory, not TypedValue material
            datatype = None
        if datatype not in (None, 'int'):
            return self._intern_value_boxed(TypedValue(value, datatype))
        if isinstance(value, int) and not isinstance(value, bool) and \
                0 <= value < (1 << 31):
            return value
        return self._intern_value_boxed(value)

    def _make_link_value(self, slot, oid, type_name):
        """THE make-op link rule, shared by the apply and bulk-load ingest
        paths: a child object created by a make op is represented as a
        boxed link value; sequence children (text/list) allocate their
        device row immediately — an empty child would otherwise push every
        read of the doc to the mirror via an unresolved link."""
        if type_name in ('text', 'list'):
            if oid not in self.slot_seq.get(slot, {}):
                self._alloc_seq_row(slot, oid, type_name)
            return self._intern_value_boxed(_SeqLink(oid))
        return self._intern_value_boxed(_MapLink(oid, type_name))

    def _pack_seq_op(self, row, info, op, packed, op_id=None):
        """One decoded sequence op -> (row, kind, ref, packed, value,
        pred0..predD-1, flag) with packed opIds in fleet actor numbering."""
        from .sequence import INSERT, SET, DEL, PAD, SEQ_PRED_LANES
        from .tensor_doc import pack_op_id
        from ..common import parse_op_id

        def pack_ref(eid):
            if eid in (None, '_head'):
                return 0
            ctr, actor = parse_op_id(eid)
            return pack_op_id(ctr, self.actors.intern(actor))

        action = op['action']
        flag = False
        lanes = [0] * SEQ_PRED_LANES
        pred_ids = op.get('pred', [])
        if len(pred_ids) > SEQ_PRED_LANES:
            flag = True
            pred_ids = pred_ids[:SEQ_PRED_LANES]
        for i, p in enumerate(pred_ids):
            lanes[i] = pack_ref(p)
        if action == 'inc':
            # Exact on device: the INC kind accumulates into the pred'd
            # counter lane with Lamport-max attribution (new.js:937-965).
            # The lane bit-packs (sum << 2) | count-bits, so deltas are
            # bounded at +/-2^29 — larger ones flag the row inexact
            # instead of wrapping.
            from .sequence import INC
            kind = INC
            delta = op.get('value', 0)
            if isinstance(delta, int) and not isinstance(delta, bool) and \
                    -(1 << 29) < delta < (1 << 29):
                value = delta
            else:
                kind, value, flag = PAD, 0, True   # unencodable delta
        elif action == 'del':
            kind, value = DEL, 0
        elif action in _SEQ_MAKE or action in _MAP_MAKE:
            # Nested object as a sequence element (rows-in-lists, lists in
            # lists; ref new.js:1461-1528 objectMeta ancestry): the element
            # value is a link to the child object, which registers like any
            # fleet object — (objectId, key) grid columns for maps/tables,
            # its own SeqState row for text/lists.
            kind = INSERT if op.get('insert') else SET
            value = self._make_link_value(info['slot'], op_id,
                                          OBJECT_TYPE[action])
            if info['type'] == 'text':
                # Object elements inside Text render as spans, which stay
                # mirror territory: flag the row so reads route there
                flag = True
        else:
            kind = INSERT if op.get('insert') else SET
            value = self._intern_seq_value(info['type'], op)
        return (row, kind, pack_ref(op.get('elemId')), packed, value,
                *lanes, flag)

    @_spanned('dispatch_seq')
    def _dispatch_seq(self, ops):
        """Place every touched row in a size-class pool with enough
        capacity (migrating rows that outgrew their class) and batch-apply
        all pending sequence ops — ONE dispatch per active size class, each
        one launch of the sequence scan on the fleet's device. `ops` is a
        _SeqRuns (op tuples convert with _SeqRuns.from_tuples)."""
        if len(self.seq_rows) == 0 or len(ops) == 0:
            return
        ps = _span_seq()
        try:
            self._dispatch_seq_phases(ops, ps)
        finally:
            ps.done()

    def _dispatch_seq_phases(self, ops, ps):
        """_dispatch_seq's body, tiled by contiguous `seq_place` (once),
        then `seq_pack` (`sorted=`: the input's runs needed a sort),
        `seq_copy` and `seq_launch` (each once per active size class)
        phases under its `dispatch_seq` span."""
        from .sequence import apply_seq_batch_donated
        ps.mark('seq_place')
        migrations = self.metrics.seq_migrations
        # Widen every pool's lane axis FIRST: a new actor whose hex sorts
        # after all existing ones produces no remap (identity perm), yet
        # its lane must exist before its ops apply
        self.seq_pools.ensure_lanes(self._seq_lane_width())
        if ops.sorted:
            self.metrics.seq_pack_sorted += 1
        else:
            self.metrics.seq_pack_grouped += 1
        cls_r, idx_r = self._place_seq_runs(ops)
        ps.add(migrated=self.metrics.seq_migrations - migrations)
        # One batch per active class, the classes in the order of their
        # lowest row
        classes = np.unique(cls_r)
        if len(classes) > 1:
            classes = classes[np.argsort(
                [ops.rows[cls_r == c].min() for c in classes])]
        for cls in classes.tolist():
            sel = None if len(classes) == 1 else cls_r == cls
            ps.mark('seq_pack', rows=len(cls_r) if sel is None else
                    int(sel.sum()), sorted=int(ops.sorted))
            st = self.seq_pools.state(cls)
            batch = _pack_seq_class(ops, st.elem_id.shape[0], idx_r, sel)
            ps.mark('seq_copy', bytes=sum(c.nbytes for c in batch.columns())
                    if ps.on else None)
            on_device = batch.to(self.device)
            ps.mark('seq_launch')
            apply_seq_batch_donated(st, on_device)
            self.metrics.dispatches += 1
        self.metrics.device_ops += len(ops)

    def _place_seq_runs(self, ops):
        """Give every row of `ops` (a _SeqRuns) a placement with room for
        its inserts; returns each run's size class and pool index. Host-
        tracked element counts give each row's needed class without any
        device reads, checked for all rows at once: only fresh rows and
        rows that outgrew their class take _place_seq_row, in ascending
        row order, so pools are reserved and allocated as one per-row pass
        over the sorted rows would."""
        from .sequence import INSERT
        rows = ops.rows.tolist()
        n = len(rows)
        ins = np.add.reduceat(ops.kind == INSERT, ops.starts, dtype=np.int64)
        old = np.fromiter((self.seq_len[r] for r in rows), np.int64, n)
        new = np.maximum(old + ins, 1)
        places = [self.seq_place[r] for r in rows]
        cur = np.fromiter((-1 if p is None else p[0] for p in places),
                          np.int64, n)
        moving = np.flatnonzero(self.seq_pools.cls_for_many(new) > cur)
        if len(moving):
            moving = moving[np.argsort(ops.rows[moving])]
            # Reserve each pool's capacity ONCE for all rows landing in it
            # this dispatch (per-alloc pow2 growth would copy the pool
            # once per step)
            lanes = self._seq_lane_width()
            new_by_cls = {}
            for k in moving.tolist():
                need_cls = self._seq_need(rows[k], int(new[k]))
                new_by_cls[need_cls] = new_by_cls.get(need_cls, 0) + 1
            for cls, count in new_by_cls.items():
                self.seq_pools.reserve(cls, count, lanes)
            for k in moving.tolist():
                places[k] = self._place_seq_row(rows[k], int(new[k]))
        for r, length in zip(rows, new.tolist()):
            self.seq_len[r] = length
        return (np.fromiter((p[0] for p in places), np.int64, n),
                np.fromiter((p[1] for p in places), np.int64, n))

    def render_seq_all(self):
        """Render every live sequence row: {row: str/list}, with None for
        rows whose device state is inexact (host mirror must serve those
        reads). One materialize + transfer per ACTIVE size class."""
        from .sequence import materialize as seq_materialize
        from .registers import TypedValue
        out = {}
        per_cls = {}
        for row, info in enumerate(self.seq_rows):
            if info is None:
                continue
            place = self.seq_place[row]
            if place is None:
                out[row] = '' if info['type'] == 'text' else []
            else:
                per_cls.setdefault(place[0], []).append(row)
        mats = {}
        for cls in per_cls:
            st = self.seq_pools.state(cls)
            vals, cnts, vis, _n = seq_materialize(st)
            cap = vals.shape[1]
            host = torch.cat([vals, cnts, vis.to(torch.int32),
                              st.inexact.to(torch.int32).unsqueeze(1)],
                             dim=1).cpu().numpy()
            mats[cls] = (host[:, :cap], host[:, cap:2 * cap],
                         host[:, 2 * cap:3 * cap] != 0, host[:, -1] != 0)

        def unbox(v, c):
            boxed = self.value_table[-v - 2]
            if isinstance(boxed, TypedValue):
                # counter display = set base + accumulated inc deltas
                # (ref new.js:937-965)
                return boxed.value + c if boxed.datatype == 'counter' \
                    else boxed.value
            return boxed

        for cls, rows in per_cls.items():
            vals, cnts, vis, inexact = mats[cls]
            for row in rows:
                idx = self.seq_place[row][1]
                if inexact[idx]:
                    out[row] = None
                    continue
                row_vals = vals[idx][vis[idx]]
                if self.seq_rows[row]['type'] == 'text' and \
                        (row_vals >= 0).all():
                    out[row] = _code_points(row_vals)
                    continue
                # counter lanes bit-pack (sum << 2) | count-bits
                items = [(int(v), int(c) >> 2) for v, c in
                         zip(row_vals, cnts[idx][vis[idx]])]
                if self.seq_rows[row]['type'] == 'text':
                    out[row] = ''.join(
                        chr(v) if v >= 0 else str(unbox(v, c))
                        for v, c in items)
                else:
                    out[row] = [v if v >= 0 else unbox(v, c)
                                for v, c in items]
        return out

    # -- ingest ---------------------------------------------------------

    def enqueue(self, slot, buffers, actors):
        if buffers:
            self.pending.append((slot, list(buffers)))
            self.pending_actors.update(actors)

    def _grid_cap(self):
        """Doc capacity of the grid state — materialized or (fresh
        fleet, allocation deferred into the first dispatch) recorded."""
        return self.state.winners.shape[0] if self.state is not None \
            else self.doc_cap

    def _materialize_grid(self, n_docs, n_keys):
        """Eagerly materialize the grid state at capacity — for callers
        that write `self.state` IN PLACE (the bulk loader's direct
        installs) rather than through a dispatch, where the deferred
        fresh-fleet allocation (see _ensure_capacity/_dispatch_grid)
        would leave state None."""
        self._ensure_capacity(n_docs=n_docs, n_keys=n_keys)
        if self.state is None:
            self.state = FleetState.empty(self.doc_cap, self.key_cap,
                                          self.device)

    def _ensure_capacity(self, n_docs, n_keys):
        need_docs = self._cap_docs(n_docs)
        need_keys = _pow2(max(n_keys + 1, self.key_cap))
        if self.state is None:
            self.doc_cap, self.key_cap = need_docs, need_keys
            self.host_winners = np.zeros((need_docs, need_keys + 1),
                                         dtype=np.int32)
            if self.mesh is not None:
                # mesh fleets allocate eagerly, as the reference's do: the
                # first dispatch is already the in-place merge, split
                # over the docs blocks
                self.state = FleetState.empty(need_docs, need_keys,
                                              self.device)
            # else: the first _dispatch_grid builds the zero state INSIDE
            # its merge (apply.apply_op_batch_fresh) — the fill fuses with
            # the first merge instead of being its own whole-grid memset
            return
        old_n, old_k = self.state.winners.shape
        if need_docs <= old_n and need_keys + 1 <= old_k:
            return
        self.metrics.grows += 1
        n, k = max(need_docs, old_n), max(need_keys + 1, old_k)
        # The old scratch column (index old_k - 1) holds garbage from padded
        # scatter lanes; it must not become a real key slot when widening
        grown = []
        for arr in self.state.tensors():
            out = torch.zeros((n, k), dtype=arr.dtype, device=self.device)
            out[:old_n, :old_k - 1] = arr[:, :old_k - 1]
            grown.append(out)
        hw = np.zeros((n, k), dtype=np.int32)
        if self.host_winners is not None:
            hw[:old_n, :old_k - 1] = self.host_winners[:, :old_k - 1]
        self.host_winners = hw
        self.doc_cap, self.key_cap = n, k - 1
        self.state = FleetState(*grown)

    @_spanned('actor_remap')
    def _remap_actors(self, perm):
        """Renumber the actor bits of every packed opId on the device."""
        perm_full = np.arange(MAX_ACTORS, dtype=np.int32)
        perm_full[:len(perm)] = perm
        self._index_remap_actors(perm_full)
        if self.state is None:
            return
        mask = MAX_ACTORS - 1
        self.metrics.remaps += 1
        w = self.state.winners
        perm_t = torch.from_numpy(perm_full).to(self.device)
        remapped = (w & ~mask) | perm_t[(w & mask).long()]
        w.copy_(torch.where(w != 0, remapped, 0))
        if self.host_winners is not None:
            self._fold_pending_winners()
            hw = self.host_winners
            hw_new = (hw & ~mask) | perm_full[hw & mask]
            self.host_winners = np.where(hw != 0, hw_new, 0) \
                .astype(np.int32)

    def _ensure_reg_capacity(self, n_docs, n_keys):
        from .registers import RegisterState
        need_docs = self._cap_docs(n_docs)
        need_keys = _pow2(max(n_keys + 1, self.key_cap))
        need_slots = _pow2(max(len(self.actors), self.actor_slot_cap))
        if self.reg_state is None:
            self.doc_cap, self.key_cap = need_docs, need_keys
            self.actor_slot_cap = need_slots
            self.reg_state = RegisterState.empty(need_docs, need_keys - 1,
                                                 need_slots, self.device)
            return
        old_n, old_k, old_a = self.reg_state.reg.shape
        if need_docs <= old_n and need_keys <= old_k and \
                need_slots <= old_a:
            return
        self.metrics.grows += 1
        n = max(need_docs, old_n)
        k = max(need_keys, old_k)
        a = max(need_slots, old_a)
        grown = []
        for arr in self.reg_state.tensors()[:4]:
            out = torch.zeros((n, k, a), dtype=arr.dtype, device=self.device)
            # old scratch column (old_k - 1) holds garbage: drop it
            out[:old_n, :old_k - 1, :old_a] = arr[:, :old_k - 1]
            grown.append(out)
        inexact = torch.zeros((n,), dtype=torch.bool, device=self.device)
        inexact[:old_n] = self.reg_state.inexact
        self.doc_cap, self.key_cap = n, k - 1
        self.actor_slot_cap = a
        self.reg_state = RegisterState(*grown, inexact)

    def _lane_permutation(self, perm, n_lanes):
        """Actor-lane permutation machinery for the register engine:
        lanes are indexed by actor number, so a sorted-order actor
        insertion (perm: old actor num -> new actor num) both renumbers
        packed-id actor bits and moves every lane.

        Returns (move, renum): move(arr, fill) permutes the trailing lane
        axis of a [..., n_lanes] tensor — every pre-existing actor appears
        in perm; lanes not fed by any old actor (newly inserted actors,
        plus the unused tail) start as `fill` — and renum(arr) rewrites
        the actor bits of non-zero packed opIds."""
        old_of_new = np.zeros(n_lanes, dtype=np.int64)
        fresh = np.ones(n_lanes, dtype=bool)
        for old_i, new_i in enumerate(np.asarray(perm)):
            if new_i < n_lanes:
                old_of_new[new_i] = old_i
                fresh[new_i] = False
        gather = torch.from_numpy(old_of_new).to(self.device)
        zero_new = torch.from_numpy(fresh).to(self.device)
        mask = MAX_ACTORS - 1
        perm_full = np.arange(MAX_ACTORS, dtype=np.int32)
        perm_full[:len(perm)] = perm
        bits = torch.from_numpy(perm_full).to(self.device)

        def move(arr, fill):
            return torch.where(zero_new, fill, arr[..., gather])

        def renum(arr):
            return torch.where(arr != 0,
                               (arr & ~mask) | bits[(arr & mask).long()], 0)

        return move, renum

    @_spanned('actor_remap')
    def _remap_reg_actors(self, perm):
        """Renumber actor bits AND permute the actor-slot axis of the
        register state after a sorted-order actor insertion."""
        perm_full = np.arange(MAX_ACTORS, dtype=np.int32)
        perm_full[:len(perm)] = perm
        self._index_remap_actors(perm_full)
        if self.reg_state is None:
            return
        from .registers import RegisterState
        # Grow the slot axis FIRST: the freshly inserted actors may push an
        # existing actor's new slot index past the current width, and the
        # permutation below would silently drop its registers
        self._ensure_reg_capacity(n_docs=self.n_slots, n_keys=len(self.keys))
        self.metrics.remaps += 1
        rs = self.reg_state
        move, renum = self._lane_permutation(perm, rs.reg.shape[2])
        self.reg_state = RegisterState(
            renum(move(rs.reg, 0)), move(rs.killed, False),
            move(rs.value, 0), move(rs.counter, 0), rs.inexact)

    def _rebase_slot(self, slot, new_ctr, floor_ctr=None):
        """Shift a slot's packing window so counters up to `new_ctr` fit:
        new base = min(live winner counters, incoming batch floor) - 1, with
        the slot's live winners shifted down in one device update. When the
        spread itself exceeds the window the slot lands in grid_overflow
        (reads fall back to the host mirror; history stays unbounded)."""
        old = self.ctr_base.get(slot, 0)
        min_live = None
        if self.state is not None and slot < self.state.winners.shape[0]:
            row = self.state.winners[slot].cpu().numpy()
            live = row[row != 0]
            if len(live):
                min_live = int((live >> ACTOR_BITS).min()) + old
        floor = new_ctr if floor_ctr is None else floor_ctr
        if min_live is not None:
            floor = min(floor, min_live)
        new_base = floor - 1
        if new_ctr - new_base >= CTR_LIMIT or new_base <= old:
            self.grid_overflow.add(slot)
            return old
        if min_live is not None:
            self._fold_pending_winners()
            delta = (new_base - old) << ACTOR_BITS
            w = self.state.winners
            w[slot] = torch.where(w[slot] != 0, w[slot] - delta, 0)
            self.metrics.dispatches += 1
            if self.host_winners is not None and \
                    slot < self.host_winners.shape[0]:
                hw = self.host_winners[slot]
                self.host_winners[slot] = np.where(hw != 0, hw - delta, 0)
        self._index_rebase(slot, (new_base - old) << ACTOR_BITS)
        self.ctr_base[slot] = new_base
        return new_base

    def _pack_pred(self, slot, op):
        """Pack an inc op's attribution pred against the slot's current
        window WITHOUT rebase side effects. Multi-pred incs (conflicted
        counters) attribute to the LAMPORT-MAX pred, matching the
        reference's counterStates overwrite (new.js:942-945). Returns -1
        when no pred can be packed (absent, unregistered actor, outside
        the window) — which _note_grid_batch treats as a mismatch."""
        from ..common import parse_op_id
        from .tensor_doc import pack_op_id
        preds = op.get('pred') or []
        if not preds:
            return -1
        packed = []
        for pr in preds:
            try:
                ctr, actor = parse_op_id(pr)
                num = self.actors.intern(actor)
            except (KeyError, ValueError):
                return -1
            rel = ctr - self.ctr_base.get(slot, 0)
            if rel <= 0 or rel >= CTR_LIMIT:
                return -1
            packed.append(pack_op_id(rel, num))
        return max(packed)

    # -- dangling-pred oracle (see _op_index in __init__) ---------------

    def _index_ops(self, slots, key_ids, packeds):
        """Record applied map-key op rows (sets, incs, makes — never
        dels) for later pred-existence checks. slots/key_ids/packeds are
        parallel arrays in fleet numbering. O(1) per batch: the per-slot
        split is deferred to consolidation (lookup/clone/rebase time), so
        pred-free bulk workloads pay only the combo pack."""
        if not len(slots):
            return
        combos = (np.asarray(key_ids, dtype=np.int64) << 32) | \
            np.asarray(packeds, dtype=np.int64)
        self._op_index_pending.append(
            (np.asarray(slots, dtype=np.int64), combos))

    def _index_consolidate(self):
        """Drain the flat pending batches into per-slot sorted arrays."""
        if not self._op_index_pending:
            return
        slots = np.concatenate([p[0] for p in self._op_index_pending])
        combos = np.concatenate([p[1] for p in self._op_index_pending])
        self._op_index_pending = []
        order = np.argsort(slots, kind='stable')
        ss = slots[order]
        cs = combos[order]
        bounds = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
        ends = np.r_[bounds[1:], len(ss)]
        for b, e in zip(bounds, ends):
            slot = int(ss[b])
            old = self._op_index.get(slot)
            if old is None:
                self._op_index[slot] = np.sort(cs[b:e])
            else:
                self._op_index[slot] = np.sort(
                    np.concatenate([old, cs[b:e]]))

    def _index_lookup(self, slot, combos):
        """Membership of (key << 32 | packed) combos in the slot's
        applied-op index (consolidates the pending backlog first)."""
        self._index_consolidate()
        arr = self._op_index.get(slot)
        if arr is None or not len(arr):
            return np.zeros(len(combos), dtype=bool)
        pos = np.searchsorted(arr, combos)
        pos = np.clip(pos, 0, len(arr) - 1)
        return arr[pos] == combos

    def _index_remap_actors(self, perm_full):
        """Renumber the actor bits of every indexed packed opId (actor
        table re-sort) — consolidated arrays and pending batches alike."""
        mask = np.int64(MAX_ACTORS - 1)
        perm64 = perm_full.astype(np.int64)

        def remap(arr):
            return (arr & ~mask) | perm64[arr & mask]

        for slot, arr in self._op_index.items():
            self._op_index[slot] = np.sort(remap(arr))
        self._op_index_pending = [(s, remap(c))
                                  for s, c in self._op_index_pending]

    def _index_rebase(self, slot, delta_packed):
        """Shift a slot's indexed packed ids down by a counter rebase."""
        self._index_consolidate()
        arr = self._op_index.get(slot)
        if arr is None or not len(arr):
            return
        low = arr & 0xffffffff
        shifted = np.maximum(low - delta_packed, 0)
        self._op_index[slot] = np.sort(
            (arr & ~np.int64(0xffffffff)) | shifted)

    @_spanned('dispatch_grid')
    def _dispatch_grid(self, batch, kills=None):
        """One LWW-grid merge dispatch: the batch's host columns move to
        the fleet's device and ONE merge kernel launch lands them. With
        `kills` (a (kill_key, kill_packed) [N, Q] pair from delete preds),
        the kills pre-pass runs first so deletes only kill the ops they
        pred (apply.apply_op_batch_kills — ref new.js:1204-1217). The
        batch must already be padded to the state's doc capacity; kills
        are padded here."""
        from .apply import (apply_op_batch_donated, apply_op_batch_fresh,
                            apply_op_batch_kills_donated,
                            apply_op_batch_kills_fresh,
                            apply_op_batch_noinc_donated,
                            apply_op_batch_noinc_fresh)
        fresh = self.state is None      # deferred fresh-fleet allocation
        has_inc = bool(batch.is_inc.any())
        if has_inc:
            self._counters_touched = True
        batch = batch.to(self.device)
        if kills is None:
            if not has_inc and not self._counters_touched:
                # set-only batch on a counter-free grid: the specialized
                # kernel skips ~3 whole-grid memory passes (see apply.py)
                if fresh:
                    self.state, _stats = apply_op_batch_noinc_fresh(
                        batch, self.doc_cap, self.key_cap)
                else:
                    self.state, _stats = apply_op_batch_noinc_donated(
                        self.state, batch,
                        **self._split(self.state.winners.shape[0]))
            elif fresh:
                self.state, _stats = apply_op_batch_fresh(
                    batch, self.doc_cap, self.key_cap)
            else:
                self.state, _stats = apply_op_batch_donated(
                    self.state, batch,
                    **self._split(self.state.winners.shape[0]))
        else:
            kill_key, kill_packed = kills
            n_cap = self._grid_cap()
            if kill_key.shape[0] < n_cap:
                pad = n_cap - kill_key.shape[0]
                kill_key = np.pad(kill_key, ((0, pad), (0, 0)))
                kill_packed = np.pad(kill_packed, ((0, pad), (0, 0)))
            kill_key = torch.from_numpy(np.ascontiguousarray(
                kill_key, dtype=np.int32)).to(self.device)
            kill_packed = torch.from_numpy(np.ascontiguousarray(
                kill_packed, dtype=np.int32)).to(self.device)
            if fresh:
                self.state, _stats = apply_op_batch_kills_fresh(
                    batch, kill_key, kill_packed, self.doc_cap,
                    self.key_cap)
            else:
                self.state, _stats = apply_op_batch_kills_donated(
                    self.state, batch, kill_key, kill_packed,
                    **self._split(self.state.winners.shape[0]))
        self.metrics.dispatches += 1

    def _note_grid_batch(self, set_doc, set_key, set_packed,
                         inc_doc, inc_key, inc_pred,
                         kill_doc=(), kill_key=(), kill_packed=()):
        """Advance the host winner mirror with a batch's set rows (same
        scatter-max the device applies, minus sets a same-batch kill
        names — the device masks those lanes) and kill rows (delete preds
        — clear the mirrored winner iff it holds exactly the pred'd opId,
        matching apply.apply_op_batch_kills), route every kill-touched
        slot's reads to the exact mirror (del_fallback), then verify
        every inc op's pred against the post-batch winner. An inc whose
        pred is not the winner would be credited to the wrong counter by
        the device cell (apply.py's documented corner), so its slot goes
        mirror-authoritative via grid_overflow. inc_pred == -1 marks
        preds that could not be packed (absent, multiple, or outside the
        window) and always flags."""
        if len(kill_doc):
            # Blunt-but-sound delete rule (see del_fallback): the grid's
            # winner view after kills is best-effort only. Runs BEFORE the
            # mirror guard — read-routing soundness must not depend on the
            # optional winner mirror being allocated.
            self.del_fallback.update(int(d) for d in np.unique(kill_doc))
        hw = self.host_winners
        if hw is None:
            return
        if len(set_doc) or len(kill_doc):
            self._pending_winner_rows.append(
                (np.asarray(kill_doc, dtype=np.int64),
                 np.asarray(kill_key, dtype=np.int64),
                 np.asarray(kill_packed, dtype=np.int32),
                 np.asarray(set_doc, dtype=np.int64),
                 np.asarray(set_key, dtype=np.int64),
                 np.asarray(set_packed, dtype=np.int32)))
            self._pending_winner_count += len(set_doc) + len(kill_doc)
        if len(inc_doc):
            self._fold_pending_winners()
            inc_doc = np.asarray(inc_doc, dtype=np.int64)
            inc_key = np.asarray(inc_key, dtype=np.int64)
            inc_pred = np.asarray(inc_pred, dtype=np.int64)
            bad = inc_pred != hw[inc_doc, inc_key]
            for d in np.unique(inc_doc[bad]):
                self.grid_overflow.add(int(d))
        elif self._pending_winner_count > _WINNER_FOLD_LIMIT or \
                len(self._pending_winner_rows) > 4096:
            # Two caps: total rows (bounds the fold's work) and batch
            # count (bounds per-batch numpy/tuple overhead under many
            # tiny inc-free flushes)
            self._fold_pending_winners()

    def _fold_pending_winners(self):
        """Replay the deferred batches into the host winner mirror. Per
        batch, preserving the device dispatch order: (1) kills clear a
        cell iff it holds exactly the pred'd opId (the device's
        standing-winner kill); (2) set rows scatter-max — EXCLUDING sets
        a same-batch kill names, which the device masks at the lane
        level. Kill-touched slots are already read-routed to the mirror
        (del_fallback), so this winner view is only consumed by the
        counter-attribution check on delete-free slots."""
        if not self._pending_winner_rows:
            return
        hw = self.host_winners
        for (kill_doc, kill_key, kill_packed,
             set_doc, set_key, set_packed) in self._pending_winner_rows:
            if len(kill_doc):
                m = hw[kill_doc, kill_key] == kill_packed
                hw[kill_doc[m], kill_key[m]] = 0
            if len(set_doc):
                keep = np.ones(len(set_doc), dtype=bool)
                if len(kill_doc):
                    kill_combo = kill_doc * (1 << 32) + kill_packed
                    keep = ~np.isin(set_doc * (1 << 32) + set_packed,
                                    kill_combo)
                np.maximum.at(hw, (set_doc[keep], set_key[keep]),
                              set_packed[keep])
        self._pending_winner_rows = []
        self._pending_winner_count = 0

    def _slot_pack(self, slot, ctr, actor_num):
        """Pack a grid op's (counter, actor) against the slot's rebased
        window; overflowing slots still get a clamped packing (their grid
        rows are no longer authoritative — reads use the mirror)."""
        base = self.ctr_base.get(slot, 0)
        if ctr - base >= CTR_LIMIT and slot not in self.grid_overflow:
            # (an overflowed slot must NOT rebase mid-batch: earlier ops in
            # this batch already packed against the old base)
            base = self._rebase_slot(slot, ctr)
        rel = ctr - base
        if rel <= 0 or rel >= CTR_LIMIT:
            # Sub-window straggler after a rebase, or irreducible spread:
            # mark and clamp (the mirror is authoritative for this slot)
            self.grid_overflow.add(slot)
            rel = min(max(rel, 1), CTR_LIMIT - 1)
        return pack_op_id(rel, actor_num)

    @_spanned('fleet_flush')
    def flush(self):
        """Land all pending change buffers on the device: one batched ingest
        and one merge dispatch for the whole fleet."""
        if not self.pending:
            return
        perm = self.actors.insert_many(self.pending_actors)
        if perm is not None:
            if self.exact_device:
                self._remap_reg_actors(perm)
            else:
                self._remap_actors(perm)
            self._remap_seq_actors(perm)
        n_docs = self.n_slots
        per_doc = [[] for _ in range(n_docs)]
        for slot, buffers in self.pending:
            per_doc[slot].extend(buffers)
            self.metrics.changes_ingested += len(buffers)
            self.metrics.bytes_ingested += sum(len(b) for b in buffers)
        self.pending = []
        self.pending_actors = set()
        if self.exact_device:
            self._flush_exact(per_doc, n_docs)
            return
        batch = None
        rebased_touched = any(
            d < n_docs and per_doc[d]
            for d in set(self.ctr_base) | self.grid_overflow)
        hazard = []
        kills = []
        index_rows = []
        if native.available() and not rebased_touched:
            # (rebased slots pack against per-slot bases the native batch
            # does not know about: only flushes touching such slots take
            # the Python decode — the rest of the fleet keeps the C++ path)
            from .ingest import changes_to_op_batch_native
            batch = changes_to_op_batch_native(per_doc, self.keys,
                                               self.actors,
                                               hazard_out=hazard,
                                               kills_out=kills,
                                               index_out=index_rows)
        if batch is None:
            # Sequence ops, non-inline values, or no native codec: Python
            # decode once, routing flat rows to the grid and sequence ops
            # to the SeqState fleet
            self._flush_mixed(per_doc, n_docs)
            return
        self._ensure_capacity(n_docs=n_docs, n_keys=len(self.keys))
        if batch.key_id.shape[0] < self._grid_cap():
            pad = self._grid_cap() - batch.key_id.shape[0]
            batch = type(batch)(*(np.pad(col, ((0, pad), (0, 0)))
                                  for col in batch.columns()))
        if index_rows:
            self._index_ops(*index_rows[0])
        self._dispatch_grid(batch, kills[0] if kills else None)
        self.metrics.device_ops += int(batch.valid.sum())
        if hazard:
            self._note_grid_batch(*hazard[0])

    def _flush_exact(self, per_doc, n_docs):
        """Exact-device flush: flat rows (with preds) into the multi-value
        register engine, one ordered-scan dispatch. Batches the native
        rows cannot carry route through the mixed Python parse."""
        from .ingest import changes_to_op_rows
        from .registers import (apply_register_batch_donated,
                                rows_to_register_batch)
        try:
            rows = changes_to_op_rows(per_doc, self.keys, self.actors,
                                      value_table=self.value_table)
        except ValueError:
            self._flush_exact_mixed(per_doc, n_docs)
            return
        self._ensure_reg_capacity(n_docs=n_docs, n_keys=len(self.keys))
        n_cap = self.reg_state.reg.shape[0]
        idx_sel = ((rows['flags'] == FLAG_SET) &
                   (rows['value'] != TOMBSTONE)) | (rows['flags'] == FLAG_INC)
        self._index_ops(rows['doc'][idx_sel], rows['key'][idx_sel],
                        rows['packed'][idx_sel])
        batch = rows_to_register_batch(
            rows['doc'], rows['flags'], rows['key'], rows['packed'],
            rows['value'], rows['pred_off'], rows['pred'],
            n_docs=n_cap, d_preds=self.d_preds)
        apply_register_batch_donated(self.reg_state, batch.to(self.device),
                                     **self._split(n_cap))
        self.metrics.dispatches += 1
        self.metrics.device_ops += len(rows['doc'])

    def _flush_exact_mixed(self, per_doc, n_docs):
        """Mixed-content flush for exact-device mode: flat rows (with pred
        lists) into the register engine, sequence ops into the SeqState
        fleet."""
        from .registers import (apply_register_batch_donated,
                                rows_to_register_batch)
        from .tensor_doc import pack_op_id
        from .ingest import changes_to_decoded_ops
        from ..common import parse_op_id

        def pack(opid):
            ctr, actor = parse_op_id(opid)
            return pack_op_id(ctr, self.actors.intern(actor))

        out_doc, out_key, out_packed, out_val, out_flags = [], [], [], [], []
        pred_off, preds = [0], []
        seq_ops = []
        for d, op_id, op in changes_to_decoded_ops(per_doc):
            obj = op['obj']
            action = op['action']
            packed = pack(op_id)
            if obj != '_root' and obj in self.slot_seq.get(d, {}):
                row = self.slot_seq[d][obj]
                seq_ops.append(self._pack_seq_op(row, self.seq_rows[row],
                                                 op, packed, op_id=op_id))
                continue
            if action in _SEQ_MAKE:
                self._alloc_seq_row(
                    d, op_id, 'text' if action == 'makeText' else 'list')
                val_idx, flags = \
                    self._intern_value_boxed(_SeqLink(op_id)), FLAG_SET
            elif action in _MAP_MAKE:
                val_idx, flags = self._intern_value_boxed(
                    _MapLink(op_id, OBJECT_TYPE[action])), FLAG_SET
            elif action == 'del':
                val_idx, flags = TOMBSTONE, FLAG_SET
            elif action == 'inc':
                val_idx, flags = op.get('value', 0), FLAG_INC
            else:
                # _intern_typed is THE datatype-boxing rule: uint/counter/
                # timestamp/float64 sets box with their datatype so
                # device-served patches stay exact
                val_idx, flags = self._intern_typed(
                    op.get('value'), op.get('datatype')), FLAG_SET
            out_doc.append(d)
            out_key.append(self.keys.intern(
                op['key'] if obj == '_root' else (obj, op['key'])))
            out_packed.append(packed)
            out_val.append(val_idx)
            out_flags.append(flags)
            for p in op.get('pred', []):
                preds.append(pack(p))
            pred_off.append(len(preds))
        if out_doc:
            self._ensure_reg_capacity(n_docs=n_docs, n_keys=len(self.keys))
            n_cap = self.reg_state.reg.shape[0]
            doc_a = np.array(out_doc, dtype=np.int64)
            key_a = np.array(out_key, dtype=np.int32)
            packed_a = np.array(out_packed, dtype=np.int32)
            flags_a = np.array(out_flags, dtype=np.uint8)
            val_a = np.array(out_val, dtype=np.int32)
            idx_sel = ((flags_a == FLAG_SET) & (val_a != TOMBSTONE)) | \
                (flags_a == FLAG_INC)
            self._index_ops(doc_a[idx_sel], key_a[idx_sel],
                            packed_a[idx_sel])
            batch = rows_to_register_batch(
                doc_a, flags_a, key_a, packed_a, val_a,
                np.array(pred_off, dtype=np.int64),
                np.array(preds, dtype=np.int32),
                n_docs=n_cap, d_preds=self.d_preds)
            apply_register_batch_donated(self.reg_state,
                                         batch.to(self.device),
                                         **self._split(n_cap))
            self.metrics.dispatches += 1
            self.metrics.device_ops += len(out_doc)
        self._dispatch_seq(_SeqRuns.from_tuples(seq_ops))

    def inexact_slots(self):
        """Slots whose histories fell outside the register engine's exact
        shape (self-conflicts, pred overflow, …) — reads for these route to
        the host mirror."""
        self.flush()
        if self.reg_state is None:
            return set()
        return set(np.flatnonzero(self.reg_state.inexact.cpu().numpy()))

    def _flush_mixed(self, per_doc, n_docs):
        """Python-decode flush splitting flat root-map rows (LWW grid) from
        sequence-object ops (SeqState fleet). per_doc is indexed by slot."""
        from .tensor_doc import OpBatch, pack_op_id
        from .ingest import changes_to_decoded_ops
        from ..common import parse_op_id

        ops_list = list(changes_to_decoded_ops(per_doc))
        # Rebase pre-pass: shift any slot whose incoming grid counters
        # overflow its packing window BEFORE building rows, so one batch
        # packs against one base per slot
        slot_max, slot_min = {}, {}
        for d, op_id, op in ops_list:
            if op['obj'] == '_root' or \
                    op['obj'] not in self.slot_seq.get(d, {}):
                ctr = parse_op_id(op_id)[0]
                if ctr > slot_max.get(d, 0):
                    slot_max[d] = ctr
                if ctr < slot_min.get(d, ctr + 1):
                    slot_min[d] = ctr
        for d, ctr in slot_max.items():
            if ctr - self.ctr_base.get(d, 0) >= CTR_LIMIT:
                self._rebase_slot(d, ctr, floor_ctr=slot_min[d])

        rows = []       # (slot, key_id, packed, value, is_set, is_inc)
        seq_ops = []
        inc_checks = []  # (slot, key_id, pred packed | -1)
        kill_rows = []   # (slot, key_id, pred packed): delete kill lanes
        for d, op_id, op in ops_list:
            ctr, actor = parse_op_id(op_id)
            obj = op['obj']
            action = op['action']
            if obj != '_root' and obj in self.slot_seq.get(d, {}):
                row = self.slot_seq[d][obj]
                packed = pack_op_id(ctr, self.actors.intern(actor))
                seq_ops.append(self._pack_seq_op(row, self.seq_rows[row],
                                                 op, packed, op_id=op_id))
                continue
            packed = self._slot_pack(d, ctr, self.actors.intern(actor))
            # Root keys intern as bare strings (shared with the native
            # path); nested map/table keys as (objectId, key) tuples —
            # the two never collide
            key_id = self.keys.intern(
                op['key'] if obj == '_root' else (obj, op['key']))
            if action in _SEQ_MAKE:
                self._alloc_seq_row(
                    d, op_id, 'text' if action == 'makeText' else 'list')
                rows.append((d, key_id, packed,
                             self._intern_value_boxed(_SeqLink(op_id)),
                             True, False))
            elif action in _MAP_MAKE:
                rows.append((d, key_id, packed,
                             self._intern_value_boxed(_MapLink(
                                 op_id, OBJECT_TYPE[action])),
                             True, False))
            elif action == 'del':
                # Pred-scoped delete (ref new.js:1204-1217): each pred
                # becomes a kill lane; the del writes no winner of its
                # own, so concurrent sets it never saw stay visible. An
                # unpackable pred (outside the slot's counter window,
                # unknown actor) can't kill exactly — the mirror goes
                # authoritative for that slot instead.
                for pr in op.get('pred') or []:
                    try:
                        pctr, pactor = parse_op_id(pr)
                        num = self.actors.intern(pactor)
                    except (KeyError, ValueError):
                        self.grid_overflow.add(d)
                        continue
                    rel = pctr - self.ctr_base.get(d, 0)
                    if rel <= 0 or rel >= CTR_LIMIT:
                        self.grid_overflow.add(d)
                        continue
                    kill_rows.append((d, key_id, pack_op_id(rel, num)))
            elif action == 'inc':
                rows.append((d, key_id, packed, op.get('value', 0),
                             False, True))
                inc_checks.append((d, key_id, self._pack_pred(d, op)))
            else:
                rows.append((d, key_id, packed,
                             self._intern_value(op.get('value')),
                             True, False))
        if rows or kill_rows:
            counts = np.zeros(n_docs, dtype=np.int64)
            for r in rows:
                counts[r[0]] += 1
            width = max(int(counts.max()), 1)
            self._ensure_capacity(n_docs=n_docs, n_keys=len(self.keys))
            n_cap = self._grid_cap()
            shape = (n_cap, width)
            cols = {name: np.zeros(shape, dtype=np.int32)
                    for name in ('key_id', 'packed', 'value')}
            is_set = np.zeros(shape, dtype=bool)
            is_inc = np.zeros(shape, dtype=bool)
            valid = np.zeros(shape, dtype=bool)
            pos = np.zeros(n_docs, dtype=np.int64)
            for (d, k, p, v, s, inc) in rows:
                j = pos[d]
                pos[d] += 1
                cols['key_id'][d, j] = k
                cols['packed'][d, j] = p
                cols['value'][d, j] = v
                is_set[d, j] = s
                is_inc[d, j] = inc
                valid[d, j] = True
            batch = OpBatch(cols['key_id'], cols['packed'], cols['value'],
                            is_set, is_inc, valid)
            # every rows entry is a map-key set/inc/make (dels became
            # kill lanes): feed the dangling-pred oracle
            self._index_ops([r[0] for r in rows], [r[1] for r in rows],
                            [r[2] for r in rows])
            kills = None
            if kill_rows:
                from .ingest import layout_doc_rows
                kd = np.array([k[0] for k in kill_rows], dtype=np.int64)
                kk = np.array([k[1] for k in kill_rows], dtype=np.int64)
                kp = np.array([k[2] for k in kill_rows], dtype=np.int64)
                (kk_arr, kp_arr), _ = layout_doc_rows(
                    kd, n_cap, (kk, kp), (np.int32, np.int32))
                kills = (kk_arr, kp_arr)
            self._dispatch_grid(batch, kills)
            self.metrics.device_ops += len(rows) + len(kill_rows)
            sets = [(r[0], r[1], r[2]) for r in rows if r[4]]
            self._note_grid_batch([s[0] for s in sets], [s[1] for s in sets],
                                  [s[2] for s in sets],
                                  [c[0] for c in inc_checks],
                                  [c[1] for c in inc_checks],
                                  [c[2] for c in inc_checks],
                                  [k[0] for k in kill_rows],
                                  [k[1] for k in kill_rows],
                                  [k[2] for k in kill_rows])
        self._dispatch_seq(_SeqRuns.from_tuples(seq_ops))

    # -- reads ----------------------------------------------------------

    def materialize_all(self):
        """Whole-fleet state readback in one device->host transfer:
        slot -> {key: value} with LWW winners, tombstones dropped, and
        counter accumulators added to their base value. In exact-device
        mode the read comes from the multi-value registers instead (winner
        per key from the visible set, per-op counter folds)."""
        self.flush()
        if self.exact_device:
            return self._materialize_registers()
        if self.state is None:
            return [{} for _ in range(self.n_slots)]
        winners, values, counters = (t.cpu().numpy()
                                     for t in self.state.tensors())
        out = []
        free = set(self.free_slots)
        rendered = None
        for slot in range(self.n_slots):
            if slot in free:
                out.append({})
                continue
            root_cells = {}      # root key -> value
            nested = {}          # objectId -> {key: value}
            any_seq = False
            live = np.flatnonzero(winners[slot, :len(self.keys)])
            for k in live:
                v = int(values[slot, k])
                if v == TOMBSTONE:
                    continue
                value = self.value_table[-v - 2] if v <= -2 else v
                if isinstance(value, _SeqLink):
                    any_seq = True
                elif not isinstance(value, _MapLink):
                    c = int(counters[slot, k])
                    if c and isinstance(value, int) and \
                            not isinstance(value, bool):
                        value += c
                key = self.keys.keys[k]
                if isinstance(key, tuple):
                    nested.setdefault(key[0], {})[key[1]] = value
                else:
                    root_cells[key] = value
            if any_seq and rendered is None:
                rendered = self.render_seq_all()
            out.append({key: self._resolve_value(slot, v, rendered or {},
                                                 nested)
                        for key, v in root_cells.items()})
        return out

    def _resolve_value(self, slot, value, rendered, nested, depth=0):
        """Resolve link values into rendered subtrees with slot context:
        _MapLink -> nested dict assembled from the (objectId, key) grid
        cells; _SeqLink -> the rendered device sequence row, with list
        elements resolved recursively so objects nested inside sequences
        materialize straight from device state (the two-level interning of
        the reference's objectMeta ancestry, ref new.js:1461-1528).
        Unresolved links (device-inexact rows, recursion backstop) stay in
        place, which routes bulk readers to the host mirror."""
        if depth > 128:
            return value
        if isinstance(value, _SeqLink):
            row = self.slot_seq.get(slot, {}).get(value.object_id)
            if row is None:
                return value
            r = rendered.get(row)
            if r is None:
                return value
            if isinstance(r, list):
                return [self._resolve_value(slot, v, rendered, nested,
                                            depth + 1) for v in r]
            return r
        if isinstance(value, _MapLink):
            return {k: self._resolve_value(slot, v, rendered, nested,
                                           depth + 1)
                    for k, v in nested.get(value.object_id, {}).items()}
        return value

    def materialize(self, slot):
        return self.materialize_all()[slot]

    def _materialize_registers(self):
        from .registers import materialize_registers
        if self.reg_state is None:
            return [{} for _ in range(self.n_slots)]
        docs = materialize_registers(self.reg_state, self.keys.keys,
                                     value_table=self.value_table,
                                     n_docs=self.n_slots)
        free = set(self.free_slots)
        out = []
        rendered = None
        for slot in range(self.n_slots):
            if slot in free or slot >= len(docs):
                out.append({})
            else:
                # Keys legitimately set to null keep their None value (the
                # LWW grid and host mirror both report them; only absent /
                # fully-deleted keys are omitted)
                root_cells, nested = {}, {}
                any_seq = False
                for k, (v, _conflicts) in docs[slot].items():
                    if isinstance(v, _SeqLink):
                        any_seq = True
                    if isinstance(k, tuple):
                        nested.setdefault(k[0], {})[k[1]] = v
                    else:
                        root_cells[k] = v
                if any_seq and rendered is None:
                    rendered = self.render_seq_all()
                out.append({k: self._resolve_value(slot, v, rendered or {},
                                                   nested)
                            for k, v in root_cells.items()})
        return out

    def conflicts_all(self):
        """Exact-device only: slot -> {key: {packed opId: value}} for every
        key with a multi-value conflict (>1 visible op)."""
        self.flush()
        from .registers import materialize_registers
        if not self.exact_device:
            raise ValueError('conflicts_all requires exact_device=True')
        if self.reg_state is None:
            return [{} for _ in range(self.n_slots)]
        docs = materialize_registers(self.reg_state, self.keys.keys,
                                     value_table=self.value_table,
                                     n_docs=self.n_slots)
        return [{k: conflicts for k, (_v, conflicts) in doc.items()
                 if conflicts} for doc in docs[:self.n_slots]]


class _DocCols:
    """Struct-of-arrays doc state for every fleet engine, indexed by slot.

    The turbo commit's per-doc Python loop (heads / max_op / stale /
    binary_doc writes, clock advance, log bookkeeping) is replaced by
    vectorized scatters into these columns; `_FlatEngine` exposes the
    same attributes as properties reading its row, so every slow path
    keeps its exact semantics against ONE source of truth. Grows pow2
    with the fleet's slot count; recycled slots are reset at allocation
    time in one vectorized pass (`reset_rows`).

    Head frontier: ``HEAD_LANES`` raw 32-byte hashes a doc in
    ``head32`` ([cap, HEAD_LANES, 32]); ``head_n`` is how many lanes are
    in use (0 = empty), in the heads list's order (sorted hex), with
    ``head_obj`` memoizing the hex list, or -1 when the authoritative
    list lives in ``head_obj`` (a frontier wider than the lanes, or
    heads that are not hex hashes). The native gate checks every
    change's deps against the lanes; a -1 doc keeps the chain shape
    with its first change's deps compared on the host.

    Clock: up to ``CLOCK_LANES`` (actor, seq) lanes per doc
    (``ck_actor`` holds ids into the fleet's clock-actor registry,
    -1 = unused), ``ck_n`` the lane count — or -1 when the
    authoritative dict lives in ``ck_obj`` (actor populations past the
    lane width). The gate's per-(doc, actor) base lookup and the
    commit's clock advance are vectorized over the lanes; dict-mode
    docs take the counted fallback loop.

    Change log: per-doc buffer lists stay on the engines (``_log``),
    but turbo commits append LAZILY — each batch parks one
    `_SeamSegs` record on the fleet and bumps ``pend_n``; an engine
    folds its pending segments into ``_log``/``_defer`` only when
    something actually reads its history (`_fold_pending`). ``pend_doc``
    / ``parked_n`` mirror ``_doc_pending`` / ``_parked_n`` so the
    commit computes parked-prefix bases without touching engines."""

    CLOCK_LANES = 4
    HEAD_LANES = 4

    __slots__ = ('cap', 'maxop', 'stale', 'bindoc', 'head_n', 'head32',
                 'head_obj', 'ck_n', 'ck_actor', 'ck_seq', 'ck_obj',
                 'pend_doc', 'parked_n', 'pend_n')

    def __init__(self, cap=64):
        self._alloc(max(int(cap), 1))

    def _alloc(self, cap):
        L = self.CLOCK_LANES
        self.cap = cap
        self.maxop = np.zeros(cap, dtype=np.int64)
        self.stale = np.zeros(cap, dtype=bool)
        self.bindoc = np.full(cap, None, dtype=object)
        self.head_n = np.zeros(cap, dtype=np.int32)
        self.head32 = np.zeros((cap, self.HEAD_LANES, 32), dtype=np.uint8)
        self.head_obj = np.full(cap, None, dtype=object)
        self.ck_n = np.zeros(cap, dtype=np.int32)
        self.ck_actor = np.full((cap, L), -1, dtype=np.int32)
        self.ck_seq = np.zeros((cap, L), dtype=np.int64)
        self.ck_obj = np.full(cap, None, dtype=object)
        self.pend_doc = np.full(cap, None, dtype=object)
        self.parked_n = np.zeros(cap, dtype=np.int64)
        self.pend_n = np.zeros(cap, dtype=np.int64)

    def ensure(self, n):
        """Grow (pow2) so rows [0, n) are addressable."""
        if n <= self.cap:
            return
        old = {name: getattr(self, name) for name in self.__slots__
               if name != 'cap'}
        k = self.cap
        self._alloc(_pow2(n))
        for name, arr in old.items():
            getattr(self, name)[:k] = arr

    def reset_rows(self, rows):
        """Vectorized per-row defaults (fresh-engine state) — the single
        choke point recycled slots pass through at allocation."""
        if not len(rows):
            return
        rows = np.asarray(rows, dtype=np.int64)
        self.maxop[rows] = 0
        self.stale[rows] = False
        self.bindoc[rows] = None
        self.head_n[rows] = 0
        self.head_obj[rows] = None
        self.ck_n[rows] = 0
        self.ck_actor[rows] = -1
        self.ck_seq[rows] = 0
        self.ck_obj[rows] = None
        self.pend_doc[rows] = None
        self.parked_n[rows] = 0
        self.pend_n[rows] = 0


class _SeamSegs:
    """One turbo commit's lazily-folded log/deferred-graph appends: the
    flat buffer list + parse metadata, and per-slot (start, stop, base)
    segments. `_FlatEngine._fold_pending` pops its slot's segment and
    splices `buffers[start:stop]` into the log (and one deferred-graph
    record at `base`) — until then the commit cost for the log is one
    dict build for the whole batch."""

    __slots__ = ('buffers', 'meta', 'rowmap')

    def __init__(self, buffers, meta, rowmap):
        self.buffers = buffers
        self.meta = meta
        self.rowmap = rowmap


class _FlatEngine(HashGraph):
    """Host-side mirror + patch generator for one fleet document.

    The mirror is a real OpSet (the host conformance engine, op_set.py) with
    the causal gate bypassed — this engine's own HashGraph does the gating,
    and ready changes stream into the mirror's op store. Patches, conflict
    sets, counter accumulation, and error conditions are therefore identical
    to the host backend *by construction*: it is the same code. The heavy
    merge state lives on the device; the mirror exists for exact patches,
    reads, and serialization — and after turbo (metadata-only) applies it is
    dropped and rebuilt lazily, like the reference's deferred hash graph
    (new.js:1887-1912)."""

    # 'changes' is inherited as a HashGraph slot but shadowed by the
    # property below; storage lives in _changes (see the property note).
    # The hot doc-state fields (heads/clock/max_op/stale/binary_doc/
    # _doc_pending/_parked_n) live in the fleet's _DocCols columns —
    # shadowed here as properties reading this engine's slot row — so
    # the turbo commit updates a whole batch of docs with vectorized
    # scatters instead of per-engine attribute writes.
    # _doc_hashes/_doc_maxops carry the native extractor's per-change
    # hashes/maxOps after a native materialize (in place of the decoded
    # dicts the Python path keeps in _doc_decoded).
    __slots__ = ('fleet', 'slot', 'mirror', 'seq_objects', 'map_objects',
                 '_doc_decoded', '_log', '_defer', '_doc_hashes',
                 '_doc_maxops')

    def __init__(self, fleet, slot):
        # fleet/slot FIRST: every col-backed property setter below (and
        # in HashGraph.__init__) resolves through them
        self.fleet = fleet
        self.slot = slot
        fleet._engines[slot] = self
        self._log = []
        self._defer = []
        super().__init__()
        self.mirror = None        # OpSet, built lazily on first exact use
        self.binary_doc = None
        self.seq_objects = {}     # objectId -> 'text' | 'list'
        self.map_objects = {}     # objectId -> 'map' | 'table'
        # True after a turbo apply (or failed exact apply): the hash graph
        # and device state are current but the mirror is not; reads rebuild
        self.stale = False
        # Bulk document load (fleet/loader.py) installs device state without
        # touching the change log: the original document chunk parks here and
        # the per-change buffers materialize only when history is actually
        # read (the deferred-hash-graph load of ref new.js:1709-1749)
        self._doc_pending = None

    @classmethod
    def _bulk_new(cls, fleet, slot):
        """Allocation-only constructor for init_docs: __new__ + the same
        attribute sets as __init__, skipping the constructor call chain
        (measurable at 10k+ docs). MUST stay equivalent to
        __init__/HashGraph.__init__ — test_bulk_init_matches_constructor
        pins the attribute-set equivalence. Column-backed fields
        (heads/clock/max_op/stale/binary_doc/_doc_pending) are NOT set
        here: the caller's alloc_slots already reset their rows in one
        vectorized pass (`_DocCols.reset_rows`)."""
        e = cls.__new__(cls)
        e.fleet = fleet
        e.slot = slot
        fleet._engines[slot] = e
        # HashGraph.__init__ body (column-backed fields via reset_rows)
        e.actor_ids = []
        e.queue = []
        e._log = []
        e.changes_meta = []
        e.change_index_by_hash = {}
        e.dependencies_by_hash = {}
        e.dependents_by_hash = {}
        e.hashes_by_actor = {}
        e._defer = []
        # _FlatEngine.__init__ body
        e.mirror = None
        e.seq_objects = {}
        e.map_objects = {}
        return e

    # -- column-backed doc state (struct-of-arrays; see _DocCols) -------

    @property
    def max_op(self):
        return int(self.fleet.doc_cols.maxop[self.slot])

    @max_op.setter
    def max_op(self, v):
        self.fleet.doc_cols.maxop[self.slot] = v

    @property
    def stale(self):
        return bool(self.fleet.doc_cols.stale[self.slot])

    @stale.setter
    def stale(self, v):
        self.fleet.doc_cols.stale[self.slot] = v

    @property
    def binary_doc(self):
        return self.fleet.doc_cols.bindoc[self.slot]

    @binary_doc.setter
    def binary_doc(self, v):
        self.fleet.doc_cols.bindoc[self.slot] = v

    @property
    def _doc_pending(self):
        return self.fleet.doc_cols.pend_doc[self.slot]

    @_doc_pending.setter
    def _doc_pending(self, v):
        self.fleet.doc_cols.pend_doc[self.slot] = v

    @property
    def _parked_n(self):
        return int(self.fleet.doc_cols.parked_n[self.slot])

    @_parked_n.setter
    def _parked_n(self, v):
        self.fleet.doc_cols.parked_n[self.slot] = v

    @property
    def heads(self):
        """The head frontier as the usual sorted-hex list. Materialized
        lazily from the binary column (memoized per generation); treat
        the returned list as read-only — replace it via assignment, as
        every existing writer does."""
        cols = self.fleet.doc_cols
        r = self.slot
        memo = cols.head_obj[r]
        if memo is None:
            lanes = cols.head32[r]
            memo = [lanes[l].tobytes().hex() for l in range(cols.head_n[r])]
            cols.head_obj[r] = memo
        return memo

    @heads.setter
    def heads(self, v):
        cols = self.fleet.doc_cols
        r = self.slot
        if type(v) is not list:
            v = list(v)
        cols.head_obj[r] = v
        if len(v) > cols.HEAD_LANES or any(len(h) != 64 for h in v):
            cols.head_n[r] = -1           # attr-mode: past the lanes
            return
        try:
            raw = bytes.fromhex(''.join(v))
        except ValueError:
            cols.head_n[r] = -1           # not hex hashes: attr-mode
            return
        cols.head32[r, :len(v)] = np.frombuffer(
            raw, dtype=np.uint8).reshape(len(v), 32)
        cols.head_n[r] = len(v)

    @property
    def clock(self):
        """The vector clock as a dict. Lane-mode rows materialize a
        FRESH dict per read — mutate via whole-dict assignment (the
        pattern every writer uses), never in place."""
        cols = self.fleet.doc_cols
        r = self.slot
        n = cols.ck_n[r]
        if n == -1:
            return cols.ck_obj[r]
        if n == 0:
            return {}
        names = self.fleet._ck_names
        ck_actor = cols.ck_actor
        ck_seq = cols.ck_seq
        return {names[ck_actor[r, l]]: int(ck_seq[r, l]) for l in range(n)}

    @clock.setter
    def clock(self, d):
        cols = self.fleet.doc_cols
        r = self.slot
        n = len(d)
        if 0 < n <= cols.CLOCK_LANES:
            reg = self.fleet._ck_reg
            names = self.fleet._ck_names
            for l, (a, s) in enumerate(d.items()):
                aid = reg.get(a)
                if aid is None:
                    aid = len(names)
                    reg[a] = aid
                    names.append(a)
                cols.ck_actor[r, l] = aid
                cols.ck_seq[r, l] = s
            # clear the tail lanes: the gate/commit lane scans read all
            # CLOCK_LANES, so a SHRINKING assignment (e.g. restore_all
            # rolling back a failed drain) must not leave a stale lane
            # that would hand the gate a phantom seq base
            cols.ck_actor[r, n:] = -1
            cols.ck_n[r] = n
            cols.ck_obj[r] = None
        elif n == 0:
            cols.ck_actor[r, :] = -1
            cols.ck_n[r] = 0
            cols.ck_obj[r] = None
        else:
            cols.ck_n[r] = -1
            cols.ck_obj[r] = d

    # -- lazily-folded change log (see _SeamSegs) -----------------------

    def _fold_pending(self):
        """Splice this doc's pending turbo-commit segments into the real
        log + deferred-graph records (commit order preserved). Runs only
        when something genuinely reads or extends history — the hot
        write path never pays it."""
        fleet = self.fleet
        r = self.slot
        if not fleet.doc_cols.pend_n[r]:
            return
        log = self._log
        defer = self._defer
        compact = False
        for seg in fleet._pend_seams:
            ent = seg.rowmap.pop(r, None)
            if ent is None:
                continue
            start, stop, base = ent
            log.extend(seg.buffers[start:stop])
            defer.append((base, seg.meta, range(start, stop)))
            if not seg.rowmap:
                compact = True
        fleet.doc_cols.pend_n[r] = 0
        if compact:
            fleet._pend_seams = [s for s in fleet._pend_seams if s.rowmap]

    @property
    def _changes(self):
        if self.fleet.doc_cols.pend_n[self.slot]:
            self._fold_pending()
        return self._log

    @_changes.setter
    def _changes(self, value):
        # fold-then-replace: an overwrite must never silently drop
        # pending accepted appends (every real caller reads first, so
        # the fold is a no-op there; this is belt-and-braces)
        if self.fleet.doc_cols.pend_n[self.slot]:
            self._fold_pending()
        self._log = value

    @property
    def _deferred(self):
        if self.fleet.doc_cols.pend_n[self.slot]:
            self._fold_pending()
        return self._defer

    @_deferred.setter
    def _deferred(self, value):
        self._defer = value

    # The change log is a property so a bulk-loaded document's history can
    # stay unmaterialized until something genuinely reads or extends it
    # (sync, save-after-edit, mirror rebuilds, clone, further applies).
    @property
    def changes(self):
        if self._doc_pending is not None:
            self._materialize_doc()
        return self._changes

    @changes.setter
    def changes(self, value):
        self._changes = value

    def _materialize_doc(self):
        """Expand the parked document chunk into the real change log
        prefix (runs at most once per parked generation, and only when
        history is genuinely read). The native extractor (codec.cpp
        am_extract_changes) splits the chunk into canonical per-change
        buffers + hashes directly — byte-identical to the Python
        decode_document + encode_change round trip it replaces, ~5-10x
        faster (the delta+main materialize kernel); docs outside the
        native subset fall back to the Python path transparently. Changes
        appended while parked (the delta tail — see apply_changes_docs'
        commit loop) stay in _changes and the extracted prefix splices in
        front of them. Attributed three ways: a `doc_materialize` span,
        `metrics.seconds['doc_materializations']`, and the
        `doc_materialize_s` histogram."""
        chunk = self._doc_pending
        if chunk is None:
            return
        self._doc_pending = None
        metrics = self.fleet.metrics
        metrics.doc_materializations += 1
        start = time.perf_counter()
        tail = self._changes
        used_native = False
        with _span('doc_materialize', slot=self.slot,
                   durable_id=getattr(self, '_dur_id', None),
                   chunk_bytes=len(chunk)):
            extracted = native.extract_changes([chunk]) \
                if native.available() else None
            if extracted is not None and extracted[0] is not None:
                buffers, hashes, max_ops = extracted[0]
                self._changes = buffers + tail
                self._doc_decoded = None
                self._doc_hashes = hashes
                self._doc_maxops = max_ops
                used_native = True
            else:
                from ..columnar import decode_document, encode_change
                decoded = decode_document(chunk)
                self._changes = [encode_change(ch) for ch in decoded] + tail
                self._doc_decoded = decoded
        elapsed = time.perf_counter() - start
        metrics.seconds['doc_materializations'] = \
            metrics.seconds.get('doc_materializations', 0.0) + elapsed
        if used_native:
            metrics.seconds['doc_materializations_native'] = \
                metrics.seconds.get('doc_materializations_native', 0.0) + \
                elapsed
        _hist.record_value('doc_materialize_s', elapsed, scale=1e9,
                           unit='s')

    def _install_parked_chunk(self, chunk, n_changes):
        """THE parked form, in one place (loader bulk-load and park_docs
        both install it): host history collapses to the document chunk —
        change log empty, graph dicts empty, one full-range deferred
        record resolving through the chunk, mirrors and any previously
        decoded history dropped. Causal state (heads/clock/max_op/
        actor_ids) is NOT touched; callers own it."""
        from .loader import _DocDeferredBatch
        ix = self.fleet._hash_index
        if ix is not None:
            # the slot's history representation is being replaced
            # wholesale; drop its membership space (a later sync round
            # re-registers and backfills from the chunk's hash lanes)
            ix.drop_slots([self.slot])
        self._changes = []
        self._doc_pending = chunk
        self._doc_decoded = None
        self._doc_hashes = None
        self._doc_maxops = None
        self._parked_n = n_changes
        self.binary_doc = chunk
        self.changes_meta = []
        self.change_index_by_hash = {}
        self.dependencies_by_hash = {}
        self.dependents_by_hash = {}
        self.hashes_by_actor = {}
        self._deferred = [(0, _DocDeferredBatch(self), range(n_changes))] \
            if n_changes else []
        self.mirror = None
        self.stale = True

    def _doc_resolve(self, i):
        """(hash, deps, actor, meta) for _ensure_graph over a bulk-loaded
        document's i-th change. After a NATIVE materialize the decoded
        dicts don't exist; the hash/maxOp come from the extractor's
        arrays and the rest from a header-only decode of the canonical
        change buffer (cheap: no op columns are touched)."""
        self._materialize_doc()
        if self._doc_decoded is None:
            # header + raw column slicing only — no op decode (and
            # extraBytes, which the header-only decode_change_meta
            # doesn't reach, survives into changes_meta)
            from ..columnar import decode_change_columns
            m = decode_change_columns(self._changes[i])
            meta = {
                'actor': m['actor'], 'seq': m['seq'],
                'maxOp': self._doc_maxops[i],
                'time': m.get('time', 0),
                'message': m.get('message') or '',
                'deps': list(m['deps']),
                'extraBytes': m.get('extraBytes'),
            }
            return self._doc_hashes[i], meta['deps'], meta['actor'], meta
        ch = self._doc_decoded[i]
        meta = {
            'actor': ch['actor'], 'seq': ch['seq'],
            'maxOp': ch['startOp'] + len(ch['ops']) - 1,
            'time': ch.get('time', 0), 'message': ch.get('message') or '',
            'deps': list(ch['deps']), 'extraBytes': ch.get('extraBytes'),
        }
        return ch['hash'], meta['deps'], meta['actor'], meta

    @_spanned('mirror_rebuild')
    def _rebuild_mirror(self):
        """Replay the committed log into a fresh OpSet, bypassing the causal
        gate (the log is already in applied order, so no per-change SHA-256
        or dep checks are needed)."""
        mirror = OpSet()
        for buffer in self.changes:
            change = decode_change(bytes(buffer))
            mirror._apply_decoded_change(
                {'_root': {'objectId': '_root', 'type': 'map', 'props': {}}},
                change, set())
        self.mirror = mirror

    def _ensure_mirror(self):
        """Rebuild the mirror after turbo applies. Raises if the committed
        log contains a change turbo could not validate (dangling pred) — see
        apply_changes_docs' trust note."""
        if self.mirror is None and not self.stale and not self.changes:
            self.mirror = OpSet()
            return
        if not self.stale and self.mirror is not None:
            return
        self.fleet.metrics.mirror_rebuilds += 1
        self._rebuild_mirror()
        self.seq_objects = {oid: obj.type
                            for oid, obj in self.mirror.objects.items()
                            if oid != '_root' and obj.is_seq}
        self.map_objects = {oid: obj.type
                            for oid, obj in self.mirror.objects.items()
                            if oid != '_root' and not obj.is_seq}
        # Turbo queue entries carry only metadata; re-decode so the exact
        # drain path can apply their ops when deps arrive
        self.queue = [dict(decode_change(bytes(c['buffer'])), buffer=c['buffer'])
                      if not isinstance(c.get('ops'), list) else c
                      for c in self.queue]
        self.stale = False

    # -- change application --------------------------------------------

    def _ensure_graph(self):
        if self._deferred:
            self.fleet.metrics.graph_builds += 1
        super()._ensure_graph()

    # Frontier-index maintenance (fleet/hashindex.py): every path that
    # lands an APPLIED change on this engine stages its hash — the
    # general/exact paths per change here, the turbo fast path as one
    # vectorized batch in the commit. One attribute check when no index
    # exists.

    def _record_applied(self, change):
        super()._record_applied(change)
        ix = self.fleet._hash_index
        if ix is not None:
            ix.stage_one(self.slot, change['hash'])

    def _defer_record(self, change):
        super()._defer_record(change)
        ix = self.fleet._hash_index
        if ix is not None:
            ix.stage_one(self.slot, change['hash'])

    def probe_hashes(self, hashes):
        """Exact membership flags for `hashes` from the fleet's frontier
        index, or None when this doc has no WARM index space (the
        single-doc protocol path must not pay a surprise history
        backfill — the batched driver registers; until then the caller's
        dict path serves) or routing is disabled
        (AUTOMERGE_TPU_FRONTIER_INDEX=0 must pin the classic path on
        EVERY consumer, not just the batched driver)."""
        from .hashindex import frontier_enabled
        ix = self.fleet._hash_index
        if ix is None or not ix.registered(self) or not frontier_enabled():
            return None
        return ix.probe_pairs([self] * len(hashes), list(hashes))

    def apply_changes(self, change_buffers, is_local=False):
        self.fleet.metrics.exact_calls += 1
        decoded = decode_change_buffers(change_buffers)

        # Pre-scan for the supported subset before mutating anything, so
        # promotion to the host engine happens from an untouched state.
        # `made_seq`/`made_map` track objects created earlier in the same
        # batch so ops on them pass the scan.
        made_seq = set(self.seq_objects)
        made_map = set(self.map_objects)
        for change in decoded:
            start, actor = change['startOp'], change['actor']
            for i, op in enumerate(change['ops']):
                self._check_supported(op, made_seq, made_map, ctr=start + i)
                if op['obj'] == '_root' or op['obj'] in made_map or \
                        op['obj'] in made_seq:
                    if op['action'] in _SEQ_MAKE:
                        made_seq.add(f'{start + i}@{actor}')
                    elif op['action'] in _MAP_MAKE:
                        made_map.add(f'{start + i}@{actor}')
        self._ensure_mirror()

        from ..backend.op_set import empty_object_patch
        patches = {'_root': empty_object_patch('_root', 'map')}
        object_ids = set()
        backup = (dict(self.clock), list(self.heads), list(self.queue))
        try:
            all_applied, queue = self._drain_queue(
                decoded,
                lambda change: self.mirror._apply_decoded_change(
                    patches, change, object_ids))
        except Exception:
            self._rollback(backup)
            raise
        self.mirror._setup_patches(patches, object_ids)

        for change in all_applied:
            self._record_applied(change)
            for i, op in enumerate(change['ops']):
                if op['obj'] == '_root' or op['obj'] in self.map_objects \
                        or op['obj'] in self.seq_objects:
                    oid = f"{change['startOp'] + i}@{change['actor']}"
                    if op['action'] in _SEQ_MAKE:
                        self.seq_objects[oid] = OBJECT_TYPE[op['action']]
                    elif op['action'] in _MAP_MAKE:
                        self.map_objects[oid] = OBJECT_TYPE[op['action']]
        self.queue = queue
        self.max_op = max(self.max_op, self.mirror.max_op)
        self.binary_doc = None
        self.fleet.enqueue(self.slot, [c['buffer'] for c in all_applied],
                           [c['actor'] for c in all_applied])

        patch = {'maxOp': self.max_op, 'clock': dict(self.clock),
                 'deps': list(self.heads), 'pendingChanges': len(self.queue),
                 'diffs': patches['_root']}
        if is_local and len(decoded) == 1:
            patch['actor'] = decoded[0]['actor']
            patch['seq'] = decoded[0]['seq']
        return patch

    def _check_supported(self, op, made_seq, made_map, ctr=None):
        """Fleet-resident subset: keyed set/del/inc plus nested
        makeMap/makeTable/makeText/makeList on the root map or any
        registered map/table object (map trees intern as (objectId, key)
        grid columns), and element ops on registered sequence objects.
        Anything else (objects inside sequences, link ops) promotes to the
        host engine.

        Counter headroom: the LWW grid rebases its packing window per slot
        (unbounded history), but the sequence rows and the exact-device
        register engine pack raw counters — ops at or past CTR_LIMIT on
        those paths promote cleanly here, BEFORE any state mutates."""
        action = op['action']
        if action == 'link':
            # Reserved wire-table action the reference never applies
            # (new.js:893 TODO). Reject here in the pre-scan — before the
            # _Unsupported promotion path — so a bogus change cannot cost
            # the document its device slot (see PARITY.md).
            raise ValueError('link operations are not supported')
        if op['obj'] == '_root' or op['obj'] in made_map:
            if op.get('insert') or op.get('key') is None:
                raise _Unsupported()
            if ctr is not None and ctr >= CTR_LIMIT and \
                    (self.fleet.exact_device or action in _SEQ_MAKE):
                raise _Unsupported()
            if action in _SEQ_MAKE or action in _MAP_MAKE:
                return
            if action not in _FLAT_ACTIONS:
                raise _Unsupported()
            if action == 'inc':
                # The device value column carries inc deltas inline as int32
                delta = op.get('value', 0)
                if not isinstance(delta, int) or isinstance(delta, bool) or \
                        not -(1 << 31) < delta < (1 << 31):
                    raise _Unsupported()
            return
        if op['obj'] not in made_seq:
            raise _Unsupported()
        if action in _SEQ_MAKE or action in _MAP_MAKE:
            # Nested object as a sequence element: the element value links
            # to the child, which interns like any registered object
            if op.get('key') is not None:
                raise _Unsupported()
        elif action not in ('set', 'del', 'inc') or op.get('key') is not None:
            raise _Unsupported()
        if ctr is not None and ctr >= CTR_LIMIT:
            raise _Unsupported()      # sequence rows pack raw counters

    def _rollback(self, backup):
        """Restore gate state; the partially-mutated mirror rebuilds lazily
        from the (unmodified) committed log. The device never saw the failed
        call; enqueue happens only on success."""
        self.clock, self.heads, self.queue = backup
        self.stale = True

    # -- reads ----------------------------------------------------------

    def get_patch(self):
        diffs = self._register_patch_diffs()
        if diffs is not None:
            return {'maxOp': self.max_op, 'clock': dict(self.clock),
                    'deps': list(self.heads),
                    'pendingChanges': len(self.queue), 'diffs': diffs}
        self._ensure_mirror()
        patch = self.mirror.get_patch()
        patch['maxOp'] = max(self.max_op, self.mirror.max_op)
        patch['clock'] = dict(self.clock)
        patch['deps'] = list(self.heads)
        patch['pendingChanges'] = len(self.queue)
        return patch

    def _register_patch_diffs(self):
        """Whole-doc patch diffs straight from the device state (exact
        mode) — no mirror rebuild. The device's visible register lanes
        become pseudo op rows fed through the host engine's OWN patch
        machinery (`op_set._update_patch_property`, ref new.js:884-1040 /
        documentPatch :1604-1635), so the patch grammar is identical by
        construction. Returns None when the mirror must serve instead:
        non-register fleets, device-inexact rows, or payloads the device
        lanes can't represent."""
        fleet = self.fleet
        if not fleet.exact_device:
            return None
        fleet.flush()
        empty = {'objectId': '_root', 'type': 'map', 'props': {}}
        # emptiness check must not touch the changes property: on a
        # bulk-loaded doc that would materialize the whole parked chunk
        # just to answer a question the device state answers anyway
        if self._doc_pending is None and not self._changes:
            return empty
        if fleet.reg_state is None:
            return empty
        if self.slot >= fleet.reg_state.inexact.shape[0]:
            # Past the register state's doc capacity: the mirror serves
            return None
        if bool(fleet.reg_state.inexact[self.slot]):
            return None
        try:
            return self._device_patch_diffs()
        except _Unsupported:
            return None

    def _device_patch_diffs(self):
        """Assemble the whole-doc diff tree from device register/sequence
        lanes via the host patch machinery. Raises _Unsupported for any
        shape the lanes can't serve exactly (callers use the mirror)."""
        from ..backend.op_set import OpSet, ObjState, _utf16_key, root_meta
        from ..common import lamport_key
        from .registers import _patch_leaf
        from .tensor_doc import unpack_op_id
        fleet = self.fleet
        n_keys = len(fleet.keys)
        reg, killed, value, counter = (
            t[self.slot, :n_keys].cpu().numpy()
            for t in fleet.reg_state.tensors()[:4])
        visible = (reg != 0) & ~killed

        def op_id_str(packed):
            ctr, num = unpack_op_id(int(packed))
            return f'{ctr}@{fleet.actors.actors[num]}'

        def lane_row(packed, raw, cnt, base, char=None):
            """Pseudo op row for one live register lane. `char` carries an
            inline text code point already decoded (so reads never intern
            into the shared value table)."""
            row = dict(base)
            row['id'] = op_id_str(packed)
            row['succ'] = []
            if char is not None:
                row['action'] = 'set'
                row['value'] = char
                return row, None
            boxed = fleet.value_table[-raw - 2] if raw <= -2 else raw
            if isinstance(boxed, _SeqLink):
                oid = boxed.object_id
                row['action'] = 'makeText' \
                    if self.seq_objects.get(oid) == 'text' else 'makeList'
                return row, oid
            if isinstance(boxed, _MapLink):
                row['action'] = 'makeTable' if boxed.kind == 'table' \
                    else 'makeMap'
                return row, boxed.object_id
            leaf = _patch_leaf(int(raw), int(cnt), fleet.value_table)
            if leaf is None:
                raise _Unsupported('payload outside device lanes')
            row['action'] = 'set'
            row['value'] = leaf['value']
            if 'datatype' in leaf:
                row['datatype'] = leaf['datatype']
            return row, None

        # group this doc's live cells by (object, key)
        cells = {}                  # object_id -> {key: [(packed, lane)]}
        for k in np.flatnonzero(visible.any(axis=-1)):
            key = fleet.keys.keys[int(k)]
            obj, key_str = key if isinstance(key, tuple) else ('_root', key)
            lanes = sorted((int(reg[k, s]), int(s))
                           for s in np.flatnonzero(visible[k]))
            cells.setdefault(obj, {})[key_str] = [(p, s, int(k))
                                                  for p, s in lanes]
        # cells are fleet-global: keep only THIS doc's objects (root keys
        # are per-slot because register rows are per-slot; nested keys are
        # (oid, key) and oids are globally unique)
        mine = {'_root'} | set(self.map_objects) | set(self.seq_objects)
        cells = {obj: kv for obj, kv in cells.items() if obj in mine}

        # reachability from root through live make lanes
        shim = OpSet()
        shim.objects = {'_root': ObjState('map')}
        for oid, typ in self.map_objects.items():
            shim.objects[oid] = ObjState(typ)
        for oid, typ in self.seq_objects.items():
            shim.objects[oid] = ObjState(typ)

        seq_rows_data = self._fetch_seq_rows()
        object_order = ['_root'] + sorted(
            set(self.map_objects) | set(self.seq_objects), key=lamport_key)
        object_meta = {'_root': root_meta()}
        patches = {'_root': {'objectId': '_root', 'type': 'map',
                             'props': {}}}
        for object_id in object_order:
            obj = shim.objects[object_id]
            prop_state = {}
            if obj.is_seq:
                if object_id not in object_meta:
                    continue          # unreachable (overwritten) object
                data = seq_rows_data.get(object_id)
                if data is None:
                    raise _Unsupported('sequence rows unavailable')
                list_index = 0
                for elem_packed, elem_lanes in data:
                    elem_str = op_id_str(elem_packed)
                    vis_elem = False
                    for packed, raw, cnt, char, n_incs, dead in elem_lanes:
                        # object elements (rows-in-lists) flow through the
                        # same make-row path the map cells use: the child
                        # registers in object_meta and its own rows link
                        # in when its (later) object_id is processed
                        base = {'insert': True} if packed == elem_packed \
                            else {'insert': False, 'elemId': elem_str}
                        if n_incs == 0:
                            row, _child = lane_row(packed, raw, cnt, base,
                                                   char)
                            shim._update_patch_property(
                                patches, object_id, row, prop_state,
                                list_index, 0, object_meta, whole_doc=True)
                        else:
                            # Replay the reference's counterStates walk
                            # (new.js:936-965): the counter set with its
                            # inc succs, then the incs — the edit shape
                            # (insert for one consumed inc, the transient
                            # remove->update for two or more, the phantom
                            # remove of a deleted inc'd counter) falls
                            # out of the same ported machinery. A dead
                            # lane gets an extra never-consumed del succ
                            # so its counter state never completes.
                            opid = op_id_str(packed)
                            base_row, _child = lane_row(packed, raw, 0,
                                                        base, char)
                            if base_row.get('datatype') != 'counter':
                                raise _Unsupported('inc on non-counter')
                            succs = [f'{opid}+inc{i}'
                                     for i in range(n_incs)]
                            all_succs = succs + ([f'{opid}+del'] if dead
                                                 else [])
                            base_row['succ'] = all_succs
                            shim._update_patch_property(
                                patches, object_id, base_row, prop_state,
                                list_index, len(all_succs), object_meta,
                                whole_doc=True)
                            for i, sid in enumerate(succs):
                                inc_row = {
                                    'id': sid, 'succ': [], 'action': 'inc',
                                    'insert': False, 'elemId': elem_str,
                                    'value': cnt if i == n_incs - 1 else 0,
                                }
                                shim._update_patch_property(
                                    patches, object_id, inc_row,
                                    prop_state, list_index, 0, object_meta,
                                    whole_doc=True)
                        # a dead inc'd counter lane still counts: its inc
                        # rows are succ-free, so the host walk treats the
                        # element as visible and bumps the index past the
                        # phantom remove
                        vis_elem = True
                    if vis_elem:
                        list_index += 1
            else:
                if object_id != '_root' and object_id not in object_meta:
                    continue          # unreachable (overwritten) object
                for key_str in sorted(cells.get(object_id, {}),
                                      key=_utf16_key):
                    for packed, s, k in cells[object_id][key_str]:
                        row, _child = lane_row(packed, int(value[k, s]),
                                               int(counter[k, s]),
                                               {'key': key_str,
                                                'insert': False})
                        shim._update_patch_property(
                            patches, object_id, row, prop_state, 0, 0,
                            object_meta, whole_doc=True)
        return patches['_root']

    def _fetch_seq_rows(self):
        """Read this doc's sequence rows off the device: {objectId:
        [(elem packed id, [(packed, raw, counter_sum, char, n_incs,
        dead)])] in RGA order}. `char` is the decoded inline text code
        point (None for table-boxed payloads — reads never write the
        shared value table); `n_incs` is the consumed-inc count (0, 1,
        or 2 meaning "two or more"); `dead` marks killed inc'd counter
        lanes, which ride along because the reference's dangling inc
        rows still shape the whole-doc patch. Raises _Unsupported when
        a row is device-inexact."""
        from .sequence import HEAD, END
        fleet = self.fleet
        rows_map = fleet.slot_seq.get(self.slot, {})
        out = {}
        if not rows_map:
            return out
        for oid, row in rows_map.items():
            place = fleet.seq_place[row]
            if place is None:
                out[oid] = []          # allocated but never written: empty
                continue
            st = fleet.seq_pools.state(place[0])
            idx = place[1]
            if bool(st.inexact[idx]):
                raise _Unsupported('sequence row inexact')
            # one transfer for the row's six arrays (not six round-trips)
            nodes, a = st.reg.shape[1:]
            host = torch.cat([st.elem_id[idx].unsqueeze(1),
                              st.nxt[idx].unsqueeze(1), st.reg[idx],
                              st.killed[idx].to(torch.int32), st.val[idx],
                              st.counter[idx]], dim=1).cpu().numpy()
            elem_id, nxt = host[:, 0], host[:, 1]
            reg, killed, val, cnt = (host[:, 2 + k * a:2 + (k + 1) * a]
                                     for k in range(4))
            killed = killed != 0
            is_text = self.seq_objects.get(oid) == 'text'
            elems = []
            node = int(nxt[HEAD])
            hops = 0
            limit = elem_id.shape[0]
            while node != END and hops <= limit:
                lanes = []
                live = (reg[node] != 0) & ~killed[node]
                # Dead lanes whose op consumed incs still shape the
                # whole-doc patch: the reference's dangling inc rows emit
                # a phantom remove (converted to update by a surviving
                # lane), so they ride along marked dead
                dead_incd = (reg[node] != 0) & killed[node] & \
                    ((cnt[node] & 3) != 0)
                for s in np.flatnonzero(live | dead_incd):
                    raw = int(val[node, s])
                    char = chr(raw) if is_text and raw >= 0 else None
                    # counter lanes bit-pack (sum << 2) | count-bits
                    # (0, 1, or 3; 3 = two or more); the count rides along
                    # so the patch walk can replay the reference's
                    # counterStates edit shapes
                    bits = int(cnt[node, s]) & 3
                    lanes.append((int(reg[node, s]), raw,
                                  int(cnt[node, s]) >> 2, char,
                                  2 if bits == 3 else bits,
                                  bool(dead_incd[s])))
                lanes.sort(key=lambda lane: lane[0])
                elems.append((int(elem_id[node]), lanes))
                node = int(nxt[node])
                hops += 1
            if hops > limit:
                raise _Unsupported('corrupt sequence chain')
            out[oid] = elems
        return out

    def materialize(self):
        """Exact current {key: value} view (LWW winner per key,
        ascending-Lamport max, frontend/apply_patch.js:33-42); sequence
        values render to str (text) / list. get_patch serves from the
        device registers when it can and rebuilds the mirror itself when it
        can't, so no mirror work happens here."""
        from ..common import lamport_key
        doc = {}
        for key, candidates in self.get_patch()['diffs'].get('props',
                                                             {}).items():
            if candidates:
                winner = max(candidates.keys(), key=lamport_key)
                doc[key] = _leaf_value(candidates[winner])
        return doc

    def save(self):
        """Canonical document container serialization. The native builder
        (codec.cpp am_build_document) parses the change log, replays it into
        a succ-annotated op store, and emits the chunk entirely in C++ — no
        host mirror; histories it can't represent (link/child ops, unknown
        columns) fall back to the mirror path, which is the same bytes by
        construction (differential-tested)."""
        if self.binary_doc is None:
            if native.available():
                built = native.build_document(
                    [bytes(b) for b in self.changes], self.heads)
                if built is not None:
                    self.binary_doc = built
                    return self.binary_doc
            self._ensure_mirror()
            self._ensure_graph()
            m = self.mirror
            m.changes = self.changes
            m.changes_meta = self.changes_meta
            m.change_index_by_hash = self.change_index_by_hash
            m.heads = list(self.heads)
            m.clock = dict(self.clock)
            m.binary_doc = None
            self.binary_doc = m.save()
        return self.binary_doc

    def clone_engine(self):
        self._ensure_mirror()
        self._ensure_graph()
        other = _FlatEngine(self.fleet, self.fleet.clone_slot(self.slot))
        for field in ('max_op', 'actor_ids', 'heads', 'clock', 'queue',
                      'changes', 'changes_meta', 'change_index_by_hash',
                      'dependencies_by_hash', 'dependents_by_hash',
                      'hashes_by_actor', 'mirror', 'seq_objects',
                      'map_objects'):
            setattr(other, field, copy.deepcopy(getattr(self, field)))
        return other


class FleetDoc:
    """A Backend-contract document handle routed through the device fleet.

    Wraps either a _FlatEngine (fleet mode) or, after promotion, a host
    OpSet. All HashGraph state is exposed as properties so handles stay
    valid across promotion, and so host-backed and fleet-backed documents
    interoperate (merge, sync) freely."""

    # _dur_id: durable doc id assigned by an attached ChangeJournal
    # (fleet/durability.py); set lazily, survives promotion and slot reuse
    __slots__ = ('fleet', '_impl', '_dur_id')

    def __init__(self, fleet, impl=None):
        self.fleet = fleet
        self._impl = impl if impl is not None else \
            _FlatEngine(fleet, fleet.alloc_slot())

    # HashGraph state passthrough (valid across promotion)
    heads = property(lambda self: self._impl.heads)
    clock = property(lambda self: self._impl.clock)
    queue = property(lambda self: self._impl.queue)
    changes = property(lambda self: self._impl.changes)
    max_op = property(lambda self: self._impl.max_op)
    actor_ids = property(lambda self: self._impl.actor_ids)

    def _graph_dict(name):
        # The index dicts materialize lazily after turbo applies
        def get(self):
            self._impl._ensure_graph()
            return getattr(self._impl, name)
        return property(get)

    changes_meta = _graph_dict('changes_meta')
    change_index_by_hash = _graph_dict('change_index_by_hash')
    dependencies_by_hash = _graph_dict('dependencies_by_hash')
    dependents_by_hash = _graph_dict('dependents_by_hash')
    hashes_by_actor = _graph_dict('hashes_by_actor')
    del _graph_dict

    @property
    def is_fleet(self):
        return isinstance(self._impl, _FlatEngine)

    def promote(self):
        """Replay this document into the host OpSet engine and delegate all
        further calls to it (the escape hatch for non-flat documents)."""
        if not self.is_fleet:
            return self._impl
        impl = self._impl
        impl.fleet.metrics.promotions += 1
        ops = OpSet()
        if impl.changes:
            ops.apply_changes([bytes(b) for b in impl.changes])
        for change in impl.queue:
            ops.apply_changes([change['buffer']])
        self.fleet.free_slot(impl.slot)
        self._impl = ops
        return ops

    def apply_changes(self, change_buffers, is_local=False):
        change_buffers = list(change_buffers)
        if self.is_fleet:
            try:
                patch = self._impl.apply_changes(change_buffers, is_local)
                self._journal_accepted(change_buffers)
                return patch
            except _Unsupported:
                self.promote()
        patch = self._impl.apply_changes(change_buffers, is_local)
        self._journal_accepted(change_buffers)
        return patch

    def _journal_accepted(self, buffers):
        """Durability seam hook: record the buffers this call accepted
        (applied or causally queued — replay reproduces either) in the
        fleet's attached change journal. Rejected calls raise before
        reaching here, so the journal never holds refused bytes."""
        journal = self.fleet.journal
        if journal is not None and buffers:
            journal.record_changes(self, buffers)

    def get_patch(self):
        return self._impl.get_patch()

    def get_changes(self, have_deps):
        return self._impl.get_changes(have_deps)

    def get_change_hashes(self, have_deps):
        return self._impl.get_change_hashes(have_deps)

    def get_changes_added(self, other):
        return self._impl.get_changes_added(other)

    def get_change_by_hash(self, hash):
        return self._impl.get_change_by_hash(hash)

    def probe_hashes(self, hashes):
        """Frontier-index membership flags (see _FlatEngine.probe_hashes);
        None after promotion or while the index is cold."""
        probe = getattr(self._impl, 'probe_hashes', None)
        return probe(hashes) if probe is not None else None

    def get_missing_deps(self, heads=()):
        return self._impl.get_missing_deps(heads)

    def save(self):
        return self._impl.save()

    def clone(self):
        if self.is_fleet:
            out = FleetDoc(self.fleet, self._impl.clone_engine())
        else:
            out = FleetDoc(self.fleet, self._impl.clone())
        journal = self.fleet.journal
        if journal is not None:
            # the clone is a NEW durable document whose history predates
            # its first journaled change: baseline it with one document
            # chunk, plus its causally-held-back queue buffers — the
            # original's queue records live under the ORIGINAL's durable
            # id, so the clone must carry its own copies or a crash
            # before the next checkpoint would drop them
            bufs = [bytes(out.save())]
            for entry in out.queue or []:
                if isinstance(entry, dict) and \
                        entry.get('buffer') is not None:
                    bufs.append(bytes(entry['buffer']))
            journal.record_changes(out, bufs)
        return out

    def free(self):
        journal = self.fleet.journal
        if journal is not None:
            journal.record_free(self)
        if self.is_fleet:
            self.fleet.free_slot(self._impl.slot)
        self._impl = None

    def materialize(self):
        """Exact current {key: value} state (host mirror when in fleet mode,
        whole-doc patch walk after promotion); nested objects render to
        plain Python values (str for text, list, dict for maps)."""
        if self.is_fleet:
            return self._impl.materialize()
        patch = self._impl.get_patch()
        return _leaf_value(patch['diffs'])


# ----------------------------------------------------------------------
# Backend-contract module surface (ref backend/index.js:1-8): identical to
# automerge_tpu_torch.backend but init/load build fleet-routed documents.
# Pass this module (or a FleetBackend instance) to
# automerge_tpu_torch.set_default_backend.
# ----------------------------------------------------------------------

_default_fleet = None


def default_fleet():
    """The module-level fleet, built on first use (on CUDA: a machine
    with no card raises here, not at import)."""
    global _default_fleet
    if _default_fleet is None:
        _default_fleet = DocFleet()
    return _default_fleet


from ..backend import (  # noqa: E402
    _backend_state, apply_changes, apply_local_change, save,
    load_changes, get_patch, get_heads, get_all_changes, get_changes,
    get_changes_added, get_change_by_hash, get_missing_deps,
    generate_sync_message, receive_sync_message, encode_sync_message,
    decode_sync_message, init_sync_state, encode_sync_state,
    decode_sync_state, BloomFilter,
)


def init(fleet=None):
    return {'state': FleetDoc(fleet or default_fleet()), 'heads': []}


def load(data, fleet=None):
    handle = init(fleet)
    state = handle['state']
    state.apply_changes([data])
    return {'state': state, 'heads': state.heads}


def clone(backend):
    return {'state': _backend_state(backend).clone(),
            'heads': backend['heads']}


def free(backend):
    backend['state'].free()
    backend['state'] = None
    backend['frozen'] = True


class FleetBackend:
    """Object-style backend (equivalent to this module) bound to its own
    DocFleet — for isolating fleets or injecting a custom-capacity one."""

    def __init__(self, fleet=None):
        self.fleet = fleet or DocFleet()

    def init(self):
        return init(self.fleet)

    def load(self, data):
        return load(data, self.fleet)

    def __getattr__(self, name):
        import sys
        return getattr(sys.modules[__name__], name)


# ----------------------------------------------------------------------
# Fleet-level batched API: the TPU-idiomatic entry point
# ----------------------------------------------------------------------

@contextlib.contextmanager
def _gc_paused():
    """CPython's generational GC fires every ~700 net container
    allocations; a 10k-doc bulk init or commit allocates ~10^5 containers,
    paying ~170 gen-0 scans of an ever-growing heap — measured 4-7x the
    useful work of init_docs itself. Pause collection across the bounded
    bulk phase: everything allocated inside is live on exit, so the
    skipped scans could not have freed anything anyway. Reentrant-safe
    (restores the prior state), exception-safe (finally)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def init_docs(n, fleet=None):
    """Create n fleet documents sharing one device fleet, with O(1)
    (size-independent) device work.

    Bulk-constructs the engines via _FlatEngine._bulk_new instead of
    going through init(): the per-doc constructor chain (init -> FleetDoc
    -> _FlatEngine -> HashGraph -> alloc_slot) costs ~8us/doc in CPython,
    which at 10k+ docs is a measurable slice of the turbo seam; pausing
    the GC across the loop saves another 4-7x (see _gc_paused). Slot
    numbers come from ONE alloc_slots call, and when the fleet already
    holds device state it is pre-grown to the new slot count in one step
    here — n fresh docs would otherwise regrow the [docs, keys] state
    O(log n) times across their first flushes. (A fleet with no device
    state yet keeps its lazy allocation: the first flush allocates at
    full capacity in one step, and seq-only fleets never pay for a grid.)"""
    fleet = fleet or default_fleet()
    out = []
    append = out.append
    bulk_new = _FlatEngine._bulk_new
    with _gc_paused():
        slots = fleet.alloc_slots(n)
        if fleet.state is not None:
            fleet._ensure_capacity(n_docs=fleet.n_slots,
                                   n_keys=len(fleet.keys))
        if fleet.reg_state is not None:
            fleet._ensure_reg_capacity(n_docs=fleet.n_slots,
                                       n_keys=len(fleet.keys))
        for slot in slots:
            d = FleetDoc.__new__(FleetDoc)
            d.fleet = fleet
            d._impl = bulk_new(fleet, slot)
            append({'state': d, 'heads': []})
    return out


@_spanned('free_docs')
def free_docs(handles):
    """Free n fleet documents with O(1) device dispatches: per owning
    fleet, one batched row-zeroing per engine kind (free_slots_batch)
    instead of the per-doc free() chain, which rewrites the whole device
    grid once per document. Handles are frozen like free()."""
    by_fleet = {}
    journals = {}
    for handle in handles:
        state = handle.get('state')
        if isinstance(state, FleetDoc):
            journal = state.fleet.journal
            if journal is not None:
                journal.record_free(state, commit=False)
                journals[id(journal)] = journal
            if state.is_fleet:
                fleet = state.fleet
                by_fleet.setdefault(id(fleet), (fleet, []))[1].append(
                    state._impl.slot)
            state._impl = None
        handle['state'] = None
        handle['frozen'] = True
    for journal in journals.values():
        journal.commit()          # one group commit for the whole batch
    for fleet, slots in by_fleet.values():
        fleet.free_slots_batch(slots)


def host_memory_stats(handles):
    """Host-RAM accounting for fleet documents (round-5 VERDICT item 8):
    what the HOST keeps per doc alongside the device state. Returns a
    dict of byte totals: change logs (the source of truth), rebuilt host
    mirrors (only docs something has read exactly), parked document
    chunks (bulk loads), plus the owning fleet's host-side structures
    (winner mirror, applied-op index, value table entry count). Device
    bytes live in DocFleet.memory_stats()."""
    log_bytes = queue_bytes = parked_bytes = 0
    mirrors = decoded = 0
    fleet = None
    for handle in handles:
        state = handle.get('state')
        if not isinstance(state, FleetDoc) or not state.is_fleet:
            continue
        impl = state._impl
        fleet = impl.fleet
        if impl._doc_pending is not None:
            parked_bytes += len(impl._doc_pending)
        # a parked doc's _changes holds its delta TAIL (changes accepted
        # since parking); both forms count — they are both host RAM
        log_bytes += sum(len(b) for b in impl._changes)
        for q in impl.queue:
            buf = q.get('buffer') if isinstance(q, dict) else None
            if buf is not None:
                queue_bytes += len(buf)
        if impl.mirror is not None:
            mirrors += 1
        if getattr(impl, '_doc_decoded', None) is not None:
            decoded += 1
    out = {
        'change_log_bytes': log_bytes,
        'parked_doc_bytes': parked_bytes,
        'queue_bytes': queue_bytes,
        'docs_with_host_mirror': mirrors,
        # rematerialized histories pin their decoded change dicts (larger
        # than the binary log) until the next park_docs — visible here so
        # the accounting cannot claim reclaim while they linger
        'docs_with_decoded_history': decoded,
        'n_docs': len(handles),
    }
    if fleet is not None:
        if fleet.host_winners is not None:
            out['host_winner_mirror_bytes'] = int(fleet.host_winners.nbytes)
        out['op_index_bytes'] = int(
            sum(a.nbytes for a in fleet._op_index.values()) +
            sum(p[1].nbytes for p in fleet._op_index_pending))
        out['value_table_entries'] = len(fleet.value_table)
    return out


def park_docs(handles):
    """Demote cold documents to their canonical saved chunk — the
    loader's parked form (`_doc_pending`), made available to LIVE docs:
    the host-side change log, deferred hash-graph records, graph dicts,
    and read mirrors collapse into ONE compressed document chunk per doc
    (BASELINE.md's 100k-doc host-memory plan, operational). Device state
    is untouched and causal state (heads/clock/maxOp/actorIds) stays
    live, so parked docs keep accepting changes through the turbo gate,
    serving sync, and answering bulk device reads; any history read
    rematerializes the log lazily from the chunk (the same machinery
    bulk-loaded documents already exercise, ref new.js:1709-1749 — the
    deferred document-chunk load). A history read or a new change
    REVIVES the host log (appending needs the change list); revived docs
    show up in host_memory_stats (change_log_bytes,
    docs_with_decoded_history) and re-park on the next park_docs call —
    parking is a policy the caller applies to docs it believes are cold,
    not a one-way compression.

    Soundness: the chunk is round-trip-validated once at park time — the
    native extractor reconstructs every change canonically and verifies
    the re-encoded hash frontier against the header heads (codec.cpp
    am_extract_changes; Python `decode_document` does the identical check
    when the native codec is absent or bails) — so a doc whose history
    cannot round-trip (e.g. foreign non-canonically-encoded changes) is
    left live rather than parked. The change COUNT comes from the same
    extraction instead of a full Python decode (the old
    decode-every-change-just-to-record-n cost). Docs with queued changes
    are skipped; an already-parked doc re-parks only when it has accrued
    a delta tail (changes accepted while parked), folding the tail into
    a fresh chunk. Returns the number of docs parked."""
    parked = 0
    flushed = set()
    cands = []                   # (impl, chunk) pending batch validation
    for handle in handles:
        state = handle.get('state')
        if not isinstance(state, FleetDoc) or not state.is_fleet:
            continue
        impl = state._impl
        fleet = impl.fleet
        if id(fleet) not in flushed:
            fleet.flush()
            flushed.add(id(fleet))
        if impl.queue or not impl._changes:
            # held-back queue entries can't be represented in a chunk;
            # no tail means either an empty doc or already parked clean
            continue
        cands.append((impl, bytes(impl.save())))
    # ONE batched validation for the whole park call: the native
    # extractor fans the chunks over its thread pool instead of paying a
    # per-doc FFI round trip
    counts = _validate_doc_chunks([chunk for _impl, chunk in cands])
    for (impl, chunk), n in zip(cands, counts):
        if n is None:
            continue          # cannot round-trip: stays live
        impl._install_parked_chunk(chunk, n)
        parked += 1
    return parked


def _validate_doc_chunks(chunks):
    """Batched round-trip validation: per chunk, its change count or
    None when the history cannot be reproduced from it (the park-time
    soundness gate). Native extraction validates by construction (heads
    verified against re-encoded hashes) over the thread pool; docs it
    bails on get the identical check from the Python decode."""
    if not chunks:
        return []
    native_out = native.extract_changes(chunks) if native.available() \
        else None
    out = [None] * len(chunks)
    from ..columnar import decode_document
    for i, chunk in enumerate(chunks):
        if native_out is not None and native_out[i] is not None:
            out[i] = len(native_out[i][0])
        else:
            try:
                out[i] = len(decode_document(chunk))
            except Exception:
                out[i] = None
    return out


def rebuild_docs(handles, fleet=None, mirror=False):
    """Recover documents into a fresh fleet from their host-side change
    logs — the donation-failure contract (fleet/apply.py): a failed
    donated dispatch leaves the old fleet's device state unrecoverable,
    but the change logs remain the source of truth, so documents replay
    into new slots. Causally-held-back queue entries re-queue too.
    Returns new handles in input order; the old handles are frozen.

    Durability continuity: each rebuilt document keeps its durable id in
    its OWN source journal's registry (ids are per-journal), so no
    checkpoint ever snapshots the dead pre-rebuild states. When exactly
    one source journal is involved and the target fleet is unjournaled,
    the journal moves across (no baseline records needed — it already
    holds these docs' full accepted-change history, which is exactly
    what the rebuild replayed); with several source journals, or a
    target that already carries its own, the caller must re-home the
    managers explicitly (DurableFleet.adopt_fleet). Source fleets are
    detached either way — they are abandoned by contract."""
    fleet = fleet or DocFleet()
    per_doc, per_doc_queue, src_states, src_journals = [], [], [], []
    journals = {}
    src_fleets = {}
    for handle in handles:
        state = handle['state']
        impl = state._impl if isinstance(state, FleetDoc) else state
        journal = state.fleet.journal if isinstance(state, FleetDoc) \
            else None
        if journal is not None:
            journals[id(journal)] = journal
            src_fleets[id(state.fleet)] = state.fleet
        src_journals.append(journal)
        src_states.append(state)
        per_doc.append([bytes(b) for b in impl.changes])
        per_doc_queue.append([q['buffer'] for q in impl.queue
                              if isinstance(q, dict) and 'buffer' in q])
        handle['frozen'] = True
    for src_fleet in src_fleets.values():
        src_fleet.attach_journal(None)    # abandoned by contract
    new_handles = init_docs(len(handles), fleet)
    new_handles, _ = apply_changes_docs(new_handles, per_doc, mirror=mirror)
    if any(per_doc_queue):
        new_handles, _ = apply_changes_docs(new_handles, per_doc_queue,
                                            mirror=mirror)
    for old, journal, new_handle in zip(src_states, src_journals,
                                        new_handles):
        did = getattr(old, '_dur_id', None)
        if journal is not None and did is not None and \
                journal.docs.get(did) is old:
            new_state = new_handle['state']
            new_state._dur_id = did
            journal.docs[did] = new_state
    if len(journals) == 1 and fleet.journal is None:
        fleet.attach_journal(next(iter(journals.values())))
    return new_handles


# Fault-containment roll-up (observability.health_counts): documents
# rejected by quarantining batch calls, and how many change buffers went
# down with them. Module-level because quarantine also runs over host
# backends with no fleet in sight (the sync driver's receive path).
quarantine_stats = Counters({'quarantined_docs': 0,
                             'rejected_changes': 0})

# ---- memory-watermark tier: fleet-resident state ---------------------------
#
# Every live DocFleet's device grids + register/sequence pools + host
# mirror, summed on demand for the perf observatory's watermark sampler
# (perf.sample_watermarks). The WeakSet itself lives just under the
# import block (a fleet is constructed during module init, before this
# block runs).
def _fleet_bytes(fleet):
    total = 0
    for state in (fleet.state, fleet.reg_state):
        if state is not None:
            total += state.nbytes()
    for state in list(fleet.seq_pools.pools.values()):
        total += state.nbytes()
    if fleet.host_winners is not None:
        total += fleet.host_winners.nbytes
    return total


def fleets_resident_bytes():
    """Resident bytes across every live fleet's device/mirror state."""
    return sum(_fleet_bytes(fleet) for fleet in list(_live_fleets))


register_mem_source('fleet_resident_bytes', fleets_resident_bytes)
register_health_source('quarantined_docs',
                       lambda: quarantine_stats['quarantined_docs'])
register_health_source('rejected_changes',
                       lambda: quarantine_stats['rejected_changes'])


def _first_fleet(handles):
    """The fleet of the first fleet-resident doc among `handles`, or
    None. A turbo batch requires one shared fleet, so this is THE fleet
    (and its journal THE journal)."""
    for handle in handles:
        state = handle.get('state') if isinstance(handle, dict) else None
        if isinstance(state, FleetDoc) and state.is_fleet:
            return state.fleet
    return None


def _journal_of(handles):
    """The attached ChangeJournal of the handles' fleet, or None."""
    fleet = _first_fleet(handles)
    return None if fleet is None else fleet.journal


def apply_changes_docs(handles, per_doc_changes, mirror=True,
                       on_error='raise', deadline=None):
    """Apply per-document change lists across the fleet. Returns
    (see _apply_changes_docs_impl for the full contract). When
    observability is enabled the whole batch records an `apply_batch`
    span and an `apply_batch_s` latency histogram sample. `deadline` (a
    service.deadline.Deadline) is checked HERE, before any parse or
    mutation: an expired deadline raises typed DeadlineExceeded with the
    batch entirely unapplied — the all-or-nothing half of the service's
    deadline contract (work that expires DURING the batch still commits;
    late useful work beats a torn doc)."""
    if deadline is not None:
        deadline.check(what='apply_changes_docs')
    start = time.perf_counter()
    with _span('apply_batch', docs=len(handles), mirror=mirror,
               on_error=on_error):
        out = _apply_changes_docs_impl(handles, per_doc_changes, mirror,
                                       on_error)
    _hist.record_value('apply_batch_s', time.perf_counter() - start,
                       scale=1e9, unit='s')
    return out


def _apply_changes_docs_impl(handles, per_doc_changes, mirror, on_error):
    """Apply per-document change lists across the fleet. Returns
    (new_handles, patches) — or (new_handles, patches, errors) with
    on_error='quarantine', where a bad input rejects ONLY its own doc
    (errors[i] is a DocError; healthy docs commit in the same fused
    dispatch). on_error='raise' keeps the classic batch-fatal contract,
    now with typed exceptions carrying `doc_index`.

    mirror=True (exact): per-doc causal gating and patch mirrors on host,
    then ONE batched ingest + merge dispatch for every document's ops.

    mirror=False (turbo): only change *headers* are decoded on host (hash,
    deps, actor/seq — the causal gate and hash graph stay exact); the op
    columns go straight from the wire through the native C++ parser into the
    device merge, never materializing per-op Python objects. Patches come
    back as None and per-key mirrors are marked stale — reads rebuild them
    lazily. Sync protocol functions need only the hash graph, so they work
    on turbo documents without any rebuild.

    Validation: turbo checks the causal gate (seq contiguity, deps),
    chunk checksums/hashes, intra-batch duplicate opIds, AND map-key pred
    well-formedness — a change whose pred names no existing op row is
    rejected at apply time with the exact path's error and full rollback
    (the per-slot applied-op index, DocFleet._op_index, is the oracle;
    round-5, closing the old trust note). Residual envelope: sequence
    refs/preds drop-and-flag-inexact instead of raising (the mirror
    serves those docs), bulk-loaded docs skip the apply-time check for
    the slot's lifetime (their loaded history never fed the index;
    dangling preds there surface at the next mirror read), and a
    pred-less inc on a non-counter key surfaces at the next mirror read
    rather than at apply."""
    if on_error == 'quarantine':
        return _apply_changes_docs_quarantine(handles, per_doc_changes,
                                              mirror)
    if on_error != 'raise':
        raise ValueError(f"on_error must be 'raise' or 'quarantine', "
                         f"got {on_error!r}")
    if not mirror:
        journal = _journal_of(handles)
        if journal is not None:
            # turbo consumes one-shot iterables into its flat batch;
            # materialize them first so the journal hook sees the bytes.
            # The OUTER sequence materializes before the any() scan — a
            # generator argument would otherwise be consumed by the scan
            # itself and turbo would see an empty batch.
            if not isinstance(per_doc_changes, (list, tuple)):
                per_doc_changes = list(per_doc_changes)
            if any(not isinstance(c, (list, tuple))
                   for c in per_doc_changes):
                per_doc_changes = [c if isinstance(c, (list, tuple))
                                   else list(c) for c in per_doc_changes]
        with _gc_paused():
            turbo = _apply_changes_turbo(handles, per_doc_changes)
            if turbo is not None and journal is not None:
                # inside the GC pause: the ~4 small objects per framed
                # record would otherwise re-trigger the gen-0 scans the
                # pause exists to avoid
                journal.record_seam(turbo[0], per_doc_changes)
        if turbo is not None:
            return turbo
    return _apply_exact(handles, per_doc_changes, fell_back=not mirror)


def _apply_exact(handles, per_doc_changes, fell_back, reject=None):
    """The exact path's tail, shared by the plain and the quarantining
    apply: each doc's changes through apply_changes (per-doc causal
    gating and mirrors on host; the device work enqueues), then ONE flush
    lands every doc's ops in one batched ingest and merge dispatch.
    Per-doc applies journal through FleetDoc.apply_changes, and the
    journal's group() folds their commits into ONE write+fsync for the
    whole batch. `fell_back` counts a batch the turbo path refused in
    its fleet's `fallbacks`. With `reject` (the quarantining caller's),
    a doc whose apply raises is handed to reject(d, typed error, 'apply')
    and keeps its handle, so isolation costs no extra dispatch;
    without it the error propagates."""
    if fell_back:
        fleet = _first_fleet(handles)
        if fleet is not None:
            fleet.metrics.fallbacks += 1
    out_handles, patches = [], []
    journal = _journal_of(handles)
    with journal.group() if journal is not None else \
            contextlib.nullcontext():
        for d, (handle, changes) in enumerate(zip(handles,
                                                  per_doc_changes)):
            new_handle, patch = handle, None
            if changes:
                try:
                    new_handle, patch = apply_changes(handle, changes)
                except Exception as exc:
                    if reject is None:
                        raise
                    # normalize so the DocError is ALWAYS typed — host
                    # gate ValueErrors arrive bare on this path
                    reject(d, as_wire_error(exc, InvalidChange, 'apply',
                                            doc_index=d), 'apply')
            out_handles.append(new_handle)
            patches.append(patch)
    fleet = _first_fleet(out_handles)
    if fleet is not None:
        fleet.flush()
    return out_handles, patches


def _screen_malformed_docs(work):
    """Per-doc screen after the batched native parse refused the whole
    flat batch (it cannot name the offender): re-parse each doc's buffers
    ALONE through the native parser — a doc that parses clean is healthy;
    a doc the parser refuses gets the (slow, Python) header decode to
    distinguish CORRUPT bytes (checksum/header damage -> quarantine,
    returned as [(doc, MalformedChange)]) from merely turbo-INELIGIBLE
    content (unsupported ops, document chunks — legal input that belongs
    on the exact path, where deeper corruption is already contained
    per-doc). The native fast path keeps the screen ~parse-speed for the
    N-K healthy docs; only refused docs pay Python decode. Host work
    only; no device dispatch."""
    from ..columnar import (CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE,
                            decode_change_meta, split_containers)
    bad = []

    def classify(d):
        """Python header decode of one refused doc: corrupt vs ineligible."""
        try:
            for buf in work[d]:
                for chunk in split_containers(bytes(buf)):
                    if chunk[8] in (CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE):
                        decode_change_meta(chunk, True)
                    elif hashlib.sha256(bytes(chunk[8:])).digest()[:4] != \
                            bytes(chunk[4:8]):
                        # an unknown container TYPE is legal to skip
                        # (forward compatibility) — but only when its
                        # checksum validates; a well-framed chunk whose
                        # checksum fails is corruption wearing an
                        # unknown-type byte (e.g. a bit flip IN the type
                        # byte) and must quarantine typed, not slide
                        # through as "nothing to apply" (found by
                        # the chaos client)
                        raise MalformedChange(
                            'container checksum mismatch on unknown '
                            f'chunk type {chunk[8]}', doc_index=d)
        except Exception as exc:
            bad.append((d, as_wire_error(exc, MalformedChange,
                                         'change screen', doc_index=d)))

    nonempty = [d for d, changes in enumerate(work) if changes]
    if not native.available():
        for d in nonempty:
            classify(d)
        return bad

    def scan(indices):
        """Bisect to the refused docs in O(K log N) native parses —
        parse failure is a per-buffer property, so a subset that parses
        clean clears every doc in it."""
        bufs = [bytes(b) for d in indices for b in work[d]]
        if native.ingest_changes(bufs, None, with_meta=True,
                                 with_seq=True) is not None:
            return
        if len(indices) == 1:
            classify(indices[0])
            return
        mid = len(indices) // 2
        scan(indices[:mid])
        scan(indices[mid:])

    scan(nonempty)
    return bad


def _apply_changes_docs_quarantine(handles, per_doc_changes, mirror):
    """Fault-contained batched apply: the blast radius of a bad input is
    ONE document. Returns (new_handles, patches, errors) with errors[i]
    a DocError for each rejected doc (None for healthy ones).

    Containment strategy: the turbo path validates the whole batch BEFORE
    its device dispatch and raises typed, doc-scoped errors with full
    rollback, so quarantine is a host-side retry loop — reject the
    offender's slot, re-run the (host-only) parse+validation over the
    survivors, and let the single fused device dispatch happen only on
    the attempt that passes. Survivors therefore commit in exactly the
    dispatches a clean batch of N-K docs would take (pinned by
    tests/test_quarantine.py); each retry costs one host-side re-parse of
    the surviving buffers, which is the right trade at K << N. When the
    native parser refuses the whole flat batch (it cannot say which
    buffer is corrupt), a per-doc header screen identifies the poisoned
    docs and the batch retries without them. Workloads turbo cannot take
    at all fall to the per-doc exact path, where isolation is free —
    each doc's gate failure is caught and recorded individually."""
    n = len(handles)
    work = []
    for d in range(n):
        changes = per_doc_changes[d] if d < len(per_doc_changes) else []
        work.append(list(changes) if changes else [])
    errors = [None] * n

    def reject(d, exc, stage):
        errors[d] = DocError(d, stage, exc)
        quarantine_stats.inc('quarantined_docs')
        quarantine_stats.inc('rejected_changes', len(work[d]))
        # flight-recorder event: WHICH doc (slot + durable id), WHAT
        # phase, WHAT typed error, plus a digest of the refused bytes so
        # the forensic dump can be matched to a captured wire corpus
        bufs = work[d]
        state = handles[d].get('state') if d < n else None
        _flight.record_event(
            'quarantine', doc=d, stage=stage,
            error=type(exc).__name__, message=str(exc)[:200],
            durable_id=getattr(state, '_dur_id', None),
            change_bytes=sum(len(b) for b in bufs),
            digest=hashlib.sha256(
                b''.join(bytes(b) for b in bufs)).hexdigest()[:16]
            if bufs else None)
        work[d] = []

    if not mirror:
        screened = False
        turbo = None
        # Bounded: every iteration either returns/breaks or rejects >= 1
        # doc, and only n docs exist
        for _ in range(n + 1):
            try:
                with _gc_paused():
                    turbo = _apply_changes_turbo(handles, work)
            except AutomergeError as exc:
                if exc.doc_index is None:
                    raise     # not doc-scoped: genuinely batch-fatal
                reject(exc.doc_index, exc, 'apply')
                continue
            if turbo is not None or screened:
                break
            # Native parse refused the flat batch without naming the
            # offender: screen headers per doc, quarantine the corrupt
            # ones, and give turbo one retry over the survivors
            screened = True
            bad = _screen_malformed_docs(work)
            if not bad:
                break             # turbo-ineligible workload, not corrupt
            for d, exc in bad:
                reject(d, exc, 'decode')
        if turbo is not None:
            out_handles, patches = turbo
            journal = _journal_of(out_handles)
            if journal is not None:
                with _gc_paused():
                    journal.record_seam(out_handles, work, errors)
            _dump_quarantine_record(out_handles, errors)
            return out_handles, patches, errors
    # Exact / fallback path: the SAME per-doc loop the non-quarantining
    # exact path runs (a rejected doc's work is already empty) — device
    # work still lands in ONE flush dispatch at the end, so isolation
    # here is free, not a batching forfeit (pinned by
    # test_exact_path_quarantine_isolates_per_doc's dispatch check).
    out_handles, patches = _apply_exact(handles, work, fell_back=not mirror,
                                        reject=reject)
    _dump_quarantine_record(out_handles, errors)
    return out_handles, patches, errors


def _dump_quarantine_record(handles, errors):
    """One forensic flight-recorder dump per quarantining batch that
    actually rejected something: every DocError described with its slot,
    stage, typed error, and durable id (when journaled), alongside the
    surrounding event ring. "quarantined_docs moved by K" becomes K
    named documents with context."""
    if not any(e is not None for e in errors):
        return
    detail = {'errors': [
        e.describe(durable_id=getattr(handles[i].get('state'), '_dur_id',
                                      None) if i < len(handles) else None)
        for i, e in enumerate(errors) if e is not None]}
    _flight.dump_flight_record('quarantine', detail)


class _LazyHandle(dict):
    """A backend handle whose 'heads' hexes LAZILY from the head lanes
    captured at commit time (dict ``__missing__``): the turbo fast path
    stopped materializing hex head strings per doc (the residual-floor
    fix), so a handle nobody asks for heads never pays the decode. The
    rows ([heads, 32], sorted) are captured by VALUE at commit, so a
    stale handle still answers with its own generation's frontier
    exactly like the eager dict did. Every dict operation real callers
    use (['state'], ['heads'], .get('frozen'), item assignment,
    isinstance(..., dict)) behaves identically."""

    __slots__ = ('_head32',)

    def __missing__(self, key):
        if key == 'heads':
            value = [row.tobytes().hex() for row in self._head32]
            self['heads'] = value
            return value
        raise KeyError(key)


class _TurboMetaBatch:
    """Raw per-change metadata from the native parser, with lazy hex/dict
    materialization: the fast path touches only numpy arrays; full dicts are
    built per change only for general-path gating and deferred hash-graph
    resolution."""

    __slots__ = ('m', 'actors', 'buffers')

    def __init__(self, m, actors, buffers):
        self.m = m
        self.actors = actors
        self.buffers = buffers

    def hash_hex(self, i):
        return self.m['hash32'][i].tobytes().hex()

    def deps_hex(self, i):
        off = self.m['deps_off']
        blob = self.m['deps_blob']
        return [blob[32 * j:32 * (j + 1)].hex()
                for j in range(off[i], off[i + 1])]

    def message(self, i):
        off = self.m['msg_off']
        return self.m['msg_blob'][off[i]:off[i + 1]].decode('utf8')

    def meta(self, i):
        """Full change-header dict (general gating path)."""
        m = self.m
        return {
            'actor': self.actors[int(m['actor'][i])], 'seq': int(m['seq'][i]),
            'startOp': int(m['startOp'][i]), 'time': int(m['time'][i]),
            'message': self.message(i), 'deps': self.deps_hex(i),
            'extraBytes': None, 'hash': self.hash_hex(i),
            'buffer': self.buffers[i], 'ops': range(int(m['nops'][i])),
            '_change_index': i,
        }

    def resolve(self, i):
        """(hash, deps, actor, changes_meta entry) for HashGraph._ensure_graph."""
        m = self.m
        meta = {
            'actor': self.actors[int(m['actor'][i])], 'seq': int(m['seq'][i]),
            'maxOp': int(m['startOp'][i] + m['nops'][i] - 1),
            'time': int(m['time'][i]), 'message': self.message(i),
            'deps': self.deps_hex(i), 'extraBytes': None,
        }
        return self.hash_hex(i), meta['deps'], meta['actor'], meta


def _apply_changes_turbo(handles, per_doc_changes):
    """Header-decode + native-ingest batched apply. Returns None when the
    workload can't take the turbo path (no native codec, non-fleet docs,
    multi-chunk buffers, or ops outside the flat subset), in which case the
    caller falls back to the exact path.

    Control flow: one native parse for every change; one native causal
    gate over the whole batch (every dep a start head or an earlier
    change of the same doc's run, contiguous seqs), which also returns
    every doc's new head frontier; docs it accepts, chains and causal
    runs alike, commit through the deferred hash graph with no
    per-change dict work, the rest go through the general causal gate.
    The call is atomic: any gate error rolls back every doc.

    Phase attribution: when spans are enabled the call tiles into
    contiguous `turbo_setup` / `turbo_parse` / `turbo_gate` /
    `turbo_commit` / `turbo_stage` / `turbo_dispatch` spans (no
    unattributed gap between marks — the coverage contract bench.py's
    observability section checks), with the native parse / device
    dispatch sub-spans nested inside."""
    ps = _span_seq()
    ps.mark('turbo_setup', docs=len(handles))
    try:
        return _apply_changes_turbo_inner(handles, per_doc_changes, ps)
    finally:
        ps.done()


def _apply_changes_turbo_inner(handles, per_doc_changes, ps):
    """The turbo apply as a sequence of stages: until the drain any of
    them may send the batch to the exact path (None); from there on a
    failure restores every drained doc and raises."""
    engines = _turbo_engines(handles) if native.available() else None
    if engines is None:
        return None
    fleet = engines[0].fleet
    buffers, counts = _flatten_changes(per_doc_changes, len(handles))
    if not buffers:
        return handles, [None] * len(handles)
    if (fleet.ctr_base or fleet.grid_overflow) and any(
            (e.slot in fleet.ctr_base or e.slot in fleet.grid_overflow) and
            counts[d] for d, e in enumerate(engines)):
        # Rebased/overflowed slots pack against per-slot counter bases the
        # native turbo parser does not apply: batches that actually touch
        # such a slot take the exact path; everything else keeps turbo
        return None
    # doc_ids=None: the zero-copy list entry (C walks the bytes objects
    # in place — no blob join, no length array; buffer i IS doc i here)
    ps.mark('turbo_parse', changes=len(buffers))
    out = native.ingest_changes(buffers, None, with_meta=True, with_seq=True)
    if out is None:
        return None     # ops outside the fleet subset, or corrupt chunk
    ps.mark('turbo_gate')
    tp = _TurboParse(out, buffers, counts)
    gate = _turbo_gate(fleet, engines, tp, ps)
    if gate is None or not _turbo_objects_resolve(engines, tp, gate.fast) \
            or not tp.decode_payloads():
        return None

    # From here on the batch is committed to turbo (counted as such)
    fleet.metrics.turbo_calls += 1
    backups = _EngineBackups()
    ready, staged = _turbo_drain(engines, tp, gate.fast, backups)
    keep = ready[tp.rows['doc']]
    _check_turbo_op_ids(tp, keep, backups)
    _validate_turbo_preds(fleet, tp, keep, gate.erows, backups)
    # Count only causally-applied changes: queued ones are re-counted when
    # the exact path drains and flushes them later. Byte counts come from
    # the parser's buf_len meta column — no Python len() pass.
    buf_len = tp.nmeta['buf_len']
    fleet.metrics.changes_ingested += int(ready.sum())
    fleet.metrics.bytes_ingested += int(buf_len.sum()) if ready.all() \
        else int(buf_len[ready].sum())

    # Phase 2 — infallible: record logs, queues, staleness
    ps.mark('turbo_commit', ready=int(ready.sum()) if ps.on else None)
    result = _turbo_commit(fleet, handles, engines, tp, gate, staged)
    if not keep.any():
        return result            # everything queued: no device work

    # Land any lazily-enqueued earlier changes first: the register engine
    # is order-sensitive (pred kills), and even the LWW grid's counter
    # reset bases on the pre-batch winner
    ps.mark('turbo_stage', kept=int(keep.sum()) if ps.on else None)
    fleet.flush()
    _register_turbo_actors(fleet, tp, ready)
    vals, flags = _intern_turbo_values(fleet, engines, tp, keep)
    root = _turbo_root_rows(fleet, tp, keep & tp.on_map, vals, flags,
                            gate.erows)
    if fleet.exact_device:
        _stage_register_rows(fleet, tp, root, ps)
    else:
        _stage_grid_rows(fleet, tp, root, ps)
    _stage_seq_runs(fleet, tp, keep & tp.on_seq, vals, gate.erows)
    fleet.metrics.device_ops += int(keep.sum())
    return result


# make codes whose object is a sequence (Text or list)
_SEQ_OBJECT_MAKES = tuple(code for code, typ in native.MAKE_TYPES.items()
                          if typ in ('text', 'list'))


class _TurboParse:
    """One turbo call's parse (native.ingest_changes with meta and
    sequence rows): op rows, key and actor tables, change metadata
    (`meta`, with the buffers), each change's doc and each doc's run, and
    what every stage reads of them: the flag selectors, `oid(p)`, and —
    once the stage has registered the actors — `actor_map` and `remap`.
    It lives for the call only: the lazy log keeps `meta`, never rows."""

    __slots__ = ('rows', 'nat_keys', 'nat_actors', 'nmeta', 'meta',
                 'counts', 'starts', 'change_doc', 'seq_sel', 'make_sel',
                 'elem_make_sel', 'nested_sel', 'on_seq', 'on_map',
                 'values', 'value_gid', 'actor_map', '_oids')

    def __init__(self, out, buffers, counts):
        self.rows, self.nat_keys, self.nat_actors, self.nmeta = out
        self.meta = _TurboMetaBatch(self.nmeta, self.nat_actors, buffers)
        self.counts = counts
        self.starts = np.cumsum(counts) - counts
        self.change_doc = np.repeat(np.arange(len(counts), dtype=np.int64),
                                    counts)
        flags = self.rows['flags']
        self.seq_sel = (flags >= FLAG_SEQ_INSERT) & (flags <= FLAG_SEQ_INC)
        self.make_sel = (flags >= FLAG_MAKE_TEXT) & (flags <= FLAG_MAKE_TABLE)
        self.elem_make_sel = flags >= FLAG_ELEM_MAKE_TEXT
        self.nested_sel = (flags <= FLAG_INC) & (self.rows['obj'] != 0)
        self.on_seq = self.seq_sel | self.elem_make_sel
        self.on_map = ~self.on_seq
        self.values, self.value_gid = [], None
        self.actor_map = None
        self._oids = {}

    def oid(self, p):
        """The objectId (`counter@actor`) of packed id `p`."""
        oid = self._oids.get(p)
        if oid is None:
            oid = self._oids[p] = native.format_op_id(p, self.nat_actors)
        return oid

    def objects_of(self, sel):
        """(doc, objectId) of each distinct (doc, containing object) of
        the rows `sel` picks."""
        idx = np.flatnonzero(sel)
        combo = np.unique((self.change_doc[self.rows['doc'][idx]] << 32) |
                          self.rows['obj'][idx].astype(np.int64))
        for cv in combo.tolist():
            yield cv >> 32, self.oid(cv & 0xffffffff)

    def remap(self, p):
        """Packed ids `p` in fleet numbering; 0 stays 0. An id whose actor
        the fleet never registered maps to -1 (its actor_map entry, all
        ones, ORs to -1): a ref or pred that never matches."""
        return np.where(p != 0, (p & ~ACTOR_MASK) |
                        self.actor_map[p & ACTOR_MASK], 0)

    def decode_payloads(self):
        """Decode every arena-boxed payload BEFORE the commit point: one
        decode_value rejects (bad leb, UTF-8 or float width) sends the
        batch to the exact path (False). `values` gets one dict per
        DISTINCT payload, `value_gid` each row's index into it (-1: not
        decoded), so interning works per distinct value, never per row."""
        rows = self.rows
        flags, vlen, vtype = rows['flags'], rows['vlen'], rows['vtype']
        self.value_gid = np.full(len(flags), -1, dtype=np.int32)
        decode_sel = np.isin(flags, (FLAG_SET, FLAG_SEQ_INSERT,
                                     FLAG_SEQ_SET)) & \
            (rows['value'] != -1) & ((vlen > 0) | np.isin(vtype, (0, 1, 2)))
        if not decode_sel.any():
            return True
        from ..columnar import decode_value
        voff = np.cumsum(vlen, dtype=np.int64) - vlen
        vblob = rows['vblob']
        vb = vblob if isinstance(vblob, np.ndarray) else \
            np.frombuffer(vblob, dtype=np.uint8)
        sel_idx = np.flatnonzero(decode_sel)
        try:
            # Group rows by (len, vtype), then dedupe payload bytes within
            # each group so every distinct value decodes exactly once.
            combos = (vlen[sel_idx].astype(np.int64) << 8) | vtype[sel_idx]
            corder = np.argsort(combos, kind='stable')
            csorted = combos[corder]
            starts = np.flatnonzero(np.r_[True, csorted[1:] != csorted[:-1]])
            stops = np.r_[starts[1:], len(csorted)]
            for gi in range(len(starts)):
                combo = int(csorted[starts[gi]])
                grp = sel_idx[corder[starts[gi]:stops[gi]]]
                ln, vt = combo >> 8, combo & 0xff
                if ln == 0:
                    self.value_gid[grp] = len(self.values)
                    self.values.append(decode_value(vt, b''))
                    continue
                mat = vb[voff[grp][:, None] + np.arange(ln)[None, :]]
                # one sort of packed rows (void view) instead of
                # np.unique(axis=0)'s per-byte-column lexsort
                packed_rows = np.ascontiguousarray(mat).view(
                    np.dtype((np.void, ln))).ravel()
                uq, inv = np.unique(packed_rows, return_inverse=True)
                self.value_gid[grp] = len(self.values) + inv
                self.values += [decode_value((ln << 4) | vt, u.tobytes())
                                for u in uq]
        except Exception:
            return False
        return True


# What the turbo gate decided: `fast[d]`, doc d passed the native gate;
# each doc's slot (`erows`) and end frontier (`new32`, `new_n`); the
# per-(doc, actor) seq groups the clock commit scatters (`g_rows`, `g_reg`:
# their slots and clock-registry ids, None when there are none).
_GateVerdict = collections.namedtuple(
    '_GateVerdict', 'erows fast causal_docs new32 new_n g_doc g_actor '
    'g_last g_rows g_reg')


class _EngineBackups(list):
    """(engine, clock, heads, queue) of each doc the turbo drain ran: a
    failure before the commit restores all of them (the call is atomic)."""

    def save(self, engine):
        self.append((engine, dict(engine.clock), list(engine.heads),
                     list(engine.queue)))

    def restore(self):
        for engine, clock, heads, queue in self:
            engine.clock, engine.heads, engine.queue = clock, heads, queue


def _turbo_engines(handles):
    """The fleet engines of `handles` when the turbo path can take them
    all — every doc a live fleet doc with no held-back changes, all on
    one fleet — else None (also for no handles)."""
    engines = []
    for handle in handles:
        state = handle.get('state')
        if handle.get('frozen') or not isinstance(state, FleetDoc) or \
                not state.is_fleet:
            return None
        if state._impl.queue:
            # Draining held-back changes needs their op rows; the exact path
            # re-ingests them on flush, so route this call there
            return None
        engines.append(state._impl)
    if not engines or any(e.fleet is not engines[0].fleet for e in engines):
        return None
    return engines


def _flatten_changes(per_doc_changes, n_docs):
    """The batch as one flat list of bytes, doc-major, and each doc's
    change count (0 past the end of per_doc_changes, as the exact path's
    zip truncates)."""
    flat = []
    counts = np.zeros(n_docs, dtype=np.int64)
    for d, changes in enumerate(per_doc_changes):
        k = len(flat)
        if not isinstance(changes, (list, tuple)):
            changes = list(changes)   # one-shot iterables: materialize once
        flat += changes
        counts[d] = len(flat) - k
    if set(map(type, flat)) - {bytes}:
        # one normalization pass; set(map(type, ...)) runs the scan at C
        # speed instead of a 200k-element genexpr
        flat = [bytes(b) for b in flat]
    return flat, counts


def _turbo_gate(fleet, engines, tp, ps):
    """Batched causal-run validation, ONE native call (codec.cpp's
    am_turbo_gate, GIL released): a doc is fast iff every change's deps
    are start heads or earlier changes of its own run (buffer order is
    causal order) and seqs are contiguous per actor — a chain, or
    concurrent branches and their merges; the rest get the general gate.
    Returns a _GateVerdict, or None for the exact path."""
    nmeta, counts = tp.nmeta, tp.counts
    with _span('turbo_causal') as causal_span:
        cols = fleet.doc_cols
        erows = np.fromiter((e.slot for e in engines), dtype=np.int64,
                            count=len(engines))
        if len(np.unique(erows)) != len(erows):
            # the same doc twice in one batch: the scatter commit would
            # collapse its two runs; the exact path applies them in order
            return None
        doc_off = np.concatenate([tp.starts, [len(tp.change_doc)]])
        gate = native.turbo_gate(doc_off, nmeta['actor'], nmeta['seq'],
                                 nmeta['hash32'], nmeta['deps_off'],
                                 nmeta['deps_blob'], cols.head32[erows],
                                 cols.head_n[erows])
        if gate is None:
            return None
        (gate_kind, hostcheck, new32, new_n, g_doc, g_actor, g_first,
         g_last) = gate
        fast = gate_kind > 0
        # Docs whose start frontier is wider than the head lanes get the
        # host hex compare for JUST their first change (the gate holds
        # them to the chain shape).
        for d in np.flatnonzero(hostcheck == 1).tolist():
            if fast[d] and counts[d]:
                i = int(tp.starts[d])
                heads = engines[d].heads
                if int(nmeta['deps_off'][i + 1] -
                       nmeta['deps_off'][i]) != len(heads) or \
                        tp.meta.deps_hex(i) != heads:
                    fast[d] = False
        # Seq bases: each (doc, actor) run's first seq must extend the
        # doc's clock. Lane-mode rows check vectorized against the clock
        # columns; dict-mode rows (actor populations past the lane width)
        # probe their dicts per group.
        g_rows = g_reg = None
        if len(g_doc):
            g_rows = erows[g_doc]
            g_reg = _clock_reg_ids(fleet, tp.nat_actors)[g_actor]
            base = np.zeros(len(g_doc), dtype=np.int64)
            known = g_reg >= 0
            if known.any():
                for l in range(cols.CLOCK_LANES):
                    m = known & (cols.ck_actor[g_rows, l] == g_reg)
                    if m.any():
                        base[m] = cols.ck_seq[g_rows[m], l]
            for gi in np.flatnonzero(cols.ck_n[g_rows] == -1).tolist():
                base[gi] = engines[int(g_doc[gi])].clock.get(
                    tp.nat_actors[int(g_actor[gi])], 0)
            bad = g_first != base + 1
            if bad.any():
                fast[g_doc[bad]] = False
        causal_docs = int(((gate_kind == 2) & fast).sum())
        if ps.on:
            causal_span.set(
                chain=int(((gate_kind == 1) & fast & (counts > 0)).sum()),
                causal=causal_docs,
                host=int((~fast & (counts > 0)).sum()),
                merges=int((np.diff(nmeta['deps_off']) > 1)[
                    fast[tp.change_doc]].sum()),
                wide=int((hostcheck > 0).sum()))
    return _GateVerdict(erows, fast, causal_docs, new32, new_n, g_doc,
                        g_actor, g_last, g_rows, g_reg)


def _clock_reg_ids(fleet, nat_actors):
    """Each parser actor's clock-registry id, -1 where it has none."""
    return np.fromiter((fleet._ck_reg.get(a, -1) for a in nat_actors),
                       dtype=np.int64, count=len(nat_actors)) \
        if nat_actors else np.zeros(1, dtype=np.int64)


def _turbo_objects_resolve(engines, tp, fast):
    """Whether the batch's objects let it stay on the turbo path. RGA
    application is order-sensitive, so with any object op every doc must
    be fast (buffer order proven causal). Every op's object must be a
    registered one or a make earlier in this batch, of its kind (seq ops
    on seq objects, keyed ops on maps): else the exact path errs."""
    rows = tp.rows
    if not (tp.seq_sel.any() or tp.make_sel.any() or tp.nested_sel.any() or
            tp.elem_make_sel.any()):
        return True
    if (~fast[tp.change_doc]).any():
        return False
    made_seq = [set() for _ in engines]
    made_map = [set() for _ in engines]
    mk_rows = np.flatnonzero(tp.make_sel | tp.elem_make_sel)
    mk_docs = tp.change_doc[rows['doc'][mk_rows]].tolist()
    mk_packed = rows['packed'][mk_rows].tolist()
    mk_is_seq = np.isin(rows['flags'][mk_rows], _SEQ_OBJECT_MAKES).tolist()
    for d, p, isq in zip(mk_docs, mk_packed, mk_is_seq):
        (made_seq if isq else made_map)[d].add(tp.oid(p))
    for d, oid in tp.objects_of(tp.on_seq):
        if oid not in made_seq[d] and oid not in engines[d].seq_objects:
            return False
    for d, oid in tp.objects_of(tp.nested_sel |
                                (tp.make_sel & (rows['obj'] != 0))):
        if oid not in made_map[d] and oid not in engines[d].map_objects:
            return False
    return True


def _turbo_drain(engines, tp, fast, backups):
    """Phase 1 — fallible: the general causal gate for the docs the
    native gate sent to the host. _drain_queue mutates clock/heads, so
    each drained engine is saved in `backups` first and any failure
    restores all of them. Returns (ready: per change, applied by this
    call; staged: (engine, applied, queue) per drained doc)."""
    ready = fast[tp.change_doc]    # fancy-indexed: a fresh, writable array
    staged = []
    drain_docs = np.flatnonzero(~fast & (tp.counts > 0)).tolist()
    with _span('turbo_drain', docs=len(drain_docs)):
        for d in drain_docs:
            engine = engines[d]
            start = int(tp.starts[d])
            backups.save(engine)
            try:
                applied, queue = engine._drain_queue(
                    [tp.meta.meta(i)
                     for i in range(start, start + int(tp.counts[d]))],
                    lambda change: None)
            except Exception as exc:
                backups.restore()
                # Gate errors are doc-scoped by construction (the drain
                # loop runs one doc's changes): type them so a
                # quarantining caller can reject slot d and retry the
                # batch without it
                if isinstance(exc, AutomergeError):
                    if exc.doc_index is None:
                        exc.doc_index = d
                    raise
                if isinstance(exc, ValueError):
                    raise InvalidChange(str(exc), doc_index=d) from exc
                raise
            staged.append((engine, applied, queue))
            for change in applied:
                ready[change['_change_index']] = True
    return ready, staged


def _check_turbo_op_ids(tp, keep, backups):
    """Duplicate opIds *within* the applied batch, per doc, from the
    native rows without decoding op objects: one sort and an adjacent-
    equality scan. Raises DuplicateOpId after restoring `backups`."""
    kept_packed = tp.rows['packed'][keep]
    if not len(kept_packed):
        return
    pairs_sorted = np.sort(tp.change_doc[tp.rows['doc'][keep]] * (1 << 32)
                           + kept_packed)
    dup = pairs_sorted[1:] == pairs_sorted[:-1]
    if dup.any():
        backups.restore()
        bad_doc = int(pairs_sorted[1:][dup][0] >> 32)
        raise DuplicateOpId('duplicate operation ID in turbo batch',
                            doc_index=bad_doc)


def _validate_turbo_preds(fleet, tp, keep, slots, backups):
    """Reject kept map-key rows whose preds name no existing op row — the
    exact path's rule (op_set.py `no matching operation for pred`;
    new.js:1219-1220). A pred exists iff it is (a) an earlier kept
    non-del map-key row of the same (doc, object, key) in THIS batch, or
    (b) in the slot's applied-op index (_op_index). Raises DanglingPred,
    after restoring `backups`. Only preds missing from the batch take
    the per-pred index walk. Sequence refs/preds keep their envelope
    (drop and flag inexact), and bulk-loaded docs, whose indexes are
    incomplete, skip the check (the next mirror rebuild surfaces it)."""
    rows = tp.rows
    pc = np.diff(rows['pred_off'])
    root_rows = keep & tp.on_map
    check_rows = root_rows & (pc > 0)
    if not check_rows.any():
        return
    row_doc = tp.change_doc[rows['doc']]
    if fleet._op_index_incomplete:
        inc = np.fromiter(
            (s in fleet._op_index_incomplete for s in slots),
            dtype=bool, count=len(slots))
        check_rows &= ~inc[row_doc]
        if not check_rows.any():
            return
    # Batch-internal pred targets: kept, non-seq, non-del rows (dels have
    # no rows in the reference representation; incs and makes do). Dense
    # collision-free ids for (doc, obj, key) triples — restricted to the
    # relevant rows (targets + rows under check), and built with two
    # 1D-packed uniques instead of np.unique(axis=0)'s void compare.
    tgt = root_rows & ~((rows['flags'] == FLAG_SET) &
                        (rows['value'] == TOMBSTONE))
    rel = np.flatnonzero(tgt | check_rows)
    objkey_rel = (rows['obj'][rel].astype(np.int64) << 32) | \
        rows['key'][rel].astype(np.int64)
    _u1, ok_inv = np.unique(objkey_rel, return_inverse=True)
    combo2_rel = (row_doc[rel].astype(np.int64) << 32) | \
        ok_inv.astype(np.int64)
    _u2, rel_inv = np.unique(combo2_rel, return_inverse=True)
    inv = np.zeros(len(row_doc), dtype=np.int64)
    inv[rel] = rel_inv
    tgt_combo = np.sort(inv[tgt] * (1 << 32) + rows['packed'][tgt])
    # Pred entries of the rows under check
    entry_sel = np.repeat(check_rows, pc)
    pred_nat = rows['pred'][entry_sel].astype(np.int64)
    owner = np.repeat(np.arange(len(pc)), pc)[entry_sel]
    pred_combo = inv[owner] * (1 << 32) + pred_nat
    in_batch = np.zeros(len(pred_nat), dtype=bool)
    if len(tgt_combo):
        pos = np.clip(np.searchsorted(tgt_combo, pred_combo), 0,
                      len(tgt_combo) - 1)
        in_batch = (tgt_combo[pos] == pred_combo) & \
            (pred_nat < rows['packed'][owner])
    missing = (pred_nat > 0) & ~in_batch
    if not missing.any():
        return
    # Lazily-pending earlier changes haven't fed the index yet: land
    # them before consulting it (they were already accepted — flushing
    # here mutates only fleet device state, never the engines' causal
    # state that the backups guard)
    if fleet.pending:
        fleet.flush()
    # Standing-index check for the remainder, in fleet numbering (reads
    # only — unknown actors/keys simply have no standing ops)
    amap = np.array([fleet.actors.index.get(a, -1) for a in tp.nat_actors],
                    dtype=np.int64) if tp.nat_actors else \
        np.zeros(1, np.int64)
    key_cache = {}
    for i in np.flatnonzero(missing).tolist():
        p = int(pred_nat[i])
        d = int(row_doc[owner[i]])
        pa = int(amap[p & ACTOR_MASK])
        fk = None
        if pa >= 0:
            o = int(rows['obj'][owner[i]])
            kn = int(rows['key'][owner[i]])
            fk = key_cache.get((o, kn), -2)
            if fk == -2:
                ks = tp.nat_keys[kn]
                fk = fleet.keys.index.get(ks if o == 0 else (tp.oid(o), ks))
                key_cache[(o, kn)] = fk
        if fk is None or not bool(fleet._index_lookup(
                int(slots[d]), np.array([(fk << 32) | (p & ~ACTOR_MASK) | pa],
                                        dtype=np.int64))[0]):
            backups.restore()
            raise DanglingPred(f'no matching operation for pred: '
                               f'{tp.oid(p)}', doc_index=d)


def _turbo_commit(fleet, handles, engines, tp, gate, staged):
    """Phase 2 — infallible: fast docs land as vectorized scatters into
    the _DocCols columns (heads, maxop, staleness, one lazy log record,
    the frontier index's staging, the clock lanes); drained docs take the
    exact per-doc tail. Returns the call's (handles, patches)."""
    cols = fleet.doc_cols
    counts, starts_all = tp.counts, tp.starts
    last_op = tp.nmeta['startOp'] + tp.nmeta['nops'] - 1
    # per-doc max of last_op (a chain's LAST change need not hold it)
    nonempty = counts > 0
    if _hist.on() and nonempty.any():
        # per-doc change bytes, recorded past every validation raise: a
        # quarantining caller's retry loop records each batch's survivors
        # exactly once, on the attempt that commits
        _hist.histogram('doc_change_bytes', unit='B').record_many(
            np.add.reduceat(tp.nmeta['buf_len'], starts_all[nonempty]))
    doc_max = np.zeros(len(handles), dtype=np.int64)
    if nonempty.any():
        doc_max[nonempty] = np.maximum.reduceat(
            last_op, starts_all[nonempty])
    fast_ne = np.flatnonzero(gate.fast & nonempty)
    # Head frontier: the gate's end-frontier lanes (raw hashes); hex
    # strings are made only on first access (the heads property's memo,
    # and _LazyHandle for the returned handles).
    frows = gate.erows[fast_ne]
    fleet.metrics.turbo_causal_docs += gate.causal_docs
    fleet.metrics.turbo_drain_docs += len(staged)
    with _span('turbo_heads') as heads_span:
        head_rows = gate.new32[fast_ne]
        head_n = gate.new_n[fast_ne]
        cols.head32[frows] = head_rows
        cols.head_n[frows] = head_n
        cols.head_obj[frows] = None
        multi = int((head_n > 1).sum())
        fleet.metrics.turbo_multihead_docs += multi
        heads_span.set(multi=multi)
    cols.maxop[frows] = np.maximum(cols.maxop[frows], doc_max[fast_ne])
    cols.stale[frows] = True
    cols.bindoc[frows] = None
    # Log append, lazily: one _SeamSegs record for the whole batch; each
    # doc's (start, stop, base) segment folds into its log only when
    # something reads history. Bases count a parked doc's parked prefix.
    log_lens = np.fromiter((len(e._log) for e in engines),
                           dtype=np.int64, count=len(engines))
    bases = log_lens[fast_ne] + cols.pend_n[frows]
    if cols.parked_n[frows].any():
        # only fleets that actually hold parked docs pay the object-
        # column scan for the parked-prefix bases
        parked = np.array([chunk is not None
                           for chunk in cols.pend_doc[frows]], dtype=bool)
        bases += np.where(parked, cols.parked_n[frows], 0)
    starts_f = starts_all[fast_ne]
    stops_f = starts_f + counts[fast_ne]
    seg = _SeamSegs(tp.meta.buffers, tp.meta,
                    dict(zip(frows.tolist(),
                             zip(starts_f.tolist(), stops_f.tolist(),
                                 bases.tolist()))))
    cols.pend_n[frows] += counts[fast_ne]
    fleet._pend_seams.append(seg)
    if len(fleet._pend_seams) > _SEAM_FOLD_LIMIT:
        fleet._fold_all_pending()
    if fleet._hash_index is not None and len(fast_ne):
        # frontier-index staging: a host-side append of the fast docs'
        # hash lanes (the next sync probe flushes); drained docs stage
        # per change through _defer_record below
        fsel = gate.fast[tp.change_doc]
        fleet._hash_index.stage_rows(gate.erows[tp.change_doc[fsel]],
                                     tp.nmeta['hash32'][fsel])
    _commit_clock_lanes(fleet, engines, tp, gate)
    for engine, applied, queue in staged:
        # drained docs: the exact per-doc tail loop (counted)
        fleet.metrics.turbo_commit_fallback_docs += 1
        for change in applied:
            engine.changes.append(change['buffer'])
            engine._defer_record(change)
            engine.max_op = max(engine.max_op,
                                change['startOp'] + len(change['ops']) - 1)
            engine.stale = True
            engine.binary_doc = None
        engine.queue = queue
        if queue:
            # Queue entries from this pass carry only headers; flag the
            # mirror so the exact path re-decodes them before draining
            engine.stale = True

    for handle in handles:
        handle['frozen'] = True
    # Fast docs' handles capture their post-commit head32 ROW and hex it
    # only when someone reads 'heads' (_LazyHandle.__missing__) — the
    # commit fast path serves the handle contract with zero hex
    # materializations; slow/empty docs consult their engines eagerly
    # (few, and their memos are already warm).
    fast_pos = {int(d): k for k, d in enumerate(fast_ne.tolist())}
    out_handles = []
    for d, handle in enumerate(handles):
        k = fast_pos.get(d)
        if k is None:
            out_handles.append({'state': handle['state'],
                                'heads': engines[d].heads})
        else:
            lazy = _LazyHandle(state=handle['state'])
            lazy._head32 = head_rows[k, :head_n[k]]
            out_handles.append(lazy)
    return out_handles, [None] * len(handles)


def _commit_clock_lanes(fleet, engines, tp, gate):
    """Clock advance: the gate's per-(doc, actor) groups of fast docs
    scatter their final seqs into the clock lanes. Dict-mode rows and
    lane overflows take the counted per-doc dict merge (pinned at zero
    for fast-path workloads)."""
    if not len(gate.g_doc):
        return
    cols = fleet.doc_cols
    nat_actors = tp.nat_actors
    gsel = np.flatnonzero(gate.fast[gate.g_doc])
    if not len(gsel):
        return
    g_doc, g_actor = np.asarray(gate.g_doc), np.asarray(gate.g_actor)
    s_rows = gate.g_rows[gsel]
    s_reg = gate.g_reg[gsel]
    s_last = gate.g_last[gsel]
    dict_mode = cols.ck_n[s_rows] == -1
    lanes = np.full(len(gsel), -1, dtype=np.int64)
    for l in range(cols.CLOCK_LANES):
        lanes = np.where((cols.ck_actor[s_rows, l] == s_reg) &
                         (s_reg >= 0), l, lanes)
    new = (lanes < 0) & ~dict_mode
    if new.any():
        # intern actors the clock registry hasn't seen
        for a in np.unique(g_actor[gsel][new]).tolist():
            hexa = nat_actors[a]
            if hexa not in fleet._ck_reg:
                fleet._ck_reg[hexa] = len(fleet._ck_names)
                fleet._ck_names.append(hexa)
        s_reg = _clock_reg_ids(fleet, nat_actors)[g_actor[gsel]]
        # per-row rank among this batch's new actors (groups of
        # one doc are contiguous in kernel order)
        ni = np.flatnonzero(new)
        rw = s_rows[ni]
        run_first = np.r_[True, rw[1:] != rw[:-1]]
        rank = np.arange(len(ni)) - \
            np.repeat(np.flatnonzero(run_first),
                      np.diff(np.r_[np.flatnonzero(run_first), len(ni)]))
        lanes[ni] = cols.ck_n[rw] + rank
    over = lanes >= cols.CLOCK_LANES
    good = ~dict_mode & ~over
    if good.any():
        gi = np.flatnonzero(good)
        cols.ck_actor[s_rows[gi], lanes[gi]] = s_reg[gi]
        cols.ck_seq[s_rows[gi], lanes[gi]] = s_last[gi]
        newly = good & new
        if newly.any():
            np.add.at(cols.ck_n, s_rows[newly], 1)
    fallback_docs = set(g_doc[gsel[dict_mode | over]].tolist())
    if fallback_docs:
        # Dict-mode / lane-overflow docs: per-doc dict merge — correct
        # for any actor population, counted so the guard can pin the
        # fast path at zero iterations.
        fleet.metrics.turbo_commit_fallback_docs += len(fallback_docs)
        for d in fallback_docs:
            engine = engines[d]
            clock = dict(engine.clock)
            for gi in np.flatnonzero(g_doc == d).tolist():
                clock[nat_actors[int(g_actor[gi])]] = int(gate.g_last[gi])
            engine.clock = clock


def _register_turbo_actors(fleet, tp, ready):
    """Register the applied changes' actors (renumbering device state when
    one sorts first) and set `tp.actor_map`, -1 for actors the fleet
    never registered: those surface only through pred/ref columns, where
    each route flags the doc or row inexact instead of using actor 0."""
    applied_actor_ids = np.unique(tp.nmeta['actor'][ready])
    perm = fleet.actors.insert_many([tp.nat_actors[int(a)]
                                     for a in applied_actor_ids])
    if perm is not None:
        if fleet.exact_device:
            fleet._remap_reg_actors(perm)
        else:
            fleet._remap_actors(perm)
        fleet._remap_seq_actors(perm)
    tp.actor_map = np.array(
        [fleet.actors.index.get(a, -1) for a in tp.nat_actors],
        dtype=np.int32) if tp.nat_actors else np.zeros(1, np.int32)


def _intern_turbo_values(fleet, engines, tp, keep):
    """The rows' device values and flags: make ops register their object
    (and a sequence's device row) and carry a boxed link value, memoized
    per packed id; map-key makes become FLAG_SET cells. Then, in exact
    mode, datatyped inline sets; then every arena-boxed cell payload,
    once per DISTINCT value. Returns (values, flags), one a parser row."""
    rows = tp.rows
    vals = rows['value'].astype(np.int32, copy=True)
    flags = rows['flags'].copy()
    make_memo = {}    # (packed, make code) -> (type, boxed link value)
    for ri in np.flatnonzero((tp.make_sel | tp.elem_make_sel) &
                             keep).tolist():
        p = int(rows['packed'][ri])
        mk = int(rows['flags'][ri])
        # keyed on (p, mk): the same packed opId can be a different make
        # KIND on different docs in one batch (independent docs share
        # actor numbering), so type must not leak across docs
        memo = make_memo.get((p, mk))
        if memo is None:
            typ = native.MAKE_TYPES[mk]
            link = _SeqLink(tp.oid(p)) if typ in ('text', 'list') else \
                _MapLink(tp.oid(p), typ)
            memo = make_memo[(p, mk)] = (typ,
                                         fleet._intern_value_boxed(link))
        typ, boxed = memo
        oid = tp.oid(p)
        engine = engines[tp.change_doc[int(rows['doc'][ri])]]
        if typ in ('text', 'list'):
            engine.seq_objects[oid] = typ
            if oid not in fleet.slot_seq.get(engine.slot, {}):
                fleet._alloc_seq_row(engine.slot, oid, typ)
        else:
            engine.map_objects[oid] = typ
        # element makes keep their insert bit in rows['value'] for the
        # seq dispatch; map-key makes become grid/register cell rows
        vals[ri] = boxed
        if mk <= FLAG_MAKE_TABLE:
            flags[ri] = FLAG_SET
    vlen, vtype = rows['vlen'], rows['vtype']
    if fleet.exact_device:
        # uint/counter/timestamp sets box with their wire datatype so
        # device-served patches keep exact datatypes and counter folds
        # (same rule as ingest.changes_to_op_rows; dels carry value -1 and
        # no typed vtype, so they never box)
        from .registers import typed_wire_tags
        tags = typed_wire_tags()
        typed_sel = keep & (rows['flags'] == FLAG_SET) & \
            (rows['value'] != -1) & (vlen == 0) & np.isin(vtype, list(tags))
        typed_memo = {}
        for ri in np.flatnonzero(typed_sel).tolist():
            tk = (int(rows['value'][ri]), int(vtype[ri]))
            vid = typed_memo.get(tk)
            if vid is None:
                vid = typed_memo[tk] = fleet._intern_typed(tk[0],
                                                           tags[tk[1]])
            vals[ri] = vid
    # arena-boxed map-cell payloads (strings/bools/None/floats/bytes,
    # out-of-lane ints), interned by the shared rule (exact mode keeps
    # TypedValue datatypes; the LWW grid boxes raw) once per DISTINCT value
    boxed_idx = np.flatnonzero(
        keep & (rows['flags'] == FLAG_SET) & (rows['value'] != -1) &
        ((vlen > 0) | np.isin(vtype, (0, 1, 2))))
    if len(boxed_idx):
        gids = tp.value_gid[boxed_idx]
        if gids.min(initial=0) < 0:
            # the boxed rows are decoded ones; a -1 here is a parser-
            # contract break and must fail loudly, not index values[-1]
            raise AssertionError('undecoded arena payload in turbo batch')
        uniq_g = np.unique(gids)
        if fleet.exact_device:
            vids = [fleet._intern_typed(tp.values[g]['value'],
                                        tp.values[g].get('datatype'))
                    for g in uniq_g.tolist()]
        else:
            vids = [fleet._intern_value(tp.values[g]['value'])
                    for g in uniq_g.tolist()]
        vals[boxed_idx] = np.asarray(vids, dtype=np.int32)[
            np.searchsorted(uniq_g, gids)]
    return vals, flags


_RootRows = collections.namedtuple(
    '_RootRows', 'sel slots doc key packed flags vals')


def _turbo_root_rows(fleet, tp, sel, vals, flags, slots_of_doc):
    """The kept map-key rows (`sel`) in fleet numbering as a _RootRows
    (keys interned as in the register ingest: composite (objectId, key)
    for nested cells), feeding the dangling-pred oracle their sets,
    folded makes and incs (never dels)."""
    from .ingest import intern_composite_keys
    doc = tp.change_doc[tp.rows['doc'][sel]].astype(np.int32)
    slots = slots_of_doc.astype(np.int32)[doc]
    key = intern_composite_keys(tp.rows['obj'][sel], tp.rows['key'][sel],
                                tp.nat_keys, tp.nat_actors, fleet.keys)
    packed = tp.remap(tp.rows['packed'][sel])
    root = _RootRows(sel, slots, doc, key, packed, flags[sel], vals[sel])
    idx_sel = ((root.flags == FLAG_SET) & (root.vals != TOMBSTONE)) | \
        (root.flags == FLAG_INC)
    fleet._index_ops(slots[idx_sel], key[idx_sel], packed[idx_sel])
    return root


def _stage_register_rows(fleet, tp, root, ps):
    """Exact mode: the kept map-key rows, with their pred lists in fleet
    numbering, as one register-scan dispatch. A pred naming an actor the
    fleet never registered is zeroed and its row goes inexact (host
    replay re-validates it) rather than killing actor 0's slot."""
    from .registers import apply_register_batch_donated, rows_to_register_batch
    n_rows = len(root.slots)
    if not n_rows:
        return
    pred_off = tp.rows['pred_off']
    pred_counts = np.diff(pred_off)
    preds = tp.remap(tp.rows['pred'][np.repeat(root.sel, pred_counts)]
                     ).astype(np.int32)
    bad_pred = preds < 0
    preds[bad_pred] = 0   # unknown-actor preds never reach the device
    off_kept = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(pred_counts[root.sel], out=off_kept[1:])
    bad_rows = np.zeros(n_rows, dtype=bool)
    if bad_pred.any():
        row_of_entry = np.repeat(np.arange(n_rows), pred_counts[root.sel])
        bad_rows[row_of_entry[bad_pred]] = True
    fleet._ensure_reg_capacity(n_docs=fleet.n_slots, n_keys=len(fleet.keys))
    n_cap = fleet.reg_state.reg.shape[0]
    reg_batch = rows_to_register_batch(
        root.slots.astype(np.int64), root.flags, root.key, root.packed,
        root.vals, off_kept, preds, n_docs=n_cap, d_preds=fleet.d_preds,
        force_overflow=bad_rows)
    ps.mark('turbo_dispatch')
    apply_register_batch_donated(fleet.reg_state, reg_batch.to(fleet.device),
                                 **fleet._split(n_cap))
    fleet.metrics.dispatches += 1


def _stage_grid_rows(fleet, tp, root, ps):
    """LWW mode: the kept map-key rows as one grid dispatch, scattered
    straight into capacity-shaped columns. Pred-scoped deletes (ref
    new.js:1204-1217): del rows (FLAG_SET, TOMBSTONE value) write no
    winner, their preds become kill lanes; a pred of an unregistered
    actor makes its slot mirror-authoritative instead of killing actor
    0. Then the host winner mirror advances (_note_grid_batch)."""
    from .ingest import build_kill_lanes, layout_doc_rows, max_pred_per_inc
    from .tensor_doc import OpBatch
    n_root = len(root.slots)
    if not n_root:
        return
    slots, key, packed, vals = root.slots, root.key, root.packed, root.vals
    fleet._ensure_capacity(n_docs=fleet.n_slots, n_keys=len(fleet.keys))
    n_cap = fleet._grid_cap()
    del_sel = (root.flags == FLAG_SET) & (vals == TOMBSTONE)
    set_sel = (root.flags == FLAG_SET) & ~del_sel
    inc_sel = root.flags == FLAG_INC
    # Lane layout with no argsort: kept root rows are doc-contiguous (rows
    # in change order, changes in doc order), so a row's lane is its rank
    # in its doc run
    run_starts = np.r_[0, np.flatnonzero(root.doc[1:] != root.doc[:-1]) + 1]
    run_lens = np.diff(np.r_[run_starts, n_root])
    pos = np.arange(n_root) - np.repeat(run_starts, run_lens)
    shape = (n_cap, max(int(run_lens.max()), 1))
    grid_cols = [np.zeros(shape, dtype=dt)
                 for dt in (np.int32,) * 3 + (bool,) * 3]
    for out, col in zip(grid_cols, (key, packed, vals, set_sel, inc_sel,
                                    set_sel | inc_sel)):
        out[slots, pos] = col
    batch = OpBatch(*grid_cols)

    kills = None
    kill_doc = kill_key_f = kill_packed_f = ()
    pred_counts = np.diff(tp.rows['pred_off'])
    counts_root = pred_counts[root.sel]
    off_root = tp.rows['pred_off'][:-1][root.sel]
    if del_sel.any():
        # the del rows' pred runs, out of the full batch's pred column
        del_all = np.zeros(len(pred_counts), dtype=bool)
        del_all[np.flatnonzero(root.sel)[del_sel]] = True
        kill_doc, kill_key_f, kill_packed_f = build_kill_lanes(
            slots[del_sel].astype(np.int64),
            key[del_sel].astype(np.int64), counts_root[del_sel],
            tp.rows['pred'][np.repeat(del_all, pred_counts)], tp.actor_map,
            on_bad_actor=lambda ds: fleet.grid_overflow.update(
                int(s) for s in ds))
        # laid out at capacity so _dispatch_grid skips its pad copy
        (kk_arr, kp_arr), _ = layout_doc_rows(
            kill_doc, n_cap, (kill_key_f, kill_packed_f),
            (np.int32, np.int32))
        kills = (kk_arr, kp_arr)

    ps.mark('turbo_dispatch')
    fleet._dispatch_grid(batch, kills)
    # Counter-attribution check: advance the host winner mirror with the
    # set and kill rows, and hold each inc's pred to the post-batch winner
    if set_sel.any() or inc_sel.any() or del_sel.any():
        inc_preds = max_pred_per_inc(
            tp.rows['pred'], off_root[inc_sel], counts_root[inc_sel],
            tp.actor_map)
        fleet._note_grid_batch(slots[set_sel], key[set_sel],
                               packed[set_sel], slots[inc_sel],
                               key[inc_sel], inc_preds,
                               kill_doc, kill_key_f, kill_packed_f)


def _kept(col, sel):
    """A batch column's kept rows: the column itself (read, never
    written) when `sel` is None, every row being kept."""
    return col if sel is None else col[sel]


def _stage_seq_runs(fleet, tp, keep_seq, vals, slots_of_doc):
    """Kept sequence rows -> one _SeqRuns dispatch (fleet numbering),
    laid out by their (doc, object) runs: the parser emits rows in
    change order and changes in doc order, so a doc's ops on one object
    are one run unless objects interleave (_SeqRuns sorts those)."""
    if not keep_seq.any():
        return
    from .sequence import INC, INSERT, SET, DEL, SEQ_PRED_LANES
    rows = tp.rows
    sel = None if keep_seq.all() else keep_seq
    sflags = _kept(rows['flags'], sel)
    svtype = _kept(rows['vtype'], sel)
    wire_value = _kept(rows['value'], sel)
    svalue = wire_value.astype(np.int64)
    is_mk = sflags >= FLAG_ELEM_MAKE_TEXT     # make element rows
    any_mk = bool(is_mk.any())
    if any_mk:
        # make rows carry their boxed link value, not the insert bit
        svalue[is_mk] = _kept(vals, sel)[is_mk]
    # (doc, objectId) runs with no sort: a run breaks where the change
    # or the object does; runs of one object over a doc's consecutive
    # changes then merge
    schange = _kept(rows['doc'], sel)
    sobj = _kept(rows['obj'], sel)
    n_seq = len(sflags)
    starts = np.flatnonzero(np.r_[True, (schange[1:] != schange[:-1]) |
                                  (sobj[1:] != sobj[:-1])])
    run_doc = tp.change_doc[schange[starts]]
    run_obj = sobj[starts]
    fresh = np.r_[True, (run_doc[1:] != run_doc[:-1]) |
                  (run_obj[1:] != run_obj[:-1])]
    if not fresh.all():
        starts, run_doc, run_obj = \
            starts[fresh], run_doc[fresh], run_obj[fresh]
    lens = np.diff(np.r_[starts, n_seq])
    # each run's device row and type
    run_row = np.empty(len(starts), dtype=np.int64)
    run_txt = np.empty(len(starts), dtype=bool)
    slots = slots_of_doc.tolist()
    for i, (d, obj_nat) in enumerate(zip(run_doc.tolist(),
                                         run_obj.tolist())):
        row = fleet.slot_seq[slots[d]][tp.oid(obj_nat)]
        run_row[i] = row
        run_txt[i] = fleet.seq_rows[row]['type'] == 'text'
    # one type for the whole batch (a bool), else one an op
    one_type = bool(run_txt.all() or not run_txt.any())
    txt = bool(run_txt[0]) if one_type else np.repeat(run_txt, lens)

    kind_lut = np.zeros(FLAG_ELEM_MAKE_TABLE + 1, dtype=np.int32)
    kind_lut[FLAG_SEQ_INSERT], kind_lut[FLAG_SEQ_SET] = INSERT, SET
    kind_lut[FLAG_SEQ_DEL], kind_lut[FLAG_SEQ_INC] = DEL, INC
    skind = kind_lut[sflags]
    if any_mk:
        # the wire value of a make element row is its insert bit
        skind[is_mk] = np.where(wire_value[is_mk] != 0, INSERT, SET)
    D = SEQ_PRED_LANES
    pred_off = rows['pred_off']
    counts_seq = _kept(np.diff(pred_off), sel)
    off_seq = _kept(pred_off[:-1], sel)
    pred_col = rows['pred']
    pred_lanes = []
    for d in range(D):
        has = counts_seq > d
        lane = None
        if has.all():
            lane = tp.remap(pred_col[off_seq + d])
        elif has.any():
            # gather THEN remap: only the kept seq rows' lanes, not the
            # whole batch's pred column
            lane = np.zeros(n_seq, dtype=pred_col.dtype)
            lane[has] = tp.remap(pred_col[off_seq[has] + d])
        pred_lanes.append(lane)
    # host-side inexact flags (the rule of _pack_seq_op): pred lists past
    # the lane width, object elements inside Text rows, and inc deltas
    # past the bit-packed counter lane's +/-2^29 envelope
    hflag = counts_seq > D
    if any_mk:
        hflag |= is_mk & txt
    is_inc = sflags == FLAG_SEQ_INC
    if is_inc.any():
        hflag |= is_inc & (np.abs(svalue) >= (1 << 29))
    # Re-intern every payload the device lane can't carry inline
    # through _intern_seq_value — THE shared sequence-value rule:
    # text rows inline single code points, lists inline plain ints,
    # everything else (arena-boxed strings/bools/floats, datatyped
    # ints) boxes into the value table
    val_op = (sflags == FLAG_SEQ_INSERT) | (sflags == FLAG_SEQ_SET)
    svlen = _kept(rows['vlen'], sel)
    inline_vt = svtype == (6 if txt else 4) if one_type else \
        np.where(txt, svtype == 6, svtype == 4)
    rebox = np.flatnonzero(val_op & ~hflag & ~((svlen == 0) & inline_vt))
    seq_ri = np.flatnonzero(keep_seq) if len(rebox) and sel is not None \
        else None
    tag_names = {3: 'uint', 4: 'int', 8: 'counter', 9: 'timestamp'}
    seq_memo = {}
    for i in rebox.tolist():
        ln, vt = int(svlen[i]), int(svtype[i])
        t = txt if one_type else bool(txt[i])
        if ln > 0 or vt in (0, 1, 2):
            # pre-validated: decode_payloads covers every arena row here
            gid = int(tp.value_gid[i if seq_ri is None else int(seq_ri[i])])
            if gid < 0:
                raise AssertionError(
                    'undecoded arena payload in turbo seq batch')
            decoded = tp.values[gid]
            mk = (gid, t)
        else:
            decoded = {'value': int(svalue[i]),
                       'datatype': tag_names.get(vt)}
            mk = (decoded['value'], decoded['datatype'], t)
        vid = seq_memo.get(mk)
        if vid is None:
            vid = seq_memo[mk] = fleet._intern_seq_value(
                'text' if t else 'list',
                {'value': decoded['value'],
                 'datatype': decoded.get('datatype')})
        svalue[i] = vid
    fleet._dispatch_seq(_SeqRuns(
        run_row, lens, skind, tp.remap(_kept(rows['ref'], sel)),
        tp.remap(_kept(rows['packed'], sel)), svalue, pred_lanes, hflag))


def _has_unresolved_link(value):
    """True if a materialized tree still contains a _SeqLink (device-inexact
    sequence row) or _MapLink (recursion-backstopped subtree) anywhere,
    including inside nested maps and rendered lists."""
    if isinstance(value, (_SeqLink, _MapLink)):
        return True
    if isinstance(value, dict):
        return any(_has_unresolved_link(v) for v in value.values())
    if isinstance(value, list):
        return any(_has_unresolved_link(v) for v in value)
    return False


def materialize_docs(handles):
    """Bulk {key: value} readback for many documents; fleet-resident docs
    come from one device transfer, promoted docs from their host engine."""
    by_fleet = {}
    for handle in handles:
        state = handle['state']
        if isinstance(state, FleetDoc) and state.is_fleet:
            fleet = state.fleet
            if id(fleet) not in by_fleet:
                by_fleet[id(fleet)] = fleet.materialize_all()
    inexact_by_fleet = {}
    out = []
    for handle in handles:
        state = handle['state']
        if isinstance(state, FleetDoc) and state.is_fleet:
            fleet = state.fleet
            if fleet.exact_device:
                if id(fleet) not in inexact_by_fleet:
                    inexact_by_fleet[id(fleet)] = fleet.inexact_slots()
                if state._impl.slot in inexact_by_fleet[id(fleet)]:
                    # History fell outside the register engine's exact
                    # shape: the host mirror is authoritative
                    out.append(state.materialize())
                    continue
            if state._impl.slot in fleet.grid_overflow or \
                    state._impl.slot in fleet.del_fallback:
                # Counter spread exceeded the packing window, or the
                # doc's history contains deletes (the grid's winner view
                # after kills is best-effort): the exact host mirror is
                # authoritative for this slot
                out.append(state.materialize())
                continue
            raw = by_fleet[id(fleet)][state._impl.slot]
            if _has_unresolved_link(raw):
                # A sequence row is device-inexact (concurrent overwrite,
                # counter in list): the host mirror serves the whole doc
                out.append(state.materialize())
            else:
                out.append(raw)
        elif isinstance(state, FleetDoc):
            out.append(state.materialize())
        else:
            raise TypeError('materialize_docs needs fleet backend handles')
    return out
