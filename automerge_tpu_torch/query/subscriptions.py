"""Incremental patch subscriptions: push only the diff since a cursor.

A subscriber follows a document without running a full sync peer: it
holds a CURSOR (the heads frontier of the last state it folded) and, per
tick, receives the changes PAST that frontier — exactly the incremental
recomputation of a view over a growing op graph that "Formal Foundations
of Continuous Graph Processing" frames (PAPERS.md). Folding the pushed
buffers onto the subscriber's shadow copy reproduces the server document
at the pushed heads byte-identically (the chaos-universe audit pins it).

``SubscriptionHub`` is the fan-out engine:

- Documents register under caller-chosen keys; sources can be live fleet
  handles OR parked ``(store, id)`` rows — a doc parking or reviving
  mid-subscription just rebinds its source (``update_source``), cursors
  survive because history (and its hashes) survives.
- Per tick, subscribers group into (doc, cursor-frontier) EQUIVALENCE
  CLASSES: one diff is computed per class and shared by every member, so
  10k subscribers at k distinct cursors over one doc cost k selection
  walks — and ZERO device dispatches (the diff is pure hash-graph work;
  the dispatch-count tests pin it).
- Cursor hygiene is typed, never wrong: a cursor naming hashes outside
  the doc's history (bogus, or stale past a server that never had them)
  triggers a full RESYNC event (changes from the empty frontier) tagged
  with the typed ``UnknownHeads`` — plus a forensic flight-recorder dump
  — while replayed-but-valid cursors simply get the (idempotent) diff
  from their older frontier again.

``encode_cursor``/``decode_cursor`` are the wire form of a cursor (what
a client presents over the service boundary); hostile bytes fail with
typed ``InvalidCursor`` (``WireCorruption``) — tools/fuzz_wire.py holds
the decode boundary to the zero-untyped-escapes contract.
"""

import time

import numpy as np

from ..encoding import Decoder, Encoder
from ..errors import InvalidCursor, UnknownHeads, as_wire_error
from ..observability import hist as _hist
from ..observability import recorder as _flight
from ..observability.metrics import Counters
from ..observability.spans import span as _span
from .history import history_of, select_descendants

__all__ = ['SubscriptionHub', 'Subscription', 'encode_cursor',
           'decode_cursor', 'diff_since']

CURSOR_MAGIC = 0x51          # 'Q': a query-engine cursor frame
_MAX_CURSOR_HEADS = 4096     # count-bomb ceiling (a real frontier is tiny)


def encode_cursor(heads):
    """Wire form of a cursor: magic byte + uint53 count + 32-byte hashes
    (sorted, deduped). The inverse of ``decode_cursor``."""
    heads = sorted(dict.fromkeys(str(h) for h in heads))
    out = Encoder()
    out.append_byte(CURSOR_MAGIC)
    out.append_uint53(len(heads))
    for h in heads:
        raw = bytes.fromhex(h)
        if len(raw) != 32:
            raise ValueError(f'cursor head is not a 32-byte hash: {h!r}')
        out.append_raw_bytes(raw)
    return out.buffer


def decode_cursor(data):
    """Decode cursor bytes to a sorted list of hex head hashes. Hostile
    bytes (bad magic, count bombs, truncation, trailing garbage) raise
    typed ``InvalidCursor`` — never a bare decoder exception."""
    try:
        decoder = Decoder(bytes(data))
        if decoder.read_byte() != CURSOR_MAGIC:
            raise ValueError('cursor does not begin with magic byte 0x51')
        count = decoder.read_uint53()
        if count > _MAX_CURSOR_HEADS:
            raise ValueError(f'cursor head count {count} exceeds '
                             f'{_MAX_CURSOR_HEADS}')
        heads = [decoder.read_raw_bytes(32).hex() for _ in range(count)]
        if not decoder.done:
            raise ValueError('cursor has trailing data')
        if heads != sorted(dict.fromkeys(heads)):
            raise ValueError('cursor heads are not sorted and unique')
        # canonical-form discipline, enforced as decode∘encode identity:
        # a frame that decodes but would not re-encode to the same bytes
        # (e.g. a non-minimal LEB count) must be rejected, or equivalent
        # cursors would split subscriber equivalence classes
        if bytes(encode_cursor(heads)) != bytes(data):
            raise ValueError('cursor frame is not in canonical form')
    except Exception as exc:
        raise as_wire_error(exc, InvalidCursor, 'decode_cursor')
    return heads


def diff_since(source, cursor, what='diff_since'):
    """(changes, heads): the change buffers past the `cursor` frontier
    and the source's current heads — the patch that takes a shadow copy
    from the cursor state to the current state. Typed ``UnknownHeads``
    when the cursor names history the source does not have.

    The quiet case (cursor already at the heads) is answered from the
    causal state alone: a parked doc's chunk is never extracted, a live
    doc's graph never materialized — at-frontier subscribers are the
    steady state, so their tick cost is a heads comparison."""
    cursor = sorted(str(h) for h in cursor)
    if isinstance(source, tuple):
        heads = sorted(source[0].heads(source[1]))
    elif not isinstance(source, (bytes, bytearray)):
        state = source.get('state') if isinstance(source, dict) else source
        heads = sorted(state.heads)
    else:
        heads = None
    if heads is not None and cursor == heads:
        return [], heads
    history = history_of(source)
    if heads is None:
        heads = sorted(history.heads)
        if cursor == heads:
            return [], heads
    start = time.perf_counter()
    changes = select_descendants(history, cursor, what=what)
    _hist.record_value('subscription_diff_s',
                       time.perf_counter() - start, scale=1e9, unit='s')
    return [bytes(c) for c in changes], heads


class Subscription:
    """One subscriber's hub-side state. ``cursor`` auto-advances to the
    pushed heads on every patch/resync event (delivery is assumed; a
    client that lost a push re-subscribes — or presents its own cursor
    via ``resubscribe`` — and gets the idempotent diff again).
    ``fresh_tick`` is the hub tick at which the cursor last matched the
    document heads (the freshness SLI's anchor: a push's cursor lag is
    the ticks elapsed since then)."""

    __slots__ = ('id', 'key', 'cursor', 'priority', 'closed',
                 'fresh_tick', 'born_tick')

    def __init__(self, sid, key, cursor, priority, born_tick=0):
        self.id = sid
        self.key = key
        self.cursor = list(cursor)
        self.priority = priority
        self.closed = False
        self.fresh_tick = None
        # hub tick count at subscribe time: an all-quiet fast tick's
        # hub-wide freshness floor applies to this subscriber only for
        # ticks it actually existed in (floor > born_tick)
        self.born_tick = born_tick

    def __repr__(self):
        return (f'Subscription({self.id}, key={self.key!r}, '
                f'cursor={len(self.cursor)} heads)')


class SubscriptionHub:
    """See the module docstring. Single-threaded by contract, like the
    service core it plugs into.

    ``device`` (the port's one difference from the reference) is the
    torch device of the all-quiet compare when no source is a fleet doc;
    otherwise the compare runs on the shared fleet's own device. None is
    CUDA (it raises without a card when the compare runs)."""

    def __init__(self, batch_quiet=True, device=None):
        self._sources = {}           # key -> query source
        self._subs = {}              # sub id -> Subscription
        self._next_sid = 0
        self._slo = None             # (SloRegistry, tenant_of) when bound
        # stats ride the atomic Counters family like every other module
        # stat: the threaded shard pump can tick hubs concurrently with
        # readers, and a bare-dict `+=` is a splittable read-modify-write
        # (the round-15 undercount bug class)
        self.stats = Counters({
            'ticks': 0, 'pushes': 0, 'resyncs': 0, 'quiet': 0,
            'diffs_computed': 0, 'diffs_reused': 0, 'lag_max': 0,
        })
        # (key, cursor tuple) -> member count, maintained incrementally
        # at every cursor-mutation point so the tick can enumerate
        # equivalence CLASSES (k of them) without walking subscribers
        # (10k of them) — the all-quiet fast path's input
        self._classes = {}
        self._cursor_rows = {}       # ckey -> (head32 row | None, n)
        self._class_epoch = 0        # bumped when the class SET changes
        self._source_epoch = 0       # bumped when a source (re)binds
        self._scan_cache = None      # assembled compare arrays (by epoch)
        self.batch_quiet = batch_quiet
        # the hub-wide freshness floor: the latest tick every subscriber
        # was proven at-frontier by the batched compare (per-sub
        # fresh_tick updates are exactly what the fast path skips)
        self._quiet_floor = None
        self.device = device

    def bind_slo(self, registry, tenant_of=str):
        """Feed the freshness SLI: every served push reports its cursor
        lag (ticks since the subscriber was last at the heads) to
        ``registry.record_freshness`` under ``tenant_of(key)`` — the
        hub already walks each subscriber per tick, so the accounting
        rides the walk instead of adding a rescan. ``registry=None``
        unbinds."""
        self._slo = None if registry is None else (registry, tenant_of)

    # -- documents -----------------------------------------------------

    def register(self, key, source):
        """Bind `key` to a query source (live handle, parked (store, id)
        pair, or raw chunk bytes). Re-registering rebinds."""
        self._sources[key] = source
        self._source_epoch += 1

    update_source = register

    def unregister(self, key):
        """Drop the doc; its subscribers resolve closed on next tick."""
        self._sources.pop(key, None)
        self._source_epoch += 1

    def keys(self):
        return list(self._sources)

    # -- subscribers ---------------------------------------------------

    def subscribe(self, key, cursor=None, priority=0):
        """Attach a subscriber to `key` at `cursor` (None/[] = from the
        empty document: the first tick pushes the full state)."""
        if key not in self._sources:
            raise KeyError(f'no document registered under {key!r}')
        sid = self._next_sid
        self._next_sid += 1
        sub = Subscription(sid, key, cursor or [], priority,
                           born_tick=self.stats['ticks'])
        self._subs[sid] = sub
        self._class_add(sub)
        return sub

    def resubscribe(self, sub, cursor):
        """Reset a subscriber's cursor (the client-driven recovery path:
        present the frontier of the state you actually hold)."""
        if self._subs.get(sub.id) is sub:
            self._class_move(sub, list(cursor))
        else:
            # detached subscriber: its classes were already released —
            # touch only the cursor, never the live class map
            sub.cursor = list(cursor)

    def unsubscribe(self, sub):
        sub.closed = True
        if self._subs.pop(sub.id, None) is not None:
            self._class_drop(sub)

    def __len__(self):
        return len(self._subs)

    # -- cursor equivalence classes ------------------------------------

    @staticmethod
    def _ckey(sub):
        return (sub.key, tuple(sorted(sub.cursor)))

    def _class_add(self, sub):
        ckey = self._ckey(sub)
        count = self._classes.get(ckey, 0)
        self._classes[ckey] = count + 1
        if count == 0:
            self._class_epoch += 1

    def _class_drop(self, sub):
        ckey = self._ckey(sub)
        n = self._classes.get(ckey, 0) - 1
        if n > 0:
            self._classes[ckey] = n
        else:
            self._classes.pop(ckey, None)
            self._cursor_rows.pop(ckey, None)
            self._class_epoch += 1

    def _class_move(self, sub, new_cursor):
        self._class_drop(sub)
        sub.cursor = new_cursor
        self._class_add(sub)

    def _cursor_row(self, ckey):
        """(head32 row | None, head count) for a class cursor; row None
        marks a host-residue cursor (multi-head, or not a hex hash)."""
        ent = self._cursor_rows.get(ckey)
        if ent is None:
            heads = ckey[1]
            if len(heads) == 0:
                ent = (np.zeros(32, dtype=np.uint8), 0)
            elif len(heads) == 1 and len(heads[0]) == 64:
                try:
                    row = np.frombuffer(bytes.fromhex(heads[0]),
                                        dtype=np.uint8)
                except ValueError:
                    row = None
                ent = (row, 1)
            else:
                ent = (None, len(heads))
            self._cursor_rows[ckey] = ent
        return ent

    # -- the tick ------------------------------------------------------

    def tick(self):
        """One fan-out round. Returns {sub_id: event} for every
        subscriber owed something this tick; quiet subscribers (cursor
        already at the doc's heads) are omitted. Events:

        - ``{'kind': 'patch', 'changes': [...], 'heads': [...]}`` —
          fold the buffers onto the shadow copy; it now equals the
          server doc at ``heads``.
        - ``{'kind': 'resync', 'changes': [...], 'heads': [...],
          'error': 'UnknownHeads'}`` — the cursor was invalid; the
          changes rebuild the doc from scratch (fold onto an EMPTY
          shadow).
        - ``{'kind': 'closed'}`` — the doc was unregistered.

        One diff per (doc, cursor-frontier) equivalence class; class
        members past the first are served from the memo (the
        ``diffs_reused`` counter / reuse ratio in bench). An ALL-QUIET
        tick (every class cursor at its doc's frontier) is proven by ONE
        batched frontier-compare dispatch over the classes — cursor
        head32 rows against the fleet's columnar ``_DocCols`` heads —
        and returns without walking subscribers at all; any non-quiet
        residue falls back to this per-class diff path byte-identically
        (proven-quiet classes just pre-seed the memo)."""
        from . import _stats

        tick_no = self.stats.inc('ticks')
        quiet_classes = None
        with _span('subscription_tick', subscribers=len(self._subs)):
            if self.batch_quiet and self._subs:
                quiet_classes, all_quiet = self._try_batch_quiet()
                if all_quiet:
                    # every subscriber is at its frontier: one counter
                    # bump and a hub-wide freshness floor instead of 10k
                    # attribute writes (push-time lag accounting folds
                    # the floor back in)
                    self.stats.inc('quiet', len(self._subs))
                    self._quiet_floor = tick_no
                    return {}
            events = {}
            memo = {}              # (key, cursor tuple) -> event | None
            if quiet_classes:
                # classes the batched compare already proved quiet: the
                # diff path would return None for them by definition
                # (cursor == heads), so seed the memo and skip the
                # recompute — the residue keeps the existing path
                for ckey in quiet_classes:
                    memo[ckey] = None
            invalid = []
            for sub in list(self._subs.values()):
                source = self._sources.get(sub.key)
                if source is None:
                    events[sub.id] = {'kind': 'closed'}
                    if self._subs.pop(sub.id, None) is not None:
                        self._class_drop(sub)
                    continue
                ckey = (sub.key, tuple(sorted(sub.cursor)))
                if ckey in memo:
                    # membership, not get(): a QUIET class memoizes None,
                    # and its members must share that answer instead of
                    # recomputing (one diff — or one heads compare — per
                    # class, even at 10k at-frontier subscribers)
                    event = memo[ckey]
                    if event is not None:
                        self.stats.inc('diffs_reused')
                        _stats.inc('subscription_diff_reuse')
                else:
                    event = self._class_diff(source, sub, invalid)
                    memo[ckey] = event
                    if event is not None:
                        self.stats.inc('diffs_computed')
                if event is None:
                    self.stats.inc('quiet')
                    sub.fresh_tick = tick_no   # at the heads right now
                    continue
                events[sub.id] = event
                self._class_move(sub, list(event['heads']))
                self.stats.inc('pushes')
                _stats.inc('subscription_pushes')
                # freshness: this push catches the cursor up — its lag
                # is the ticks since the subscriber was last at-frontier
                # (per-sub fresh_tick, or the hub-wide all-quiet floor
                # for ticks the subscriber existed in)
                base = sub.fresh_tick
                floor = self._quiet_floor
                if floor is not None and floor > sub.born_tick and \
                        (base is None or floor > base):
                    base = floor
                lag = 0 if base is None else tick_no - base
                sub.fresh_tick = tick_no
                if lag > self.stats['lag_max']:
                    self.stats['lag_max'] = lag
                if self._slo is not None:
                    registry, tenant_of = self._slo
                    registry.record_freshness(tenant_of(sub.key), lag)
        if invalid:
            _flight.dump_flight_record('query', detail={
                'invalid_cursors': invalid})
        return events

    # -- the batched quiet proof ---------------------------------------

    @staticmethod
    def _doc_frontier(source):
        """The doc's frontier in its cheapest form: ('cols', doc_cols,
        slot, head_n) for a single-or-empty-head fleet doc (compares on
        device), ('host', sorted hex list) when a host compare is
        cheap, None when there is no cheap frontier (raw chunk bytes,
        freed engines) — the tick then takes the slow path."""
        if isinstance(source, tuple):
            return ('host', sorted(source[0].heads(source[1])))
        if isinstance(source, (bytes, bytearray)):
            return None
        state = source.get('state') if isinstance(source, dict) else source
        impl = getattr(state, '_impl', state)
        slot = getattr(impl, 'slot', None)
        fleet = getattr(impl, 'fleet', None)
        if fleet is not None and isinstance(slot, int):
            cols = fleet.doc_cols
            n = int(cols.head_n[slot])
            if 0 <= n <= 1:
                return ('cols', cols, slot, n, fleet)
            # multi-head (in the head lanes or past them): the host list
            return ('host', sorted(impl.heads))
        heads = getattr(state, 'heads', None)
        if heads is None:
            return None
        return ('host', sorted(heads))

    def _scan_plan(self):
        """The compare plan for the CURRENT class set, cached until the
        set changes (cursor moves / churn bump ``_class_epoch``; the
        all-quiet steady state never rebuilds): the device-comparable
        classes' cursor rows as assembled arrays, their keys deduplicated
        with a class->key index vector, and the host-residue classes
        (multi-head / non-hex cursors) listed separately."""
        epochs = (self._class_epoch, self._source_epoch)
        cache = self._scan_cache
        if cache is not None and cache['epochs'] == epochs:
            return cache
        dev_ckeys, dev_rows, dev_n, key_idx = [], [], [], []
        host_ckeys = []
        keys, key_of = [], {}
        for ckey in self._classes:
            k = key_of.get(ckey[0])
            if k is None:
                k = key_of[ckey[0]] = len(keys)
                keys.append(ckey[0])
            cur_row, cur_n = self._cursor_row(ckey)
            if cur_row is None:
                host_ckeys.append((ckey, k))
            else:
                dev_ckeys.append(ckey)
                dev_rows.append(cur_row)
                dev_n.append(cur_n)
                key_idx.append(k)
        # resolve every key's SOURCE once per (class, source) epoch pair:
        # fleet docs collapse to (shared _DocCols, slot) for one gather
        # per tick; anything else stays 'dynamic' (re-resolved per tick);
        # a missing source or one with no cheap frontier disables the
        # whole scan (closed events / the slow path are owed)
        n_keys = len(keys)
        col_slots = np.full(n_keys, -1, dtype=np.int64)
        dynamic = []                 # key indexes resolved per tick
        shared_cols = None
        shared_fleet = None
        usable = True
        for k, key in enumerate(keys):
            source = self._sources.get(key)
            if source is None:
                usable = False
                break
            frontier = self._doc_frontier(source)
            if frontier is None:
                usable = False
                break
            if frontier[0] == 'cols' and \
                    (shared_cols is None or shared_cols is frontier[1]):
                shared_cols = frontier[1]
                shared_fleet = frontier[4]
                col_slots[k] = frontier[2]
            else:
                dynamic.append(k)
        cache = {
            'epochs': epochs,
            'keys': keys,
            'dev_ckeys': dev_ckeys,
            'cur32': np.stack(dev_rows) if dev_rows else
                np.zeros((0, 32), dtype=np.uint8),
            'cur_n': np.asarray(dev_n, dtype=np.int32),
            'key_idx': np.asarray(key_idx, dtype=np.int64),
            'host_ckeys': host_ckeys,
            'usable': usable,
            'shared_cols': shared_cols,
            'shared_fleet': shared_fleet,
            'free_epoch': shared_fleet.free_epoch
                if shared_fleet is not None else 0,
            'col_slots': col_slots,
            'dynamic': dynamic,
        }
        self._scan_cache = cache
        return cache

    def _try_batch_quiet(self):
        """Prove per-class quietness in ONE frontier-compare dispatch:
        per-KEY doc frontiers gathered from the ``_DocCols`` columns,
        fanned out to classes through the cached plan's index vector.
        Returns (proven_quiet_ckeys, all_quiet); (None, False) when the
        scan cannot run — a class's doc is unregistered (closed events
        are owed) or has no cheap frontier."""
        from ..fleet.hashindex import frontier_compare

        if not self._classes:
            # belt-and-braces: an empty class map with live subscribers
            # would otherwise prove a vacuous all-quiet
            return None, False
        plan = self._scan_plan()
        if plan['shared_fleet'] is not None and \
                plan['shared_fleet'].free_epoch != plan['free_epoch']:
            # slots were freed since the plan was built: a recycled slot
            # must never serve a stale frontier row — re-resolve
            self._scan_cache = None
            plan = self._scan_plan()
        if not plan['usable']:
            return None, False
        keys = plan['keys']
        n_keys = len(keys)
        key_rows = np.zeros((n_keys, 32), dtype=np.uint8)
        key_n = np.zeros(n_keys, dtype=np.int32)
        key_lists = [None] * n_keys    # hex lists, for host compares
        shared_cols = plan['shared_cols']
        col_slots = plan['col_slots']
        gather = col_slots >= 0
        if gather.any():
            # the steady-state path: every fleet doc's frontier in two
            # vectorized gathers off the shared _DocCols columns
            slots = col_slots[gather]
            key_rows[gather] = shared_cols.head32[slots, 0]
            key_n[gather] = shared_cols.head_n[slots]
        for k in plan['dynamic']:
            source = self._sources.get(keys[k])
            if source is None:
                return None, False
            frontier = self._doc_frontier(source)
            if frontier is None:
                return None, False
            if frontier[0] == 'cols':
                cols, slot, doc_n = frontier[1], frontier[2], frontier[3]
                key_rows[k] = cols.head32[slot, 0]
                key_n[k] = doc_n
            else:
                heads = frontier[1]
                key_lists[k] = heads
                key_n[k] = len(heads)
                if len(heads) == 1 and len(heads[0]) == 64:
                    try:
                        key_rows[k] = np.frombuffer(
                            bytes.fromhex(heads[0]), dtype=np.uint8)
                    except ValueError:
                        key_n[k] = -9      # non-hex head: never quiet
        quiet = set()
        if len(plan['dev_ckeys']):
            idx = plan['key_idx']
            fleet = plan['shared_fleet']
            flags = frontier_compare(plan['cur32'], plan['cur_n'],
                                     key_rows[idx], key_n[idx],
                                     device=self.device if fleet is None
                                     else fleet.device)
            for ckey, flag in zip(plan['dev_ckeys'], flags):
                if flag:
                    quiet.add(ckey)
        for ckey, k in plan['host_ckeys']:
            # residue cursors (multi-head / non-hex): exact list compare
            # against the doc frontier; columnar docs hold 0/1 heads so
            # only a 'host'-form doc can ever match them
            heads = key_lists[k]
            if heads is None:
                doc_n = int(key_n[k])
                heads = [] if doc_n == 0 else \
                    [key_rows[k].tobytes().hex()] if doc_n == 1 else None
            if heads is not None and list(ckey[1]) == heads:
                quiet.add(ckey)
        return quiet, len(quiet) == len(self._classes)

    def _class_diff(self, source, sub, invalid):
        """The diff event for one (doc, cursor) class; None = quiet."""
        from . import _stats
        try:
            changes, heads = diff_since(source, sub.cursor,
                                        what='subscription_tick')
        except UnknownHeads as exc:
            # bogus/stale cursor: typed, resync from scratch — never a
            # wrong patch
            self.stats['resyncs'] += 1
            _stats.inc('subscription_resyncs')
            _stats.inc('unknown_heads')
            invalid.append({'subscriber': sub.id, 'key': repr(sub.key),
                            'error': type(exc).__name__,
                            'message': str(exc)[:200]})
            changes, heads = diff_since(source, [],
                                        what='subscription_resync')
            return {'kind': 'resync', 'changes': changes, 'heads': heads,
                    'error': type(exc).__name__}
        if not changes and sorted(sub.cursor) == heads:
            return None
        return {'kind': 'patch', 'changes': changes, 'heads': heads}
