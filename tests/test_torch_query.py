# The port's copy of tests/test_query.py, imports re-pointed at
# automerge_tpu_torch and the fleets on the CPU (device='cpu'); the
# differential classes at the end hold the port to automerge_tpu.
"""Query engine (automerge_tpu_torch/query/): time-travel reads at historical
frontiers and incremental patch subscriptions.

The load-bearing contracts:

- `materialize_at` at EVERY prefix frontier of a merge-heavy doc is
  byte-identical to replaying that prefix from scratch — for live,
  parked (MainStore), and delta-tail-parked docs, across both device
  modes.
- Batched reads cost O(1) fused dispatches regardless of N; a
  subscription tick costs ZERO device dispatches (pure hash-graph work).
- Cursor hygiene is typed: hostile cursor bytes fail `InvalidCursor`,
  unknown frontiers fail `UnknownHeads` (or resync, in the hub) — a
  subscriber is never sent a wrong patch.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import automerge_tpu_torch.backend as host_backend                     # noqa: E402
from automerge_tpu_torch.columnar import (                             # noqa: E402
    decode_change_meta, encode_change)
from automerge_tpu_torch.errors import (                               # noqa: E402
    InvalidCursor, UnknownHeads)
from automerge_tpu_torch.fleet import backend as fleet_backend         # noqa: E402
from automerge_tpu_torch.fleet.backend import (                        # noqa: E402
    DocFleet, init_docs, park_docs)
from automerge_tpu_torch.fleet.storage import StorageEngine            # noqa: E402
from automerge_tpu_torch.query import (                                # noqa: E402
    SubscriptionHub, decode_cursor, diff_since, encode_cursor,
    materialize_at, materialize_at_docs)


def _change(actor, seq, start_op, deps, key, val):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}]})


def _merge_heavy_history(n_rounds=3):
    """A branching/merging two-actor history in causal order: each round
    both actors edit concurrently off the current frontier, then actor a
    merges — so every third prefix frontier is multi-head. Returns the
    change buffers; `_fix_frontiers` recomputes the per-prefix heads."""
    a, b = 'aa' * 16, 'bb' * 16
    changes = []
    heads = []
    seq = {a: 0, b: 0}
    op = {a: 1, b: 1}

    def emit(actor, deps):
        seq[actor] += 1
        buf = _change(actor, seq[actor], op[actor], deps,
                      f'k{len(changes)}', len(changes))
        op[actor] += 1
        changes.append(buf)
        return decode_change_meta(buf, True)['hash']

    for _r in range(n_rounds):
        ha = emit(a, heads)
        hb = emit(b, heads)
        heads = [emit(a, sorted([ha, hb]))]
    return changes


def _fix_frontiers(changes):
    """Recompute frontiers[k] (heads after the first k changes) from the
    change headers — the ground truth `_merge_heavy_history` must match."""
    frontiers = [[]]
    heads = set()
    for buf in changes:
        meta = decode_change_meta(buf, True)
        heads -= set(meta['deps'])
        heads.add(meta['hash'])
        frontiers.append(sorted(heads))
    return frontiers


def _control_save(changes):
    """Replay-from-scratch control: the canonical save bytes of a host
    doc holding exactly `changes`."""
    doc = host_backend.init()
    if changes:
        doc, _ = host_backend.apply_changes(doc, list(changes))
    return bytes(host_backend.save(doc))


@pytest.fixture(params=['lww', 'exact'])
def fleet(request):
    return DocFleet(exact_device=(request.param == 'exact'), device='cpu')


class TestMaterializeAt:
    def _loaded_doc(self, fleet, changes):
        handles = init_docs(1, fleet)
        handles, _ = fleet_backend.apply_changes_docs(
            handles, [list(changes)], mirror=False)
        return handles[0]

    def _assert_every_prefix(self, fleet, source, changes):
        """All prefix frontiers in ONE batched read (the audit-read
        shape: N frontiers, one fused dispatch), each byte-identical to
        a from-scratch replay of its prefix."""
        frontiers = _fix_frontiers(changes)
        outs = materialize_at_docs([source] * len(frontiers), frontiers,
                                   fleet=fleet)
        for k, (frontier, out) in enumerate(zip(frontiers, outs)):
            assert sorted(out['state'].heads) == frontier
            assert bytes(out['state'].save()) == \
                _control_save(changes[:k]), f'frontier {k}'
        fleet_backend.free_docs(outs)

    def test_every_prefix_frontier_byte_identical_live(self, fleet):
        changes = _merge_heavy_history()
        handle = self._loaded_doc(fleet, changes)
        self._assert_every_prefix(fleet, handle, changes)
        # the singular form agrees (one frontier, spot-check)
        frontiers = _fix_frontiers(changes)
        out = materialize_at(handle, frontiers[4], fleet=fleet)
        assert bytes(out['state'].save()) == _control_save(changes[:4])
        fleet_backend.free_docs([out])

    def test_every_prefix_frontier_byte_identical_parked(self, fleet):
        changes = _merge_heavy_history()
        handle = self._loaded_doc(fleet, changes)
        eng = StorageEngine(fleet)
        ids = eng.park([handle])
        assert ids[0] is not None
        self._assert_every_prefix(fleet, (eng, ids[0]), changes)
        # the audit reads never revived the parked doc
        assert len(eng.main) == 1

    def test_every_prefix_frontier_delta_tail_parked(self, fleet):
        # in-fleet parked prefix + turbo delta tail: history spans the
        # parked chunk AND the tail; selection must cover both
        changes = _merge_heavy_history()
        split = len(changes) // 2
        handle = self._loaded_doc(fleet, changes[:split])
        assert park_docs([handle]) == 1
        handle, _ = fleet_backend.apply_changes_docs(
            [handle], [list(changes[split:])], mirror=False)
        handle = handle[0]
        impl = handle['state']._impl
        assert impl._doc_pending is not None or impl._changes, \
            'expected a parked/tail engine'
        self._assert_every_prefix(fleet, handle, changes)

    def test_batched_reads_one_fused_dispatch(self, fleet):
        changes = _merge_heavy_history()
        frontiers = _fix_frontiers(changes)
        handle = self._loaded_doc(fleet, changes)
        deltas = {}
        for n in (3, 9):
            before = fleet.metrics.dispatches
            outs = materialize_at_docs(
                [handle] * n,
                [frontiers[1 + i % (len(frontiers) - 1)]
                 for i in range(n)], fleet=fleet)
            deltas[n] = fleet.metrics.dispatches - before
            fleet_backend.free_docs(outs)
        assert deltas[3] == deltas[9], deltas

    def test_unknown_heads_typed(self, fleet):
        changes = _merge_heavy_history(1)
        handle = self._loaded_doc(fleet, changes)
        with pytest.raises(UnknownHeads) as exc_info:
            materialize_at(handle, ['ee' * 32], fleet=fleet)
        assert exc_info.value.missing == ['ee' * 32]
        # parked form rejects identically
        eng = StorageEngine(fleet)
        ids = eng.park([handle])
        with pytest.raises(UnknownHeads):
            materialize_at((eng, ids[0]), ['ee' * 32], fleet=fleet)

    def test_quarantine_mode_contains_bad_frontier(self, fleet):
        changes = _merge_heavy_history(1)
        frontiers = _fix_frontiers(changes)
        handle = self._loaded_doc(fleet, changes)
        handles, errors = materialize_at_docs(
            [handle, handle], [['ee' * 32], frontiers[-1]],
            fleet=fleet, on_error='quarantine')
        assert handles[0] is None
        assert isinstance(errors[0].error, UnknownHeads)
        assert errors[1] is None
        assert bytes(handles[1]['state'].save()) == _control_save(changes)
        fleet_backend.free_docs([handles[1]])

    def test_redundant_frontier_normalizes(self, fleet):
        # a frontier naming a change AND its ancestor materializes at
        # the maximal elements
        changes = _merge_heavy_history(1)
        frontiers = _fix_frontiers(changes)
        handle = self._loaded_doc(fleet, changes)
        redundant = frontiers[-1] + frontiers[1]
        out = materialize_at(handle, redundant, fleet=fleet)
        assert sorted(out['state'].heads) == frontiers[-1]
        fleet_backend.free_docs([out])


class TestCursorCodec:
    def test_round_trip(self):
        heads = ['ab' * 32, 'cd' * 32]
        assert decode_cursor(encode_cursor(heads)) == sorted(heads)
        assert decode_cursor(encode_cursor([])) == []
        # dedupe + sort on encode
        assert decode_cursor(encode_cursor(heads[::-1] + heads)) == \
            sorted(heads)

    def test_hostile_bytes_fail_typed(self):
        good = encode_cursor(['ab' * 32])
        hostile = [b'', b'\x00', b'garbage', good[:-5], good + b'x',
                   bytes([0x52]) + good[1:],
                   bytes([0x51, 0xff, 0xff, 0xff, 0xff, 0x7f])]
        for mutant in hostile:
            with pytest.raises(InvalidCursor):
                decode_cursor(mutant)

    def test_unsorted_wire_cursor_rejected(self):
        # hand-built cursor with unsorted hashes: reject (canonical form
        # keeps equivalence classes honest)
        from automerge_tpu_torch.encoding import Encoder
        out = Encoder()
        out.append_byte(0x51)
        out.append_uint53(2)
        out.append_raw_bytes(bytes.fromhex('cd' * 32))
        out.append_raw_bytes(bytes.fromhex('ab' * 32))
        with pytest.raises(InvalidCursor):
            decode_cursor(out.buffer)


class TestSubscriptionHub:
    def _serve(self, fleet, changes):
        handles = init_docs(1, fleet)
        handles, _ = fleet_backend.apply_changes_docs(
            handles, [list(changes)], mirror=False)
        return handles[0]

    def test_patch_folds_byte_identical(self, fleet):
        changes = _merge_heavy_history()
        handle = self._serve(fleet, changes)
        hub = SubscriptionHub()
        hub.register('d', handle)
        sub = hub.subscribe('d')
        ev = hub.tick()[sub.id]
        assert ev['kind'] == 'patch'
        shadow = host_backend.init()
        shadow, _ = host_backend.apply_changes(shadow, ev['changes'])
        assert host_backend.get_heads(shadow) == ev['heads']
        assert bytes(host_backend.save(shadow)) == \
            bytes(handle['state'].save())
        # cursor advanced: next tick is quiet
        assert hub.tick() == {}

    def test_incremental_diff_only(self, fleet):
        changes = _merge_heavy_history()
        split = len(changes) - 3
        handle = self._serve(fleet, changes[:split])
        hub = SubscriptionHub()
        hub.register('d', handle)
        sub = hub.subscribe('d')
        first = hub.tick()[sub.id]
        assert len(first['changes']) == split
        handle, _ = fleet_backend.apply_changes_docs(
            [handle], [list(changes[split:])], mirror=False)
        hub.update_source('d', handle[0])
        second = hub.tick()[sub.id]
        assert len(second['changes']) == 3       # ONLY the delta
        shadow = host_backend.init()
        shadow, _ = host_backend.apply_changes(shadow, first['changes'])
        shadow, _ = host_backend.apply_changes(shadow, second['changes'])
        assert bytes(host_backend.save(shadow)) == \
            bytes(handle[0]['state'].save())

    def test_equivalence_class_reuse(self, fleet):
        changes = _merge_heavy_history()
        handle = self._serve(fleet, changes)
        hub = SubscriptionHub()
        hub.register('d', handle)
        subs = [hub.subscribe('d') for _ in range(10)]
        events = hub.tick()
        assert len(events) == 10
        assert hub.stats['diffs_computed'] == 1
        assert hub.stats['diffs_reused'] == 9
        assert all(events[s.id]['heads'] == sorted(handle['state'].heads)
                   for s in subs)

    def test_tick_costs_zero_dispatches(self, fleet):
        changes = _merge_heavy_history()
        handles = init_docs(8, fleet)
        handles, _ = fleet_backend.apply_changes_docs(
            handles, [list(changes)] * 8, mirror=False)
        hub = SubscriptionHub()
        for i, handle in enumerate(handles):
            hub.register(i, handle)
            for _ in range(5):
                hub.subscribe(i)
        before = fleet.metrics.dispatches
        events = hub.tick()
        assert len(events) == 40
        assert fleet.metrics.dispatches == before, \
            'a subscription tick must be pure host graph work'

    def test_bogus_cursor_resyncs_typed_never_wrong(self, fleet):
        changes = _merge_heavy_history()
        handle = self._serve(fleet, changes)
        hub = SubscriptionHub()
        hub.register('d', handle)
        sub = hub.subscribe('d', cursor=['99' * 32])
        ev = hub.tick()[sub.id]
        assert ev['kind'] == 'resync'
        assert ev['error'] == 'UnknownHeads'
        shadow = host_backend.init()
        shadow, _ = host_backend.apply_changes(shadow, ev['changes'])
        assert bytes(host_backend.save(shadow)) == \
            bytes(handle['state'].save())
        assert hub.stats['resyncs'] == 1

    def test_replayed_cursor_idempotent(self, fleet):
        changes = _merge_heavy_history()
        frontiers = _fix_frontiers(changes)
        handle = self._serve(fleet, changes)
        hub = SubscriptionHub()
        hub.register('d', handle)
        sub = hub.subscribe('d')
        first = hub.tick()[sub.id]
        # the client lost the push: replay from an old (valid) frontier
        hub.resubscribe(sub, frontiers[2])
        again = hub.tick()[sub.id]
        assert again['kind'] == 'patch'
        shadow = host_backend.init()
        shadow, _ = host_backend.apply_changes(shadow, first['changes'][:2])
        assert host_backend.get_heads(shadow) == frontiers[2]
        shadow, _ = host_backend.apply_changes(shadow, again['changes'])
        assert bytes(host_backend.save(shadow)) == \
            bytes(handle['state'].save())

    def test_park_revive_churn_mid_subscription(self, fleet):
        changes = _merge_heavy_history()
        split = len(changes) - 3
        handle = self._serve(fleet, changes[:split])
        hub = SubscriptionHub(device='cpu')   # its only source parks
        hub.register('d', handle)
        sub = hub.subscribe('d')
        hub.tick()
        # park: the source becomes a (store, id) pair — cursors survive
        eng = StorageEngine(fleet)
        ids = eng.park([handle])
        hub.update_source('d', (eng, ids[0]))
        assert hub.tick() == {}                   # quiet, served parked
        # revive, extend, rebind: the diff picks up from the cursor
        back = eng.revive(ids)
        back, _ = fleet_backend.apply_changes_docs(
            back, [list(changes[split:])], mirror=False)
        hub.update_source('d', back[0])
        ev = hub.tick()[sub.id]
        assert len(ev['changes']) == 3
        assert ev['heads'] == sorted(back[0]['state'].heads)

    def test_unregister_closes(self, fleet):
        changes = _merge_heavy_history(1)
        handle = self._serve(fleet, changes)
        hub = SubscriptionHub()
        hub.register('d', handle)
        sub = hub.subscribe('d')
        hub.unregister('d')
        assert hub.tick()[sub.id] == {'kind': 'closed'}
        assert len(hub) == 0


class TestDiffSince:
    def test_live_and_parked_agree(self, fleet):
        changes = _merge_heavy_history()
        frontiers = _fix_frontiers(changes)
        handles = init_docs(1, fleet)
        handles, _ = fleet_backend.apply_changes_docs(
            handles, [list(changes)], mirror=False)
        handle = handles[0]
        chunk = bytes(handle['state'].save())
        eng = StorageEngine(fleet)
        ids = eng.ingest_chunks([chunk])
        for frontier in frontiers:
            live_changes, live_heads = diff_since(handle, frontier)
            parked_changes, parked_heads = diff_since((eng, ids[0]),
                                                      frontier)
            assert live_heads == parked_heads
            # the live log keeps application order, the chunk its
            # canonical order — same change SET, both causally valid
            assert sorted(bytes(c) for c in live_changes) == \
                sorted(parked_changes)

    def test_quiet_class_computes_once(self, fleet, monkeypatch):
        # regression: a QUIET equivalence class (cursor == heads) must
        # memoize its answer too — 5 at-frontier subscribers cost one
        # diff_since call per tick, not five
        import automerge_tpu_torch.query.subscriptions as subs_mod
        changes = _merge_heavy_history(1)
        handles = init_docs(1, fleet)
        handles, _ = fleet_backend.apply_changes_docs(
            handles, [list(changes)], mirror=False)
        handle = handles[0]
        hub = SubscriptionHub()
        hub.register('d', handle)
        subs = [hub.subscribe('d') for _ in range(5)]
        assert len(hub.tick()) == 5           # first tick: full patches
        calls = []
        orig = subs_mod.diff_since
        monkeypatch.setattr(
            subs_mod, 'diff_since',
            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        assert hub.tick() == {}               # all quiet now
        # the batched frontier compare proves the tick quiet with ZERO
        # diff_since calls (round 18); the memoized slow path must still
        # cost exactly one per class — both pinned
        assert len(calls) == 0, f'{len(calls)} diffs for a batched tick'
        assert hub.stats['quiet'] >= 5
        hub.batch_quiet = False
        calls.clear()
        assert hub.tick() == {}
        assert len(calls) == 1, f'{len(calls)} diffs for one quiet class'

    def test_non_canonical_count_rejected(self):
        # non-minimal LEB128 count (80 00 = padded zero): decodes to []
        # upstream but is NOT the canonical frame for [] — reject, or
        # equivalent cursors split equivalence classes
        with pytest.raises(InvalidCursor):
            decode_cursor(bytes([0x51, 0x80, 0x00]))
        assert decode_cursor(bytes([0x51, 0x00])) == []


class _StubHistory:
    """A selection-capable history whose buffers the apply gate will
    reject (poisoned mid-log) — the rotted-parked-chunk shape."""

    def __init__(self, changes):
        import automerge_tpu_torch.columnar as columnar
        self.changes = [bytes(c) for c in changes]
        metas = [columnar.decode_change_meta(c, True) for c in changes]
        self.change_index_by_hash = {m['hash']: i
                                     for i, m in enumerate(metas)}
        self.dependencies_by_hash = {m['hash']: list(m['deps'])
                                     for m in metas}
        self.heads = [metas[-1]['hash']]
        # poison the FIRST buffer after hashing: selection still works
        # off the metadata, the fused apply rejects the bytes
        bad = bytearray(self.changes[0])
        bad[10] ^= 0x40
        self.changes[0] = bytes(bad)


class TestApplyStageQuarantine:
    def test_poisoned_history_costs_only_its_slot(self, fleet):
        from automerge_tpu_torch.errors import WireCorruption
        changes = _merge_heavy_history(1)
        frontiers = _fix_frontiers(changes)
        good = init_docs(1, fleet)
        good, _ = fleet_backend.apply_changes_docs(
            good, [list(changes)], mirror=False)
        stub = _StubHistory(changes)
        handles, errors = materialize_at_docs(
            [stub, good[0]], [stub.heads, frontiers[-1]],
            fleet=fleet, on_error='quarantine')
        assert handles[0] is None
        assert isinstance(errors[0].error, WireCorruption)
        assert errors[1] is None
        assert bytes(handles[1]['state'].save()) == _control_save(changes)
        fleet_backend.free_docs([handles[1]])

    def test_rotted_chunk_source_costs_only_its_slot(self, fleet):
        from automerge_tpu_torch.errors import MalformedDocument
        changes = _merge_heavy_history(1)
        frontiers = _fix_frontiers(changes)
        good = init_docs(1, fleet)
        good, _ = fleet_backend.apply_changes_docs(
            good, [list(changes)], mirror=False)
        rotted = bytearray(bytes(good[0]['state'].save()))
        rotted[6] ^= 0x08                      # checksum no longer holds
        handles, errors = materialize_at_docs(
            [bytes(rotted), good[0]], [frontiers[-1], frontiers[-1]],
            fleet=fleet, on_error='quarantine')
        assert handles[0] is None
        assert isinstance(errors[0].error, MalformedDocument)
        assert errors[1] is None
        assert bytes(handles[1]['state'].save()) == _control_save(changes)
        fleet_backend.free_docs([handles[1]])
        # raise mode still aborts typed
        with pytest.raises(MalformedDocument):
            materialize_at(bytes(rotted), frontiers[-1], fleet=fleet)


# ---- the port against the reference ----------------------------------
#
# The same change bytes go through automerge_tpu (JAX on the CPU) and
# automerge_tpu_torch (torch on the CPU); everything compared is exact.

import automerge_tpu.backend as ref_host                         # noqa: E402
from automerge_tpu import query as ref_query                     # noqa: E402
from automerge_tpu.errors import (                               # noqa: E402
    InvalidCursor as RefInvalidCursor, UnknownHeads as RefUnknownHeads)
from automerge_tpu.fleet import backend as ref_fleet_backend     # noqa: E402
from automerge_tpu.fleet import hashindex as ref_hashindex       # noqa: E402
from automerge_tpu.fleet.storage import (                        # noqa: E402
    StorageEngine as RefStorageEngine)

from automerge_tpu_torch import query as port_query              # noqa: E402
from automerge_tpu_torch.fleet import hashindex                  # noqa: E402


class _Pkg:
    """One package's query stack, so a scenario runs unchanged on
    both."""

    def __init__(self, name, fb, query, storage, hindex, host, unknown,
                 invalid, fleet_kw):
        self.name, self.fb, self.query = name, fb, query
        self.storage, self.hashindex, self.host = storage, hindex, host
        self.UnknownHeads, self.InvalidCursor = unknown, invalid
        self.fleet_kw = fleet_kw

    def fleet(self, mode):
        return self.fb.DocFleet(exact_device=(mode == 'exact'),
                                **self.fleet_kw)

    def serve(self, fleet, changes, n=1):
        handles = self.fb.init_docs(n, fleet)
        handles, _ = self.fb.apply_changes_docs(
            handles, [list(changes)] * n, mirror=False)
        return handles


REF = _Pkg('reference', ref_fleet_backend, ref_query, RefStorageEngine,
           ref_hashindex, ref_host, RefUnknownHeads, RefInvalidCursor, {})
PORT = _Pkg('port', fleet_backend, port_query, StorageEngine, hashindex,
            host_backend, UnknownHeads, InvalidCursor, {'device': 'cpu'})


def _source(pkg, fleet, handle, kind):
    if kind == 'live':
        return handle
    if kind == 'parked':
        eng = pkg.storage(fleet)
        return (eng, eng.park([handle])[0])
    return bytes(handle['state'].save())


def _prefix_reads(pkg, mode, kind):
    """Every prefix frontier of the merge-heavy doc in one batched read:
    (saves, heads, fleet dispatches of the read)."""
    changes = _merge_heavy_history()
    frontiers = _fix_frontiers(changes)
    fleet = pkg.fleet(mode)
    handle = pkg.serve(fleet, changes)[0]
    source = _source(pkg, fleet, handle, kind)
    before = fleet.metrics.dispatches
    outs = pkg.query.materialize_at_docs([source] * len(frontiers),
                                         frontiers, fleet=fleet)
    dispatches = fleet.metrics.dispatches - before
    saves = [bytes(out['state'].save()) for out in outs]
    heads = [sorted(out['state'].heads) for out in outs]
    pkg.fb.free_docs(outs)
    return saves, heads, dispatches


@pytest.fixture(params=['lww', 'exact'])
def mode(request):
    return request.param


class TestMaterializeAtAgainstReference:
    """Every prefix frontier's materialized save() is byte-identical
    across the packages, and a batched read is one fused dispatch in
    both."""

    def _check(self, mode, kind):
        ref = _prefix_reads(REF, mode, kind)
        port = _prefix_reads(PORT, mode, kind)
        assert port[0] == ref[0]
        assert port[1] == ref[1]
        assert port[2] == ref[2] == 1

    def test_live_source(self, mode):
        self._check(mode, 'live')

    def test_parked_source(self, mode):
        self._check(mode, 'parked')

    def test_chunk_source(self, mode):
        self._check(mode, 'chunk')

    def test_typed_errors_match(self, mode):
        changes = _merge_heavy_history(1)
        frontiers = _fix_frontiers(changes)
        got = {}
        for pkg in (REF, PORT):
            fleet = pkg.fleet(mode)
            handle = pkg.serve(fleet, changes)[0]
            with pytest.raises(pkg.UnknownHeads) as exc_info:
                pkg.query.materialize_at(handle, ['ee' * 32], fleet=fleet)
            handles, errors = pkg.query.materialize_at_docs(
                [handle, handle], [['ee' * 32], frontiers[-1]],
                fleet=fleet, on_error='quarantine')
            assert handles[0] is None and errors[1] is None
            got[pkg.name] = (str(exc_info.value), exc_info.value.missing,
                             errors[0].describe(),
                             bytes(handles[1]['state'].save()))
            pkg.fb.free_docs([handles[1]])
        assert got['port'] == got['reference']


class TestCursorsAgainstReference:
    def test_cursor_bytes_and_rejections_match(self):
        frontiers = _fix_frontiers(_merge_heavy_history())
        for frontier in frontiers:
            wire = REF.query.encode_cursor(frontier)
            assert bytes(PORT.query.encode_cursor(frontier)) == bytes(wire)
            assert PORT.query.decode_cursor(wire) == \
                REF.query.decode_cursor(wire)
        good = bytes(REF.query.encode_cursor(frontiers[-1]))
        hostile = [b'', b'\x00', b'garbage', good[:-5], good + b'x',
                   bytes([0x52]) + good[1:], bytes([0x51, 0x80, 0x00]),
                   bytes([0x51, 0xff, 0xff, 0xff, 0xff, 0x7f])]
        for mutant in hostile:
            with pytest.raises(RefInvalidCursor) as ref_exc:
                REF.query.decode_cursor(mutant)
            with pytest.raises(InvalidCursor) as port_exc:
                PORT.query.decode_cursor(mutant)
            assert str(port_exc.value) == str(ref_exc.value)


def _hub_scenario(pkg, mode):
    """Subscribers at the empty, a mid, a bogus and a cross-doc cursor;
    a tail lands; a resubscribe replays. Returns every tick's events
    (change bytes as bytes), the hub's stats and the fleet dispatches
    the ticks cost."""
    changes = _merge_heavy_history()
    frontiers = _fix_frontiers(changes)
    split = len(changes) - 3
    fleet = pkg.fleet(mode)
    handles = pkg.serve(fleet, changes[:split], n=3)
    hub = pkg.query.SubscriptionHub()
    for i, handle in enumerate(handles):
        hub.register(i, handle)
    subs = [hub.subscribe(0), hub.subscribe(0, frontiers[2]),
            hub.subscribe(1, ['99' * 32]), hub.subscribe(1),
            hub.subscribe(2, frontiers[split]), hub.subscribe(2)]
    ticks = []

    def tick():
        before = fleet.metrics.dispatches
        events = hub.tick()
        ticks.append((fleet.metrics.dispatches - before, {
            sid: {k: ([bytes(c) for c in v] if k == 'changes' else v)
                  for k, v in ev.items()} for sid, ev in events.items()}))

    tick()
    out, _ = pkg.fb.apply_changes_docs(
        [handles[0]], [list(changes[split:])], mirror=False)
    hub.update_source(0, out[0])
    tick()
    hub.resubscribe(subs[3], frontiers[1])
    tick()
    tick()                                   # all quiet
    hub.unregister(2)
    tick()
    return ticks, dict(hub.stats)


class TestSubscriptionsAgainstReference:
    def test_events_match(self, mode):
        ref_ticks, ref_stats = _hub_scenario(REF, mode)
        port_ticks, port_stats = _hub_scenario(PORT, mode)
        assert port_ticks == ref_ticks
        assert port_stats == ref_stats
        # no tick costs a merge dispatch (the all-quiet one is a
        # frontier compare, counted apart)
        assert [d for d, _ in port_ticks] == [0] * len(port_ticks)
        assert port_ticks[3][1] == {}

    def test_quiet_tick_one_compare_on_the_fleets_device(self, mode):
        changes = _merge_heavy_history(1)
        counts = {}
        for pkg in (REF, PORT):
            fleet = pkg.fleet(mode)
            handles = pkg.serve(fleet, changes, n=8)
            # no device keyword: the compare runs on the shared fleet's
            # device (the CPU here; CUDA would raise on this machine)
            hub = pkg.query.SubscriptionHub()
            for i, handle in enumerate(handles):
                hub.register(i, handle)
                for _ in range(5):
                    hub.subscribe(i)
            assert len(hub.tick()) == 40
            before = pkg.hashindex.dispatch_count()
            merges = fleet.metrics.dispatches
            assert hub.tick() == {}
            counts[pkg.name] = (pkg.hashindex.dispatch_count() - before,
                                fleet.metrics.dispatches - merges,
                                hub.stats['quiet'])
        assert counts['port'] == counts['reference'] == (1, 0, 40)

    def test_host_sources_compare_on_the_hubs_device(self):
        changes = _merge_heavy_history(1)
        docs = []
        for pkg in (REF, PORT):
            doc = pkg.host.init()
            doc, _ = pkg.host.apply_changes(doc, list(changes))
            docs.append(doc)
        counts = []
        for pkg, doc, kw in ((REF, docs[0], {}),
                             (PORT, docs[1], {'device': 'cpu'})):
            hub = pkg.query.SubscriptionHub(**kw)
            hub.register('d', doc)
            sub = hub.subscribe('d')
            first = hub.tick()[sub.id]
            before = pkg.hashindex.dispatch_count()
            assert hub.tick() == {}
            counts.append((pkg.hashindex.dispatch_count() - before,
                           [bytes(c) for c in first['changes']],
                           first['heads']))
        assert counts[1] == counts[0]
        assert counts[1][0] == 1
