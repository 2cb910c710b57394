"""Fleet-scale batched sync driver (torch port of
automerge_tpu/fleet/sync_driver.py).

The round's two Bloom dispatches are the CUDA kernels behind
fleet/bloom.py, its membership probes and sent-set inserts the CUDA
kernels behind fleet/hashindex.py (fleet/sync_kernels.py). The Bloom
dispatches run on the device of the batch's fleet, or on `device=` when
the caller names one (CUDA when the batch holds no fleet doc). The
mixed live/parked variants are the reference's: they revive the parked
docs a peer needs through fleet/storage.py in one batched revive, then
run the fused round on the revived fleet's device.

The reference's description follows.

The host protocol (``backend/sync.py``, ref backend/sync.js:234-306) builds
one Bloom filter per peer and probes each candidate change hash one at a
time — fine for two peers, quadratic pain for a fleet syncing with thousands.
Here the same control flow runs over N (document, peer-state) pairs with the
two filter-heavy steps batched into ONE device dispatch each per round —
O(1) in the peer count AND in the per-peer filter-size skew (the flat
packed layout in fleet/bloom.py gives every filter its exact wire-format
byte span inside one concatenated vector, so differing entry counts no
longer split the batch into per-size-class dispatches, and batch memory
stays proportional to real filter bytes). `dispatch_count()` exposes the
round's device-call count for bench.py and the regression tests:

- ``generate_sync_messages_docs``: every doc's Bloom build (over its
  changes since sharedHeads) lands in one ``build_bloom_filters_batch``
  dispatch, and every doc's changes-to-send scan probes the peer's filter
  in one ``probe_bloom_filters_batch`` dispatch. Both dispatches are
  issued async (begin/finish pairs) so the device build and the packed
  filter-byte transfers overlap the host-side graph scans, and filters
  cross the link bit-packed (see fleet/bloom.py). Messages are
  byte-identical to the host ``generate_sync_message`` outputs.
- ``receive_sync_messages_docs``: all received changes apply through
  ``apply_changes_docs`` (one device merge dispatch on the fleet backend's
  turbo path), then the sharedHeads algebra runs per doc.

Wire format, resets, and the dependents-closure repair of Bloom false
positives are unchanged — graph traversal stays host-side (SURVEY.md §2.11).
"""

import hashlib

from ..backend import (
    get_heads, get_missing_deps, get_change_by_hash, get_change_hashes,
)
from ..columnar import CHUNK_TYPE_CHANGE, MAGIC_BYTES as _MAGIC
from ..backend.sync import (
    _cached_meta, advance_heads, changes_to_send_finish,
    changes_to_send_prescan, decode_sync_message, encode_sync_message,
)
from ..errors import DocError, MalformedSyncMessage, as_wire_error
from ..observability import recorder as _flight
from ..observability import tracecontext as _trace
from ..observability.metrics import Counters, register_health_source
from ..observability.spans import span as _span
from .backend import FleetDoc, apply_changes_docs, quarantine_stats
from .bloom import (
    build_bloom_filters_batch_begin, build_bloom_filters_batch_finish,
    dispatch_count, probe_bloom_filters_batch_begin,
    probe_bloom_filters_batch_finish,
)

__all__ = ['generate_sync_messages_docs', 'receive_sync_messages_docs',
           'generate_sync_messages_mixed', 'receive_sync_messages_mixed',
           'dispatch_count']


# the enable flag lives in hashindex so the single-doc protocol path
# (backend/sync.py -> _FlatEngine.probe_hashes) honors the same toggle
from .hashindex import (  # noqa: E402,F401
    PeerSentSet, frontier_enabled, probe_peer_sets, release_sync_state,
    set_frontier_enabled,
)

_stats = Counters({
    'sync_frontier_member_docs': 0,     # docs probed via the hashindex
    'sync_frontier_straggler_docs': 0,  # docs routed classic in a
                                        # frontier-served round
    'sync_peer_space_links': 0,         # links whose sentHashes rode a
})                                      # peer-space this round
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def _frontier_of(backends):
    """(FleetFrontierIndex, {i: engine}) over the FLEET SUBSET of a
    batch — the docs whose membership probes (theirHave lastSync
    reconciliation, received-heads lookup, incoming-change dedup) ride
    the device-resident frontier index as batched dispatches instead of
    per-doc host-dict probes (fleet/hashindex.py). Host backends,
    promoted docs, and docs of a second fleet are STRAGGLERS: absent
    from the map, they keep the classic dict path — one promoted doc no
    longer reverts the whole round (the mixed-batch routing ROADMAP
    follow-up). None when the index is disabled or no doc qualifies."""
    if not frontier_enabled():
        return None
    members = {}
    fleet = None
    for i, backend in enumerate(backends):
        state = backend.get('state') if isinstance(backend, dict) else None
        if not isinstance(state, FleetDoc) or not state.is_fleet:
            continue
        engine = state._impl
        if fleet is None:
            fleet = engine.fleet
        elif engine.fleet is not fleet:
            continue        # a second fleet's docs route classic
        members[i] = engine
    if not members:
        return None
    return fleet.frontier_index(), members


def _probe_pairs_grouped(fidx, members, hashes_by_doc):
    """Batch the member docs' membership questions into ONE index probe:
    hashes_by_doc[i] is a (possibly empty) list of hex hashes for member
    doc i. Returns {i: [bool, ...]} aligned with each doc's list (docs
    with no hashes are omitted)."""
    flat_e, flat_h, owners = [], [], []
    for i, hashes in hashes_by_doc.items():
        engine = members[i]
        for h in hashes:
            flat_e.append(engine)
            flat_h.append(h)
            owners.append(i)
    if not flat_h:
        return {}
    hits = fidx.probe_pairs(flat_e, flat_h)
    out = {}
    for i, hit in zip(owners, hits):
        out.setdefault(i, []).append(bool(hit))
    return out


def _batched_generate_probes(frontier, sync_states):
    """The generate round's TWO membership questions — get_missing_deps
    candidates (the peer's advertised heads plus deps of causally-queued
    changes) and the theirHave lastSync reconciliation — merged into ONE
    index dispatch for the member docs. Returns (our_need, reset_known),
    both keyed by doc index: our_need[i] exactly matches
    backend.get_missing_deps (the equivalence tests pin it);
    reset_known[i] is all-lastSync-hashes-known, defaulting True for
    docs with nothing to check. Straggler docs appear in neither."""
    fidx, members = frontier
    cands, queued, last_syncs = {}, {}, {}
    for i, engine in members.items():
        state = sync_states[i]
        all_deps = set(state['theirHeads'] or [])
        in_queue = set()
        for change in engine.queue:
            in_queue.add(change['hash'])
            all_deps.update(change['deps'])
        cands[i] = sorted(all_deps)
        queued[i] = in_queue
        their_have = state['theirHave']
        last_syncs[i] = their_have[0]['lastSync'] if their_have else []
    hits = _probe_pairs_grouped(
        fidx, members,
        {i: cands[i] + last_syncs[i] for i in members})
    our_need, reset_known = {}, {}
    for i in members:
        flags = hits.get(i, [])
        need_flags = flags[:len(cands[i])]
        our_need[i] = [h for h, known in zip(cands[i], need_flags)
                       if not known and h not in queued[i]]
        if last_syncs[i]:
            reset_known[i] = all(flags[len(cands[i]):])
    return our_need, reset_known


def _fused_sent_filter(sync_states, changes_to_send_by_doc):
    """{i: [bool]} "already sent on this link?" flags for every doc
    whose sentHashes rides a peer-space (``PeerSentSet``): ALL such
    links' questions fuse into at most one staged-flush insert plus one
    probe dispatch for the round (hashindex.probe_peer_sets). Plain-set
    links are absent — their check is a host set hit, and a member link
    only promotes to a peer-space the first time it actually sends."""
    idxs = [i for i, ch in changes_to_send_by_doc.items()
            if ch and isinstance(sync_states[i]['sentHashes'],
                                 PeerSentSet)]
    if not idxs:
        return {}
    flags = probe_peer_sets(
        [sync_states[i]['sentHashes'] for i in idxs],
        [[_cached_meta(c)['hash'] for c in changes_to_send_by_doc[i]]
         for i in idxs])
    _stats.inc('sync_peer_space_links', len(idxs))
    return dict(zip(idxs, flags))


def _device_of(backends, device):
    """The device of the round's Bloom dispatches: `device` when given,
    else the fleet's of the batch's first fleet doc, else None (CUDA,
    resolved only if a dispatch is issued)."""
    if device is not None:
        return device
    for backend in backends:
        state = backend.get('state') if isinstance(backend, dict) else None
        if isinstance(state, FleetDoc) and state.is_fleet:
            return state._impl.fleet.device
    return None


def generate_sync_messages_docs(backends, sync_states, deadline=None,
                                trace_ctx=None, device=None):
    """Batched ``generate_sync_message`` over N (backend, syncState) pairs.
    Returns (new_sync_states, messages) with messages[i] = bytes or None,
    byte-identical to the host function applied per doc. All Bloom builds
    share one device dispatch; all peer-filter probes share another.
    `deadline` is checked before the build dispatch is issued (generation
    mutates no document state, so the check is purely a latency bound).

    `trace_ctx` OPTS the round into cross-peer trace stitching: every
    produced message is prepended with the trace envelope
    (observability/tracecontext.py), so the receiving peer's spans join
    this trace. Without it the wire bytes are untouched (the
    byte-identity contract above holds) — an AMBIENT context
    (``tracecontext.use``) only decorates this round's spans with the
    trace id, it never changes the wire.

    `device` places the Bloom dispatches (see `_device_of`)."""
    n = len(backends)
    if len(sync_states) != n:
        raise ValueError('backends and sync_states must align')
    if deadline is not None:
        deadline.check(what='generate_sync_messages_docs')
    with _span('sync_generate', docs=n,
               **_trace.trace_attr(trace_ctx)):
        new_states, messages = _generate_inner(
            backends, sync_states, n, _device_of(backends, device))
    if trace_ctx is not None:
        messages = [m if m is None else _trace.wrap(m, trace_ctx)
                    for m in messages]
    return new_states, messages


def _generate_inner(backends, sync_states, n, device):
    our_heads = [get_heads(b) for b in backends]
    frontier = _frontier_of(backends)
    # With a frontier index, the member docs' membership questions —
    # get_missing_deps candidates AND each doc's theirHave lastSync
    # reconciliation — merge into ONE batched dispatch here, replacing
    # per-doc get_change_by_hash dict probes: O(1) dispatches regardless
    # of peer count or history depth, and no hash-graph dict build for
    # docs that are otherwise quiet. Stragglers (host backends, promoted
    # docs, a second fleet) take the classic path WITHOUT demoting the
    # member subset.
    if frontier is not None:
        member_need, reset_known = _batched_generate_probes(frontier,
                                                            sync_states)
        _stats.inc('sync_frontier_member_docs', len(frontier[1]))
        _stats.inc('sync_frontier_straggler_docs', n - len(frontier[1]))
    else:
        member_need, reset_known = {}, None
    our_need = [member_need[i] if i in member_need
                else get_missing_deps(b, s['theirHeads'] or [])
                for i, (b, s) in enumerate(zip(backends, sync_states))]

    # Phase 1 — which docs attach a filter, and over which hashes. The
    # build dispatch is issued here but not materialized until after the
    # probe dispatch: the device builds (and the link moves packed filter
    # bytes) while phase 2's host-side graph scans run.
    bloom_hash_lists = [None] * n
    for i, (backend, state) in enumerate(zip(backends, sync_states)):
        their_heads = state['theirHeads']
        if their_heads is None or all(h in their_heads for h in our_need[i]):
            bloom_hash_lists[i] = get_change_hashes(
                backend, state['sharedHeads'])
    build_handle = build_bloom_filters_batch_begin(
        [row if row is not None else [] for row in bloom_hash_lists], device)

    # Phase 2 — full-resync resets, and the changes-to-send pre-scan
    # (the lastSync reconciliation answers come from the merged phase-1
    # probe when the frontier index is on)
    results = [None] * n          # i -> (new_state, message or None)
    probe_rows = []               # flattened (doc, filter) probe requests
    probe_meta = []               # i -> ('probe', changes, first_row, n_filters)
    for i, (backend, state) in enumerate(zip(backends, sync_states)):
        their_have, their_need = state['theirHave'], state['theirNeed']
        if their_have:
            last_sync = their_have[0]['lastSync']
            known = reset_known.get(i, True) if i in member_need \
                else all(get_change_by_hash(backend, h) is not None
                         for h in last_sync)
            if not known:
                reset = {'heads': our_heads[i], 'need': [],
                         'have': [{'lastSync': [], 'bloom': b''}],
                         'changes': []}
                results[i] = (state, encode_sync_message(reset))
                continue
        if not (isinstance(their_have, list) and
                isinstance(their_need, list)):
            probe_meta.append(None)
            continue
        mode, payload = changes_to_send_prescan(backend, their_have,
                                                their_need)
        if mode == 'need-only':
            probe_meta.append(('done', i, payload))
        else:
            changes, filter_bytes = payload
            first = len(probe_rows)
            hashes = [c['hash'] for c in changes]
            for fb in filter_bytes:
                probe_rows.append((fb, hashes))
            probe_meta.append(('probe', i, changes, first,
                               len(filter_bytes)))

    probe_handle = probe_bloom_filters_batch_begin(
        [r[0] for r in probe_rows], [r[1] for r in probe_rows], device)
    built = build_bloom_filters_batch_finish(build_handle)
    our_have = [[{'lastSync': s['sharedHeads'], 'bloom': built[i]}]
                if bloom_hash_lists[i] is not None else []
                for i, s in enumerate(sync_states)]
    hits = probe_bloom_filters_batch_finish(probe_handle)

    # Phase 3 — assemble messages exactly as the host does
    changes_to_send_by_doc = {}
    for entry in probe_meta:
        if entry is None:
            continue
        if entry[0] == 'done':
            _, i, changes_list = entry
            changes_to_send_by_doc[i] = changes_list
        else:
            _, i, changes, first, n_filters = entry
            bloom_hits = [hits[first + f] for f in range(n_filters)]
            changes_to_send_by_doc[i] = changes_to_send_finish(
                backends[i], changes, bloom_hits,
                sync_states[i]['theirNeed'])

    # Fused sentHashes filter: every peer-space link's already-sent?
    # questions ride one flush insert + one probe dispatch for the whole
    # round, regardless of link count (tentpole of the sync fabric)
    sent_flags = _fused_sent_filter(sync_states, changes_to_send_by_doc)
    member_docs = frontier[1] if frontier is not None else {}

    new_states, messages = [], []
    with _span('sync_encode', docs=n):
        for i, (backend, state) in enumerate(zip(backends, sync_states)):
            if results[i] is not None:
                new_states.append(results[i][0])
                messages.append(results[i][1])
                continue
            changes_to_send = changes_to_send_by_doc.get(i, [])
            heads_unchanged = isinstance(state['lastSentHeads'], list) and \
                our_heads[i] == state['lastSentHeads']
            heads_equal = isinstance(state['theirHeads'], list) and \
                our_heads[i] == state['theirHeads']
            if heads_unchanged and heads_equal and not changes_to_send:
                new_states.append(state)
                messages.append(None)
                continue
            sent_hashes = state['sentHashes']
            if i in sent_flags:
                changes_to_send = [c for c, hit in zip(changes_to_send,
                                                       sent_flags[i])
                                   if not hit]
            else:
                changes_to_send = [
                    c for c in changes_to_send
                    if _cached_meta(c)['hash'] not in sent_hashes]
            message = {'heads': our_heads[i], 'have': our_have[i],
                       'need': our_need[i], 'changes': changes_to_send}
            if changes_to_send:
                new_hashes = [_cached_meta(c)['hash']
                              for c in changes_to_send]
                if isinstance(sent_hashes, PeerSentSet):
                    # staged host-side; next round's fused filter (or
                    # flush_peer_sets) lands the whole shard's backlog
                    # in ONE insert
                    sent_hashes.stage_many(new_hashes)
                elif i in member_docs:
                    # first send on a member link: promote the plain set
                    # to a peer-space of the fleet's table — the
                    # promotion snapshot IS the copy-on-write the
                    # classic path performed
                    sent_hashes = PeerSentSet(frontier[0].table,
                                              seed=sent_hashes)
                    sent_hashes.stage_many(new_hashes)
                else:
                    sent_hashes = set(sent_hashes)
                    sent_hashes.update(new_hashes)
            new_states.append(dict(state, lastSentHeads=our_heads[i],
                                   sentHashes=sent_hashes))
            messages.append(encode_sync_message(message))
    return new_states, messages


def receive_sync_messages_docs(backends, sync_states, binary_messages,
                               mirror=True, on_error='raise',
                               deadline=None, _decoded=None):
    """Batched ``receive_sync_message`` over N docs. messages[i] may be None
    (no-op for that doc). All received changes apply through ONE
    apply_changes_docs call (device turbo batch with mirror=False on fleet
    backends). Returns (new_backends, new_sync_states, patches) — or, with
    on_error='quarantine', (new_backends, new_sync_states, patches,
    errors): an undecodable message or a poisoned change quarantines ONLY
    its own doc (errors[i] is a DocError; that doc's backend and sync
    state stay untouched) while the other N-1 docs commit in the same
    fused dispatch. on_error='raise' aborts the round on the first bad
    input (classic contract), with a typed exception carrying the doc
    index. Messages are decoded per doc EITHER way, so the exception
    names the offender instead of dying mid-list.

    `deadline` is checked at entry and again AFTER the (host-side,
    non-mutating) decode, immediately before the fused apply dispatch —
    a deadline that fires leaves every doc and sync state untouched
    (typed DeadlineExceeded, all-or-nothing).

    Messages carrying the trace ENVELOPE (a tracing peer generated with
    ``trace_ctx``) are transparently stripped before decode, and the
    round's spans adopt the first stripped trace id — the receive side
    of cross-peer trace stitching. Plain messages pass through the
    (one-byte) probe untouched."""
    n = len(backends)
    if len(sync_states) != n or len(binary_messages) != n:
        raise ValueError('backends, sync_states, and messages must align')
    if deadline is not None:
        deadline.check(what='receive_sync_messages_docs')
    wire_ctx, binary_messages = _strip_trace_envelopes(binary_messages)
    with _span('sync_receive', docs=n,
               **_trace.trace_attr(wire_ctx)):
        return _receive_inner(backends, sync_states, binary_messages,
                              mirror, on_error, deadline, _decoded, n)


def _strip_trace_envelopes(binary_messages):
    """(first stripped TraceContext or None, messages with every trace
    envelope removed). The input list is untouched (copied on first
    strip); plain messages cost a one-byte probe. Every receive entry
    point — batched AND mixed — must strip before any decode, or an
    enveloped message from a tracing peer reads as hostile bytes."""
    wire_ctx = None
    stripped = None
    for i, message_bytes in enumerate(binary_messages):
        if message_bytes is not None and len(message_bytes) and \
                message_bytes[0] == _trace.TRACE_MAGIC:
            ctx, payload = _trace.unwrap(bytes(message_bytes))
            if ctx is not None:
                if stripped is None:
                    stripped = list(binary_messages)
                stripped[i] = payload
                if wire_ctx is None:
                    wire_ctx = ctx
    return wire_ctx, (binary_messages if stripped is None else stripped)


def _quick_change_hash(buf):
    """Hex hash of a SINGLE well-formed change chunk without any header
    decode: the change hash is SHA-256 over the chunk from the type byte
    on, and the wire checksum is its first four bytes — so one hashlib
    pass whose digest matches the stored checksum proves both that the
    buffer is exactly one chunk (no trailing bytes shifted the span) and
    that the digest IS the change's hash. Anything else (deflated,
    multi-chunk, corrupt) returns None: the caller must keep the buffer
    for the apply path, which types those cases properly."""
    b = bytes(buf)
    if len(b) > 9 and b[:4] == _MAGIC and b[8] == CHUNK_TYPE_CHANGE:
        digest = hashlib.sha256(b[8:]).digest()
        if digest[:4] == b[4:8]:
            return digest.hex()
    return None


def _dedup_known_changes(frontier, per_doc_changes):
    """Drop incoming changes already in their doc's applied history —
    ONE batched frontier-index probe for the round's MEMBER docs
    (stragglers keep their changes: the causal gate dedups them at
    general-gate prices). A resent known change (Bloom false negative,
    replayed wire) breaks the turbo chain shape and demotes its doc to
    the per-change path. Buffers whose hash has no cheap provable lane
    are kept (never wrong)."""
    fidx, members = frontier
    flat_e, flat_h, where = [], [], []
    for i, changes in enumerate(per_doc_changes):
        if i not in members:
            continue
        for j, buf in enumerate(changes):
            h = _quick_change_hash(buf)
            if h is not None:
                flat_e.append(members[i])
                flat_h.append(h)
                where.append((i, j))
    if not flat_h:
        return
    hits = fidx.probe_pairs(flat_e, flat_h)
    drop = {}
    for (i, j), hit in zip(where, hits):
        if hit:
            drop.setdefault(i, set()).add(j)
    for i, gone in drop.items():
        per_doc_changes[i] = [c for j, c in enumerate(per_doc_changes[i])
                              if j not in gone]


def _receive_inner(backends, sync_states, binary_messages, mirror,
                   on_error, deadline, _decoded, n):
    quarantine = on_error == 'quarantine'
    if not quarantine and on_error != 'raise':
        raise ValueError(f"on_error must be 'raise' or 'quarantine', "
                         f"got {on_error!r}")
    errors = [None] * n
    decoded = [None] * n
    with _span('sync_decode', docs=n):
        for i, message_bytes in enumerate(binary_messages):
            if message_bytes is None:
                continue
            if _decoded is not None and _decoded[i] is not None:
                # the mixed parked gate already decoded this message to
                # decide revive-vs-fast; don't parse the bytes twice
                decoded[i] = _decoded[i]
                continue
            try:
                decoded[i] = decode_sync_message(message_bytes)
            except Exception as exc:
                err = as_wire_error(exc, MalformedSyncMessage,
                                    'receive_sync_messages_docs',
                                    doc_index=i)
                if not quarantine:
                    raise err
                errors[i] = DocError(i, 'decode', err)
                quarantine_stats.inc('quarantined_docs')
                state = backends[i].get('state') \
                    if isinstance(backends[i], dict) else None
                _flight.record_event(
                    'quarantine', doc=i, stage='decode',
                    error=type(err).__name__, message=str(err)[:200],
                    durable_id=getattr(state, '_dur_id', None),
                    change_bytes=len(message_bytes))
    if any(e is not None for e in errors):
        # undecodable sync messages: forensic dump now — the apply path
        # below only dumps for ITS rejects, and never sees these docs
        _flight.dump_flight_record('quarantine', detail={'errors': [
            e.describe(durable_id=getattr(
                backends[i].get('state') if isinstance(backends[i], dict)
                else None, '_dur_id', None))
            for i, e in enumerate(errors) if e is not None]})
    before_heads = [get_heads(b) for b in backends]

    frontier = _frontier_of(backends)
    per_doc_changes = [list(d['changes']) if d else [] for d in decoded]
    if frontier is not None and any(per_doc_changes):
        _dedup_known_changes(frontier, per_doc_changes)
    if any(per_doc_changes):
        # the decode above was pure host-side reading; this is the last
        # point before the fused dispatch mutates anything (apply checks
        # the deadline again at its own entry)
        if quarantine:
            new_backends, patches, apply_errors = apply_changes_docs(
                backends, per_doc_changes, mirror=mirror,
                on_error='quarantine', deadline=deadline)
            for i, err in enumerate(apply_errors):
                if err is not None and errors[i] is None:
                    errors[i] = err
        else:
            new_backends, patches = apply_changes_docs(
                backends, per_doc_changes, mirror=mirror,
                deadline=deadline)
    else:
        new_backends, patches = list(backends), [None] * n

    # Received-heads membership for the member docs in ONE index
    # dispatch (post-apply: the commit staged this round's hashes, the
    # probe's flush lands them first). Quarantined docs probe nothing.
    # Derived from the POST-apply backends, not the pre-apply engine
    # list: an apply can PROMOTE a doc to the host engine (unsupported
    # ops), freeing its slot — a stale engine reference would crash the
    # probe mid-round; a freshly promoted doc simply drops out of the
    # member map and answers via the classic dict probe below.
    heads_known = None
    post_members = {}
    post_frontier = _frontier_of(new_backends)
    if post_frontier is not None:
        post_members = post_frontier[1]
        heads_known = _probe_pairs_grouped(
            post_frontier[0], post_members,
            {i: decoded[i]['heads'] for i in post_members
             if decoded[i] is not None and errors[i] is None})

    new_states = []
    for i, (backend, state) in enumerate(zip(new_backends, sync_states)):
        message = decoded[i]
        if message is None or errors[i] is not None:
            # quarantined docs keep their pre-round sync state: the peer
            # retries from the last good handshake, nothing is half-advanced
            new_states.append(state)
            continue
        shared_heads = state['sharedHeads']
        last_sent_heads = state['lastSentHeads']
        sent_hashes = state['sentHashes']
        if message['changes']:
            shared_heads = advance_heads(before_heads[i], get_heads(backend),
                                         shared_heads)
        if not message['changes'] and message['heads'] == before_heads[i]:
            last_sent_heads = message['heads']
        if heads_known is not None and i in post_members:
            flags = heads_known.get(i, [])
            known_heads = [h for h, known in zip(message['heads'], flags)
                           if known]
        else:
            known_heads = [h for h in message['heads']
                           if get_change_by_hash(backend, h) is not None]
        if len(known_heads) == len(message['heads']):
            shared_heads = message['heads']
            if len(message['heads']) == 0:
                last_sent_heads = []
                # peer lost all data: its sent set must not survive —
                # hand a peer-space back deterministically
                release_sync_state(state)
                sent_hashes = set()
        else:
            shared_heads = sorted(set(known_heads) | set(shared_heads))
        new_states.append({
            'sharedHeads': shared_heads,
            'lastSentHeads': last_sent_heads,
            'theirHave': message['have'],
            'theirHeads': message['heads'],
            'theirNeed': message['need'],
            'sentHashes': sent_hashes,
        })
    if quarantine:
        return new_backends, new_states, patches, errors
    return new_backends, new_states, patches


# ----------------------------------------------------------------------
# Mixed live+parked rounds: the StorageEngine.needs_sync gate
# ----------------------------------------------------------------------
#
# A host serving 1M parked docs cannot revive its whole main store to
# answer sync rounds; these variants accept a MIXED population — element
# i of `docs` is either an ordinary live backend handle or an int doc id
# parked in `storage` (a fleet/storage.py StorageEngine) — and revive
# ONLY the docs a peer actually needs, in one batched revive, before
# running the ordinary fused round over the live subset. Parked docs
# whose handshake is provably quiet are answered compute-on-compressed
# (the columnar heads lane; zero chunk decode, zero device work) and
# counted in the 'storage_parked_syncs_skipped' health counter.

def _parked_stats():
    from .storage import _stats
    return _stats


def generate_sync_messages_mixed(storage, docs, sync_states,
                                 deadline=None):
    """Batched generate over a mixed live/parked population. A parked
    doc stays parked (message None, state unchanged) when the handshake
    is QUIET: the peer's advertised heads equal ours, our last sent
    heads equal ours, and the peer needs nothing — exactly the state in
    which the live protocol answers None. Every other parked doc is
    revived (one batched revive for the round) and joins the fused
    generate. Returns (docs_out, new_states, messages): docs_out[i] is
    the live handle (possibly freshly revived) or the untouched parked
    id."""
    n = len(docs)
    if len(sync_states) != n:
        raise ValueError('docs and sync_states must align')
    if deadline is not None:
        # before the gate revives anything: an already-expired deadline
        # must abort with storage untouched (all-or-nothing)
        deadline.check(what='generate_sync_messages_mixed')
    docs_out = list(docs)
    revive = []
    with _span('sync_parked_gate', docs=n):
        for i, doc in enumerate(docs):
            if not isinstance(doc, int):
                continue
            state = sync_states[i]
            their = state['theirHeads']
            last_sent = state['lastSentHeads']
            their_have = state['theirHave']
            # the live reset branch fires when the peer's lastSync names
            # history we don't hold; the heads lane can only prove
            # membership for our heads themselves, so anything else
            # revives (conservative, never wrong)
            last_sync_known = not their_have or all(
                storage.contains_head(doc, h)
                for h in their_have[0]['lastSync'])
            quiet = isinstance(their, list) and \
                not storage.needs_sync(doc, their) and \
                isinstance(last_sent, list) and \
                sorted(last_sent) == storage.heads(doc) and \
                not state['theirNeed'] and last_sync_known
            if quiet:
                _parked_stats().inc('storage_parked_syncs_skipped')
            else:
                revive.append(i)
    if revive:
        for i, handle in zip(revive,
                             storage.revive([docs[i] for i in revive])):
            docs_out[i] = handle
    live = [i for i in range(n) if not isinstance(docs_out[i], int)]
    new_states = list(sync_states)
    messages = [None] * n
    if live:
        try:
            sub_states, sub_msgs = generate_sync_messages_docs(
                [docs_out[i] for i in live],
                [sync_states[i] for i in live], deadline=deadline)
        except Exception:
            # the round raised after the gate revived docs (e.g. a
            # deadline expiring mid-round): the caller gets no docs_out,
            # so the revived handles would leak and the caller's parked
            # ids would dangle — re-park them under their original ids
            if revive:
                storage.repark([docs_out[i] for i in revive],
                               [docs[i] for i in revive])
            raise
        for i, state, message in zip(live, sub_states, sub_msgs):
            new_states[i] = state
            messages[i] = message
    return docs_out, new_states, messages


def receive_sync_messages_mixed(storage, docs, sync_states,
                                binary_messages, mirror=True,
                                on_error='raise', deadline=None):
    """Batched receive over a mixed live/parked population (see
    ``generate_sync_messages_mixed``). A parked doc stays parked when
    its message carries NO changes and every advertised head is already
    one of ours (the columnar heads-lane membership probe — then the
    sharedHeads algebra needs no history lookup and the doc mutates
    nothing); anything else revives it first. Returns
    (docs_out, new_states, patches[, errors])."""
    n = len(docs)
    if len(sync_states) != n or len(binary_messages) != n:
        raise ValueError('docs, sync_states, and messages must align')
    if deadline is not None:
        # before the gate revives anything (see generate_..._mixed)
        deadline.check(what='receive_sync_messages_mixed')
    # strip trace envelopes BEFORE the parked gate's decode — an
    # enveloped message from a tracing peer would otherwise read as
    # hostile bytes and quarantine a perfectly valid sync
    _wire_ctx, binary_messages = _strip_trace_envelopes(binary_messages)
    quarantine = on_error == 'quarantine'
    docs_out = list(docs)
    fast = {}                   # i -> decoded message served parked
    pre_decoded = [None] * n    # parked-gate decodes, reused by the
    revive = []                 # live path (no double message parse)
    with _span('sync_parked_gate', docs=n,
               **_trace.trace_attr(_wire_ctx)):
        for i, doc in enumerate(docs):
            if not isinstance(doc, int) or binary_messages[i] is None:
                continue
            try:
                message = decode_sync_message(binary_messages[i])
            except Exception as exc:
                # an undecodable message mutates nothing, so the doc can
                # stay parked while its error is reported
                err = as_wire_error(exc, MalformedSyncMessage,
                                    'receive_sync_messages_mixed',
                                    doc_index=i)
                if not quarantine:
                    raise err
                fast[i] = err
                continue
            if message['changes'] or not storage.covers_heads(
                    doc, message['heads']):
                pre_decoded[i] = message
                revive.append(i)
            else:
                fast[i] = message
    if revive:
        for i, handle in zip(revive,
                             storage.revive([docs[i] for i in revive])):
            docs_out[i] = handle
    live = [i for i in range(n) if not isinstance(docs_out[i], int)]

    new_states = list(sync_states)
    patches = [None] * n
    errors = [None] * n
    if live:
        try:
            # the messages were already stripped above, so the inner
            # receive's own probe finds no envelope — hand it the wire
            # context as AMBIENT instead (trace_attr falls back to it),
            # so the round's spans still adopt the peer's trace id
            with _trace.use(_wire_ctx or _trace.current()):
                out = receive_sync_messages_docs(
                    [docs_out[i] for i in live],
                    [sync_states[i] for i in live],
                    [binary_messages[i] for i in live], mirror=mirror,
                    on_error=on_error, deadline=deadline,
                    _decoded=[pre_decoded[i] for i in live])
        except Exception:
            # round aborted after the gate revived docs (deadline at the
            # apply seam, or a raise-mode decode failure — both fire
            # BEFORE any doc mutates): re-park under the original ids so
            # nothing leaks and the caller's ids stay valid
            if revive:
                storage.repark([docs_out[i] for i in revive],
                               [docs[i] for i in revive])
            raise
        if quarantine:
            sub_docs, sub_states, sub_patches, sub_errors = out
        else:
            sub_docs, sub_states, sub_patches = out
            sub_errors = [None] * len(live)
        for k, i in enumerate(live):
            docs_out[i] = sub_docs[k]
            new_states[i] = sub_states[k]
            patches[i] = sub_patches[k]
            if sub_errors[k] is not None:
                # the sublist call indexed its errors in ITS coordinate
                # space; re-scope the record to the caller's mixed array
                # so both error populations share one index space
                sub_errors[k].index = i
                if sub_errors[k].error is not None and \
                        getattr(sub_errors[k].error, 'doc_index',
                                None) is not None:
                    sub_errors[k].error.doc_index = i
            errors[i] = sub_errors[k]

    fast_errors = []
    for i, decoded in fast.items():
        if isinstance(decoded, Exception):
            errors[i] = DocError(i, 'decode', decoded)
            quarantine_stats.inc('quarantined_docs')
            # same forensic trail as the live decode path: this fault
            # class must not go invisible just because the doc is parked
            _flight.record_event(
                'quarantine', doc=i, stage='decode',
                error=type(decoded).__name__,
                message=str(decoded)[:200], durable_id=None,
                change_bytes=len(binary_messages[i]))
            fast_errors.append(errors[i])
            continue
        # the live sharedHeads algebra, specialized to the case the gate
        # proved: no changes, every message head one of ours — so every
        # 'known head' check is a heads-lane membership hit
        state = sync_states[i]
        ours = storage.heads(docs[i])
        last_sent = state['lastSentHeads']
        sent_hashes = state['sentHashes']
        if list(decoded['heads']) == ours:
            last_sent = decoded['heads']
        shared_heads = decoded['heads']
        if len(decoded['heads']) == 0:
            last_sent = []
            release_sync_state(state)
            sent_hashes = set()
        new_states[i] = {
            'sharedHeads': shared_heads,
            'lastSentHeads': last_sent,
            'theirHave': decoded['have'],
            'theirHeads': decoded['heads'],
            'theirNeed': decoded['need'],
            'sentHashes': sent_hashes,
        }
        _parked_stats().inc('storage_parked_syncs_skipped')
    if fast_errors:
        _flight.dump_flight_record('quarantine', detail={
            'errors': [e.describe() for e in fast_errors]})
    if quarantine:
        return docs_out, new_states, patches, errors
    return docs_out, new_states, patches
