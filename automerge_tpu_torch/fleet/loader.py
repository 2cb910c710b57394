"""Bulk document load: saved containers straight to device state.

This is the torch port of automerge_tpu/fleet/loader.py. The host logic
(the native parse, per-doc viability, the succ-derived end state, the
engines' parked form) is the reference's, line for line; the device
installs become in-place torch writes on the fleet's device (CUDA unless
the fleet was built with `device='cpu'`), one indexed assignment per
array: the LWW grids (`_install_map_cells`), the register state in
exact-device mode, and per size class the sequence pools
(`_install_seq_rows`). Where the reference's `.at[].set` scatters may
carry duplicate indices (register cells, sequence lanes), the port keeps
the last row in document order before the write: CUDA's `index_put_`
leaves the winner of a duplicate index undefined. The docs and rows that
carry duplicates are flagged inexact either way, and read from the host.

The reference's description follows.

Bulk document load: saved containers straight to device state.

This is the native batch-load path (round-2 VERDICT item 8, SURVEY §7 north
star "decode straight into padded device tensors"): one C++ call
(`native.parse_documents`, ref columnar.js:1006-1047) parses every saved
document in the fleet to flat op columns, and the FINAL CRDT state — the
succ-derived visible sets of ref new.js:1204-1217 — is scattered into the
device registers in a handful of batched dispatches. Nothing is replayed:
where the reference's load walks every op through seekToOp (new.js:1604-1635
documentPatch after decode), this loader reconstructs the end state directly
from the document columns, because the document format already stores ops in
final document order with their successors.

The change *log* is not materialized at all (the deferred-hash-graph load of
ref new.js:1709-1749): the original chunk parks on the engine and per-change
buffers/hashes are decoded lazily the first time history is genuinely read
(sync, getChanges, save-after-edit, mirror fallback). An unedited loaded
document's save() returns the loaded bytes verbatim — a byte-identical
round-trip; note this skips save()'s usual canonical re-encode, so two
replicas bulk-loaded from *different* foreign encodings of the same state
can save different bytes until their first edit.

Documents outside the fleet subset (link ops, unknown columns, op counters
past the 2^23 packing window, >256 actors) fall back per-doc to the
ordinary load path — the loader is an accelerator, never a semantic fork.
Objects inside sequences (rows-in-lists) bulk-load natively: make element
rows install as links (round 4).
"""

import numpy as np
import torch

from .. import native
from ..columnar import (decode_value, split_containers,
                        CHUNK_TYPE_DOCUMENT, MAGIC_BYTES as _MAGIC)
from .tensor_doc import CTR_LIMIT, MAX_ACTORS
from ..observability.spans import span_seq as _span_seq, \
    spanned as _spanned

# Wire action numbers (ref columnar.js:51-52)
_A_MAKE_MAP, _A_SET, _A_MAKE_LIST, _A_MAKE_TEXT = 0, 1, 2, 4
_A_INC, _A_MAKE_TABLE = 5, 6
_MAKES = (_A_MAKE_MAP, _A_MAKE_LIST, _A_MAKE_TEXT, _A_MAKE_TABLE)
_SEQ_MAKES = (_A_MAKE_LIST, _A_MAKE_TEXT)
_TYPE_NAMES = {_A_MAKE_MAP: 'map', _A_MAKE_TABLE: 'table',
               _A_MAKE_LIST: 'list', _A_MAKE_TEXT: 'text'}


class _DocDeferredBatch:
    """Adapter giving the hash graph lazy access to a bulk-loaded doc's
    change metadata (resolved through the engine's parked chunk)."""

    __slots__ = ('engine',)

    def __init__(self, engine):
        self.engine = engine

    def resolve(self, i):
        return self.engine._doc_resolve(i)


def _okey(doc, ctr, actor):
    """Doc-scoped object/op key: collision-free int64 for (doc, ctr, actor)
    with ctr < 2^23 and actor < 256 (root encodes as ctr=0, actor=-1)."""
    return doc.astype(np.int64) * (1 << 33) + ctr * 512 + (actor + 1)


def _isin_sorted(values, sorted_arr):
    if len(sorted_arr) == 0:
        return np.zeros(len(values), dtype=bool)
    pos = np.clip(np.searchsorted(sorted_arr, values), 0,
                  len(sorted_arr) - 1)
    return sorted_arr[pos] == values


def _last_per_cell(cell):
    """Rows of `cell` (in document order) that are the last of their
    value: where a scatter's indices repeat, the row the write keeps."""
    order = np.argsort(cell, kind='stable')
    cs = cell[order]
    return np.sort(order[np.r_[cs[1:] != cs[:-1], True]])


def _device_cols(device, ps, *cols):
    """Host integer columns as int64 tensors on `device`, in one copy
    (its bytes added to the running phase of `ps`)."""
    sizes = [len(c) for c in cols]
    flat = np.concatenate([np.asarray(c, dtype=np.int64) for c in cols])
    ps.add(bytes=flat.nbytes)
    return torch.from_numpy(flat).to(device).split(sizes)


@_spanned('bulk_load')
def load_docs(buffers, fleet=None):
    """Load N saved documents into fleet-resident handles in one native
    parse + a few batched device dispatches. Returns handles in input
    order. Docs the fast path can't represent load through the ordinary
    per-doc path transparently.

    Phase attribution: with spans on, the `bulk_load` span is tiled by
    contiguous `load_probe`, `load_parse`, `load_classify`,
    `load_engines`, `load_map_cells`, `load_seq_values`,
    `load_seq_install` and `load_fallback` phases (a phase whose work
    does not arise is left out)."""
    ps = _span_seq()
    try:
        return _load_docs(buffers, fleet, ps)
    finally:
        ps.done()


def _load_docs(buffers, fleet, ps):
    from . import backend as fleet_backend

    fleet = fleet or fleet_backend.default_fleet()
    n_in = len(buffers)
    handles = [None] * n_in

    ps.mark('load_probe', docs=n_in)
    chunks = [None] * n_in
    if native.available():
        for i, buf in enumerate(buffers):
            # keep memoryviews (mmap'd parked chunks on the revive
            # path) unowned: the probe below and the native parse both
            # read through the buffer protocol without materializing
            if not isinstance(buf, (bytes, memoryview)):
                buf = bytes(buf)
            # fast single-container probe: magic + document type byte —
            # the native parser re-verifies framing, checksum, and
            # trailing bytes, so a false positive only round-trips
            # through its per-doc ok=0 fallback. The full Python
            # container walk runs only for multi-chunk/odd inputs.
            if len(buf) > 11 and buf[:4] == _MAGIC and \
                    buf[8] == CHUNK_TYPE_DOCUMENT:
                chunks[i] = buf
                continue
            try:
                parts = split_containers(buf)
            except Exception:
                parts = []
            if len(parts) == 1 and parts[0][8] == CHUNK_TYPE_DOCUMENT:
                chunks[i] = parts[0]

    native_idx = [i for i, c in enumerate(chunks) if c is not None]
    ps.mark('load_parse', docs=len(native_idx))
    out = native.parse_documents([chunks[i] for i in native_idx]) \
        if native_idx else None
    installed = set()
    if out is not None and native_idx:
        installed = _install_parsed(fleet, out, native_idx, chunks, handles,
                                    fleet_backend, ps)
    ps.mark('load_fallback', docs=n_in - len(installed))
    for i in range(n_in):
        if i not in installed:
            handles[i] = fleet_backend.load(bytes(buffers[i]), fleet)
    return handles


def _install_parsed(fleet, out, native_idx, chunks, handles, fleet_backend,
                    ps):
    """Vectorized end-state assembly for every natively parsed doc; returns
    the set of input indexes successfully installed."""
    from .backend import FleetDoc, _FlatEngine

    ps.mark('load_classify', rows=len(out['doc']))
    ok = out['ok'].astype(bool)

    # Fleet actor registration (one insert_many + remap for the batch)
    perm = fleet.actors.insert_many(out['actors'])
    if perm is not None:
        if fleet.exact_device:
            fleet._remap_reg_actors(perm)
        else:
            fleet._remap_actors(perm)
        fleet._remap_seq_actors(perm)
    amap = np.array([fleet.actors.index.get(a, -1) for a in out['actors']],
                    dtype=np.int64) if out['actors'] else np.zeros(1, np.int64)

    doc = out['doc'].astype(np.int64)
    id_ctr = out['id_ctr']
    id_actor = amap[out['id_actor']]
    obj_ctr = out['obj_ctr']
    obj_actor = np.where(out['obj_actor'] >= 0, amap[out['obj_actor']], -1)
    key_ctr = out['key_ctr']
    key_actor = np.where(out['key_actor'] >= 0, amap[out['key_actor']], -1)
    key_str = out['key_str']
    action = out['action'].astype(np.int64)
    insert = out['insert'].astype(bool)
    vtype = out['vtype']
    val_int = out['val_int']
    succ_off = out['succ_off']
    succ_ctr = out['succ_ctr']
    succ_actor = amap[out['succ_actor']] if len(out['succ_actor']) else \
        np.zeros(0, dtype=np.int64)
    n_ops = len(doc)

    # ---- per-doc viability ----------------------------------------------
    # Overflow badness FIRST: _okey packing assumes ctr < 2^23 and
    # actor < 256, so rows of overflowing (fallback-bound) docs must be
    # excluded from classification keys before they can alias another
    # doc's object identities
    bad = ~ok.copy()
    ctr_over = (id_ctr >= CTR_LIMIT) | (key_ctr >= CTR_LIMIT) | \
        (obj_ctr >= CTR_LIMIT)
    actor_over = (id_actor >= MAX_ACTORS) | (id_actor < 0) | \
        (key_actor >= MAX_ACTORS) | (obj_actor >= MAX_ACTORS)
    for mask in (ctr_over, actor_over):
        if mask.any():
            bad[np.unique(doc[mask])] = True
    n_succ = len(succ_ctr)
    srow = np.repeat(np.arange(n_ops), np.diff(succ_off)) if n_succ else \
        np.zeros(0, dtype=np.int64)
    if n_succ:
        sc_over = (succ_ctr >= CTR_LIMIT) | (succ_actor >= MAX_ACTORS) | \
            (succ_actor < 0)
        if sc_over.any():
            bad[np.unique(doc[srow[sc_over]])] = True

    row_ok = ~bad[doc]
    okey = _okey(doc, obj_ctr, obj_actor)           # op's containing object
    rid = _okey(doc, id_ctr, id_actor)              # op's own id
    make_mask = np.isin(action, _MAKES)
    seq_make = np.isin(action, _SEQ_MAKES)
    seq_objs = np.sort(rid[make_mask & seq_make & row_ok])
    map_objs = np.sort(rid[make_mask & ~seq_make & row_ok])
    row_is_seq = _isin_sorted(okey, seq_objs)
    row_in_map = (obj_actor < 0) | _isin_sorted(okey, map_objs)
    orphan = row_ok & ~row_is_seq & ~row_in_map
    # map rows must carry a string key and cannot be inserts (a crafted
    # chunk can pass the column-level checks with an elemId on a map row —
    # out['keys'][-1] must never be dereferenced). Makes inside sequences
    # are legal element rows (rows-in-lists): their value lane becomes a
    # link to the child object, handled in _install_seq_rows.
    map_malformed = row_ok & ~row_is_seq & ((key_str < 0) | insert)
    for mask in (orphan, map_malformed):
        if mask.any():
            bad[np.unique(doc[mask])] = True

    # ---- alive / counter-fold (succNum==0 visibility; inc successors
    # accumulate instead of killing, ref new.js:937-965). The inc lookup
    # table takes good-doc rows ONLY: a fallback-bound doc's un-packable
    # op ids alias into other docs' _okey space and would corrupt their
    # alive/counter computation -------------------------------------------
    inc_mask = action == _A_INC
    inc_sel = inc_mask & ~bad[doc]
    inc_rid = rid[inc_sel]
    inc_order = np.argsort(inc_rid)
    inc_sorted = inc_rid[inc_order]
    inc_vals = val_int[inc_sel][inc_order]
    n_succ_per = np.diff(succ_off)
    counter_add = np.zeros(n_ops, dtype=np.int64)
    if n_succ and len(inc_sorted):
        skey = _okey(doc[srow], succ_ctr, succ_actor)
        pos = np.clip(np.searchsorted(inc_sorted, skey), 0,
                      len(inc_sorted) - 1)
        succ_is_inc = inc_sorted[pos] == skey
        # Counter attribution (new.js:942-945): an inc shared as succ by
        # multiple counter sets (conflicted counter) is consumed and
        # folded ONLY by the Lamport-max set; the other sets keep an
        # unconsumed succ, so they fail the all-succs-are-incs rule below
        # and stay invisible — matching the reference's counterStates
        # overwrite (round-4 50x-chaos find)
        succ_ok = np.zeros(len(srow), dtype=bool)
        # good-doc rows only: a fallback-bound doc's overflow-aliased succ
        # rows must not steal a good doc's winner group (same defense as
        # the inc lookup table above)
        idx = np.flatnonzero(succ_is_inc & ~bad[doc[srow]])
        if len(idx):
            packed32_pre = ((id_ctr << 8) | id_actor).astype(np.int64)
            sk = skey[idx]
            order2 = np.lexsort((packed32_pre[srow[idx]], sk))
            sk_s = sk[order2]
            last = np.r_[sk_s[1:] != sk_s[:-1], True]
            keep = np.zeros(len(idx), dtype=bool)
            keep[order2[last]] = True
            succ_ok[idx[keep]] = True
        inc_per = np.bincount(srow, weights=succ_ok.astype(np.float64),
                              minlength=n_ops).astype(np.int64)
        fold = np.where(succ_ok, inc_vals[pos], 0)
        counter_add = np.bincount(srow, weights=fold.astype(np.float64),
                                  minlength=n_ops).astype(np.int64)
    else:
        inc_per = np.zeros(n_ops, dtype=np.int64)
    alive = ~inc_mask & (inc_per == n_succ_per)

    # ---- engines + per-doc metadata --------------------------------------
    good_docs = np.flatnonzero(~bad)
    ps.mark('load_engines', docs=len(good_docs))
    packed32 = ((id_ctr << 8) | id_actor).astype(np.int64)
    oid_str = {}                       # rid key -> 'ctr@actor' string
    obj_type = {}                      # rid key -> wire make action
    # good-doc rows only: a fallback-bound doc's overflowing ids must not
    # alias (and overwrite) another doc's object identities
    for j in np.flatnonzero(make_mask & ~bad[doc]):
        oid_str[int(rid[j])] = \
            f'{int(id_ctr[j])}@{fleet.actors.actors[int(id_actor[j])]}'
        obj_type[int(rid[j])] = int(action[j])

    slot_of = np.full(len(ok), -1, dtype=np.int64)
    engines = {}
    # one batched allocation for the whole load (init_docs' bookkeeping);
    # engines come from the allocation-only bulk constructor and the GC
    # stays paused across the loop — the per-doc constructor chain +
    # gen-0 scans were a measurable slice of recovery's snapshot load
    # at 10k docs (same reasoning as init_docs)
    slots = fleet.alloc_slots(len(good_docs))
    bulk_new = _FlatEngine._bulk_new
    fleet_actors = fleet.actors.actors
    heads_off = out['heads_off']
    actor_off = out['actor_off']
    doc_actors = out['doc_actors']
    max_op_arr = out['max_op']
    n_changes_arr = out['n_changes']
    heads_hex = out['heads'].tobytes().hex() if len(out['heads']) else ''
    from .backend import _gc_paused
    with _gc_paused():
        for d, slot in zip(good_docs.tolist(), slots):
            eng = bulk_new(fleet, slot)
            slot_of[d] = slot
            # The loaded ops feed the applied-op index below
            # (_install_map_cells), so the turbo dangling-pred check stays
            # armed for bulk-loaded slots — the reference detects invalid
            # op references during the merge regardless of how the doc
            # arrived (new.js:1219-1220; closes round-5 VERDICT weak #6).
            a0, a1 = int(actor_off[d]), int(actor_off[d + 1])
            if a1 - a0 == 1:                 # the common single-actor doc
                eng.actor_ids = [fleet_actors[int(amap[doc_actors[a0]])]]
            else:
                eng.actor_ids = [fleet_actors[int(amap[g])]
                                 for g in doc_actors[a0:a1]]
            h0, h1 = int(heads_off[d]), int(heads_off[d + 1])
            if h1 - h0 == 1:                 # the common single-head doc
                eng.heads = [heads_hex[64 * h0:64 * h1]]
            else:
                eng.heads = sorted(heads_hex[64 * h:64 * (h + 1)]
                                   for h in range(h0, h1))
            eng.max_op = int(max_op_arr[d])
            chunk = bytes(chunks[native_idx[d]])
            eng._install_parked_chunk(chunk, int(n_changes_arr[d]))
            engines[d] = eng
        # clock: per (doc, actor) max seq, accumulated per doc and
        # assigned WHOLE (engine.clock is a columnar-backed property:
        # in-place writes on the materialized dict would be lost)
        c_doc = out['c_doc'].astype(np.int64)
        c_actor = amap[out['c_actor']] if len(out['c_actor']) else \
            np.zeros(0, dtype=np.int64)
        c_seq = out['c_seq']
        clocks = {}
        for d, a, s in zip(c_doc.tolist(), c_actor.tolist(),
                           c_seq.tolist()):
            if d in engines:
                clock = clocks.setdefault(d, {})
                hexa = fleet_actors[a]
                if clock.get(hexa, 0) < s:
                    clock[hexa] = s
        for d, clock in clocks.items():
            engines[d].clock = clock
    fleet.metrics.docs_bulk_loaded += len(engines)
    # object registries
    for j in np.flatnonzero(make_mask):
        d = int(doc[j])
        if d not in engines:
            continue
        a = int(action[j])
        oid = oid_str[int(rid[j])]
        if a in _SEQ_MAKES:
            engines[d].seq_objects[oid] = _TYPE_NAMES[a]
        else:
            engines[d].map_objects[oid] = _TYPE_NAMES[a]

    max_slot = int(slot_of.max()) if len(slot_of) else -1
    if max_slot >= 0:
        _ensure_caps(fleet, max_slot + 1)

    ps.mark('load_map_cells')
    keep = ~bad[doc] & (slot_of[doc] >= 0)
    _install_map_cells(fleet, out, keep & ~row_is_seq & ~inc_mask & alive,
                       keep & ~row_is_seq,
                       doc, slot_of, okey, oid_str, key_str, packed32,
                       id_actor, vtype, val_int, counter_add, action,
                       make_mask, rid, ps)
    ps.mark('load_seq_values')
    # sequence counter lanes bit-pack (sum << 2) | count-bits, where the
    # count bits are 0, 1, or 3 (3 = two or more incs consumed) — the
    # patch walk replays the reference's counterStates edit shapes, which
    # depend on whether 0, 1, or >= 2 incs were consumed. Sums past the
    # +/-2^29 envelope cannot pack; those rows go inexact in
    # _install_seq_rows (mirror-served) instead of wrapping.
    seq_counter = counter_add * 4 + np.minimum(inc_per, 2) + (inc_per >= 2)
    seq_counter_over = np.abs(counter_add) >= (1 << 29)
    _install_seq_rows(fleet, out, keep & row_is_seq, doc, slot_of, okey,
                      oid_str, obj_type, insert, alive, inc_mask,
                      packed32, id_actor, key_ctr, key_actor, vtype, val_int,
                      make_mask, rid, seq_counter, seq_counter_over, ps)

    installed = set()
    for d, eng in engines.items():
        handles[native_idx[d]] = {'state': FleetDoc(fleet, eng),
                                  'heads': eng.heads}
        installed.add(native_idx[d])
    return installed


def _ensure_caps(fleet, n_docs):
    if fleet.exact_device:
        fleet._ensure_reg_capacity(n_docs=max(n_docs, fleet.n_slots),
                                   n_keys=len(fleet.keys))
    else:
        # materialize (not just size): the loader writes fleet.state in
        # place below, so the deferred fresh-fleet allocation must land
        fleet._materialize_grid(n_docs=max(n_docs, fleet.n_slots),
                                n_keys=len(fleet.keys))


def _decode_cell_value(fleet, out, j, vtype_j, val_int_j, exact):
    """One op's value -> int32 register/grid lane value (inline or value
    table ref). Exact mode uses fleet._intern_typed — THE datatype-boxing
    rule; the LWW grid boxes raw (its reader folds counters onto plain
    ints and never unwraps TypedValue)."""
    if vtype_j == 4 and 0 <= val_int_j < (1 << 31):
        return int(val_int_j)
    off = int(out['val_off'][j])
    ln = int(out['val_len'][j])
    decoded = decode_value((ln << 4) | int(vtype_j),
                           out['val_blob'][off:off + ln])
    value, datatype = decoded['value'], decoded.get('datatype')
    if exact:
        return fleet._intern_typed(value, datatype)
    return fleet._intern_value(value)


def _install_map_cells(fleet, out, sel, index_sel, doc, slot_of, okey,
                       oid_str, key_str, packed32, id_actor, vtype, val_int,
                       counter_add, action, make_mask, rid, ps):
    """Scatter alive map-cell ops into the register state (exact mode) or
    the LWW winners grid, one batched device write per array.

    `index_sel` selects EVERY map-key op row of the loaded docs — alive,
    overwritten, and inc rows alike (the document format stores no del
    rows, so nothing here is del material). They all feed the slot's
    applied-op index in one `_index_ops` batch: the turbo dangling-pred
    oracle then covers bulk-loaded history exactly like applied history
    (an overwritten op is still a valid pred target for a concurrent op
    that saw it)."""
    idx_rows = np.flatnonzero(index_sel)
    ps.add(rows=len(idx_rows))
    if not len(idx_rows):
        return
    # Intern cell keys once over every indexed row: root keys as plain
    # strings, nested as (oid, key)
    key_ids_all = np.zeros(len(idx_rows), dtype=np.int64)
    cache = {}
    for i, j in enumerate(idx_rows):
        ks = out['keys'][int(key_str[j])]
        ok_ = int(okey[j])
        ck = (ok_, ks)
        kid = cache.get(ck)
        if kid is None:
            parent = oid_str.get(ok_)
            kid = fleet.keys.intern(ks if parent is None else (parent, ks))
            cache[ck] = kid
        key_ids_all[i] = kid
    fleet._index_ops(slot_of[doc[idx_rows]], key_ids_all,
                     packed32[idx_rows])

    rows = np.flatnonzero(sel)
    if not len(rows):
        return
    # install subset: positions of the alive cells inside the index rows
    # (sel is a subset of index_sel by construction)
    key_ids = key_ids_all[np.searchsorted(idx_rows, rows)]

    values = np.zeros(len(rows), dtype=np.int64)
    for i, j in enumerate(rows):
        jj = int(j)
        if make_mask[jj]:
            # fleet._make_link_value — THE shared make-op link rule
            # (allocates an empty child sequence's device row too)
            values[i] = fleet._make_link_value(
                int(slot_of[doc[jj]]), oid_str[int(rid[jj])],
                _TYPE_NAMES[int(action[jj])])
        else:
            values[i] = _decode_cell_value(fleet, out, jj, int(vtype[jj]),
                                           int(val_int[jj]),
                                           fleet.exact_device)

    slots = slot_of[doc[rows]]
    lanes = id_actor[rows]
    packed = packed32[rows]
    counters = counter_add[rows]
    _ensure_caps(fleet, int(slots.max()) + 1)
    if fleet.exact_device:
        # one live op per (slot, key, lane); duplicates flag the doc inexact
        cell = slots * (1 << 33) + key_ids * 512 + lanes
        uniq, counts = np.unique(cell, return_counts=True)
        dup_docs = np.unique(slots[np.isin(cell, uniq[counts > 1])]) \
            if (counts > 1).any() else np.zeros(0, dtype=np.int64)
        rs = fleet.reg_state
        # the last op of a duplicated cell in document order is the one
        # written (an inexact doc's registers are read from the mirror)
        w = _last_per_cell(cell)
        s_t, k_t, l_t, p_t, v_t, c_t, d_t = _device_cols(
            fleet.device, ps, slots[w], key_ids[w], lanes[w], packed[w],
            values[w], counters[w], dup_docs)
        idx = (s_t, k_t, l_t)
        rs.reg[idx] = p_t.to(torch.int32)
        rs.killed[idx] = False
        rs.value[idx] = v_t.to(torch.int32)
        rs.counter[idx] = c_t.to(torch.int32)
        if len(dup_docs):
            rs.inexact[d_t] = True
    else:
        # LWW grid: winner per (slot, key) by max packed opId
        cell = slots * (1 << 33) + key_ids
        order = np.lexsort((packed, cell))
        cs = cell[order]
        last = np.r_[cs[1:] != cs[:-1], True]     # winner = last per group
        w = order[last]
        s_t, k_t, p_t, v_t, c_t = _device_cols(
            fleet.device, ps, slots[w], key_ids[w], packed[w], values[w],
            counters[w])
        idx = (s_t, k_t)
        st = fleet.state
        st.winners[idx] = p_t.to(torch.int32)
        st.values[idx] = v_t.to(torch.int32)
        st.counters[idx] = c_t.to(torch.int32)
        if (counters[w] != 0).any():
            # loaded accumulators pin the fleet to the general merge
            # kernel (see DocFleet._counters_touched)
            fleet._counters_touched = True
        if fleet.host_winners is not None:
            # Seed the host winner mirror (counter-attribution checks for
            # later incs run against these loaded winners)
            np.maximum.at(fleet.host_winners, (slots[w], key_ids[w]),
                          packed[w].astype(np.int32))
    fleet.metrics.dispatches += 1
    fleet.metrics.device_ops += len(rows)


def _install_seq_rows(fleet, out, sel, doc, slot_of, okey, oid_str, obj_type,
                      insert, alive, inc_mask, packed32, id_actor,
                      key_ctr, key_actor, vtype, val_int, make_mask, rid,
                      counter_add, counter_over, ps):
    """Reconstruct SeqState rows from document-order sequence ops: element
    encounter order IS final RGA order, so the linked list is a straight
    chain — no pointer walking, no replay. Make rows (objects nested inside
    sequences) become link-valued elements, matching the ordinary apply
    path (backend._pack_seq_op)."""
    from .sequence import END, HEAD, SLOT0

    rows = np.flatnonzero(sel)
    ps.add(rows=len(rows))
    if not len(rows):
        return
    # (doc, obj) groups; rows of one object are contiguous in doc order
    gkey = okey[rows]
    uniq, inv = np.unique(gkey, return_inverse=True)
    fleet_row = np.zeros(len(uniq), dtype=np.int64)
    is_text = np.zeros(len(uniq), dtype=bool)
    first_of_group = np.full(len(uniq), len(rows), dtype=np.int64)
    np.minimum.at(first_of_group, inv, np.arange(len(rows)))
    for u, ok_ in enumerate(uniq):
        oid = oid_str[int(ok_)]
        d = int(doc[rows[int(first_of_group[u])]])
        slot = int(slot_of[d])
        typ = 'text' if obj_type[int(ok_)] == _A_MAKE_TEXT else 'list'
        # alive makes already allocated their row in _install_map_cells;
        # killed/overwritten objects' rows allocate here
        existing = fleet.slot_seq.get(slot, {}).get(oid)
        fleet_row[u] = existing if existing is not None else \
            fleet._alloc_seq_row(slot, oid, typ)
        is_text[u] = typ == 'text'

    ins = insert[rows]
    # element ordinal per insert row within its group (stable group sort
    # preserves document order inside each group)
    order = np.argsort(inv, kind='stable')
    inv_s = inv[order]
    ins_s = ins[order].astype(np.int64)
    cum = np.cumsum(ins_s)
    grp_start = np.searchsorted(inv_s, np.arange(len(uniq)), side='left')
    grp_sizes = np.diff(np.r_[grp_start, len(ins_s)])
    base = cum - np.repeat(cum[grp_start] - ins_s[grp_start], grp_sizes)
    elem_ord = np.zeros(len(rows), dtype=np.int64)
    elem_ord[order] = base - 1                 # valid where ins
    n_elems = np.bincount(inv, weights=ins.astype(np.float64),
                          minlength=len(uniq)).astype(np.int64)

    # update rows (the non-inserts): find the target element by its insert
    # op id; an update to an unknown element flags its object inexact
    node = SLOT0 + elem_ord
    bad_upd = np.zeros(len(rows), dtype=bool)
    upd = np.flatnonzero(~ins)
    if len(upd):
        ins_idx = np.flatnonzero(ins)
        ikey = inv[ins_idx] * (1 << 33) + packed32[rows][ins_idx]
        ins_sorted = np.argsort(ikey)
        ins_keys = ikey[ins_sorted]
        tgt_packed = (key_ctr[rows[upd]] << 8) | \
            np.maximum(key_actor[rows[upd]], 0)
        tkey = inv[upd] * (1 << 33) + tgt_packed
        if len(ins_keys):
            pos = np.clip(np.searchsorted(ins_keys, tkey), 0,
                          len(ins_keys) - 1)
            bad_upd[upd] = ins_keys[pos] != tkey
            node[upd] = SLOT0 + elem_ord[ins_idx[ins_sorted[pos]]]
        else:
            bad_upd[upd] = True
            node[upd] = SLOT0

    values, flag_counter = _seq_lane_values(
        fleet, out, rows, is_text[inv], doc, slot_of, oid_str, obj_type,
        inc_mask, make_mask, vtype, val_int, rid, ps)

    live = alive[rows] & ~inc_mask[rows] & ~bad_upd
    live_mask = np.zeros(len(rows), dtype=bool)
    live_mask[np.flatnonzero(live)] = True

    # inexact flags: unmatched update targets, counter sums past the
    # packable envelope, object elements in Text rows, and duplicate
    # (element, lane) live ops (outside one-op-per-actor) — computed on
    # op rows, applied per placement below
    inex_obj = np.zeros(len(uniq), dtype=bool)
    np.logical_or.at(
        inex_obj, inv[flag_counter | bad_upd | counter_over[rows]], True)
    lane_cell = inv[live_mask] * (1 << 42) + node[live_mask] * 512 + \
        id_actor[rows][live_mask]
    uq, cnt = np.unique(lane_cell, return_counts=True)
    if (cnt > 1).any():
        dup = np.isin(lane_cell, uq[cnt > 1])
        np.logical_or.at(inex_obj, inv[live_mask][dup], True)

    # place each object in its size class (host-tracked lengths), then
    # install per class: one chain/element/lane scatter set per class
    ps.mark('load_seq_install', rows=len(rows))
    place = [fleet._place_seq_row(int(fleet_row[u]), int(n_elems[u]))
             for u in range(len(uniq))]
    cls_arr = np.array([p[0] for p in place], dtype=np.int64)
    idx_arr = np.array([p[1] for p in place], dtype=np.int64)
    idx_of_op = idx_arr[inv]

    for cls in np.unique(cls_arr):
        cls = int(cls)
        objs = np.flatnonzero(cls_arr == cls)
        st = fleet.seq_pools.state(cls)
        nodes = st.elem_id.shape[1]

        # linked chain per pool row: HEAD -> SLOT0 .. SLOT0+n-1 -> END,
        # every other node END, built on the device from the lengths
        n_host = n_elems[objs]
        in_cls = np.isin(inv, objs)
        ins_sel = np.flatnonzero(ins & in_cls)
        live_sel = np.flatnonzero(live_mask & in_cls)
        # Dead counter sets that consumed incs install as KILLED lanes
        # with their counter bits: the patch walk needs them to emit the
        # reference's phantom remove / remove->update edits for deleted
        # or overwritten inc'd counters
        dead_sel = np.flatnonzero(
            in_cls & ~live_mask & ~inc_mask[rows] & ~bad_upd &
            ((counter_add[rows] & 3) != 0))
        if len(dead_sel):
            # A dead inc'd counter whose lane was reclaimed by the same
            # actor cannot be represented (sequence.py flags the same
            # shape reclaim_incd): route the object to the mirror rather
            # than clobber the live lane
            lane_key = (idx_of_op.astype(np.int64) * (1 << 40) +
                        node.astype(np.int64) * 512 +
                        id_actor[rows].astype(np.int64))
            taken = np.isin(lane_key[dead_sel], lane_key[live_sel])
            if taken.any():
                np.logical_or.at(inex_obj, inv[dead_sel[taken]], True)
                dead_sel = dead_sel[~taken]
        # the live lanes, then the dead ones (no lane is both): one write
        # per array, the last op of a duplicated lane in document order
        # kept (its object is inexact either way)
        lane_sel = np.concatenate([live_sel, dead_sel])
        lane_cell = (idx_of_op[lane_sel].astype(np.int64) * (1 << 40) +
                     node[lane_sel].astype(np.int64) * 512 +
                     id_actor[rows][lane_sel].astype(np.int64))
        lane_sel = lane_sel[_last_per_cell(lane_cell)] if len(lane_sel) \
            else lane_sel
        inex = objs[inex_obj[objs]]
        (tr, n_t, e_row, e_node, e_packed, l_row, l_node, l_actor, l_packed,
         l_val, l_counter, l_dead, inex_t) = _device_cols(
            fleet.device, ps, idx_arr[objs], n_host, idx_of_op[ins_sel],
            node[ins_sel], packed32[rows][ins_sel], idx_of_op[lane_sel],
            node[lane_sel], id_actor[rows][lane_sel],
            packed32[rows][lane_sel], values[lane_sel],
            counter_add[rows][lane_sel], ~live_mask[lane_sel],
            idx_arr[inex])
        col = torch.arange(nodes, dtype=torch.int64, device=fleet.device)
        chain = (col >= SLOT0) & (col < SLOT0 + n_t.view(-1, 1) - 1)
        nxt = torch.where(chain, col + 1, END)
        nxt[:, HEAD] = torch.where(n_t > 0, SLOT0, END)
        st.nxt[tr] = nxt.to(torch.int32)
        st.n[tr] = n_t.to(torch.int32)
        st.elem_id[(e_row, e_node)] = e_packed.to(torch.int32)
        lidx = (l_row, l_node, l_actor)
        st.reg[lidx] = l_packed.to(torch.int32)
        st.killed[lidx] = l_dead.to(torch.bool)
        st.val[lidx] = l_val.to(torch.int32)
        st.counter[lidx] = l_counter.to(torch.int32)
        if len(inex):
            st.inexact[inex_t] = True
        fleet.metrics.dispatches += 1
    fleet.metrics.device_ops += len(rows)


def _seq_lane_values(fleet, out, rows, txt, doc, slot_of, oid_str, obj_type,
                     inc_mask, make_mask, vtype, val_int, rid, ps):
    """Value lanes of the sequence op rows `rows` (text: single codepoints
    inline; lists: ints inline; everything else boxes; counters flag the
    row, ref new.js:937-965) and the rows whose object element flags the
    Text inexact. The inline rows take one column pass (the native parse
    already decoded a single-codepoint string's code point into
    `val_int`, -1 otherwise); the make rows and the values that box take
    the per-row path in row order, so the value table and the child rows
    are allocated in the reference's order."""
    values = np.zeros(len(rows), dtype=np.int64)
    flag_counter = np.zeros(len(rows), dtype=bool)
    vt, vi = vtype[rows], val_int[rows]
    inc = inc_mask[rows]
    inline = ~inc & ~make_mask[rows] & (
        (txt & (vt == 6) & (vi >= 0)) |
        (~txt & (vt == 4) & (vi >= 0) & (vi < (1 << 31))))
    values[inline] = vi[inline]
    # inc rows are consumed via succ attribution into counter lanes
    slow = np.flatnonzero(~inline & ~inc)
    ps.add(boxed=len(slow))
    for i in slow.tolist():
        jj = int(rows[i])
        if make_mask[jj]:
            # Nested object as a sequence element: fleet._make_link_value
            # is THE shared make-op link rule (links the child, allocates
            # an empty child sequence's device row)
            values[i] = fleet._make_link_value(
                int(slot_of[int(doc[jj])]), oid_str[int(rid[jj])],
                _TYPE_NAMES[obj_type[int(rid[jj])]])
            if txt[i]:
                # object elements inside Text render as spans: mirror
                # serves those reads (same rule as _pack_seq_op)
                flag_counter[i] = True
            continue
        off, ln = int(out['val_off'][jj]), int(out['val_len'][jj])
        decoded = decode_value((ln << 4) | int(vt[i]),
                               out['val_blob'][off:off + ln])
        dt = decoded.get('datatype')
        if isinstance(dt, str) and dt != 'int':
            # fleet._intern_typed — THE datatype-boxing rule (shared with
            # every other ingest path; it normalizes int wire tags itself)
            values[i] = fleet._intern_typed(decoded['value'], dt)
        else:
            # plain payloads box raw here (NOT _intern_typed): sequence
            # lanes reserve inline ints for text code points, and the
            # column pass above already took the list ints that sit inline
            values[i] = fleet._intern_value_boxed(decoded['value'])
    return values, flag_counter
