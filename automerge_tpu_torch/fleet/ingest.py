"""Wire ingest: binary changes decoded straight into fleet op tensors.

The pipeline stage between the network/disk and the device (the north star's
"decode straight into padded device tensors"): change chunks are parsed with
the native C++ codecs (automerge_tpu_torch.native) — container split + checksum,
DEFLATE, LEB128/RLE/delta column decode — and land as OpBatch columns with
host-side dictionary encoding of keys and actors. String columns (keyStr)
currently decode via the Python RLE codec; numeric columns are native.

Supports the fleet-kernel op subset (root-map set/inc/del); anything else
routes to the host OpSet engine.
"""

import numpy as np

from .. import native
from ..encoding import (
    Decoder, RLEDecoder, DeltaDecoder, BooleanDecoder,
)
from ..columnar import (
    decode_container_header, decode_column_info, decode_value, inflate_change,
    COLUMN_TYPE, CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE, ACTIONS,
)
from ..native import ACTOR_BITS, ACTOR_MASK, FLAG_INC, FLAG_SET
from .tensor_doc import OpBatch, TOMBSTONE, pack_op_id

_SET = ACTIONS.index('set')
_INC = ACTIONS.index('inc')
_DEL = ACTIONS.index('del')

_COL_KEYSTR = 1 << 4 | COLUMN_TYPE['STRING_RLE']
_COL_ACTION = 4 << 4 | COLUMN_TYPE['INT_RLE']
_COL_VALLEN = 5 << 4 | COLUMN_TYPE['VALUE_LEN']
_COL_VALRAW = 5 << 4 | COLUMN_TYPE['VALUE_RAW']
_COL_OBJCTR = 0 << 4 | COLUMN_TYPE['INT_RLE']


from ..observability.spans import spanned as _spanned


def _inflate_chunk(buffer):
    if buffer[8] != CHUNK_TYPE_DEFLATE:
        return buffer
    return inflate_change(buffer)


def _decode_numeric_column(ctype, buf):
    """Decode a numeric column: native when available, Python codecs otherwise."""
    if native.available():
        if ctype == COLUMN_TYPE['INT_DELTA']:
            return native.decode_delta_column(buf)
        if ctype == COLUMN_TYPE['BOOLEAN']:
            return native.decode_boolean_column(buf)
        return native.decode_rle_column(buf, signed=False)
    if ctype == COLUMN_TYPE['INT_DELTA']:
        decoder = DeltaDecoder(buf)
    elif ctype == COLUMN_TYPE['BOOLEAN']:
        decoder = BooleanDecoder(buf)
    else:
        decoder = RLEDecoder('uint', buf)
    values, valid = [], []
    while not decoder.done:
        v = decoder.read_value()
        values.append(0 if v is None else int(v))
        valid.append(v is not None)
    return np.array(values, dtype=np.int64), np.array(valid, dtype=bool)


def decode_change_ops_columns(buffer):
    """Parse one binary change into (header_meta, numeric column arrays).

    Returns (actor, start_op, columns) where columns maps columnId to
    (values int64[], valid bool[]) for numeric columns and to a Python list
    for the keyStr column."""
    buffer = _inflate_chunk(bytes(buffer))
    header = decode_container_header(Decoder(buffer), False)
    chunk = Decoder(header['chunkData'])
    # change header (ref columnar.js:635-652)
    num_deps = chunk.read_uint53()
    chunk.skip(32 * num_deps)
    actor = chunk.read_hex_string()
    chunk.read_uint53()  # seq
    start_op = chunk.read_uint53()
    chunk.read_int53()   # time
    chunk.read_prefixed_string()  # message
    for _ in range(chunk.read_uint53()):
        chunk.read_hex_string()
    infos = decode_column_info(chunk)
    columns = {}
    for info in infos:
        buf = chunk.read_raw_bytes(info['bufferLen'])
        cid = info['columnId']
        ctype = cid & 7
        if cid == _COL_VALRAW:
            columns[cid] = buf
        elif cid == _COL_KEYSTR:
            decoder = RLEDecoder('utf8', buf)
            values = []
            while not decoder.done:
                values.append(decoder.read_value())
            columns[cid] = values
        elif ctype in (COLUMN_TYPE['INT_DELTA'], COLUMN_TYPE['BOOLEAN'],
                       COLUMN_TYPE['INT_RLE'], COLUMN_TYPE['ACTOR_ID'],
                       COLUMN_TYPE['VALUE_LEN'], COLUMN_TYPE['GROUP_CARD']):
            columns[cid] = _decode_numeric_column(ctype, buf)
        else:
            columns[cid] = buf
    return actor, start_op, columns


class KeyInterner:
    """Host-side dictionary encoding of map keys for the fleet key grid."""

    def __init__(self):
        self.index = {}
        self.keys = []

    def intern(self, key):
        idx = self.index.get(key)
        if idx is None:
            idx = len(self.keys)
            self.index[key] = idx
            self.keys.append(key)
        return idx

    def __len__(self):
        return len(self.keys)


def layout_doc_rows(doc, n_docs, cols, dtypes):
    """Scatter flat doc-major rows into padded [N, P] arrays (per-doc
    positions in arrival order). Returns the laid-out arrays plus the
    (doc_sorted, pos) coordinates so callers can add more columns."""
    order = np.argsort(doc, kind='stable')
    doc_sorted = doc[order]
    pos = np.arange(len(doc_sorted)) - \
        np.searchsorted(doc_sorted, doc_sorted, side='left')
    counts = np.bincount(doc, minlength=n_docs)
    max_ops = max(int(counts.max()) if counts.size else 0, 1)
    shape = (n_docs, max_ops)
    out = []
    for col, dt in zip(cols, dtypes):
        arr = np.zeros(shape, dtype=dt)
        arr[doc_sorted, pos] = col[order]
        out.append(arr)
    return out, (order, doc_sorted, pos)


def build_kill_lanes(del_doc, del_key, del_pred_counts, praw, actor_map,
                     on_bad_actor=None):
    """Shared delete kill-lane construction (used by the native flush and
    the turbo path): expand per-del (doc, key) rows over their pred runs
    into flat (kill_doc, kill_key, kill_packed) lanes with pred actor
    bits remapped to fleet numbering. `praw` is the concatenated native
    pred entries of the del rows, aligned with del_pred_counts. Preds
    naming an actor outside actor_map (< 0 after remap) pack as 0
    (inert) and report via `on_bad_actor(doc_ids)`."""
    kill_doc = np.repeat(del_doc, del_pred_counts)
    kill_key = np.repeat(del_key, del_pred_counts)
    if not len(praw):
        return kill_doc, kill_key, np.zeros(0, dtype=np.int32)
    pactor = actor_map[praw & ACTOR_MASK]
    bad = (praw != 0) & (pactor < 0)
    if bad.any() and on_bad_actor is not None:
        on_bad_actor(np.unique(kill_doc[bad]))
    kill_packed = np.where(
        (praw != 0) & (pactor >= 0),
        (praw & ~ACTOR_MASK) | pactor, 0).astype(np.int32)
    return kill_doc, kill_key, kill_packed


def max_pred_per_inc(pred_col, offs, counts, actor_map):
    """Per inc row: the Lamport-max remapped pred packed id (the
    reference's counter attribution target, new.js:942-945), or -1 when
    absent or any pred names an unregistered actor. `pred_col` holds the
    parser's packed preds, `actor_map` its actors' fleet numbers. The
    single-pred common case is fully vectorized; only multi-pred rows
    (conflicted counters) loop."""
    out = np.full(len(offs), -1, dtype=np.int64)
    offs = np.asarray(offs)
    counts = np.asarray(counts)
    one = counts == 1
    if one.any() and len(pred_col):
        raw = pred_col[offs[one]].astype(np.int64)
        pa = actor_map[raw & ACTOR_MASK].astype(np.int64)
        out[one] = np.where(pa >= 0, (raw & ~ACTOR_MASK) | pa, -1)
    for i in np.flatnonzero(counts > 1):
        off, cnt = int(offs[i]), int(counts[i])
        raw = pred_col[off:off + cnt].astype(np.int64)
        pa = actor_map[raw & ACTOR_MASK].astype(np.int64)
        if (pa < 0).any():
            continue
        out[i] = int(((raw & ~ACTOR_MASK) | pa).max())
    return out


@_spanned('exact_ingest')
def changes_to_op_batch_native(per_doc_changes, key_interner, actor_interner,
                               hazard_out=None, kills_out=None,
                               index_out=None):
    """Fast path: the whole parse + dictionary-encode runs in C++
    (native.ingest_changes), and the flat op rows scatter into OpBatch
    tensors with vectorized numpy. Returns None if any change falls outside
    the fleet subset (caller falls back to the host engine).

    When `hazard_out` is a list, the parse runs with_meta so pred columns
    are available, and one tuple (set_doc, set_key, set_packed, inc_doc,
    inc_key, inc_pred, kill_doc, kill_key, kill_packed) in fleet numbering
    is appended — the feed for DocFleet._note_grid_batch's mirror advance
    and counter-attribution check (inc_pred is the Lamport-max pred, the
    reference's attribution target; -1 when absent or unresolvable).

    When `index_out` is a list, one (doc, key, packed) triple of flat
    arrays covering every map-key op ROW (sets and incs — never dels) is
    appended, in fleet numbering — the feed for the turbo path's
    dangling-pred oracle (DocFleet._index_ops).

    When `kills_out` is a list, delete ops take the reference's
    pred-scoped semantics (new.js:1204-1217): del rows are EXCLUDED from
    the set lanes and their preds land as kill lanes — one
    (kill_key [N, Q], kill_packed [N, Q]) pair appended to kills_out, for
    apply.apply_op_batch_kills. Without kills_out, dels keep the legacy
    tombstone-scatter behavior (the standalone benchmark subset)."""
    buffers, doc_ids = [], []
    for d, changes in enumerate(per_doc_changes):
        for change in changes:
            buffers.append(change)
            doc_ids.append(d)
    want_meta = hazard_out is not None or kills_out is not None
    if not buffers:
        return OpBatch(*(np.zeros((len(per_doc_changes), 1), dtype=dt)
                         for dt in (np.int32, np.int32, np.int32, bool, bool,
                                    bool)))
    out = native.ingest_changes(buffers, doc_ids, with_meta=want_meta)
    if out is None:
        return None
    if want_meta:
        rows, keys, actors, _meta = out
    else:
        rows, keys, actors = out
    # Merge the C++ interning into the fleet-level interners
    key_map = np.array([key_interner.intern(k) for k in keys], dtype=np.int32)
    actor_map = np.array([actor_interner.intern(a) for a in actors],
                         dtype=np.int32)
    n_docs = len(per_doc_changes)
    doc = rows['doc']
    key = key_map[rows['key']] if len(keys) else rows['key']
    ctr = rows['packed'] >> ACTOR_BITS
    actor = actor_map[rows['packed'] & ACTOR_MASK] if len(actors) else 0
    packed = (ctr << ACTOR_BITS) | actor
    flags_flat = rows['flags']
    # Dels are identifiable whenever either consumer needs them, but the
    # set-lane exclusion is gated on kills_out ALONE: without kill lanes
    # the legacy tombstone-scatter representation must stay intact, or
    # deletes would silently become no-ops (index_out never changes
    # device semantics — it only filters what gets indexed).
    del_sel = np.zeros(len(doc), dtype=bool)
    kill_doc = kill_key = kill_packed = np.zeros(0, dtype=np.int64)
    if kills_out is not None or index_out is not None:
        del_sel = (flags_flat == FLAG_SET) & (rows['value'] == TOMBSTONE)
    if kills_out is not None and del_sel.any():
        pred_counts_all = np.diff(rows['pred_off'])
        kill_doc, kill_key, kill_packed = build_kill_lanes(
            doc[del_sel], key[del_sel], pred_counts_all[del_sel],
            rows['pred'][np.repeat(del_sel, pred_counts_all)], actor_map)
        (kk_arr, kp_arr), _ = layout_doc_rows(
            kill_doc, n_docs, (kill_key, kill_packed),
            (np.int32, np.int32))
        kills_out.append((kk_arr, kp_arr))
    del_for_sets = del_sel if kills_out is not None else \
        np.zeros(len(doc), dtype=bool)
    if index_out is not None:
        row_sel = ((flags_flat == FLAG_SET) & ~del_sel) | \
            (flags_flat == FLAG_INC)
        index_out.append((doc[row_sel], key[row_sel], packed[row_sel]))
    if hazard_out is not None:
        set_sel = (flags_flat == FLAG_SET) & ~del_sel
        inc_sel = flags_flat == FLAG_INC
        pred_counts = np.diff(rows['pred_off'])
        amap_full = np.full(256, -1, dtype=np.int64)
        amap_full[:len(actor_map)] = actor_map
        preds = max_pred_per_inc(rows['pred'],
                                 rows['pred_off'][:-1][inc_sel],
                                 pred_counts[inc_sel], amap_full)
        hazard_out.append((doc[set_sel], key[set_sel], packed[set_sel],
                           doc[inc_sel], key[inc_sel], preds,
                           kill_doc, kill_key, kill_packed))
    # Lay out rows into [N, P] with per-doc positions
    (key_id, packed_arr, value), (order, doc_sorted, pos) = layout_doc_rows(
        doc, n_docs, (key, packed, rows['value']),
        (np.int32, np.int32, np.int32))
    is_set = np.zeros(key_id.shape, dtype=bool)
    is_inc = np.zeros(key_id.shape, dtype=bool)
    valid = np.zeros(key_id.shape, dtype=bool)
    flags = flags_flat[order]
    is_set[doc_sorted, pos] = (flags == FLAG_SET) & ~del_for_sets[order]
    is_inc[doc_sorted, pos] = flags == FLAG_INC
    valid[doc_sorted, pos] = True
    return OpBatch(key_id, packed_arr, value, is_set, is_inc, valid)


def changes_to_op_batch(per_doc_changes, key_interner, actor_interner,
                        value_table=None):
    """Convert per-document lists of binary changes into one OpBatch.

    Tries the native C++ batched parser first; falls back to the per-change
    Python decode. Only root-map set/inc/del ops are supported (the fleet
    kernel's op subset); raises ValueError otherwise. Ints in [0, 2^31) are
    stored inline in the value column; any other value is appended to
    `value_table` (when given) and referenced as -(index + 2) — distinct
    from TOMBSTONE (-1) and from inline ints."""
    if native.available():
        batch = changes_to_op_batch_native(per_doc_changes, key_interner,
                                           actor_interner)
        if batch is not None:
            return batch
    n_docs = len(per_doc_changes)
    rows = []  # (doc, key_id, packed, value, is_set, is_inc)
    for d, changes in enumerate(per_doc_changes):
        for change in changes:
            actor, start_op, columns = decode_change_ops_columns(change)
            actor_num = actor_interner.intern(actor)
            actions, actions_ok = columns.get(_COL_ACTION, (np.zeros(0), None))
            key_strs = columns.get(_COL_KEYSTR, [])
            obj_ctr = columns.get(_COL_OBJCTR)
            val_len, _vl_ok = columns.get(_COL_VALLEN, (None, None))
            val_raw = columns.get(_COL_VALRAW, b'')
            raw_pos = 0
            for i, action in enumerate(np.asarray(actions)):
                if obj_ctr is not None and i < len(obj_ctr[1]) and obj_ctr[1][i]:
                    raise ValueError('fleet ingest supports root-map ops only')
                key = key_strs[i] if i < len(key_strs) else None
                if key is None:
                    raise ValueError('fleet ingest supports map (string-key) ops only')
                tag = int(val_len[i]) if val_len is not None and i < len(val_len) \
                    else 0
                size = tag >> 4
                raw = val_raw[raw_pos:raw_pos + size]
                raw_pos += size
                if action == _SET or action == _INC:
                    decoded = decode_value(tag, raw)
                    value = decoded['value']
                elif action == _DEL:
                    value = None
                else:
                    raise ValueError(f'unsupported action {action} for fleet ingest')
                if action == _DEL:
                    val_idx = TOMBSTONE
                elif action == _INC:
                    # The device scatter-add consumes the value column of inc
                    # ops as a raw delta (never a table index), so any int32
                    # delta — negative included — must be stored inline
                    if not isinstance(value, int) or isinstance(value, bool) \
                            or not -(1 << 31) < value < (1 << 31):
                        raise ValueError('inc delta must be an int32 '
                                         'for fleet ingest')
                    val_idx = value
                elif isinstance(value, int) and not isinstance(value, bool) and \
                        0 <= value < (1 << 31):
                    val_idx = value
                elif value_table is not None:
                    val_idx = -(value_table.intern(value) + 2)
                else:
                    raise ValueError('non-int value requires a value_table')
                rows.append((d, key_interner.intern(key),
                             pack_op_id(start_op + i, actor_num), val_idx,
                             action != _INC, action == _INC))
    doc_counts = np.bincount([r[0] for r in rows], minlength=n_docs) \
        if rows else np.zeros(n_docs, dtype=np.int64)
    max_ops = int(doc_counts.max()) if rows else 0
    per_doc_counts = np.zeros(n_docs, dtype=np.int64)
    shape = (n_docs, max(max_ops, 1))
    key_id = np.zeros(shape, dtype=np.int32)
    packed = np.zeros(shape, dtype=np.int32)
    value = np.zeros(shape, dtype=np.int32)
    is_set = np.zeros(shape, dtype=bool)
    is_inc = np.zeros(shape, dtype=bool)
    valid = np.zeros(shape, dtype=bool)
    for (d, k, p, v, s, inc) in rows:
        j = per_doc_counts[d]
        per_doc_counts[d] += 1
        key_id[d, j] = k
        packed[d, j] = p
        value[d, j] = v
        is_set[d, j] = s
        is_inc[d, j] = inc
        valid[d, j] = True
    return OpBatch(key_id, packed, value, is_set, is_inc, valid)


class ActorInterner(KeyInterner):
    pass


def changes_to_decoded_ops(per_doc_changes):
    """Python-decode per-document change buffers into flat (doc, op_id, op)
    rows in application order — the mixed-content path used when a batch
    contains sequence-object ops (makeText/makeList/inserts), which the
    native flat-only parser rejects. Multi-inserts and multiOp deletes
    arrive pre-expanded by decode_change (ref columnar.js:446-475)."""
    from ..columnar import decode_change
    out = []
    for d, changes in enumerate(per_doc_changes):
        for buf in changes:
            change = decode_change(bytes(buf))
            start = change['startOp']
            actor = change['actor']
            for i, op in enumerate(change['ops']):
                out.append((d, f'{start + i}@{actor}', op))
    return out


def intern_composite_keys(obj, key_nat, nat_keys, nat_actors, key_interner):
    """Intern fleet key ids for rows that may live on nested objects:
    obj == 0 rows intern their bare key string, others the composite
    (objectId, key) tuple. Shared by the turbo path and the register
    ingest.

    Root rows ride a LUT over the parser's OWN key table (nat_keys is
    already dictionary-encoded, so one intern per distinct string and a
    single gather maps every row) — the previous np.unique over all
    row pairs cost a whole-batch sort to rediscover a dedup the parser
    had already done. Only nested-object rows (composite keys the
    parser cannot see) still pay a per-unique-pair walk."""
    n = len(obj)
    out = np.zeros(n, dtype=np.int32)
    if not n:
        return out
    # intern ONLY keys some root row actually references (one boolean
    # scatter — still no sort): nested-only key strings must not
    # bare-intern, or a nested-heavy workload would inflate the fleet
    # key table (and with it the [docs, keys] device grid) with ids no
    # root row ever uses
    root = obj == 0
    used = np.zeros(max(len(nat_keys), 1), dtype=bool)
    used[key_nat[root] if not root.all() else key_nat] = True
    lut = np.full(max(len(nat_keys), 1), -1, dtype=np.int32)
    for ki in np.flatnonzero(used).tolist():
        lut[ki] = key_interner.intern(nat_keys[ki])
    if root.all():
        return lut[key_nat]
    out[root] = lut[key_nat[root]]
    nest = np.flatnonzero(~root)
    pairs = obj[nest].astype(np.int64) * (1 << 32) + \
        key_nat[nest].astype(np.int64)
    uniq, inv = np.unique(pairs, return_inverse=True)
    u_ids = np.empty(len(uniq), dtype=np.int32)
    for ui, pv in enumerate(uniq):
        o = int(pv >> 32)
        ks = nat_keys[int(pv & 0xffffffff)]
        oid = native.format_op_id(o, nat_actors)
        u_ids[ui] = key_interner.intern((oid, ks))
    out[nest] = u_ids[inv]
    return out


def changes_to_op_rows(per_doc_changes, key_interner, actor_interner,
                       value_table=None):
    """Flat op rows with per-op pred lists, for the exact register engine
    (fleet/registers.py): returns a dict of parallel arrays
    {doc, key, packed, value, flags, pred_off, pred} in application order
    (doc-major, op order preserved), with keys/actors interned into the
    fleet tables and preds packed with fleet actor numbers.

    Native C++ path when every value is an inline int; Python decode
    otherwise (interning non-int values into value_table). flags: 1 =
    set/del (dels carry value TOMBSTONE), 2 = inc. Only flat root-map ops
    are supported; raises ValueError otherwise."""
    buffers, docs = [], []
    for d, changes in enumerate(per_doc_changes):
        for change in changes:
            buffers.append(bytes(change))
            docs.append(d)

    if native.available() and buffers:
        # with_seq=True so the wire value-type tag rides along: uint /
        # counter / timestamp set values box into the value table as
        # TypedValue, letting device-served patches keep exact datatypes
        out = native.ingest_changes(buffers, list(range(len(buffers))),
                                    with_meta=True, with_seq=True)
        if out is not None and out[0]['flags'].size and \
                out[0]['flags'].max() > FLAG_INC:
            out = None    # sequence/make rows: not register material
        if out is not None:
            rows, nat_keys, nat_actors, _meta = out
            # root keys intern bare; nested map cells (rows['obj'] != 0)
            # intern composite (objectId, key) like the Python decode path
            key_ids = intern_composite_keys(rows['obj'], rows['key'],
                                            nat_keys, nat_actors,
                                            key_interner)
            actor_map = np.array([actor_interner.intern(a)
                                  for a in nat_actors], dtype=np.int32) \
                if nat_actors else np.zeros(1, np.int32)

            def remap(p):
                return np.where(
                    p != 0, (p & ~ACTOR_MASK) | actor_map[p & ACTOR_MASK], 0
                ).astype(np.int32)

            values = rows['value'].astype(np.int32, copy=True)
            if value_table is not None and 'vtype' in rows:
                from ..columnar import decode_value
                from .registers import TypedValue, typed_wire_tags
                tags = typed_wire_tags()
                # values == TOMBSTONE (-1) identifies del rows: the native
                # parser boxes negative set values via the arena, so -1 on
                # a FLAG_SET row can only be a del
                typed = (rows['flags'] == FLAG_SET) & (values != TOMBSTONE) & \
                    (rows['vlen'] == 0) & np.isin(rows['vtype'], list(tags))
                for ri in np.flatnonzero(typed):
                    values[ri] = -(value_table.intern(TypedValue(
                        int(rows['value'][ri]),
                        tags[int(rows['vtype'][ri])])) + 2)
                # arena-boxed payloads (strings/bools/None/floats/bytes,
                # out-of-lane ints): decode the raw wire bytes and box by
                # the shared datatype rule
                vlen = rows['vlen']
                off = np.cumsum(vlen, dtype=np.int64) - vlen
                # dels (value TOMBSTONE, vtype 0) are NOT boxed nulls
                boxed_sel = (rows['flags'] == FLAG_SET) & \
                    (values != TOMBSTONE) & \
                    ((vlen > 0) | np.isin(rows['vtype'], (0, 1, 2)))
                blob = rows['vblob']
                for ri in np.flatnonzero(boxed_sel):
                    ln, vt = int(vlen[ri]), int(rows['vtype'][ri])
                    decoded = decode_value((ln << 4) | vt,
                                           blob[off[ri]:off[ri] + ln])
                    dt = decoded.get('datatype')
                    if isinstance(dt, str) and dt != 'int':
                        box = TypedValue(decoded['value'], dt)
                    else:
                        box = decoded['value']
                    values[ri] = -(value_table.intern(box) + 2)
            return {
                'doc': np.array(docs, dtype=np.int64)[rows['doc']],
                'key': key_ids,
                'packed': remap(rows['packed']),
                'value': values,
                'flags': rows['flags'],
                'pred_off': rows['pred_off'],
                'pred': remap(rows['pred']),
            }

    # Python fallback: full decode, arbitrary values via the value table
    from ..columnar import decode_change
    from ..common import parse_op_id
    out_doc, out_key, out_packed, out_val, out_flags = [], [], [], [], []
    pred_off, preds = [0], []

    def pack(op_id):
        ctr, actor = parse_op_id(op_id)
        return pack_op_id(ctr, actor_interner.intern(actor))

    for buf, d in zip(buffers, docs):
        change = decode_change(buf)
        for i, op in enumerate(change['ops']):
            if op['obj'] != '_root' or op.get('insert') or \
                    op.get('key') is None or \
                    op['action'] not in ('set', 'del', 'inc'):
                raise ValueError('register ingest supports flat root-map '
                                 'set/del/inc ops only')
            op_id = f"{change['startOp'] + i}@{change['actor']}"
            action = op['action']
            value = op.get('value')
            datatype = op.get('datatype')
            if action == 'del':
                val_idx = TOMBSTONE
            elif action == 'inc':
                if not isinstance(value, int) or isinstance(value, bool) or \
                        not -(1 << 31) < value < (1 << 31):
                    raise ValueError('inc delta must be an int32')
                val_idx = value
            elif datatype not in (None, 'int') and value_table is not None:
                # uint/counter/timestamp/float64 set values box with their
                # datatype so device-served patches stay exact
                from .registers import TypedValue
                val_idx = -(value_table.intern(
                    TypedValue(value, datatype)) + 2)
            elif isinstance(value, int) and not isinstance(value, bool) and \
                    0 <= value < (1 << 31):
                val_idx = value
            elif value_table is not None:
                val_idx = -(value_table.intern(value) + 2)
            else:
                raise ValueError('non-int value requires a value_table')
            out_doc.append(d)
            out_key.append(key_interner.intern(op['key']))
            out_packed.append(pack(op_id))
            out_val.append(val_idx)
            out_flags.append(FLAG_INC if action == 'inc' else FLAG_SET)
            for p in op.get('pred', []):
                preds.append(pack(p))
            pred_off.append(len(preds))

    return {
        'doc': np.array(out_doc, dtype=np.int64),
        'key': np.array(out_key, dtype=np.int32),
        'packed': np.array(out_packed, dtype=np.int32),
        'value': np.array(out_val, dtype=np.int32),
        'flags': np.array(out_flags, dtype=np.uint8),
        'pred_off': np.array(pred_off, dtype=np.int64),
        'pred': np.array(preds, dtype=np.int32),
    }
