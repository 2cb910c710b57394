# Frozen copy of automerge_tpu_torch/columnar.py:1-1090 (the change and
# document codec, without the native column reader and DocChunkView), kept
# here so that a change to the program cannot move the benchmark's inputs.
"""Columnar change/document container format.

Wire-compatible with the reference format (backend/columnar.js): change
chunks (magic bytes 85 6f 4a 83, 4-byte SHA-256 checksum prefix, LEB128
length), column-oriented op storage, SHA-256 change hashing, DEFLATE
compression of large chunks/columns.

Ops cross this layer as plain dicts: {action, obj, key|elemId, insert,
value?, datatype?, pred|succ, child?}, with opIds as 'counter@actor'
strings, matching the reference's JSON op representation.
"""

import hashlib
import struct
import zlib

from .common import parse_op_id, lamport_key
from .errors import MalformedChange, MalformedDocument, as_wire_error
from .encoding import (
    Encoder, Decoder, RLEEncoder, RLEDecoder, DeltaEncoder, DeltaDecoder,
    BooleanEncoder, BooleanDecoder, hex_string_to_bytes, bytes_to_hex_string,
    MAX_SAFE_INTEGER, MIN_SAFE_INTEGER,
)

MAGIC_BYTES = bytes([0x85, 0x6f, 0x4a, 0x83])

CHUNK_TYPE_DOCUMENT = 0
CHUNK_TYPE_CHANGE = 1
CHUNK_TYPE_DEFLATE = 2  # a change chunk, DEFLATE-compressed

DEFLATE_MIN_SIZE = 256

# Least-significant 3 bits of a columnId are its datatype (ref columnar.js:35-38)
COLUMN_TYPE = {
    'GROUP_CARD': 0, 'ACTOR_ID': 1, 'INT_RLE': 2, 'INT_DELTA': 3, 'BOOLEAN': 4,
    'STRING_RLE': 5, 'VALUE_LEN': 6, 'VALUE_RAW': 7,
}
COLUMN_TYPE_DEFLATE = 8  # 4th bit: column is DEFLATE-compressed

# Bottom 4 bits of a VALUE_LEN value are the type tag; upper bits are the
# byte length in the VALUE_RAW column (ref columnar.js:46-49)
VALUE_TYPE = {
    'NULL': 0, 'FALSE': 1, 'TRUE': 2, 'LEB128_UINT': 3, 'LEB128_INT': 4,
    'IEEE754': 5, 'UTF8': 6, 'BYTES': 7, 'COUNTER': 8, 'TIMESTAMP': 9,
    'MIN_UNKNOWN': 10, 'MAX_UNKNOWN': 15,
}

# make* actions at even indexes by design (ref columnar.js:51-52)
ACTIONS = ['makeMap', 'set', 'makeList', 'del', 'makeText', 'inc', 'makeTable', 'link']

OBJECT_TYPE = {'makeMap': 'map', 'makeList': 'list', 'makeText': 'text', 'makeTable': 'table'}

COMMON_COLUMNS = [
    ('objActor',  0 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('objCtr',    0 << 4 | COLUMN_TYPE['INT_RLE']),
    ('keyActor',  1 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('keyCtr',    1 << 4 | COLUMN_TYPE['INT_DELTA']),
    ('keyStr',    1 << 4 | COLUMN_TYPE['STRING_RLE']),
    ('idActor',   2 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('idCtr',     2 << 4 | COLUMN_TYPE['INT_DELTA']),
    ('insert',    3 << 4 | COLUMN_TYPE['BOOLEAN']),
    ('action',    4 << 4 | COLUMN_TYPE['INT_RLE']),
    ('valLen',    5 << 4 | COLUMN_TYPE['VALUE_LEN']),
    ('valRaw',    5 << 4 | COLUMN_TYPE['VALUE_RAW']),
    ('chldActor', 6 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('chldCtr',   6 << 4 | COLUMN_TYPE['INT_DELTA']),
]

CHANGE_COLUMNS = COMMON_COLUMNS + [
    ('predNum',   7 << 4 | COLUMN_TYPE['GROUP_CARD']),
    ('predActor', 7 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('predCtr',   7 << 4 | COLUMN_TYPE['INT_DELTA']),
]

DOC_OPS_COLUMNS = COMMON_COLUMNS + [
    ('succNum',   8 << 4 | COLUMN_TYPE['GROUP_CARD']),
    ('succActor', 8 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('succCtr',   8 << 4 | COLUMN_TYPE['INT_DELTA']),
]

# Column ids valid only inside the document container (the succ group):
# change containers treating them as "unknown" would collide on save
_DOC_RESERVED_COLUMN_IDS = \
    {cid for _, cid in DOC_OPS_COLUMNS} - {cid for _, cid in CHANGE_COLUMNS}

DOCUMENT_COLUMNS = [
    ('actor',     0 << 4 | COLUMN_TYPE['ACTOR_ID']),
    ('seq',       0 << 4 | COLUMN_TYPE['INT_DELTA']),
    ('maxOp',     1 << 4 | COLUMN_TYPE['INT_DELTA']),
    ('time',      2 << 4 | COLUMN_TYPE['INT_DELTA']),
    ('message',   3 << 4 | COLUMN_TYPE['STRING_RLE']),
    ('depsNum',   4 << 4 | COLUMN_TYPE['GROUP_CARD']),
    ('depsIndex', 4 << 4 | COLUMN_TYPE['INT_DELTA']),
    ('extraLen',  5 << 4 | COLUMN_TYPE['VALUE_LEN']),
    ('extraRaw',  5 << 4 | COLUMN_TYPE['VALUE_RAW']),
]


def _deflate_raw(data):
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return c.compress(bytes(data)) + c.flush()


def _inflate_raw(data):
    return zlib.decompress(bytes(data), -15)


class ParsedOpId:
    """An opId resolved against an actor table: (counter, actorNum, actorId)."""
    __slots__ = ('counter', 'actor_num', 'actor_id')

    def __init__(self, counter, actor_num, actor_id):
        self.counter = counter
        self.actor_num = actor_num
        self.actor_id = actor_id

    def sort_key(self):
        # Lamport order: by counter, then by actorId string (ref columnar.js:114-120)
        return (self.counter, self.actor_id)


def _parse(op_id_str, actor_ids):
    counter, actor_id = parse_op_id(op_id_str)
    try:
        actor_num = actor_ids.index(actor_id)
    except ValueError:
        raise ValueError('missing actorId')
    return ParsedOpId(counter, actor_num, actor_id)


def _valid_multi_insert_value(value, datatype):
    if datatype is None:
        return isinstance(value, (str, bool)) or value is None
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def expand_multi_ops(ops, start_op, actor):
    """Expand multi-insert `values` and `multiOp` deletions into individual
    ops (ref columnar.js:446-475)."""
    op_num = start_op
    expanded = []
    for op in ops:
        if op.get('action') == 'set' and op.get('values') is not None and op.get('insert'):
            if op.get('pred'):
                raise ValueError('multi-insert pred must be empty')
            last_elem_id = op['elemId']
            datatype = op.get('datatype')
            for value in op['values']:
                if not _valid_multi_insert_value(value, datatype):
                    raise ValueError(
                        f'Decode failed: bad value/datatype association ({value},{datatype})')
                new_op = {'action': 'set', 'obj': op['obj'], 'elemId': last_elem_id,
                          'value': value, 'pred': [], 'insert': True}
                if datatype is not None:
                    new_op['datatype'] = datatype
                expanded.append(new_op)
                last_elem_id = f'{op_num}@{actor}'
                op_num += 1
        elif op.get('action') == 'del' and op.get('multiOp', 1) > 1:
            if len(op.get('pred', [])) != 1:
                raise ValueError('multiOp deletion must have exactly one pred')
            ctr, eactor = parse_op_id(op['elemId'])
            pctr, pactor = parse_op_id(op['pred'][0])
            for i in range(op['multiOp']):
                expanded.append({'action': 'del', 'obj': op['obj'],
                                 'elemId': f'{ctr + i}@{eactor}',
                                 'pred': [f'{pctr + i}@{pactor}']})
                op_num += 1
        else:
            expanded.append(dict(op))
            op_num += 1
    return expanded


def _collect_unknown_actors(cid, value, actors):
    """Actor-id strings inside unknown columns must be in the actor table."""
    if cid % 8 == COLUMN_TYPE['ACTOR_ID'] and isinstance(value, str):
        actors.add(value)
    elif isinstance(value, list):
        for item in value:
            for inner_cid, inner_value in item.items():
                _collect_unknown_actors(inner_cid, inner_value, actors)


def parse_all_op_ids(changes, single):
    """Replace string opIds in `changes` with ParsedOpId objects and return
    (parsed_changes, actor_ids) (ref columnar.js:133-170)."""
    actors = set()
    new_changes = []
    for change in changes:
        change = dict(change)
        actors.add(change['actor'])
        change['ops'] = expand_multi_ops(change['ops'], change['startOp'], change['actor'])
        for op in change['ops']:
            if op['obj'] != '_root':
                actors.add(parse_op_id(op['obj'])[1])
            if op.get('elemId') and op['elemId'] != '_head':
                actors.add(parse_op_id(op['elemId'])[1])
            if op.get('child'):
                actors.add(parse_op_id(op['child'])[1])
            for pred in op.get('pred', []):
                actors.add(parse_op_id(pred)[1])
            for cid, value in op.get('unknownCols', {}).items():
                _collect_unknown_actors(cid, value, actors)
        new_changes.append(change)

    actor_ids = sorted(actors)
    if single:
        first = changes[0]['actor']
        actor_ids = [first] + [a for a in actor_ids if a != first]
    for change in new_changes:
        actor_num = actor_ids.index(change['actor'])
        change['actorNum'] = actor_num
        for i, op in enumerate(change['ops']):
            op['id'] = ParsedOpId(change['startOp'] + i, actor_num, change['actor'])
            if op['obj'] != '_root':
                op['obj'] = _parse(op['obj'], actor_ids)
            if op.get('elemId') and op['elemId'] != '_head':
                op['elemId'] = _parse(op['elemId'], actor_ids)
            if op.get('child'):
                op['child'] = _parse(op['child'], actor_ids)
            op['pred'] = [_parse(p, actor_ids) for p in op.get('pred', [])]
            if 'succ' in op:
                op['succ'] = [_parse(s, actor_ids) for s in op['succ']]
    return new_changes, actor_ids


def _encode_object_id(op, columns):
    if op['obj'] == '_root':
        columns['objActor'].append_value(None)
        columns['objCtr'].append_value(None)
    else:
        columns['objActor'].append_value(op['obj'].actor_num)
        columns['objCtr'].append_value(op['obj'].counter)


def _encode_operation_key(op, columns):
    if op.get('key'):
        columns['keyActor'].append_value(None)
        columns['keyCtr'].append_value(None)
        columns['keyStr'].append_value(op['key'])
    elif op.get('elemId') == '_head' and op.get('insert'):
        columns['keyActor'].append_value(None)
        columns['keyCtr'].append_value(0)
        columns['keyStr'].append_value(None)
    elif op.get('elemId') is not None and op['elemId'].actor_num >= 0 and \
            op['elemId'].counter > 0:
        columns['keyActor'].append_value(op['elemId'].actor_num)
        columns['keyCtr'].append_value(op['elemId'].counter)
        columns['keyStr'].append_value(None)
    else:
        raise ValueError(f'Unexpected operation key: {op}')


def _encode_operation_action(op, columns):
    action = op['action']
    if isinstance(action, str):
        try:
            columns['action'].append_value(ACTIONS.index(action))
        except ValueError:
            raise ValueError(f'Unexpected operation action: {action}')
    elif isinstance(action, int):
        columns['action'].append_value(action)
    else:
        raise ValueError(f'Unexpected operation action: {action}')


def encode_value_to_columns(op, val_len, val_raw):
    """Encode op's value into the valLen/valRaw column pair (ref columnar.js:259-292)."""
    value = op.get('value')
    datatype = op.get('datatype')
    action = op['action']
    if (action not in ('set', 'inc') and not isinstance(action, int)) or value is None:
        val_len.append_value(VALUE_TYPE['NULL'])
    elif value is False:
        val_len.append_value(VALUE_TYPE['FALSE'])
    elif value is True:
        val_len.append_value(VALUE_TYPE['TRUE'])
    elif isinstance(value, str):
        num_bytes = val_raw.append_raw_string(value)
        val_len.append_value(num_bytes << 4 | VALUE_TYPE['UTF8'])
    elif isinstance(datatype, int) and not isinstance(datatype, bool) and \
            VALUE_TYPE['MIN_UNKNOWN'] <= datatype <= VALUE_TYPE['MAX_UNKNOWN'] and \
            isinstance(value, (bytes, bytearray)):
        num_bytes = val_raw.append_raw_bytes(value)
        val_len.append_value(num_bytes << 4 | datatype)
    elif isinstance(value, (bytes, bytearray)):
        num_bytes = val_raw.append_raw_bytes(value)
        val_len.append_value(num_bytes << 4 | VALUE_TYPE['BYTES'])
    elif isinstance(value, (int, float)):
        type_tag, num_bytes = _encode_number(value, datatype, val_raw)
        val_len.append_value(num_bytes << 4 | type_tag)
    elif datatype:
        raise ValueError(f'Unknown datatype {datatype} for value {value}')
    else:
        raise ValueError(f'Unsupported value in operation: {value}')


def _encode_number(value, datatype, val_raw):
    """Pick the VALUE_TYPE tag for a numeric value (ref columnar.js:228-253)."""
    if datatype == 'counter':
        return VALUE_TYPE['COUNTER'], val_raw.append_int53(int(value))
    if datatype == 'timestamp':
        return VALUE_TYPE['TIMESTAMP'], val_raw.append_int53(int(value))
    if datatype == 'uint':
        return VALUE_TYPE['LEB128_UINT'], val_raw.append_uint53(int(value))
    if datatype == 'int':
        return VALUE_TYPE['LEB128_INT'], val_raw.append_int53(int(value))
    if datatype == 'float64' or isinstance(value, float):
        return VALUE_TYPE['IEEE754'], val_raw.append_raw_bytes(struct.pack('<d', value))
    if MIN_SAFE_INTEGER <= value <= MAX_SAFE_INTEGER:
        return VALUE_TYPE['LEB128_INT'], val_raw.append_int53(value)
    return VALUE_TYPE['IEEE754'], val_raw.append_raw_bytes(struct.pack('<d', float(value)))


def decode_value(size_tag, data):
    """Decode a (valLen tag, valRaw bytes) pair into {value, datatype?}
    (ref columnar.js:300-329)."""
    if size_tag == VALUE_TYPE['NULL']:
        return {'value': None}
    if size_tag == VALUE_TYPE['FALSE']:
        return {'value': False}
    if size_tag == VALUE_TYPE['TRUE']:
        return {'value': True}
    tag = size_tag % 16
    if tag == VALUE_TYPE['UTF8']:
        return {'value': bytes(data).decode('utf-8')}
    if tag == VALUE_TYPE['LEB128_UINT']:
        return {'value': Decoder(data).read_uint53(), 'datatype': 'uint'}
    if tag == VALUE_TYPE['LEB128_INT']:
        return {'value': Decoder(data).read_int53(), 'datatype': 'int'}
    if tag == VALUE_TYPE['IEEE754']:
        if len(data) == 8:
            return {'value': struct.unpack('<d', bytes(data))[0], 'datatype': 'float64'}
        raise ValueError(f'Invalid length for floating point number: {len(data)}')
    if tag == VALUE_TYPE['COUNTER']:
        return {'value': Decoder(data).read_int53(), 'datatype': 'counter'}
    if tag == VALUE_TYPE['TIMESTAMP']:
        return {'value': Decoder(data).read_int53(), 'datatype': 'timestamp'}
    return {'value': bytes(data), 'datatype': tag}


def _unknown_column_plan(ops):
    """Collect unknown column ids across ops: returns (groups, standalone)
    where `groups` maps a GROUP_CARD column id to the set of inner column ids
    observed in its items."""
    groups = {}
    standalone = set()
    for op in ops:
        for cid, value in op.get('unknownCols', {}).items():
            if cid % 8 == COLUMN_TYPE['GROUP_CARD']:
                inner = groups.setdefault(cid, set())
                if isinstance(value, list):
                    for item in value:
                        inner.update(item.keys())
            else:
                standalone.add(cid)
    return groups, standalone


def _append_unknown_scalar(encoders, cid, value, actor_lookup):
    """Append one op's value for an unknown column, re-normalizing actor
    strings to table indexes and value dicts to valLen/valRaw pairs."""
    enc = encoders[cid]
    t = cid & 7
    if t == COLUMN_TYPE['VALUE_LEN']:
        entry = value if isinstance(value, dict) else {'value': value}
        encode_value_to_columns({'action': 'set', 'value': entry.get('value'),
                                 'datatype': entry.get('datatype')},
                                enc, encoders[cid + 1])
    elif t == COLUMN_TYPE['ACTOR_ID'] and value is not None and \
            actor_lookup is not None and isinstance(value, str):
        enc.append_value(actor_lookup[value])
    else:
        enc.append_value(value)


def _encode_unknown_columns(ops, actor_lookup):
    """Build encoders for unknown forward-compat columns so they survive
    re-encoding (the reference carries them in its raw block store instead,
    new_backend_test.js:1857). Returns a list of (column_id, name, encoder)."""
    groups, standalone = _unknown_column_plan(ops)
    if not groups and not standalone:
        return []
    all_ids = set(standalone) | set(groups)
    for inner in groups.values():
        all_ids |= inner
    encoders = {}
    for cid in sorted(all_ids):
        encoders[cid] = encoder_by_column_id(cid)
        if cid % 8 == COLUMN_TYPE['VALUE_LEN'] and cid + 1 not in encoders:
            encoders[cid + 1] = Encoder()
    standalone_order = sorted(standalone)
    group_order = [(gid, sorted(inner)) for gid, inner in sorted(groups.items())]
    for op in ops:
        ucols = op.get('unknownCols', {})
        for cid in standalone_order:
            _append_unknown_scalar(encoders, cid, ucols.get(cid), actor_lookup)
        for gid, inner_order in group_order:
            items = ucols.get(gid)
            if items is None:
                encoders[gid].append_value(None)
                continue
            encoders[gid].append_value(len(items))
            for item in items:
                for cid in inner_order:
                    _append_unknown_scalar(encoders, cid, item.get(cid), actor_lookup)
    return [(cid, f'col_{cid}', enc) for cid, enc in encoders.items()]


def encode_ops(ops, for_document, actor_lookup=None):
    """Encode parsed ops into columns; returns a sorted list of
    (column_id, column_name, encoder) (ref columnar.js:370-436).
    `actor_lookup` maps actor id strings to table indexes for re-encoding
    unknown actor-type columns."""
    columns = {
        'objActor': RLEEncoder('uint'), 'objCtr': RLEEncoder('uint'),
        'keyActor': RLEEncoder('uint'), 'keyCtr': DeltaEncoder(),
        'keyStr': RLEEncoder('utf8'), 'insert': BooleanEncoder(),
        'action': RLEEncoder('uint'), 'valLen': RLEEncoder('uint'),
        'valRaw': Encoder(), 'chldActor': RLEEncoder('uint'),
        'chldCtr': DeltaEncoder(),
    }
    if for_document:
        columns.update({'idActor': RLEEncoder('uint'), 'idCtr': DeltaEncoder(),
                        'succNum': RLEEncoder('uint'), 'succActor': RLEEncoder('uint'),
                        'succCtr': DeltaEncoder()})
    else:
        columns.update({'predNum': RLEEncoder('uint'), 'predCtr': DeltaEncoder(),
                        'predActor': RLEEncoder('uint')})

    for op in ops:
        _encode_object_id(op, columns)
        _encode_operation_key(op, columns)
        columns['insert'].append_value(bool(op.get('insert')))
        _encode_operation_action(op, columns)
        encode_value_to_columns(op, columns['valLen'], columns['valRaw'])

        child = op.get('child')
        if child is not None and child.counter:
            columns['chldActor'].append_value(child.actor_num)
            columns['chldCtr'].append_value(child.counter)
        else:
            columns['chldActor'].append_value(None)
            columns['chldCtr'].append_value(None)

        if for_document:
            columns['idActor'].append_value(op['id'].actor_num)
            columns['idCtr'].append_value(op['id'].counter)
            succ = sorted(op['succ'], key=ParsedOpId.sort_key)
            columns['succNum'].append_value(len(succ))
            for s in succ:
                columns['succActor'].append_value(s.actor_num)
                columns['succCtr'].append_value(s.counter)
        else:
            pred = sorted(op['pred'], key=ParsedOpId.sort_key)
            columns['predNum'].append_value(len(pred))
            for p in pred:
                columns['predActor'].append_value(p.actor_num)
                columns['predCtr'].append_value(p.counter)

    spec = DOC_OPS_COLUMNS if for_document else CHANGE_COLUMNS
    column_list = [(column_id, name, columns[name])
                   for name, column_id in spec if name in columns]
    column_list.extend(_encode_unknown_columns(ops, actor_lookup))
    return sorted(column_list, key=lambda c: c[0])


def encoder_by_column_id(column_id):
    t = column_id & 7
    if t == COLUMN_TYPE['INT_DELTA']:
        return DeltaEncoder()
    if t == COLUMN_TYPE['BOOLEAN']:
        return BooleanEncoder()
    if t == COLUMN_TYPE['STRING_RLE']:
        return RLEEncoder('utf8')
    if t == COLUMN_TYPE['VALUE_RAW']:
        return Encoder()
    return RLEEncoder('uint')


def decoder_by_column_id(column_id, buffer):
    t = column_id & 7
    if t == COLUMN_TYPE['INT_DELTA']:
        return DeltaDecoder(buffer)
    if t == COLUMN_TYPE['BOOLEAN']:
        return BooleanDecoder(buffer)
    if t == COLUMN_TYPE['STRING_RLE']:
        return RLEDecoder('utf8', buffer)
    if t == COLUMN_TYPE['VALUE_RAW']:
        return Decoder(buffer)
    return RLEDecoder('uint', buffer)


def make_decoders(columns, column_spec):
    """Merge encoded columns with the expected spec, supplying empty decoders
    for missing columns and passing through unknown ones (ref columnar.js:553-575).

    `columns` is a list of dicts {columnId, buffer}; returns a list of dicts
    {columnId, columnName?, decoder}.
    """
    decoders = []
    ci = 0
    si = 0
    while ci < len(columns) or si < len(column_spec):
        if ci == len(columns) or (si < len(column_spec) and
                                  column_spec[si][1] < columns[ci]['columnId']):
            name, column_id = column_spec[si]
            decoders.append({'columnId': column_id, 'columnName': name,
                             'decoder': decoder_by_column_id(column_id, b'')})
            si += 1
        elif si == len(column_spec) or columns[ci]['columnId'] < column_spec[si][1]:
            column_id = columns[ci]['columnId']
            decoders.append({'columnId': column_id,
                             'decoder': decoder_by_column_id(column_id, columns[ci]['buffer'])})
            ci += 1
        else:
            name, column_id = column_spec[si]
            decoders.append({'columnId': column_id, 'columnName': name,
                             'decoder': decoder_by_column_id(column_id, columns[ci]['buffer'])})
            ci += 1
            si += 1
    return decoders


def _decode_value_columns(columns, col_index, actor_ids, result):
    """Read one value from columns[col_index] into `result`; returns the number
    of columns consumed (2 for a VALUE_LEN/VALUE_RAW pair) (ref columnar.js:339-361)."""
    col = columns[col_index]
    column_id = col['columnId']
    name = col.get('columnName', f'col_{column_id}')
    if column_id % 8 == COLUMN_TYPE['VALUE_LEN'] and col_index + 1 < len(columns) and \
            columns[col_index + 1]['columnId'] == column_id + 1:
        size_tag = col['decoder'].read_value()
        raw = columns[col_index + 1]['decoder'].read_raw_bytes((size_tag or 0) >> 4)
        decoded = decode_value(size_tag or 0, raw)
        result[name] = decoded['value']
        if 'datatype' in decoded:
            result[name + '_datatype'] = decoded['datatype']
        return 2
    if column_id % 8 == COLUMN_TYPE['ACTOR_ID']:
        actor_num = col['decoder'].read_value()
        if actor_num is None:
            result[name] = None
        else:
            if actor_num >= len(actor_ids):
                raise ValueError(f'No actor index {actor_num}')
            result[name] = actor_ids[actor_num]
        return 1
    result[name] = col['decoder'].read_value()
    return 1


def decode_columns(columns, actor_ids, column_spec):
    """Decode columns into a list of row dicts (ref columnar.js:577-607)."""
    columns = make_decoders(columns, column_spec)
    # Duplicate column ids make the row scan ambiguous (a duplicate group
    # member is never drained, spinning the scan forever): reject up front.
    ids = [c['columnId'] for c in columns]
    if len(set(ids)) != len(ids):
        raise ValueError('duplicate column id in columns')
    rows = []
    while any(not c['decoder'].done for c in columns):
        row = {}
        col = 0
        while col < len(columns):
            column_id = columns[col]['columnId']
            group_id = column_id >> 4
            group_cols = 1
            while col + group_cols < len(columns) and \
                    columns[col + group_cols]['columnId'] >> 4 == group_id:
                group_cols += 1
            if column_id % 8 == COLUMN_TYPE['GROUP_CARD']:
                count = columns[col]['decoder'].read_value()
                # Distinguish null from 0 for unknown group columns so a
                # re-encode reproduces the original bytes; known group columns
                # keep the reference's null->[] behavior (columnar.js:590-598)
                if count is None and 'columnName' not in columns[col]:
                    row[f'col_{column_id}'] = None
                    col += group_cols
                    continue
                values = []
                for _ in range(count or 0):
                    value = {}
                    off = 1
                    while off < group_cols:
                        off += _decode_value_columns(columns, col + off,
                                                     actor_ids, value)
                    values.append(value)
                row[columns[col].get('columnName', f'col_{column_id}')] = values
                col += group_cols
            else:
                col += _decode_value_columns(columns, col, actor_ids, row)
        rows.append(row)
    return rows


def decode_ops(rows, for_document):
    """Convert decoded column rows into op dicts (ref columnar.js:483-510).

    Beyond the reference: unknown columns (decoded under `col_<id>` keys) and
    the values of unknown actions are preserved on the op under 'unknownCols'
    / 'value', so that a document save/load round-trip reproduces the original
    change bytes (and hence hashes) even for forward-compatibility data the
    engine doesn't understand."""
    ops = []
    for row in rows:
        obj = '_root' if row['objCtr'] is None else f"{row['objCtr']}@{row['objActor']}"
        if row['keyStr'] is not None:
            elem_id = None
        elif row['keyCtr'] == 0:
            elem_id = '_head'
        else:
            elem_id = f"{row['keyCtr']}@{row['keyActor']}"
        action_num = row['action']
        action = ACTIONS[action_num] if isinstance(action_num, int) and \
            0 <= action_num < len(ACTIONS) else action_num
        op = {'obj': obj, 'action': action}
        if elem_id is not None:
            op['elemId'] = elem_id
        else:
            op['key'] = row['keyStr']
        op['insert'] = bool(row['insert'])
        if action in ('set', 'inc') or isinstance(action, int):
            op['value'] = row['valLen']
            if row.get('valLen_datatype') is not None:
                op['datatype'] = row['valLen_datatype']
        unknown = _collect_unknown_columns(row)
        if unknown:
            if not for_document:
                # Change-container columns in the document succ group would
                # collide with the succ columns the document container adds
                # on save, making the saved document undecodable
                bad = sorted(set(unknown) & _DOC_RESERVED_COLUMN_IDS)
                if bad:
                    raise ValueError(
                        f'change column id {bad[0]} is reserved for the '
                        f'document container')
            op['unknownCols'] = unknown
        if (row.get('chldCtr') is None) != (row.get('chldActor') is None):
            raise ValueError(
                f"Mismatched child columns: {row.get('chldCtr')} and {row.get('chldActor')}")
        if row.get('chldCtr') is not None:
            op['child'] = f"{row['chldCtr']}@{row['chldActor']}"
        if for_document:
            op['id'] = f"{row['idCtr']}@{row['idActor']}"
            op['succ'] = [f"{s['succCtr']}@{s['succActor']}" for s in row['succNum']]
            _check_sorted_op_ids([(s['succCtr'], s['succActor']) for s in row['succNum']])
        else:
            op['pred'] = [f"{p['predCtr']}@{p['predActor']}" for p in row['predNum']]
            _check_sorted_op_ids([(p['predCtr'], p['predActor']) for p in row['predNum']])
        ops.append(op)
    return ops


def _collect_unknown_columns(row):
    """Gather `col_<id>` entries from a decoded row into {column_id: value}.
    Unknown VALUE_LEN columns become {'value':..., 'datatype':...} dicts;
    unknown group columns keep their list-of-dicts shape with the inner dicts
    normalized recursively."""
    unknown = {}
    for k in row:
        if not k.startswith('col_') or k.endswith('_datatype'):
            continue
        column_id = int(k[4:])
        value = row[k]
        if column_id % 8 == COLUMN_TYPE['VALUE_LEN']:
            entry = {'value': value}
            if row.get(k + '_datatype') is not None:
                entry['datatype'] = row[k + '_datatype']
            unknown[column_id] = entry
        elif isinstance(value, list) and column_id % 8 == COLUMN_TYPE['GROUP_CARD']:
            unknown[column_id] = [_collect_unknown_columns(item) for item in value]
        else:
            unknown[column_id] = value
    return unknown


def _check_sorted_op_ids(keys):
    for i in range(1, len(keys)):
        if keys[i - 1] >= keys[i]:
            raise ValueError('operation IDs are not in ascending order')


def materialize_columns(columns):
    """Finish each column's encoder once, yielding (column_id, name, bytes)."""
    return [(cid, name, enc.buffer) for cid, name, enc in columns]


def encode_column_info(encoder, columns):
    """`columns` is a materialized list of (column_id, name, bytes)."""
    non_empty = [(cid, name, buf) for cid, name, buf in columns if len(buf) > 0]
    encoder.append_uint53(len(non_empty))
    for cid, _name, buf in non_empty:
        encoder.append_uint53(cid)
        encoder.append_uint53(len(buf))


def decode_column_info(decoder):
    column_id_mask = ~COLUMN_TYPE_DEFLATE
    last = -1
    columns = []
    for _ in range(decoder.read_uint53()):
        column_id = decoder.read_uint53()
        buffer_len = decoder.read_uint53()
        if (column_id & column_id_mask) <= (last & column_id_mask):
            raise ValueError('Columns must be in ascending order')
        last = column_id
        columns.append({'columnId': column_id, 'bufferLen': buffer_len})
    return columns


def decode_change_header(decoder):
    num_deps = decoder.read_uint53()
    deps = [bytes_to_hex_string(decoder.read_raw_bytes(32)) for _ in range(num_deps)]
    change = {
        'actor': decoder.read_hex_string(),
        'seq': decoder.read_uint53(),
        'startOp': decoder.read_uint53(),
        'time': decoder.read_int53(),
        'message': decoder.read_prefixed_string(),
        'deps': deps,
    }
    actor_ids = [change['actor']]
    for _ in range(decoder.read_uint53()):
        actor_ids.append(decoder.read_hex_string())
    change['actorIds'] = actor_ids
    return change


def encode_container(chunk_type, contents):
    """Wrap `contents` bytes in a chunk container: magic + 4-byte checksum +
    type byte + LEB128 length + contents. Returns (hash_hex, bytes)
    (ref columnar.js:659-686)."""
    header = Encoder()
    header.append_byte(chunk_type)
    header.append_uint53(len(contents))
    hashed = header.buffer + contents
    digest = hashlib.sha256(hashed).digest()
    return bytes_to_hex_string(digest), MAGIC_BYTES + digest[:4] + hashed


def decode_container_header(decoder, compute_hash):
    if decoder.read_raw_bytes(4) != MAGIC_BYTES:
        raise ValueError('Data does not begin with magic bytes 85 6f 4a 83')
    expected_checksum = decoder.read_raw_bytes(4)
    hash_start = decoder.offset
    chunk_type = decoder.read_byte()
    chunk_length = decoder.read_uint53()
    header = {'chunkType': chunk_type, 'chunkLength': chunk_length,
              'chunkData': decoder.read_raw_bytes(chunk_length)}
    if compute_hash:
        digest = hashlib.sha256(decoder.buf[hash_start:decoder.offset]).digest()
        if digest[:4] != expected_checksum:
            raise ValueError('checksum does not match data')
        header['hash'] = bytes_to_hex_string(digest)
    return header


def encode_change(change_obj):
    """Encode a change (JSON-ish dict) to its binary form (ref columnar.js:710-739)."""
    changes, actor_ids = parse_all_op_ids([change_obj], True)
    change = changes[0]

    body = Encoder()
    deps = change.get('deps', [])
    body.append_uint53(len(deps))
    for dep in sorted(deps):
        body.append_raw_bytes(hex_string_to_bytes(dep))
    body.append_hex_string(change['actor'])
    body.append_uint53(change['seq'])
    body.append_uint53(change['startOp'])
    body.append_int53(change.get('time', 0))
    body.append_prefixed_string(change.get('message') or '')
    body.append_uint53(len(actor_ids) - 1)
    for actor in actor_ids[1:]:
        body.append_hex_string(actor)
    columns = materialize_columns(encode_ops(
        change['ops'], False, {a: i for i, a in enumerate(actor_ids)}))
    encode_column_info(body, columns)
    for _cid, _name, buf in columns:
        body.append_raw_bytes(buf)
    if change.get('extraBytes'):
        body.append_raw_bytes(change['extraBytes'])

    hex_hash, data = encode_container(CHUNK_TYPE_CHANGE, body.buffer)
    if change_obj.get('hash') and change_obj['hash'] != hex_hash:
        raise ValueError(
            f"Change hash does not match encoding: {change_obj['hash']} != {hex_hash}")
    return deflate_change(data) if len(data) >= DEFLATE_MIN_SIZE else data


def decode_change_columns(buffer):
    """Decode a binary change's header and raw columns (ref columnar.js:741-765)."""
    buffer = bytes(buffer)
    if buffer[8] == CHUNK_TYPE_DEFLATE:
        buffer = inflate_change(buffer)
    decoder = Decoder(buffer)
    header = decode_container_header(decoder, True)
    chunk = Decoder(header['chunkData'])
    if not decoder.done:
        raise ValueError('Encoded change has trailing data')
    if header['chunkType'] != CHUNK_TYPE_CHANGE:
        raise ValueError(f"Unexpected chunk type: {header['chunkType']}")

    change = decode_change_header(chunk)
    columns = decode_column_info(chunk)
    for col in columns:
        if col['columnId'] & COLUMN_TYPE_DEFLATE:
            raise ValueError('change must not contain deflated columns')
        col['buffer'] = chunk.read_raw_bytes(col['bufferLen'])
    if not chunk.done:
        change['extraBytes'] = chunk.read_raw_bytes(len(chunk.buf) - chunk.offset)
    change['columns'] = columns
    change['hash'] = header['hash']
    return change


def decode_change(buffer):
    """Decode a binary change into its dict representation (ref
    columnar.js:770-776). Undecodable bytes — whatever the parser trips
    over — raise `MalformedChange` (a ValueError), never a bare decoder
    exception: callers quarantine on the type, and the wire fuzzer pins
    the contract."""
    try:
        change = decode_change_columns(buffer)
        change['ops'] = decode_ops(
            decode_columns(change['columns'], change['actorIds'],
                           CHANGE_COLUMNS), False)
    except Exception as exc:
        raise as_wire_error(exc, MalformedChange, 'decode_change')
    del change['actorIds']
    del change['columns']
    return change


def decode_change_meta(buffer, compute_hash=False):
    """Decode only the header fields of a change (ref columnar.js:783-793).
    Raises `MalformedChange` on undecodable bytes (see decode_change)."""
    try:
        buffer = bytes(buffer)
        if buffer[8] == CHUNK_TYPE_DEFLATE:
            buffer = inflate_change(buffer)
        header = decode_container_header(Decoder(buffer), compute_hash)
        if header['chunkType'] != CHUNK_TYPE_CHANGE:
            raise ValueError('Buffer chunk type is not a change')
        meta = decode_change_header(Decoder(header['chunkData']))
    except Exception as exc:
        raise as_wire_error(exc, MalformedChange, 'decode_change_meta')
    meta['change'] = buffer
    if compute_hash:
        meta['hash'] = header['hash']
    return meta


def deflate_change(buffer):
    header = decode_container_header(Decoder(buffer), False)
    if header['chunkType'] != CHUNK_TYPE_CHANGE:
        raise ValueError(f"Unexpected chunk type: {header['chunkType']}")
    compressed = _deflate_raw(header['chunkData'])
    out = Encoder()
    out.append_raw_bytes(buffer[:8])  # magic + checksum of the uncompressed form
    out.append_byte(CHUNK_TYPE_DEFLATE)
    out.append_uint53(len(compressed))
    out.append_raw_bytes(compressed)
    return out.buffer


def inflate_change(buffer):
    header = decode_container_header(Decoder(buffer), False)
    if header['chunkType'] != CHUNK_TYPE_DEFLATE:
        raise ValueError(f"Unexpected chunk type: {header['chunkType']}")
    decompressed = _inflate_raw(header['chunkData'])
    out = Encoder()
    out.append_raw_bytes(buffer[:8])
    out.append_byte(CHUNK_TYPE_CHANGE)
    out.append_uint53(len(decompressed))
    out.append_raw_bytes(decompressed)
    return out.buffer


def split_containers(buffer):
    """Split concatenated chunks into individual byte arrays (ref
    columnar.js:829-837). Raises `MalformedChange` when the container
    framing itself is corrupt."""
    try:
        decoder = Decoder(buffer)
        chunks = []
        start = 0
        while not decoder.done:
            decode_container_header(decoder, False)
            chunks.append(decoder.buf[start:decoder.offset])
            start = decoder.offset
    except Exception as exc:
        raise as_wire_error(exc, MalformedChange, 'split_containers')
    return chunks


def decode_changes(binary_changes):
    """Decode a list of byte buffers (changes and/or documents) into change dicts
    (ref columnar.js:843-857)."""
    decoded = []
    for binary in binary_changes:
        for chunk in split_containers(binary):
            if chunk[8] == CHUNK_TYPE_DOCUMENT:
                decoded.extend(decode_document(chunk))
            elif chunk[8] in (CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE):
                decoded.append(decode_change(chunk))
    return decoded


def group_change_ops(changes, ops):
    """Redistribute a document's consolidated ops back into the changes they
    came from, resynthesizing del ops from succ entries (ref columnar.js:876-943)."""
    changes_by_actor = {}
    for change in changes:
        change['ops'] = []
        actor_changes = changes_by_actor.setdefault(change['actor'], [])
        if change['seq'] != len(actor_changes) + 1:
            raise ValueError(f"Expected seq = {len(actor_changes) + 1}, got {change['seq']}")
        if change['seq'] > 1 and actor_changes[change['seq'] - 2]['maxOp'] > change['maxOp']:
            raise ValueError('maxOp must increase monotonically per actor')
        actor_changes.append(change)

    ops_by_id = {}
    for op in ops:
        if op['action'] == 'del':
            raise ValueError('document should not contain del operations')
        op['pred'] = ops_by_id[op['id']]['pred'] if op['id'] in ops_by_id else []
        ops_by_id[op['id']] = op
        for succ in op['succ']:
            if succ not in ops_by_id:
                if op.get('elemId'):
                    elem_id = op['id'] if op.get('insert') else op['elemId']
                    ops_by_id[succ] = {'id': succ, 'action': 'del', 'obj': op['obj'],
                                       'elemId': elem_id, 'pred': []}
                else:
                    ops_by_id[succ] = {'id': succ, 'action': 'del', 'obj': op['obj'],
                                       'key': op['key'], 'pred': []}
            ops_by_id[succ]['pred'].append(op['id'])
        del op['succ']
    for op in ops_by_id.values():
        if op['action'] == 'del':
            ops.append(op)

    for op in ops:
        counter, actor_id = parse_op_id(op['id'])
        actor_changes = changes_by_actor[actor_id]
        left, right = 0, len(actor_changes)
        while left < right:
            mid = (left + right) // 2
            if actor_changes[mid]['maxOp'] < counter:
                left = mid + 1
            else:
                right = mid
        if left >= len(actor_changes):
            raise ValueError(f"Operation ID {op['id']} outside of allowed range")
        actor_changes[left]['ops'].append(op)

    for change in changes:
        change['ops'].sort(key=lambda op: lamport_key(op['id']))
        change['startOp'] = change['maxOp'] - len(change['ops']) + 1
        del change['maxOp']
        for i, op in enumerate(change['ops']):
            expected = f"{change['startOp'] + i}@{change['actor']}"
            if op['id'] != expected:
                raise ValueError(f"Expected opId {expected}, got {op['id']}")
            del op['id']


def decode_document_changes(changes, expected_heads):
    """Resolve dep indexes to hashes and recompute each change's hash by
    re-encoding (ref columnar.js:945-981)."""
    heads = {}
    for i, change in enumerate(changes):
        change['deps'] = []
        for dep in change['depsNum']:
            index = dep['depsIndex']
            if index >= i or 'hash' not in changes[index]:
                raise ValueError(f'No hash for index {index} while processing index {i}')
            dep_hash = changes[index]['hash']
            change['deps'].append(dep_hash)
            heads.pop(dep_hash, None)
        change['deps'].sort()
        del change['depsNum']

        if change.get('extraLen_datatype') != VALUE_TYPE['BYTES']:
            raise ValueError(f"Bad datatype for extra bytes: {VALUE_TYPE['BYTES']}")
        change['extraBytes'] = change.pop('extraLen')
        change.pop('extraLen_datatype', None)

        changes[i] = decode_change(encode_change(change))
        heads[changes[i]['hash']] = True

    if sorted(heads.keys()) != sorted(expected_heads):
        raise ValueError(
            f"Mismatched heads hashes: expected {', '.join(expected_heads)}, "
            f"got {', '.join(sorted(heads.keys()))}")


def encode_document_header(doc):
    """Encode document metadata + column buffers into a document chunk
    (ref columnar.js:983-1004). `doc` keys: changesColumns, opsColumns,
    actorIds, heads, headsIndexes, extraBytes. Columns are
    (column_id, name, encoder) tuples."""
    changes_columns = [_deflate_column(c) for c in materialize_columns(doc['changesColumns'])]
    ops_columns = [_deflate_column(c) for c in materialize_columns(doc['opsColumns'])]
    body = Encoder()
    body.append_uint53(len(doc['actorIds']))
    for actor in doc['actorIds']:
        body.append_hex_string(actor)
    body.append_uint53(len(doc['heads']))
    for head in sorted(doc['heads']):
        body.append_raw_bytes(hex_string_to_bytes(head))
    encode_column_info(body, changes_columns)
    encode_column_info(body, ops_columns)
    for _cid, _name, buf in changes_columns:
        body.append_raw_bytes(buf)
    for _cid, _name, buf in ops_columns:
        body.append_raw_bytes(buf)
    for index in doc.get('headsIndexes', []):
        body.append_uint53(index)
    if doc.get('extraBytes'):
        body.append_raw_bytes(doc['extraBytes'])
    _hash, data = encode_container(CHUNK_TYPE_DOCUMENT, body.buffer)
    return data


def _deflate_column(column):
    cid, name, buf = column
    if len(buf) >= DEFLATE_MIN_SIZE:
        return (cid | COLUMN_TYPE_DEFLATE, name, _deflate_raw(buf))
    return column


def _inflate_column(column):
    if column['columnId'] & COLUMN_TYPE_DEFLATE:
        column['buffer'] = _inflate_raw(column['buffer'])
        column['columnId'] ^= COLUMN_TYPE_DEFLATE
    return column


def decode_document_header(buffer):
    """Parse a document chunk into raw columns + metadata (ref columnar.js:1006-1038)."""
    doc_decoder = Decoder(buffer)
    header = decode_container_header(doc_decoder, True)
    decoder = Decoder(header['chunkData'])
    if not doc_decoder.done:
        raise ValueError('Encoded document has trailing data')
    if header['chunkType'] != CHUNK_TYPE_DOCUMENT:
        raise ValueError(f"Unexpected chunk type: {header['chunkType']}")

    actor_ids = [decoder.read_hex_string() for _ in range(decoder.read_uint53())]
    num_heads = decoder.read_uint53()
    heads = [bytes_to_hex_string(decoder.read_raw_bytes(32)) for _ in range(num_heads)]

    changes_columns = decode_column_info(decoder)
    ops_columns = decode_column_info(decoder)
    for col in changes_columns:
        col['buffer'] = decoder.read_raw_bytes(col['bufferLen'])
        _inflate_column(col)
    for col in ops_columns:
        col['buffer'] = decoder.read_raw_bytes(col['bufferLen'])
        _inflate_column(col)
    heads_indexes = []
    if not decoder.done:
        heads_indexes = [decoder.read_uint53() for _ in range(num_heads)]
    extra_bytes = decoder.read_raw_bytes(len(decoder.buf) - decoder.offset)
    return {'changesColumns': changes_columns, 'opsColumns': ops_columns,
            'actorIds': actor_ids, 'heads': heads, 'headsIndexes': heads_indexes,
            'extraBytes': extra_bytes}


def decode_document(buffer):
    """Decode a document chunk back into the original list of changes
    (ref columnar.js:1040-1047). Raises `MalformedDocument` on
    undecodable bytes or when the recomputed heads miss the header's."""
    try:
        header = decode_document_header(buffer)
        changes = decode_columns(header['changesColumns'],
                                 header['actorIds'], DOCUMENT_COLUMNS)
        ops = decode_ops(
            decode_columns(header['opsColumns'], header['actorIds'],
                           DOC_OPS_COLUMNS), True)
        group_change_ops(changes, ops)
        decode_document_changes(changes, header['heads'])
    except Exception as exc:
        raise as_wire_error(exc, MalformedDocument, 'decode_document')
    return changes


