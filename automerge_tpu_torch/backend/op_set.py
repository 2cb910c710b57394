"""The CRDT document engine (OpSet): change application, patch generation,
and document serialization.

This is the host reference engine, semantically equivalent to the reference's
BackendDoc (backend/new.js) but with a different in-memory design: instead of
RLE-compressed op blocks merged by a streaming two-pointer scan
(new.js:1052-1290), we keep a key-indexed op store — per-object dicts of
per-key op lists for maps/tables, and an RGA-ordered element list for
lists/texts. Observable behavior (patches, error conditions, binary document
format) matches the reference:

- conflict resolution: all ops for a key kept in ascending Lamport order;
  visible ops are those with no successors (new.js:1204-1217)
- RGA list insertion: scan forward from the reference element, skipping
  elements with a greater insertion opId (new.js:145-163)
- counters: inc ops are successors of the set op but accumulate
  (new.js:937-965)
- patch grammar and edit coalescing (new.js:747-1040)
- causal gating with per-actor seq contiguity (new.js:1550-1597)

The batched/TPU execution path lives in automerge_tpu.fleet; this engine is
the correctness oracle and handles the irregular host-side work (hash graph,
patch assembly, wire format).
"""

import copy

from ..common import parse_op_id, lamport_key
from ..columnar import (
    OBJECT_TYPE, DOCUMENT_COLUMNS, VALUE_TYPE,
    decode_change, decode_change_meta, decode_document, decode_document_header,
    encode_change, encode_document_header, encode_ops, split_containers,
    CHUNK_TYPE_DOCUMENT, CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE,
    materialize_columns, encoder_by_column_id,
)
from .. import encoding
from .hash_graph import HashGraph, decode_change_buffers


def _utf16_key(s):
    """Sort key giving JS-compatible UTF-16 code-unit string ordering."""
    return s.encode('utf-16-be', 'surrogatepass')


def _js_typeof(value):
    if isinstance(value, bool):
        return 'boolean'
    if isinstance(value, (int, float)):
        return 'number'
    if isinstance(value, str):
        return 'string'
    return 'object'


def empty_object_patch(object_id, type):
    if type in ('list', 'text'):
        return {'objectId': object_id, 'type': type, 'edits': []}
    return {'objectId': object_id, 'type': type, 'props': {}}


def _op_id_delta(id1, id2, delta=1):
    c1, a1 = parse_op_id(id1)
    c2, a2 = parse_op_id(id2)
    return a1 == a2 and c1 + delta == c2


def append_edit(edits, next_edit):
    """Append a list edit, coalescing runs (multi-insert, remove counts)
    (ref new.js:747-782)."""
    if not edits:
        edits.append(next_edit)
        return
    last = edits[-1]
    if last['action'] == 'insert' and next_edit['action'] == 'insert' and \
            last['index'] == next_edit['index'] - 1 and \
            last['value']['type'] == 'value' and next_edit['value']['type'] == 'value' and \
            last['elemId'] == last['opId'] and next_edit['elemId'] == next_edit['opId'] and \
            _op_id_delta(last['elemId'], next_edit['elemId'], 1) and \
            last['value'].get('datatype') == next_edit['value'].get('datatype') and \
            _js_typeof(last['value']['value']) == _js_typeof(next_edit['value']['value']):
        last['action'] = 'multi-insert'
        if next_edit['value'].get('datatype'):
            last['datatype'] = next_edit['value']['datatype']
        last['values'] = [last['value']['value'], next_edit['value']['value']]
        del last['value']
        del last['opId']
    elif last['action'] == 'multi-insert' and next_edit['action'] == 'insert' and \
            last['index'] + len(last['values']) == next_edit['index'] and \
            next_edit['value']['type'] == 'value' and \
            next_edit['elemId'] == next_edit['opId'] and \
            _op_id_delta(last['elemId'], next_edit['elemId'], len(last['values'])) and \
            last.get('datatype') == next_edit['value'].get('datatype') and \
            _js_typeof(last['values'][0]) == _js_typeof(next_edit['value']['value']):
        last['values'].append(next_edit['value']['value'])
    elif last['action'] == 'remove' and next_edit['action'] == 'remove' and \
            last['index'] == next_edit['index']:
        last['count'] += next_edit['count']
    else:
        edits.append(next_edit)


def append_update(edits, index, elem_id, op_id, value, first_update):
    """Append an UpdateEdit; consecutive updates at the same index represent a
    conflict (ref new.js:798-824)."""
    insert = False
    if first_update:
        # Pop earlier edits for the same index so they aren't misread as
        # part of this conflict set
        while not insert and edits:
            last = edits[-1]
            if last['action'] in ('insert', 'update') and last['index'] == index:
                edits.pop()
                insert = last['action'] == 'insert'
            elif last['action'] == 'multi-insert' and \
                    last['index'] + len(last['values']) - 1 == index:
                last['values'].pop()
                insert = True
            else:
                break
    if insert:
        append_edit(edits, {'action': 'insert', 'index': index, 'elemId': elem_id,
                            'opId': op_id, 'value': value})
    else:
        append_edit(edits, {'action': 'update', 'index': index, 'opId': op_id,
                            'value': value})


def convert_insert_to_update(edits, index, elem_id):
    """Rewrite a trailing insert-plus-updates suffix at `index` into updates
    (ref new.js:838-869)."""
    updates = []
    while edits:
        last = edits[-1]
        if last['action'] == 'insert':
            if last['index'] != index:
                raise ValueError('last edit has unexpected index')
            updates.insert(0, edits.pop())
            break
        elif last['action'] == 'update':
            if last['index'] != index:
                raise ValueError('last edit has unexpected index')
            updates.insert(0, edits.pop())
        else:
            raise ValueError('last edit has unexpected action')
    first_update = True
    for update in updates:
        append_update(edits, index, elem_id, update['opId'], update['value'], first_update)
        first_update = False


def _value_patch(op):
    value = {'type': 'value', 'value': op.get('value')}
    if op.get('datatype') is not None:
        value['datatype'] = op['datatype']
    return value


class Elem:
    """One list/text element: the insertion op plus all ops targeting it,
    in ascending Lamport order. Visibility (any op with no successors) is
    cached and refreshed by the mutation paths."""
    __slots__ = ('elem_id', 'ops', 'vis')

    def __init__(self, elem_id, ops):
        self.elem_id = elem_id
        self.ops = ops
        self.vis = any(len(op['succ']) == 0 for op in ops)

    def visible(self):
        return self.vis

    def recompute_visibility(self):
        self.vis = any(len(op['succ']) == 0 for op in self.ops)
        return self.vis


# Sequence objects store elements in blocks with cached visible counts so
# that position lookups are O(blocks + block_size) instead of O(elements) —
# the same trick as the reference's op blocks (ref new.js MAX_BLOCK_SIZE=600,
# blocks carry numVisible metadata for list index computation)
_BLOCK_SIZE = 256


class _Block:
    __slots__ = ('elems', 'visible')

    def __init__(self, elems=None, visible=0):
        self.elems = elems if elems is not None else []
        self.visible = visible


class ObjState:
    """State of one object in the document tree."""
    __slots__ = ('type', 'keys', 'blocks', 'elem_block')

    def __init__(self, type):
        self.type = type
        if type in ('list', 'text'):
            self.keys = None
            self.blocks = [_Block()]
            self.elem_block = {}
        else:
            self.keys = {}
            self.blocks = None
            self.elem_block = None

    @property
    def is_seq(self):
        return self.blocks is not None

    # -- sequence operations ------------------------------------------------

    def iter_elems(self):
        for block in self.blocks:
            yield from block.elems

    def find(self, elem_id):
        entry = self.elem_block.get(elem_id)
        return entry[1] if entry is not None else None

    def visible_index_of(self, elem_id):
        """Number of visible elements strictly before the given element."""
        entry = self.elem_block.get(elem_id)
        if entry is None:
            raise ValueError(f'Reference element not found: {elem_id}')
        target_block = entry[0]
        count = 0
        for block in self.blocks:
            if block is target_block:
                for elem in block.elems:
                    if elem.elem_id == elem_id:
                        return count
                    if elem.visible():
                        count += 1
                break
            count += block.visible
        raise ValueError(f'Reference element not found: {elem_id}')

    def insert_rga(self, ref_elem_id, elem, my_key):
        """Insert `elem` after `ref_elem_id` ('_head' for the front), skipping
        concurrent insertions with greater packed opIds (the RGA rule, ref
        new.js:145-163). Returns the visible index of the insertion point."""
        if ref_elem_id == '_head':
            bi, pos, count = 0, 0, 0
        else:
            entry = self.elem_block.get(ref_elem_id)
            if entry is None:
                raise ValueError(f'Reference element not found: {ref_elem_id}')
            block = entry[0]
            bi = self.blocks.index(block)
            count = sum(b.visible for b in self.blocks[:bi])
            pos = None
            for i, e in enumerate(block.elems):
                if e.elem_id == ref_elem_id:
                    pos = i + 1
                    if e.visible():
                        count += 1
                    break
                if e.visible():
                    count += 1
            if pos is None:
                raise ValueError(f'Reference element not found: {ref_elem_id}')
        # Skip concurrent siblings with greater insertion opIds
        while True:
            block = self.blocks[bi]
            while pos < len(block.elems):
                nxt = block.elems[pos]
                if lamport_key(nxt.elem_id) > my_key:
                    if nxt.visible():
                        count += 1
                    pos += 1
                else:
                    break
            else:
                if bi + 1 < len(self.blocks):
                    bi += 1
                    pos = 0
                    continue
            break
        block = self.blocks[bi]
        block.elems.insert(pos, elem)
        self.elem_block[elem.elem_id] = (block, elem)
        if elem.visible():
            block.visible += 1
        if len(block.elems) > _BLOCK_SIZE:
            self._split_block(bi)
        return count

    def _split_block(self, bi):
        block = self.blocks[bi]
        half = len(block.elems) // 2
        right = _Block(block.elems[half:])
        block.elems = block.elems[:half]
        right.visible = sum(1 for e in right.elems if e.visible())
        block.visible -= right.visible
        self.blocks.insert(bi + 1, right)
        for elem in right.elems:
            self.elem_block[elem.elem_id] = (right, elem)

    def refresh_visibility(self, elem, was_visible):
        """Adjust the cached visible count after elem's ops changed."""
        now = elem.recompute_visibility()
        if now != was_visible:
            block = self.elem_block[elem.elem_id][0]
            block.visible += 1 if now else -1


def root_meta():
    """Fresh root objectMeta entry (ref new.js:1694-1768)."""
    return {'parentObj': None, 'parentKey': None, 'opId': '_root',
            'type': 'map', 'children': {}}


class OpSet(HashGraph):
    """The document engine: equivalent of the reference's BackendDoc
    (new.js:1694-2069). Causal-gate/hash-graph state lives in HashGraph."""

    def __init__(self, buffer=None):
        super().__init__()
        self.objects = {'_root': ObjState('map')}
        self.object_meta = {'_root': root_meta()}
        self.binary_doc = None
        self.extra_bytes = None
        if buffer is not None:
            self._load(buffer)

    def clone(self):
        other = copy.deepcopy(self)
        return other

    # ------------------------------------------------------------------
    # Change application
    # ------------------------------------------------------------------

    def apply_changes(self, change_buffers, is_local=False):
        """Apply binary changes; returns a patch (ref new.js:1797-1879)."""
        decoded = decode_change_buffers(change_buffers)
        patches = {'_root': empty_object_patch('_root', 'map')}
        object_ids = set()

        try:
            all_applied, queue = self._drain_queue(
                decoded,
                lambda change: self._apply_decoded_change(patches, change,
                                                          object_ids))
        except Exception:
            # Roll back to the pre-call state by replaying the (unmodified)
            # change history; cheap because it only runs on the error path
            self._restore_from_history()
            raise

        self._setup_patches(patches, object_ids)

        for change in all_applied:
            self._record_applied(change)
        self.queue = queue
        self.binary_doc = None

        patch = {'maxOp': self.max_op, 'clock': dict(self.clock), 'deps': list(self.heads),
                 'pendingChanges': len(self.queue), 'diffs': patches['_root']}
        if is_local and len(decoded) == 1:
            patch['actor'] = decoded[0]['actor']
            patch['seq'] = decoded[0]['seq']
        return patch

    def _restore_from_history(self):
        fresh = OpSet()
        if self.changes:
            fresh.apply_changes(list(self.changes))
        self.objects = fresh.objects
        self.object_meta = fresh.object_meta
        self.max_op = fresh.max_op
        self.actor_ids = fresh.actor_ids
        self.heads = fresh.heads
        self.clock = fresh.clock

    def _apply_decoded_change(self, patches, change, object_ids):
        if change['actor'] not in self.actor_ids:
            self.actor_ids.append(change['actor'])
        start_op = change['startOp']
        for i, op in enumerate(change['ops']):
            op_id = f"{start_op + i}@{change['actor']}"
            if start_op + i > self.max_op:
                self.max_op = start_op + i
            self._apply_op(patches, op_id, op, object_ids)

    def _apply_op(self, patches, op_id, op, object_ids):
        if op['action'] == 'link':
            # `link` is a reserved slot in the wire-format action table
            # (ref columnar.js:51-52) that the reference engine never
            # emits or applies (open TODO at new.js:893, zero test
            # coverage). Storing the op anyway would leave an untracked
            # parent-child edge and a patch referencing a child object
            # that never resolves, so we reject loudly instead of
            # diverging silently. Documented in PARITY.md.
            raise ValueError(f'link operations are not supported (op {op_id})')
        object_id = op['obj']
        obj = self.objects.get(object_id)
        if obj is None:
            raise ValueError(f'modification of unknown object {object_id}')
        object_ids.add(object_id)

        record = {
            'id': op_id, 'action': op['action'], 'insert': bool(op.get('insert')),
            'succ': [],
        }
        if 'value' in op:
            record['value'] = op['value']
        if op.get('datatype') is not None:
            record['datatype'] = op['datatype']
        if op.get('child') is not None:
            record['child'] = op['child']
        if op.get('unknownCols'):
            record['unknownCols'] = op['unknownCols']
        if obj.is_seq:
            # Keep the original reference elemId (needed to serialize the
            # document's keyActor/keyCtr columns); the element's own id is
            # derived from the record id when insert is set
            record['elemId'] = op.get('elemId')
        else:
            record['key'] = op.get('key')

        # A make* op brings a new object into existence
        if op['action'] in OBJECT_TYPE and op_id not in self.objects:
            self.objects[op_id] = ObjState(OBJECT_TYPE[op['action']])

        if op.get('insert'):
            self._apply_insert(patches, object_id, obj, record, op)
        else:
            self._apply_update(patches, object_id, obj, record, op)

    def _apply_insert(self, patches, object_id, obj, record, op):
        """RGA list insertion (ref new.js seekWithinBlock:95-163)."""
        if not obj.is_seq:
            raise ValueError(f'insert into non-list object {object_id}')
        if op.get('pred'):
            pred = op['pred'][0]
            raise ValueError(f'no matching operation for pred: {pred}')
        op_id = record['id']
        if op_id in obj.elem_block:
            raise ValueError(f'duplicate operation ID: {op_id}')
        ref = op.get('elemId', '_head')
        elem = Elem(op_id, [record])
        list_index = obj.insert_rga(ref, elem, lamport_key(op_id))

        prop_state = {}
        self._update_patch_property(patches, object_id, record, prop_state,
                                    list_index, None, self.object_meta)

    def _apply_update(self, patches, object_id, obj, record, op):
        """Apply a non-insert op: merge into the target key's op list, mark
        succ on preds, and emit patch calls for every op of that key in
        ascending Lamport order (equivalent to the doc-op consumption in
        new.js mergeDocChangeOps:1067-1282)."""
        op_id = record['id']
        elem = None
        if obj.is_seq:
            elem_id = op.get('elemId')
            elem = obj.find(elem_id)
            if elem is None:
                raise ValueError(f'Reference element not found: {elem_id}')
            rows = elem.ops
        else:
            key = op.get('key')
            if key is None:
                raise ValueError(f'Unexpected operation key: {op}')
            rows = self.objects[object_id].keys.setdefault(key, [])

        # Capture old succ counts (before this op's overwrites are recorded)
        old_succ = {row['id']: len(row['succ']) for row in rows}
        was_visible = elem.visible() if elem is not None else None

        # Mark this op as successor of each of its preds
        preds = list(op.get('pred', []))
        pred_set = set(preds)
        seen = set()
        for row in rows:
            if row['id'] == op_id:
                raise ValueError(f'duplicate operation ID: {op_id}')
            if row['id'] in pred_set:
                row['succ'].append(op_id)
                row['succ'].sort(key=lamport_key)
                seen.add(row['id'])
        for pred in preds:
            if pred not in seen:
                raise ValueError(f'no matching operation for pred: {pred}')

        is_del = op['action'] == 'del'
        # Insert the new op into the key's op list in ascending Lamport order
        # (deletions exist only as succ entries, not as rows)
        if not is_del:
            insert_at = len(rows)
            my_key = lamport_key(op_id)
            for i, row in enumerate(rows):
                if lamport_key(row['id']) > my_key:
                    insert_at = i
                    break
            rows.insert(insert_at, record)

        # Keep the block's cached visible count in sync with the mutation
        if elem is not None:
            obj.refresh_visibility(elem, was_visible)

        # Emit patch calls for all ops of this key in order
        if obj.is_seq:
            list_index = obj.visible_index_of(op.get('elemId'))
        else:
            list_index = 0
        prop_state = {}
        for row in rows:
            if row is record:
                self._update_patch_property(patches, object_id, row, prop_state,
                                            list_index, None, self.object_meta)
            else:
                self._update_patch_property(patches, object_id, row, prop_state,
                                            list_index, old_succ[row['id']],
                                            self.object_meta)

    # ------------------------------------------------------------------
    # Patch generation
    # ------------------------------------------------------------------

    def _update_patch_property(self, patches, object_id, op, prop_state, list_index,
                               old_succ_num, object_meta, whole_doc=False):
        """Port of new.js updatePatchProperty (:884-1040): updates `patches`
        to reflect op, carrying conflict/counter state in `prop_state`."""
        action = op['action']
        is_make = action in OBJECT_TYPE
        type_ = OBJECT_TYPE.get(action)
        op_id = op['id']
        obj = self.objects[object_id]
        is_seq = obj.is_seq
        if is_seq:
            key = op['id'] if op.get('insert') else op.get('elemId')
        else:
            key = op.get('key')

        if is_make and op_id not in object_meta:
            object_meta[op_id] = {'parentObj': object_id, 'parentKey': key,
                                  'opId': op_id, 'type': type_, 'children': {}}
            object_meta[object_id]['children'].setdefault(key, {})[op_id] = \
                {'objectId': op_id, 'type': type_, 'props': {}}

        first_op = key not in prop_state
        state = prop_state.setdefault(
            key, {'visibleOps': [], 'hasChild': False, 'counterStates': {}, 'action': None})

        is_overwritten = old_succ_num is not None and len(op['succ']) > 0

        if not is_overwritten:
            state['visibleOps'].append(op)
            state['hasChild'] = state['hasChild'] or is_make

        prev_children = object_meta[object_id]['children'].get(key)
        if state['hasChild'] or prev_children:
            values = {}
            for vis in state['visibleOps']:
                if vis['action'] == 'set':
                    values[vis['id']] = _value_patch(vis)
                elif vis['action'] in OBJECT_TYPE:
                    values[vis['id']] = {'objectId': vis['id'],
                                         'type': OBJECT_TYPE[vis['action']], 'props': {}}
            object_meta[object_id]['children'][key] = values

        patch_key = patch_value = None

        if is_overwritten and action == 'set' and op.get('datatype') == 'counter':
            # Counter initialization: succs may be increments that accumulate
            counter_state = {'opId': op_id, 'value': op.get('value'),
                             'succs': set(op['succ'])}
            for succ in op['succ']:
                state['counterStates'][succ] = counter_state
        elif action == 'inc':
            counter_state = state['counterStates'].get(op_id)
            if counter_state is None:
                raise ValueError(f'increment operation {op_id} for unknown counter')
            counter_state['value'] += op.get('value')
            counter_state['succs'].discard(op_id)
            if not counter_state['succs']:
                patch_key = counter_state['opId']
                patch_value = {'type': 'value', 'datatype': 'counter',
                               'value': counter_state['value']}
        elif not is_overwritten:
            if action == 'set':
                patch_key = op_id
                patch_value = _value_patch(op)
            elif is_make:
                if op_id not in patches:
                    patches[op_id] = empty_object_patch(op_id, type_)
                patch_key = op_id
                patch_value = patches[op_id]

        if object_id not in patches:
            patches[object_id] = empty_object_patch(object_id,
                                                    object_meta[object_id]['type'])
        patch = patches[object_id]

        if is_seq:
            elem_id = key
            if old_succ_num == 0 and not whole_doc and state['action'] == 'insert':
                # The list element already existed, so the insert becomes an update
                state['action'] = 'update'
                convert_insert_to_update(patch['edits'], list_index, elem_id)

            if patch_value is not None:
                if not state['action'] and (old_succ_num is None or whole_doc):
                    state['action'] = 'insert'
                    append_edit(patch['edits'], {'action': 'insert', 'index': list_index,
                                                 'elemId': elem_id, 'opId': patch_key,
                                                 'value': patch_value})
                elif state['action'] == 'remove':
                    last = patch['edits'][-1]
                    if last['action'] != 'remove':
                        raise ValueError('last edit has unexpected type')
                    if last['count'] > 1:
                        last['count'] -= 1
                    else:
                        patch['edits'].pop()
                    state['action'] = 'update'
                    append_update(patch['edits'], list_index, elem_id, patch_key,
                                  patch_value, True)
                else:
                    append_update(patch['edits'], list_index, elem_id, patch_key,
                                  patch_value, not state['action'])
                    if not state['action']:
                        state['action'] = 'update'
            elif old_succ_num == 0 and not state['action']:
                state['action'] = 'remove'
                append_edit(patch['edits'], {'action': 'remove', 'index': list_index,
                                             'count': 1})
        elif patch_value is not None or not whole_doc:
            if first_op or key not in patch['props']:
                patch['props'][key] = {}
            if patch_value is not None:
                patch['props'][key][patch_key] = patch_value

    def _setup_patches(self, patches, object_ids):
        """Link child-object patches up the tree to the root (ref new.js:1461-1528)."""
        for object_id in object_ids:
            meta = self.object_meta[object_id]
            child_meta = None
            patch_exists = False
            while True:
                has_children = child_meta is not None and \
                    bool(meta['children'].get(child_meta['parentKey']))
                if object_id not in patches:
                    patches[object_id] = empty_object_patch(object_id, meta['type'])

                if child_meta and has_children:
                    if meta['type'] in ('list', 'text'):
                        for edit in patches[object_id]['edits']:
                            if edit.get('opId') and \
                                    edit['opId'] in meta['children'][child_meta['parentKey']]:
                                patch_exists = True
                        if not patch_exists:
                            obj = self.objects[object_id]
                            visible_count = obj.visible_index_of(child_meta['parentKey'])
                            for op_id, value in \
                                    meta['children'][child_meta['parentKey']].items():
                                patch_value = value
                                if value.get('objectId'):
                                    if value['objectId'] not in patches:
                                        patches[value['objectId']] = \
                                            empty_object_patch(value['objectId'], value['type'])
                                    patch_value = patches[value['objectId']]
                                append_edit(patches[object_id]['edits'],
                                            {'action': 'update', 'index': visible_count,
                                             'opId': op_id, 'value': patch_value})
                    else:
                        values = patches[object_id]['props'].setdefault(
                            child_meta['parentKey'], {})
                        for op_id, value in \
                                meta['children'][child_meta['parentKey']].items():
                            if op_id in values:
                                patch_exists = True
                            elif value.get('objectId'):
                                if value['objectId'] not in patches:
                                    patches[value['objectId']] = \
                                        empty_object_patch(value['objectId'], value['type'])
                                values[op_id] = patches[value['objectId']]
                            else:
                                values[op_id] = value

                if patch_exists or not meta['parentObj'] or \
                        (child_meta and not has_children):
                    break
                child_meta = meta
                object_id = meta['parentObj']
                meta = self.object_meta[object_id]
        return patches

    # ------------------------------------------------------------------
    # Whole-document patch (ref new.js documentPatch:1604-1635)
    # ------------------------------------------------------------------

    def get_patch(self):
        object_meta = {'_root': root_meta()}
        patches = {'_root': empty_object_patch('_root', 'map')}
        for object_id in self._document_object_order():
            obj = self.objects[object_id]
            prop_state = {}
            if obj.is_seq:
                list_index = 0
                for elem in obj.iter_elems():
                    for row in elem.ops:
                        self._update_patch_property(patches, object_id, row, prop_state,
                                                    list_index, len(row['succ']),
                                                    object_meta, whole_doc=True)
                    if elem.visible():
                        list_index += 1
            else:
                for key in sorted(obj.keys.keys(), key=_utf16_key):
                    for row in obj.keys[key]:
                        self._update_patch_property(patches, object_id, row, prop_state,
                                                    0, len(row['succ']),
                                                    object_meta, whole_doc=True)
        return {'maxOp': self.max_op, 'clock': dict(self.clock),
                'deps': list(self.heads), 'pendingChanges': len(self.queue),
                'diffs': patches['_root']}

    def _document_object_order(self):
        """Objects in document order: root first, then ascending (counter, actor)."""
        others = [oid for oid in self.objects if oid != '_root']
        others.sort(key=lamport_key)
        return ['_root'] + others

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def _document_ops(self):
        """All ops in document order, as dicts for columnar encoding."""
        ops = []
        for object_id in self._document_object_order():
            obj = self.objects[object_id]
            if obj.is_seq:
                for elem in obj.iter_elems():
                    for row in elem.ops:
                        op = {'obj': object_id, 'action': row['action'],
                              'insert': row.get('insert', False),
                              'id': row['id'], 'succ': list(row['succ']),
                              'elemId': row['elemId']}
                        if 'value' in row:
                            op['value'] = row['value']
                        if 'datatype' in row:
                            op['datatype'] = row['datatype']
                        if 'child' in row:
                            op['child'] = row['child']
                        if 'unknownCols' in row:
                            op['unknownCols'] = row['unknownCols']
                        ops.append(op)
            else:
                for key in sorted(obj.keys.keys(), key=_utf16_key):
                    for row in obj.keys[key]:
                        op = {'obj': object_id, 'action': row['action'],
                              'key': key, 'insert': False,
                              'id': row['id'], 'succ': list(row['succ'])}
                        if 'value' in row:
                            op['value'] = row['value']
                        if 'datatype' in row:
                            op['datatype'] = row['datatype']
                        if 'child' in row:
                            op['child'] = row['child']
                        if 'unknownCols' in row:
                            op['unknownCols'] = row['unknownCols']
                        ops.append(op)
        return ops

    def _canonical_change_order(self):
        """Deterministic topological order over the applied changes, so that
        converged replicas serialize byte-identical documents regardless of
        the order changes arrived. The reference serializes in application
        order and leaves canonicalization as a TODO (new.js:2048); we order by
        a Kahn traversal with ties broken on change hash, adding implicit
        per-actor seq edges so actors' changes stay seq-ascending (required by
        the document decoder, columnar.js:876-905). Returns (order,
        hash_by_index) where `order` lists original change indexes."""
        import heapq
        self._ensure_graph()
        n = len(self.changes_meta)
        hash_by_index = [None] * n
        for h, i in self.change_index_by_hash.items():
            hash_by_index[i] = h
        children = [[] for _ in range(n)]
        indegree = [0] * n
        for i, meta in enumerate(self.changes_meta):
            for dep in meta['deps']:
                children[self.change_index_by_hash[dep]].append(i)
                indegree[i] += 1
        by_actor = {}
        for i, meta in enumerate(self.changes_meta):
            by_actor.setdefault(meta['actor'], []).append(i)
        for idxs in by_actor.values():
            idxs.sort(key=lambda i: self.changes_meta[i]['seq'])
            for a, b in zip(idxs, idxs[1:]):
                children[a].append(b)
                indegree[b] += 1
        heap = [(hash_by_index[i], i) for i in range(n) if indegree[i] == 0]
        heapq.heapify(heap)
        order = []
        while heap:
            _, i = heapq.heappop(heap)
            order.append(i)
            for child in children[i]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    heapq.heappush(heap, (hash_by_index[child], child))
        return order, hash_by_index

    def save(self):
        """Serialize to the document container format (ref new.js:2033-2055).
        Unlike the reference, the encoding is canonical: changes are sorted
        into a deterministic topological order and the actor table is sorted,
        so converged replicas produce identical bytes."""
        if self.binary_doc:
            return self.binary_doc
        doc_ops = self._document_ops()
        order, hash_by_index = self._canonical_change_order()
        canonical_index = {hash_by_index[old]: pos for pos, old in enumerate(order)}
        # Unknown ACTOR_ID columns may reference actors that never authored a
        # change; they still need actor-table entries (cf. the change-encode
        # path's _collect_unknown_actors use in parse_all_op_ids)
        from ..columnar import ParsedOpId, _collect_unknown_actors
        doc_actor_set = set(self.actor_ids)
        for op in doc_ops:
            for cid, value in op.get('unknownCols', {}).items():
                _collect_unknown_actors(cid, value, doc_actor_set)
        doc_actor_ids = sorted(doc_actor_set)
        actor_index = {actor: i for i, actor in enumerate(doc_actor_ids)}

        def parse(op_id_str):
            ctr, actor = parse_op_id(op_id_str)
            return ParsedOpId(ctr, actor_index[actor], actor)

        parsed_ops = []
        for op in doc_ops:
            parsed = dict(op)
            parsed['id'] = parse(op['id'])
            parsed['obj'] = op['obj'] if op['obj'] == '_root' else parse(op['obj'])
            if parsed.get('elemId') not in (None, '_head'):
                parsed['elemId'] = parse(parsed['elemId'])
            parsed['succ'] = [parse(s) for s in op['succ']]
            if parsed.get('child') is not None:
                parsed['child'] = parse(parsed['child'])
            parsed_ops.append(parsed)
        ops_columns = encode_ops(parsed_ops, True, actor_index)

        changes_columns = self._encode_changes_columns(order, actor_index,
                                                       canonical_index)
        self.binary_doc = encode_document_header({
            'changesColumns': changes_columns,
            'opsColumns': ops_columns,
            'actorIds': doc_actor_ids,
            'heads': list(self.heads),
            'headsIndexes': [canonical_index[h] for h in sorted(self.heads)],
            'extraBytes': self.extra_bytes,
        })
        return self.binary_doc

    def _encode_changes_columns(self, order, actor_index, canonical_index):
        columns = {name: encoder_by_column_id(cid) for name, cid in DOCUMENT_COLUMNS
                   if (cid & 7) != 7}
        val_raw = encoding.Encoder()
        for i in order:
            meta = self.changes_meta[i]
            columns['actor'].append_value(actor_index[meta['actor']])
            columns['seq'].append_value(meta['seq'])
            columns['maxOp'].append_value(meta['maxOp'])
            columns['time'].append_value(meta['time'])
            columns['message'].append_value(meta['message'])
            deps = sorted(meta['deps'])
            columns['depsNum'].append_value(len(deps))
            for dep in deps:
                columns['depsIndex'].append_value(canonical_index[dep])
            extra = meta.get('extraBytes')
            if extra:
                num = val_raw.append_raw_bytes(extra)
                columns['extraLen'].append_value(num << 4 | VALUE_TYPE['BYTES'])
            else:
                columns['extraLen'].append_value(VALUE_TYPE['BYTES'])
        out = []
        for name, cid in DOCUMENT_COLUMNS:
            if name == 'extraRaw':
                out.append((cid, name, val_raw))
            else:
                out.append((cid, name, columns[name]))
        return out

    def _load(self, buffer):
        """Initialize from a saved document (or concatenated chunks)."""
        buffer = bytes(buffer)
        chunks = split_containers(buffer)
        changes = []
        for chunk in chunks:
            if chunk[8] == CHUNK_TYPE_DOCUMENT:
                header = decode_document_header(chunk)
                if header['extraBytes']:
                    self.extra_bytes = header['extraBytes']
                for change in decode_document(chunk):
                    changes.append(encode_change(change))
            else:
                changes.append(chunk)
        if changes:
            self.apply_changes(changes)
        # Deliberately NOT caching `buffer` as binary_doc: save() promises a
        # canonical encoding, and a loaded document's bytes may be a foreign
        # (application-order) encoding that converged replicas would not share
