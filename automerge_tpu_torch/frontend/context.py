"""Mutation context: the write path of the frontend (ref frontend/context.js).

Accumulates ops for a change request while simultaneously applying an
equivalent local patch so the mutable proxies see their own writes.
"""

import datetime

from ..common import parse_op_id, uuid
from .apply_patch import interpret_patch, datetime_to_timestamp
from .values import Counter, WriteableCounter, Int, Uint, Float64, \
    MAX_SAFE_INTEGER, MIN_SAFE_INTEGER
from .text import Text
from .table import Table
from .views import MapView, ListView, get_object_id

PRIMITIVES = (str, bool, int, float, type(None))
WRAPPERS = (datetime.datetime, Counter, Int, Uint, Float64)


def _is_primitive(value):
    return isinstance(value, PRIMITIVES) or isinstance(value, WRAPPERS)


class Context:
    def __init__(self, doc, actor_id, apply_patch=None):
        self.actor_id = actor_id
        self.next_op_num = doc._state['maxOp'] + 1
        self.cache = doc._cache
        self.updated = {}
        self.ops = []
        self.apply_patch = apply_patch if apply_patch is not None else interpret_patch
        self.instantiate_object = None  # set by proxies.root_object_proxy

    def add_op(self, operation):
        self.ops.append(operation)
        if operation['action'] == 'set' and 'values' in operation:
            self.next_op_num += len(operation['values'])
        elif operation['action'] == 'del' and operation.get('multiOp'):
            self.next_op_num += operation['multiOp']
        else:
            self.next_op_num += 1

    def next_op_id(self):
        return f'{self.next_op_num}@{self.actor_id}'

    def get_value_description(self, value):
        """JS value -> typed patch description (ref context.js:51-93)."""
        if isinstance(value, datetime.datetime):
            return {'type': 'value', 'value': datetime_to_timestamp(value),
                    'datatype': 'timestamp'}
        if isinstance(value, Int):
            return {'type': 'value', 'value': value.value, 'datatype': 'int'}
        if isinstance(value, Uint):
            return {'type': 'value', 'value': value.value, 'datatype': 'uint'}
        if isinstance(value, Float64):
            return {'type': 'value', 'value': value.value, 'datatype': 'float64'}
        if isinstance(value, Counter):
            return {'type': 'value', 'value': value.value, 'datatype': 'counter'}
        if isinstance(value, bool) or value is None or isinstance(value, str):
            return {'type': 'value', 'value': value}
        if isinstance(value, int):
            if MIN_SAFE_INTEGER <= value <= MAX_SAFE_INTEGER:
                return {'type': 'value', 'value': value, 'datatype': 'int'}
            return {'type': 'value', 'value': float(value), 'datatype': 'float64'}
        if isinstance(value, float):
            if value.is_integer() and MIN_SAFE_INTEGER <= value <= MAX_SAFE_INTEGER:
                return {'type': 'value', 'value': int(value), 'datatype': 'int'}
            return {'type': 'value', 'value': value, 'datatype': 'float64'}
        # Nested object (map, list, text, or table)
        object_id = get_object_id(value)
        if not object_id:
            raise ValueError(f'Object {value!r} has no objectId')
        type_ = self.get_object_type(object_id)
        if type_ in ('list', 'text'):
            return {'objectId': object_id, 'type': type_, 'edits': []}
        return {'objectId': object_id, 'type': type_, 'props': {}}

    def get_values_descriptions(self, path, object, key):
        """(ref context.js:100-124)"""
        if isinstance(object, Table):
            value = Table.by_id(object, key)
            op_id = object.op_ids.get(key)
            return {op_id: self.get_value_description(value)} if value is not None else {}
        if isinstance(object, Text):
            if key >= len(object.elems):
                return {}
            value = object.elems[key]['value']
            elem_id = object.elems[key]['elemId']
            return {elem_id: self.get_value_description(value)} if value is not None else {}
        conflicts = object._conflicts[key] if isinstance(object, ListView) and \
            key < len(object._conflicts) else \
            (object._conflicts.get(key) if isinstance(object, MapView) else None)
        if conflicts is None:
            raise ValueError(f'No children at key {key} of path {path!r}')
        return {op_id: self.get_value_description(v) for op_id, v in conflicts.items()}

    def get_property_value(self, object, key, op_id):
        if isinstance(object, Table):
            return Table.by_id(object, key)
        if isinstance(object, Text):
            return object.elems[key]['value']
        return object._conflicts[key][op_id]

    def get_subpatch(self, patch, path):
        """(ref context.js:151-180)"""
        if not path:
            return patch
        subpatch = patch
        object = self.get_object('_root')
        for path_elem in path:
            key = path_elem['key']
            values = self.get_values_descriptions(path, object, key)
            if 'props' in subpatch:
                if key not in subpatch['props']:
                    subpatch['props'][key] = values
            elif 'edits' in subpatch:
                for op_id, value in values.items():
                    subpatch['edits'].append(
                        {'action': 'update', 'index': key, 'opId': op_id,
                         'value': value})
            next_op_id = None
            for op_id, value in values.items():
                if value.get('objectId') == path_elem['objectId']:
                    next_op_id = op_id
            if next_op_id is None:
                raise ValueError(
                    f"Cannot find path object with objectId {path_elem['objectId']}")
            subpatch = values[next_op_id]
            object = self.get_property_value(object, key, next_op_id)
        return subpatch

    def get_object(self, object_id):
        # Explicit None checks: an empty MapView/ListView/Table is falsy in
        # Python (unlike any JS object), so `updated.get(id) or cache.get(id)`
        # would wrongly fall through to the stale cache
        object = self.updated.get(object_id)
        if object is None:
            object = self.cache.get(object_id)
        if object is None:
            raise ValueError(f'Target object does not exist: {object_id}')
        return object

    def get_object_type(self, object_id):
        if object_id == '_root':
            return 'map'
        object = self.get_object(object_id)
        if isinstance(object, Text):
            return 'text'
        if isinstance(object, Table):
            return 'table'
        if isinstance(object, ListView):
            return 'list'
        return 'map'

    def get_object_field(self, path, object_id, key):
        """Returns the value at `key`, proxied if it is an object
        (ref context.js:198-216)."""
        object = self.get_object(object_id)
        try:
            value = object[key]
        except (KeyError, IndexError):
            return None
        if isinstance(value, Counter):
            return WriteableCounter(value.value, self, path, object_id, key)
        if isinstance(value, (MapView, ListView, Text, Table)):
            child_id = get_object_id(value)
            subpath = path + [{'key': key, 'objectId': child_id}]
            return self.instantiate_object(subpath, child_id)
        return value

    def create_nested_objects(self, obj, key, value, insert, pred, elem_id=None):
        """Recursively create Automerge objects for a nested value
        (ref context.js:230-273)."""
        if get_object_id(value):
            raise ValueError('Cannot create a reference to an existing document object')
        object_id = self.next_op_id()

        if isinstance(value, Text):
            op = {'action': 'makeText', 'obj': obj, 'insert': insert, 'pred': pred}
            op['elemId' if elem_id else 'key'] = elem_id if elem_id else key
            self.add_op(op)
            subpatch = {'objectId': object_id, 'type': 'text', 'edits': []}
            self.insert_list_items(subpatch, 0, list(value), True)
            return subpatch
        if isinstance(value, Table):
            if value.count > 0:
                raise ValueError('Assigning a non-empty Table object is not supported')
            op = {'action': 'makeTable', 'obj': obj, 'insert': insert, 'pred': pred}
            op['elemId' if elem_id else 'key'] = elem_id if elem_id else key
            self.add_op(op)
            return {'objectId': object_id, 'type': 'table', 'props': {}}
        if isinstance(value, (list, tuple, ListView)):
            op = {'action': 'makeList', 'obj': obj, 'insert': insert, 'pred': pred}
            op['elemId' if elem_id else 'key'] = elem_id if elem_id else key
            self.add_op(op)
            subpatch = {'objectId': object_id, 'type': 'list', 'edits': []}
            self.insert_list_items(subpatch, 0, list(value), True)
            return subpatch
        # Map object (anything else is not an assignable value,
        # ref context.js:88-91 "Unsupported type of value")
        if not hasattr(value, 'keys'):
            raise TypeError(
                f'Unsupported type of value: {type(value).__name__}')
        op = {'action': 'makeMap', 'obj': obj, 'insert': insert, 'pred': pred}
        op['elemId' if elem_id else 'key'] = elem_id if elem_id else key
        self.add_op(op)
        props = {}
        for nested in sorted(value.keys()):
            op_id = self.next_op_id()
            value_patch = self.set_value(object_id, nested, value[nested], False, [])
            props[nested] = {op_id: value_patch}
        return {'objectId': object_id, 'type': 'map', 'props': props}

    def set_value(self, object_id, key, value, insert, pred, elem_id=None):
        """(ref context.js:289-309)"""
        if not object_id:
            raise ValueError('setValue needs an objectId')
        if key == '':
            raise ValueError('The key of a map entry must not be an empty string')
        if not _is_primitive(value):
            return self.create_nested_objects(object_id, key, value, insert, pred,
                                              elem_id)
        description = self.get_value_description(value)
        op = {'action': 'set', 'obj': object_id, 'insert': insert,
              'value': description['value'], 'pred': pred}
        if elem_id:
            op['elemId'] = elem_id
        else:
            op['key'] = key
        if description.get('datatype'):
            op['datatype'] = description['datatype']
        self.add_op(op)
        return description

    def apply_at_path(self, path, callback):
        diff = {'objectId': '_root', 'type': 'map', 'props': {}}
        callback(self.get_subpatch(diff, path))
        self.apply_patch(diff, self.cache['_root'], self.updated)

    def set_map_key(self, path, key, value):
        """(ref context.js:325-348)"""
        if not isinstance(key, str):
            raise ValueError(f'The key of a map entry must be a string, not {type(key)}')
        object_id = '_root' if not path else path[-1]['objectId']
        object = self.get_object(object_id)
        if isinstance(object.get(key), Counter):
            raise ValueError('Cannot overwrite a Counter object; use .increment() or '
                             '.decrement() to change its value.')
        existing = object.get(key)
        conflicted = len(object._conflicts.get(key, {})) > 1
        if not self._values_equal(existing, value) or conflicted or \
                key not in object:
            def update(subpatch):
                pred = get_pred(object, key)
                op_id = self.next_op_id()
                value_patch = self.set_value(object_id, key, value, False, pred)
                subpatch['props'][key] = {op_id: value_patch}
            self.apply_at_path(path, update)

    def _values_equal(self, existing, value):
        """Mirror of the JS `object[key] !== value` no-op check: primitives
        compare by value (with JS-style type strictness), objects by identity."""
        prim = (str, int, float, type(None))
        if isinstance(existing, prim) and isinstance(value, prim):
            if isinstance(existing, bool) != isinstance(value, bool):
                return False
            if type(existing) is not type(value) and not (
                    isinstance(existing, (int, float)) and
                    isinstance(value, (int, float)) and
                    not isinstance(existing, bool) and not isinstance(value, bool)):
                return False
            return existing == value
        return existing is value

    def delete_map_key(self, path, key):
        object_id = '_root' if not path else path[-1]['objectId']
        object = self.get_object(object_id)
        if key in object:
            pred = get_pred(object, key)
            self.add_op({'action': 'del', 'obj': object_id, 'key': key,
                         'insert': False, 'pred': pred})
            self.apply_at_path(path, lambda subpatch: subpatch['props'].update({key: {}}))

    def insert_list_items(self, subpatch, index, values, new_object):
        """Multi-insert optimization: runs of same-datatype primitives become
        one set op with a values array (ref context.js:370-405)."""
        list_ = [] if new_object else self.get_object(subpatch['objectId'])
        if index < 0 or index > len(list_):
            raise IndexError(
                f'List index {index} is out of bounds for list of length {len(list_)}')
        if not values:
            return
        elem_id = get_elem_id(list_, index, insert=True)
        all_primitive = all(_is_primitive(v) for v in values)
        descriptions = [self.get_value_description(v) for v in values] \
            if all_primitive else []
        same_datatype = all(d.get('datatype') == descriptions[0].get('datatype')
                            for d in descriptions) if descriptions else False

        if all_primitive and same_datatype and len(values) > 1:
            next_elem_id = self.next_op_id()
            datatype = descriptions[0].get('datatype')
            plain_values = [d['value'] for d in descriptions]
            op = {'action': 'set', 'obj': subpatch['objectId'], 'elemId': elem_id,
                  'insert': True, 'values': plain_values, 'pred': []}
            edit = {'action': 'multi-insert', 'elemId': next_elem_id, 'index': index,
                    'values': plain_values}
            if datatype:
                op['datatype'] = datatype
                edit['datatype'] = datatype
            self.add_op(op)
            subpatch['edits'].append(edit)
        else:
            for offset, value in enumerate(values):
                next_elem_id = self.next_op_id()
                value_patch = self.set_value(subpatch['objectId'], index + offset,
                                             value, True, [], elem_id)
                elem_id = next_elem_id
                subpatch['edits'].append(
                    {'action': 'insert', 'index': index + offset, 'elemId': elem_id,
                     'opId': elem_id, 'value': value_patch})

    def set_list_index(self, path, index, value):
        """(ref context.js:411-435)"""
        object_id = '_root' if not path else path[-1]['objectId']
        list_ = self.get_object(object_id)
        if index >= len(list_):
            insertions = [None] * (index - len(list_))
            insertions.append(value)
            return self.splice(path, len(list_), 0, insertions)
        current = list_[index] if not isinstance(list_, Text) else \
            list_.elems[index]['value']
        if isinstance(current, Counter):
            raise ValueError('Cannot overwrite a Counter object; use .increment() or '
                             '.decrement() to change its value.')
        conflicted = isinstance(list_, ListView) and \
            len(list_._conflicts[index] or {}) > 1
        if not self._values_equal(current, value) or conflicted:
            def update(subpatch):
                pred = get_pred(list_, index)
                op_id = self.next_op_id()
                value_patch = self.set_value(object_id, index, value, False, pred,
                                             get_elem_id(list_, index))
                subpatch['edits'].append({'action': 'update', 'index': index,
                                          'opId': op_id, 'value': value_patch})
            self.apply_at_path(path, update)

    def splice(self, path, start, deletions, insertions):
        """Multi-delete run compression (ref context.js:441-502)."""
        object_id = '_root' if not path else path[-1]['objectId']
        list_ = self.get_object(object_id)
        length = len(list_)
        if start < 0 or deletions < 0 or start > length - deletions:
            raise IndexError(f'{deletions} deletions starting at index {start} are '
                             f'out of bounds for list of length {length}')
        if deletions == 0 and not insertions:
            return
        patch = {'diffs': {'objectId': '_root', 'type': 'map', 'props': {}}}
        subpatch = self.get_subpatch(patch['diffs'], path)

        if deletions > 0:
            op = None
            last_elem_parsed = last_pred_parsed = None
            for i in range(deletions):
                if isinstance(self.get_object_field(path, object_id, start + i),
                              Counter):
                    # Deleting counters from lists is unsupported
                    # (rationale: context.js:455-471)
                    raise TypeError(
                        'Unsupported operation: deleting a counter from a list')
                this_elem = get_elem_id(list_, start + i)
                this_elem_parsed = parse_op_id(this_elem)
                this_pred = get_pred(list_, start + i)
                this_pred_parsed = parse_op_id(this_pred[0]) \
                    if len(this_pred) == 1 else None
                if op is not None and last_elem_parsed and last_pred_parsed and \
                        this_pred_parsed and \
                        last_elem_parsed[1] == this_elem_parsed[1] and \
                        last_elem_parsed[0] + 1 == this_elem_parsed[0] and \
                        last_pred_parsed[1] == this_pred_parsed[1] and \
                        last_pred_parsed[0] + 1 == this_pred_parsed[0]:
                    op['multiOp'] = op.get('multiOp', 1) + 1
                else:
                    if op is not None:
                        self.add_op(op)
                    op = {'action': 'del', 'obj': object_id, 'elemId': this_elem,
                          'insert': False, 'pred': this_pred}
                last_elem_parsed = this_elem_parsed
                last_pred_parsed = this_pred_parsed
            self.add_op(op)
            subpatch['edits'].append({'action': 'remove', 'index': start,
                                      'count': deletions})

        if insertions:
            self.insert_list_items(subpatch, start, insertions, False)
        self.apply_patch(patch['diffs'], self.cache['_root'], self.updated)

    def add_table_row(self, path, row):
        """(ref context.js:508-527)"""
        if not isinstance(row, (dict, MapView)) or isinstance(row, (list, tuple)):
            raise TypeError('A table row must be an object')
        if get_object_id(row):
            raise TypeError('Cannot reuse an existing object as table row')
        if 'id' in row:
            raise TypeError('A table row must not have an "id" property; '
                            'it is generated automatically')
        id = uuid()
        value_patch = self.set_value(path[-1]['objectId'], id, dict(row), False, [])
        self.apply_at_path(path, lambda subpatch: subpatch['props'].update(
            {id: {value_patch['objectId']: value_patch}}))
        return id

    def delete_table_row(self, path, row_id, pred):
        object_id = path[-1]['objectId']
        table = self.get_object(object_id)
        if Table.by_id(table, row_id) is not None:
            self.add_op({'action': 'del', 'obj': object_id, 'key': row_id,
                         'insert': False, 'pred': [pred]})
            self.apply_at_path(path, lambda subpatch: subpatch['props'].update(
                {row_id: {}}))

    def increment(self, path, key, delta):
        """(ref context.js:546-573)"""
        object_id = '_root' if not path else path[-1]['objectId']
        object = self.get_object(object_id)
        if isinstance(object, Text):
            current = object.elems[key]['value']
        else:
            current = object[key] if not isinstance(object, Table) else None
        if not isinstance(current, Counter):
            raise TypeError('Only counter values can be incremented')
        type_ = self.get_object_type(object_id)
        value = current.value + delta
        op_id = self.next_op_id()
        pred = get_pred(object, key)
        if type_ in ('list', 'text'):
            elem_id = get_elem_id(object, key, False)
            self.add_op({'action': 'inc', 'obj': object_id, 'elemId': elem_id,
                         'value': delta, 'insert': False, 'pred': pred})
        else:
            self.add_op({'action': 'inc', 'obj': object_id, 'key': key,
                         'value': delta, 'insert': False, 'pred': pred})

        def update(subpatch):
            if type_ in ('list', 'text'):
                subpatch['edits'].append(
                    {'action': 'update', 'index': key, 'opId': op_id,
                     'value': {'value': value, 'datatype': 'counter'}})
            else:
                subpatch['props'][key] = {op_id: {'value': value,
                                                  'datatype': 'counter'}}
        self.apply_at_path(path, update)


def get_pred(object, key):
    """(ref context.js:576-586)"""
    if isinstance(object, Table):
        return [object.op_ids[key]]
    if isinstance(object, Text):
        return list(object.elems[key].get('pred', []))
    if isinstance(object, MapView):
        return list(object._conflicts.get(key, {}).keys())
    if isinstance(object, ListView):
        if key < len(object._conflicts) and object._conflicts[key]:
            return list(object._conflicts[key].keys())
        return []
    return []


def get_elem_id(list_, index, insert=False):
    """(ref context.js:588-596)"""
    if insert:
        if index == 0:
            return '_head'
        index -= 1
    if isinstance(list_, ListView):
        return list_._elem_ids[index]
    if isinstance(list_, Text):
        return list_.elems[index]['elemId']
    if hasattr(list_, 'get_elem_id'):
        return list_.get_elem_id(index)
    raise IndexError(f'Cannot find elemId at list index {index}')
