"""Patch interpreter: applies backend patches to the immutable document tree
(ref frontend/apply_patch.js)."""

import datetime

from ..common import parse_op_id
from .values import Counter
from .text import instantiate_text
from .table import instantiate_table
from .views import MapView, RootView, ListView, get_object_id


def timestamp_to_datetime(ms):
    return datetime.datetime.fromtimestamp(ms / 1000.0, datetime.timezone.utc)


def datetime_to_timestamp(dt):
    return int(round(dt.timestamp() * 1000))


def get_value(patch, obj, updated):
    """Reconstruct a value from a patch node (ref apply_patch.js:10-27)."""
    if patch.get('objectId'):
        if obj is not None and get_object_id(obj) != patch['objectId']:
            obj = None
        return interpret_patch(patch, obj, updated)
    if patch.get('datatype') == 'timestamp':
        return timestamp_to_datetime(patch['value'])
    if patch.get('datatype') == 'counter':
        return Counter(patch['value'])
    return patch.get('value')


def lamport_compare_key(ts):
    """Sort key for opId strings; plain strings sort as (0, string)
    (ref apply_patch.js:33-42)."""
    try:
        counter, actor = parse_op_id(ts)
        return (counter, actor)
    except ValueError:
        return (0, ts)


def apply_properties(props, object, conflicts, updated):
    """Per-key conflict resolution: the greatest opId in Lamport order wins,
    all values are kept in `conflicts[key]` (ref apply_patch.js:57-79)."""
    if not props:
        return
    for key, key_props in props.items():
        op_ids = sorted(key_props.keys(), key=lamport_compare_key, reverse=True)
        values = {}
        for op_id in op_ids:
            subpatch = key_props[op_id]
            existing = conflicts.get(key, {}).get(op_id) if isinstance(conflicts, dict) \
                else None
            values[op_id] = get_value(subpatch, existing, updated)
        if not op_ids:
            object.pop(key, None)
            conflicts.pop(key, None)
        else:
            object[key] = values[op_ids[0]]
            conflicts[key] = values


def _clone_map_object(original, object_id):
    data = dict(original._data) if original is not None else {}
    conflicts = dict(original._conflicts) if original is not None else {}
    if object_id == '_root':
        view = RootView(data, conflicts)
        if original is not None:
            view._options = getattr(original, '_options', None)
    else:
        view = MapView(object_id, data, conflicts)
    return view


def update_map_object(patch, obj, updated):
    object_id = patch['objectId']
    if object_id not in updated:
        updated[object_id] = _clone_map_object(obj, object_id)
    view = updated[object_id]
    apply_properties(patch.get('props'), view._data, view._conflicts, updated)
    return view


def update_table_object(patch, obj, updated):
    """(ref apply_patch.js:114-135)"""
    object_id = patch['objectId']
    if object_id not in updated:
        updated[object_id] = obj._clone() if obj is not None \
            else instantiate_table(object_id)
    table = updated[object_id]
    for key, key_props in (patch.get('props') or {}).items():
        op_ids = list(key_props.keys())
        if len(op_ids) == 0:
            table.remove(key)
        elif len(op_ids) == 1:
            subpatch = key_props[op_ids[0]]
            table._set(key, get_value(subpatch, table.by_id(key), updated), op_ids[0])
        else:
            raise ValueError('Conflicts are not supported on properties of a table')
    return table


def _clone_list_object(original, object_id):
    data = list(original._data) if original is not None else []
    conflicts = list(original._conflicts) if original is not None else []
    elem_ids = list(original._elem_ids) if original is not None else []
    return ListView(object_id, data, conflicts, elem_ids)


def update_list_object(patch, obj, updated):
    """(ref apply_patch.js:156-213)"""
    object_id = patch['objectId']
    if object_id not in updated:
        updated[object_id] = _clone_list_object(obj, object_id)
    view = updated[object_id]
    data, conflicts, elem_ids = view._data, view._conflicts, view._elem_ids
    edits = patch['edits']
    i = 0
    while i < len(edits):
        edit = edits[i]
        if edit['action'] in ('insert', 'update'):
            index = edit['index']
            old_value = conflicts[index].get(edit['opId']) \
                if edit['action'] == 'update' and index < len(conflicts) and \
                isinstance(conflicts[index], dict) else None
            last_value = get_value(edit['value'], old_value, updated)
            values = {edit['opId']: last_value}
            # Consecutive updates at the same index form a conflict set; the
            # last (greatest Lamport timestamp) is the default resolution
            while i < len(edits) - 1 and edits[i + 1].get('index') == index and \
                    edits[i + 1]['action'] == 'update':
                i += 1
                conflict = edits[i]
                old2 = conflicts[index].get(conflict['opId']) \
                    if index < len(conflicts) and isinstance(conflicts[index], dict) \
                    else None
                last_value = get_value(conflict['value'], old2, updated)
                values[conflict['opId']] = last_value
            if edit['action'] == 'insert':
                data.insert(index, last_value)
                conflicts.insert(index, values)
                elem_ids.insert(index, edit['elemId'])
            else:
                data[index] = last_value
                conflicts[index] = values
        elif edit['action'] == 'multi-insert':
            counter, actor = parse_op_id(edit['elemId'])
            datatype = edit.get('datatype')
            new_elems, new_values, new_conflicts = [], [], []
            for offset, value in enumerate(edit['values']):
                elem_id = f'{counter + offset}@{actor}'
                value = get_value({'value': value, 'datatype': datatype}, None, updated)
                new_values.append(value)
                new_conflicts.append({elem_id: value})
                new_elems.append(elem_id)
            index = edit['index']
            data[index:index] = new_values
            conflicts[index:index] = new_conflicts
            elem_ids[index:index] = new_elems
        elif edit['action'] == 'remove':
            index, count = edit['index'], edit['count']
            del data[index:index + count]
            del conflicts[index:index + count]
            del elem_ids[index:index + count]
        i += 1
    return view


def update_text_object(patch, obj, updated):
    """(ref apply_patch.js:220-259)"""
    object_id = patch['objectId']
    if object_id in updated:
        elems = updated[object_id].elems
    elif obj is not None:
        elems = list(obj.elems)
    else:
        elems = []
    for edit in patch['edits']:
        if edit['action'] == 'insert':
            value = get_value(edit['value'], None, updated)
            elems.insert(edit['index'],
                         {'elemId': edit['elemId'], 'pred': [edit['opId']],
                          'value': value})
        elif edit['action'] == 'multi-insert':
            counter, actor = parse_op_id(edit['elemId'])
            datatype = edit.get('datatype')
            new_elems = []
            for offset, value in enumerate(edit['values']):
                value = get_value({'datatype': datatype, 'value': value}, None, updated)
                elem_id = f'{counter + offset}@{actor}'
                new_elems.append({'elemId': elem_id, 'pred': [elem_id], 'value': value})
            elems[edit['index']:edit['index']] = new_elems
        elif edit['action'] == 'update':
            index = edit['index']
            elem_id = elems[index]['elemId']
            value = get_value(edit['value'], elems[index]['value'], updated)
            elems[index] = {'elemId': elem_id, 'pred': [edit['opId']], 'value': value}
        elif edit['action'] == 'remove':
            index, count = edit['index'], edit['count']
            del elems[index:index + count]
    updated[object_id] = instantiate_text(object_id, elems)
    return updated[object_id]


def interpret_patch(patch, obj, updated):
    """Apply a patch node to the (immutable) object `obj`, placing writable
    clones into `updated` (ref apply_patch.js:266-284)."""
    if obj is not None and not patch.get('props') and not patch.get('edits') and \
            patch['objectId'] not in updated:
        return obj
    if patch['type'] == 'map':
        return update_map_object(patch, obj, updated)
    if patch['type'] == 'table':
        return update_table_object(patch, obj, updated)
    if patch['type'] == 'list':
        return update_list_object(patch, obj, updated)
    if patch['type'] == 'text':
        return update_text_object(patch, obj, updated)
    raise TypeError(f"Unknown object type: {patch.get('type')}")


def clone_root_object(root):
    if get_object_id(root) != '_root':
        raise ValueError(f'Not the root object: {get_object_id(root)}')
    return _clone_map_object(root, '_root')
