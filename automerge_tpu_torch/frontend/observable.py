"""Observable: per-objectId change subscriptions (ref frontend/observable.js)."""

from .views import MapView, ListView, get_object_id
from .text import Text
from .table import Table


class Observable:
    def __init__(self):
        self.observers = {}  # objectId -> list of callbacks

    def patch_callback(self, patch, before, after, local, changes):
        self._object_update(patch['diffs'], before, after, local, changes)

    def _object_update(self, diff, before, after, local, changes):
        """Recursively walk the patch diff tree, tracking list index offsets
        between the before and after states (ref observable.js:28-100)."""
        if not diff.get('objectId'):
            return
        for callback in self.observers.get(diff['objectId'], []):
            callback(diff, before, after, local, changes)

        def conflicts_of(obj, key):
            if isinstance(obj, MapView):
                return obj._conflicts.get(key)
            if isinstance(obj, ListView) and isinstance(key, int) and \
                    0 <= key < len(obj._conflicts):
                return obj._conflicts[key]
            return None

        if diff['type'] == 'map' and diff.get('props'):
            for prop, prop_values in diff['props'].items():
                for op_id, subdiff in prop_values.items():
                    b = conflicts_of(before, prop)
                    a = conflicts_of(after, prop)
                    self._object_update(subdiff,
                                        b.get(op_id) if b else None,
                                        a.get(op_id) if a else None,
                                        local, changes)
        elif diff['type'] == 'table' and diff.get('props'):
            for row_id, row_values in diff['props'].items():
                for op_id, subdiff in row_values.items():
                    self._object_update(subdiff,
                                        before.by_id(row_id) if before else None,
                                        after.by_id(row_id) if after else None,
                                        local, changes)
        elif diff['type'] == 'list' and diff.get('edits') is not None:
            offset = 0
            for edit in diff['edits']:
                if edit['action'] == 'insert':
                    offset -= 1
                    a = conflicts_of(after, edit['index'])
                    self._object_update(edit['value'], None,
                                        a.get(edit['elemId']) if a else None,
                                        local, changes)
                elif edit['action'] == 'multi-insert':
                    offset -= len(edit['values'])
                elif edit['action'] == 'update':
                    b = conflicts_of(before, edit['index'] + offset)
                    a = conflicts_of(after, edit['index'])
                    self._object_update(edit['value'],
                                        b.get(edit['opId']) if b else None,
                                        a.get(edit['opId']) if a else None,
                                        local, changes)
                elif edit['action'] == 'remove':
                    offset += edit['count']
        elif diff['type'] == 'text' and diff.get('edits') is not None:
            offset = 0
            for edit in diff['edits']:
                if edit['action'] == 'insert':
                    offset -= 1
                    self._object_update(edit['value'], None,
                                        after.get(edit['index']) if after else None,
                                        local, changes)
                elif edit['action'] == 'multi-insert':
                    offset -= len(edit['values'])
                elif edit['action'] == 'update':
                    self._object_update(
                        edit['value'],
                        before.get(edit['index'] + offset) if before else None,
                        after.get(edit['index']) if after else None,
                        local, changes)
                elif edit['action'] == 'remove':
                    offset += edit['count']

    def observe(self, object, callback):
        object_id = get_object_id(object)
        if not object_id:
            raise TypeError('The observed object must be part of an Automerge document')
        self.observers.setdefault(object_id, []).append(callback)
