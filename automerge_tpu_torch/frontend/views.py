"""Immutable document views: the Python counterpart of the reference's
plain-JS-objects-with-hidden-Symbols document representation
(ref frontend/constants.js, frontend/apply_patch.js clone helpers).

A document is a tree of MapView / ListView / Text / Table objects plus
primitive values. Views compare equal to plain dicts/lists with the same
values, so tests and applications can treat them as ordinary data.
"""

from collections.abc import Mapping, Sequence


class MapView(Mapping):
    """Read-only map object; `_conflicts` maps key -> {opId: value}."""

    def __init__(self, object_id, data=None, conflicts=None):
        self._object_id = object_id
        self._data = data if data is not None else {}
        self._conflicts = conflicts if conflicts is not None else {}

    def __getitem__(self, key):
        return self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def get(self, key, default=None):
        return self._data.get(key, default)

    def __eq__(self, other):
        if isinstance(other, MapView):
            return self._data == other._data
        if isinstance(other, Mapping):
            return dict(self._data) == dict(other)
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def __repr__(self):
        return f'MapView({self._data!r})'

    def to_py(self):
        return {k: _to_py(v) for k, v in self._data.items()}


class RootView(MapView):
    """The document root: a MapView carrying document-level hidden state."""

    def __init__(self, data=None, conflicts=None):
        super().__init__('_root', data, conflicts)
        self._options = None
        self._cache = None
        self._state = None
        self._change_context = None


class ListView(Sequence):
    """Read-only list object; `_conflicts` is a list of {opId: value} and
    `_elem_ids` the stable element identity of each index."""

    def __init__(self, object_id, data=None, conflicts=None, elem_ids=None):
        self._object_id = object_id
        self._data = data if data is not None else []
        self._conflicts = conflicts if conflicts is not None else []
        self._elem_ids = elem_ids if elem_ids is not None else []

    def __getitem__(self, index):
        return self._data[index]

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def __eq__(self, other):
        if isinstance(other, ListView):
            return self._data == other._data
        if isinstance(other, (list, tuple)):
            return self._data == list(other)
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def __repr__(self):
        return f'ListView({self._data!r})'

    def index(self, value, *args):
        return self._data.index(value, *args)

    def to_py(self):
        return [_to_py(v) for v in self._data]


def _to_py(value):
    if isinstance(value, (MapView, ListView)):
        return value.to_py()
    if hasattr(value, 'to_json'):
        return value.to_json()
    return value


def get_object_id(obj):
    return getattr(obj, '_object_id', None)
