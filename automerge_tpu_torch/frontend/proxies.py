"""Mutable document proxies used inside change callbacks
(ref frontend/proxies.js, which uses ES6 Proxy; here they are explicit
MutableMapping/MutableSequence-style classes bound to a Context)."""

from collections.abc import MutableMapping, MutableSequence

from .values import Counter
from .text import Text
from .table import Table
from .views import ListView, get_object_id


class MapProxy(MutableMapping):
    def __init__(self, context, object_id, path):
        object.__setattr__(self, '_context', context)
        object.__setattr__(self, '_object_id', object_id)
        object.__setattr__(self, '_path', path)

    def _target(self):
        return self._context.get_object(self._object_id)

    def __setattr__(self, name, value):
        # Attribute assignment writes to the document, mirroring the JS
        # `doc.key = value` proxy API (ref frontend/proxies.js:126-130)
        self._context.set_map_key(self._path, name, value)

    def __getattr__(self, name):
        # Only called when normal lookup fails; expose document keys as attrs
        if name.startswith('_'):
            raise AttributeError(name)
        target = object.__getattribute__(self, '_context').get_object(
            object.__getattribute__(self, '_object_id'))
        if name in target:
            return self[name]
        raise AttributeError(name)

    def __getitem__(self, key):
        if key not in self._target():
            raise KeyError(key)
        return self._context.get_object_field(self._path, self._object_id, key)

    def get(self, key, default=None):
        if key in self._target():
            return self._context.get_object_field(self._path, self._object_id, key)
        return default

    def __setitem__(self, key, value):
        self._context.set_map_key(self._path, key, value)

    def __delitem__(self, key):
        if key not in self._target():
            raise KeyError(key)
        self._context.delete_map_key(self._path, key)

    def __contains__(self, key):
        return key in self._target()

    def __iter__(self):
        return iter(list(self._target().keys()))

    def __len__(self):
        return len(self._target())

    def keys(self):
        return list(self._target().keys())

    def update(self, other=(), **kwargs):
        items = other.items() if hasattr(other, 'items') else other
        for key, value in items:
            self[key] = value
        for key, value in kwargs.items():
            self[key] = value

    def __repr__(self):
        return f'MapProxy({dict(self._target())!r})'


class ListProxy(MutableSequence):
    def __init__(self, context, object_id, path):
        self._context = context
        self._object_id = object_id
        self._path = path

    def _target(self):
        return self._context.get_object(self._object_id)

    def __len__(self):
        return len(self._target())

    def __getitem__(self, index):
        target = self._target()
        if isinstance(index, slice):
            return [self._context.get_object_field(self._path, self._object_id, i)
                    for i in range(*index.indices(len(target)))]
        if index < 0:
            index += len(target)
        if index < 0 or index >= len(target):
            raise IndexError('list index out of range')
        return self._context.get_object_field(self._path, self._object_id, index)

    def __setitem__(self, index, value):
        if isinstance(index, slice):
            indices = range(*index.indices(len(self._target())))
            values = list(value)
            if len(indices) == len(values):
                for i, v in zip(indices, values):
                    self._context.set_list_index(self._path, i, v)
            elif index.step in (1, None):
                # Contiguous slice of different length: replace via splice
                self._context.splice(self._path, indices.start,
                                     len(indices), values)
            else:
                raise ValueError(
                    f'attempt to assign sequence of size {len(values)} to '
                    f'extended slice of size {len(indices)}')
            return
        if index < 0:
            index += len(self._target())
        self._context.set_list_index(self._path, index, value)

    def __delitem__(self, index):
        if isinstance(index, slice):
            indices = range(*index.indices(len(self._target())))
            self._context.splice(self._path, indices.start, len(indices), [])
            return
        if index < 0:
            index += len(self._target())
        self._context.splice(self._path, index, 1, [])

    def insert(self, index, value):
        self._context.splice(self._path, index, 0, [value])

    def insert_at(self, index, *values):
        self._context.splice(self._path, index, 0, list(values))
        return self

    def delete_at(self, index, num_delete=1):
        self._context.splice(self._path, index, num_delete, [])
        return self

    def append(self, *values):
        self._context.splice(self._path, len(self._target()), 0, list(values))

    def extend(self, values):
        self._context.splice(self._path, len(self._target()), 0, list(values))

    def fill(self, value, start=0, end=None):
        """Set a range of elements to `value` (ref proxies.js listMethods
        fill())."""
        length = len(self._target())
        for i in range(*slice(start, end).indices(length)):
            self._context.set_list_index(self._path, i, value)
        return self

    def pop(self, index=-1):
        if index < 0:
            index += len(self._target())
        value = self[index]
        self._context.splice(self._path, index, 1, [])
        return value

    def __iter__(self):
        for i in range(len(self._target())):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f'ListProxy({list(self._target()._data)!r})'


def instantiate_proxy(context, path, object_id, read_only=None):
    object = context.get_object(object_id)
    if isinstance(object, Text) or isinstance(object, Table):
        return object.get_writeable(context, path)
    if isinstance(object, ListView):
        return ListProxy(context, object_id, path)
    return MapProxy(context, object_id, path)


def root_object_proxy(context):
    context.instantiate_object = \
        lambda path, object_id, read_only=None: \
        instantiate_proxy(context, path, object_id, read_only)
    return MapProxy(context, '_root', [])
