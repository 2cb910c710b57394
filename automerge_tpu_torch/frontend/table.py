"""Table: an unordered row collection keyed by UUID (ref frontend/table.js)."""

from .views import MapView, get_object_id


def _compare_rows(properties, row):
    key = []
    for prop in properties:
        v = row.get(prop) if hasattr(row, 'get') else None
        key.append((0, v) if isinstance(v, (int, float)) and
                   not isinstance(v, bool) else (1, str(v)))
    return key


class Table:
    """Rows are identified by unique IDs; rows get an auto-generated `id`
    property. Conflicts are impossible since row IDs are unique."""

    def __init__(self):
        self.entries = {}
        self.op_ids = {}
        self._object_id = None

    def by_id(self, id):
        return self.entries.get(id)

    @property
    def ids(self):
        return [key for key, entry in self.entries.items()
                if isinstance(entry, MapView) and entry.get('id') == key]

    @property
    def count(self):
        return len(self.ids)

    @property
    def rows(self):
        return [self.by_id(id) for id in self.ids]

    def filter(self, callback):
        return [row for row in self.rows if callback(row)]

    def find(self, callback):
        for row in self.rows:
            if callback(row):
                return row
        return None

    def map(self, callback):
        return [callback(row) for row in self.rows]

    def sort(self, arg=None):
        if callable(arg):
            import functools
            return sorted(self.rows, key=functools.cmp_to_key(arg))
        if isinstance(arg, str):
            return sorted(self.rows, key=lambda r: _compare_rows([arg], r))
        if isinstance(arg, (list, tuple)):
            return sorted(self.rows, key=lambda r: _compare_rows(list(arg), r))
        if arg is None:
            return sorted(self.rows, key=lambda r: _compare_rows(['id'], r))
        raise TypeError(f'Unsupported sorting argument: {arg}')

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return self.count

    def __eq__(self, other):
        if isinstance(other, Table):
            return {id: self.by_id(id) for id in self.ids} == \
                {id: other.by_id(id) for id in other.ids}
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def _clone(self):
        if not self._object_id:
            raise ValueError('clone() requires the objectId to be set')
        return instantiate_table(self._object_id, dict(self.entries), dict(self.op_ids))

    def _set(self, id, value, op_id):
        # Rows get an automatically-generated `id` property (ref table.js:156-160)
        if isinstance(value, MapView):
            value._data['id'] = id
        self.entries[id] = value
        self.op_ids[id] = op_id

    def remove(self, id):
        # Tolerate missing ids like the JS `delete` operator does: a patch may
        # remove a row that was created and deleted within the same change
        self.entries.pop(id, None)
        self.op_ids.pop(id, None)

    def get_writeable(self, context, path):
        if not self._object_id:
            raise ValueError('get_writeable() requires the objectId to be set')
        instance = WriteableTable.__new__(WriteableTable)
        instance._object_id = self._object_id
        instance.context = context
        instance.entries = self.entries
        instance.op_ids = self.op_ids
        instance.path = path
        return instance

    def to_json(self):
        return {id: self.by_id(id).to_py() if hasattr(self.by_id(id), 'to_py')
                else self.by_id(id) for id in self.ids}


class WriteableTable(Table):
    """Table bound to a change context (ref frontend/table.js:217-249)."""

    def by_id(self, id):
        entry = self.entries.get(id)
        if isinstance(entry, MapView) and entry.get('id') == id:
            object_id = get_object_id(entry)
            return self.context.instantiate_object(
                self.path + [{'key': id, 'objectId': object_id}], object_id)
        return None

    def add(self, row):
        return self.context.add_table_row(self.path, row)

    def remove(self, id):
        entry = self.entries.get(id)
        if isinstance(entry, MapView) and entry.get('id') == id:
            self.context.delete_table_row(self.path, id, self.op_ids[id])
        else:
            raise ValueError(f'There is no row with ID {id} in this table')


def instantiate_table(object_id, entries=None, op_ids=None):
    if not object_id:
        raise ValueError('instantiate_table requires an objectId to be given')
    instance = Table.__new__(Table)
    instance._object_id = object_id
    instance.entries = entries if entries is not None else {}
    instance.op_ids = op_ids if op_ids is not None else {}
    return instance
