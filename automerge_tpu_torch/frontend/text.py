"""Text: a character-sequence CRDT view (ref frontend/text.js)."""

from .views import get_object_id


class Text:
    """A sequence of characters (or embedded objects) supporting concurrent
    editing. `elems` is a list of {'elemId', 'pred', 'value'} dicts."""

    def __init__(self, text=None):
        if isinstance(text, str):
            self.elems = [{'value': ch} for ch in text]
        elif isinstance(text, (list, tuple)):
            self.elems = [{'value': v} for v in text]
        elif text is None:
            self.elems = []
        else:
            raise TypeError(f'Unsupported initial value for Text: {text}')
        self._object_id = None
        self.context = None
        self.path = None

    @property
    def length(self):
        return len(self.elems)

    def __len__(self):
        return len(self.elems)

    def get(self, index):
        value = self.elems[index]['value']
        if self.context is not None and get_object_id(value):
            object_id = get_object_id(value)
            return self.context.instantiate_object(
                self.path + [{'key': index, 'objectId': object_id}], object_id)
        return value

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self.get(i) for i in range(*index.indices(len(self.elems)))]
        return self.get(index)

    def get_elem_id(self, index):
        return self.elems[index]['elemId']

    def __iter__(self):
        for elem in self.elems:
            yield elem['value']

    def __str__(self):
        return ''.join(e['value'] for e in self.elems if isinstance(e['value'], str))

    def __eq__(self, other):
        if isinstance(other, Text):
            return [e['value'] for e in self.elems] == \
                [e['value'] for e in other.elems]
        if isinstance(other, str):
            return str(self) == other
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def __repr__(self):
        return f'Text({str(self)!r})'

    def to_spans(self):
        """The content as strings interleaved with non-character elements
        (ref frontend/text.js:78-96)."""
        spans = []
        chars = ''
        for elem in self.elems:
            if isinstance(elem['value'], str):
                chars += elem['value']
            else:
                if chars:
                    spans.append(chars)
                    chars = ''
                spans.append(elem['value'])
        if chars:
            spans.append(chars)
        return spans

    def to_json(self):
        return str(self)

    def get_writeable(self, context, path):
        if not self._object_id:
            raise ValueError('get_writeable() requires the objectId to be set')
        instance = instantiate_text(self._object_id, self.elems)
        instance.context = context
        instance.path = path
        return instance

    def set(self, index, value):
        if self.context is not None:
            self.context.set_list_index(self.path, index, value)
        elif self._object_id is None:
            self.elems[index] = {'value': value}
        else:
            raise TypeError(
                'Automerge.Text object cannot be modified outside of a change block')
        return self

    def __setitem__(self, index, value):
        self.set(index, value)

    def insert_at(self, index, *values):
        if self.context is not None:
            self.context.splice(self.path, index, 0, list(values))
        elif self._object_id is None:
            self.elems[index:index] = [{'value': v} for v in values]
        else:
            raise TypeError(
                'Automerge.Text object cannot be modified outside of a change block')
        return self

    def delete_at(self, index, num_delete=1):
        if self.context is not None:
            self.context.splice(self.path, index, num_delete, [])
        elif self._object_id is None:
            del self.elems[index:index + num_delete]
        else:
            raise TypeError(
                'Automerge.Text object cannot be modified outside of a change block')
        return self


def instantiate_text(object_id, elems):
    instance = Text.__new__(Text)
    instance._object_id = object_id
    instance.elems = elems
    instance.context = None
    instance.path = None
    return instance
