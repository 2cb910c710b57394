"""CRDT value types: Counter and explicit number wrappers
(ref frontend/counter.js, frontend/numbers.js)."""

MAX_SAFE_INTEGER = 2 ** 53 - 1
MIN_SAFE_INTEGER = -(2 ** 53 - 1)


class Counter:
    """An integer that can only be incremented/decremented; addition is
    commutative so concurrent increments merge trivially."""

    def __init__(self, value=0):
        self.value = value or 0

    def __int__(self):
        return self.value

    def __eq__(self, other):
        if isinstance(other, Counter):
            return self.value == other.value
        return self.value == other

    def __hash__(self):
        return hash(self.value)

    def __repr__(self):
        return f'Counter({self.value})'

    def __str__(self):
        return str(self.value)

    def __add__(self, other):
        return self.value + other

    def __radd__(self, other):
        return other + self.value

    def __lt__(self, other):
        return self.value < other

    def __le__(self, other):
        return self.value <= other

    def __gt__(self, other):
        return self.value > other

    def __ge__(self, other):
        return self.value >= other

    def to_json(self):
        return self.value


class WriteableCounter(Counter):
    """Counter bound to a change context (ref frontend/counter.js:46-65)."""

    def __init__(self, value, context, path, object_id, key):
        super().__init__(value)
        self.context = context
        self.path = path
        self.object_id = object_id
        self.key = key

    def increment(self, delta=1):
        self.context.increment(self.path, self.key, delta)
        self.value += delta
        return self.value

    def decrement(self, delta=1):
        return self.increment(-delta)


class Int:
    def __init__(self, value):
        if not isinstance(value, int) or isinstance(value, bool) or \
                not (MIN_SAFE_INTEGER <= value <= MAX_SAFE_INTEGER):
            raise ValueError(f'Value {value} cannot be an int')
        self.value = value

    def __eq__(self, other):
        return isinstance(other, Int) and self.value == other.value

    def __hash__(self):
        return hash(('Int', self.value))


class Uint:
    def __init__(self, value):
        if not isinstance(value, int) or isinstance(value, bool) or \
                not (0 <= value <= MAX_SAFE_INTEGER):
            raise ValueError(f'Value {value} cannot be a uint')
        self.value = value

    def __eq__(self, other):
        return isinstance(other, Uint) and self.value == other.value

    def __hash__(self):
        return hash(('Uint', self.value))


class Float64:
    def __init__(self, value=0.0):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise ValueError(f'Value {value} cannot be a float64')
        self.value = float(value or 0.0)

    def __eq__(self, other):
        return isinstance(other, Float64) and self.value == other.value

    def __hash__(self):
        return hash(('Float64', self.value))
