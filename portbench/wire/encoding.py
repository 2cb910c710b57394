# Frozen copy of automerge_tpu_torch/encoding.py (whole file), kept here so
# that a change to the program cannot move the benchmark's inputs.
"""Column codecs: LEB128 varints, run-length, delta, and boolean encodings.

These are the storage/wire codecs of the Automerge columnar format
(reference: backend/encoding.js). Byte-for-byte compatible with the
reference implementation: the RLE well-formedness rules (no repetition
counts of 1, no successive runs of the same kind, no repeated values
inside literals) make the encoding canonical, and the encoders here
produce exactly that canonical form.

Python integers are arbitrary precision, so unlike the JS reference
(backend/encoding.js:168-226) we do not split 64-bit values into two
32-bit halves; the width-suffixed methods differ only in their range
checks, which mirror the reference's error conditions exactly.
"""

MAX_SAFE_INTEGER = 2 ** 53 - 1
MIN_SAFE_INTEGER = -(2 ** 53 - 1)


def hex_string_to_bytes(value):
    """Convert a string of lowercase hex digit pairs to bytes (ref encoding.js:22-34)."""
    if not isinstance(value, str):
        raise TypeError('value is not a string')
    if len(value) % 2 != 0 or not all(c in '0123456789abcdef' for c in value):
        raise ValueError('value is not hexadecimal')
    return bytes.fromhex(value)


def bytes_to_hex_string(data):
    return bytes(data).hex()


def _check_int(value):
    if not isinstance(value, int) or isinstance(value, bool):
        raise ValueError('value is not an integer')


def uleb_append(out, value):
    """Append an unsigned LEB128 to a bytearray (the allocation-free
    counterpart of Encoder._append_uleb, shared by the sync message and
    Bloom filter fast paths)."""
    if value < 0 or value > 0xffffffffffffffff:
        raise ValueError('number out of range')
    while True:
        b = value & 0x7f
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


class Encoder:
    """Growable byte buffer with LEB128 append operations (ref encoding.js:57-286)."""

    def __init__(self):
        self.buf = bytearray()

    @property
    def buffer(self):
        self.finish()
        return bytes(self.buf)

    def finish(self):
        pass

    def append_byte(self, value):
        self.buf.append(value)

    def _append_uleb(self, value):
        n = 0
        while True:
            byte = value & 0x7f
            value >>= 7
            if value:
                self.buf.append(byte | 0x80)
                n += 1
            else:
                self.buf.append(byte)
                return n + 1

    def _append_sleb(self, value):
        n = 0
        while True:
            byte = value & 0x7f
            value >>= 7  # arithmetic shift: propagates sign
            done = (value == 0 and byte & 0x40 == 0) or (value == -1 and byte & 0x40)
            if done:
                self.buf.append(byte)
                return n + 1
            self.buf.append(byte | 0x80)
            n += 1

    def append_uint32(self, value):
        _check_int(value)
        if value < 0 or value > 0xffffffff:
            raise ValueError('number out of range')
        return self._append_uleb(value)

    def append_int32(self, value):
        _check_int(value)
        if value < -0x80000000 or value > 0x7fffffff:
            raise ValueError('number out of range')
        return self._append_sleb(value)

    def append_uint53(self, value):
        _check_int(value)
        if value < 0 or value > MAX_SAFE_INTEGER:
            raise ValueError('number out of range')
        return self._append_uleb(value)

    def append_int53(self, value):
        _check_int(value)
        if value < MIN_SAFE_INTEGER or value > MAX_SAFE_INTEGER:
            raise ValueError('number out of range')
        return self._append_sleb(value)

    def append_uint64(self, value):
        _check_int(value)
        if value < 0 or value > 2 ** 64 - 1:
            raise ValueError('number out of range')
        return self._append_uleb(value)

    def append_int64(self, value):
        _check_int(value)
        if value < -(2 ** 63) or value > 2 ** 63 - 1:
            raise ValueError('number out of range')
        return self._append_sleb(value)

    def append_raw_bytes(self, data):
        self.buf.extend(data)
        return len(data)

    def append_raw_string(self, value):
        if not isinstance(value, str):
            raise TypeError('value is not a string')
        return self.append_raw_bytes(value.encode('utf-8'))

    def append_prefixed_bytes(self, data):
        self.append_uint53(len(data))
        self.append_raw_bytes(data)
        return self

    def append_prefixed_string(self, value):
        if not isinstance(value, str):
            raise TypeError('value is not a string')
        self.append_prefixed_bytes(value.encode('utf-8'))
        return self

    def append_hex_string(self, value):
        self.append_prefixed_bytes(hex_string_to_bytes(value))
        return self


class Decoder:
    """Cursor over a byte buffer with LEB128 reads (ref encoding.js:293-534)."""

    def __init__(self, buffer):
        if isinstance(buffer, memoryview):
            # ZERO-COPY: a memoryview (e.g. into an mmap'd storage
            # segment) is consumed in place — raw-byte reads return
            # sub-views into the source buffer, so decoding a parked
            # chunk's header costs page-cache touches, not an arena copy
            self.buf = buffer if buffer.ndim == 1 and \
                buffer.format == 'B' else buffer.cast('B')
        elif not isinstance(buffer, (bytes, bytearray)):
            raise TypeError(f'Not a byte array: {buffer!r}')
        else:
            self.buf = bytes(buffer)
        self.offset = 0

    @property
    def done(self):
        return self.offset == len(self.buf)

    def reset(self):
        self.offset = 0

    def skip(self, num_bytes):
        if self.offset + num_bytes > len(self.buf):
            raise ValueError('cannot skip beyond end of buffer')
        self.offset += num_bytes

    def read_byte(self):
        self.offset += 1
        return self.buf[self.offset - 1]

    def _read_uleb(self, max_bytes):
        result = 0
        shift = 0
        n = 0
        while self.offset < len(self.buf):
            byte = self.buf[self.offset]
            self.offset += 1
            n += 1
            if n > max_bytes:
                raise ValueError('number out of range')
            result |= (byte & 0x7f) << shift
            shift += 7
            if byte & 0x80 == 0:
                return result
        raise ValueError('buffer ended with incomplete number')

    def _read_sleb(self, max_bytes):
        result = 0
        shift = 0
        n = 0
        while self.offset < len(self.buf):
            byte = self.buf[self.offset]
            self.offset += 1
            n += 1
            if n > max_bytes:
                raise ValueError('number out of range')
            result |= (byte & 0x7f) << shift
            shift += 7
            if byte & 0x80 == 0:
                if byte & 0x40:
                    result -= 1 << shift
                return result
        raise ValueError('buffer ended with incomplete number')

    def read_uint32(self):
        value = self._read_uleb(5)
        if value > 0xffffffff:
            raise ValueError('number out of range')
        return value

    def read_int32(self):
        value = self._read_sleb(5)
        if value < -0x80000000 or value > 0x7fffffff:
            raise ValueError('number out of range')
        return value

    def read_uint53(self):
        value = self._read_uleb(10)
        if value > MAX_SAFE_INTEGER:
            raise ValueError('number out of range')
        return value

    def read_int53(self):
        value = self._read_sleb(10)
        # ref encoding.js:402-408: valid range is (-2^53, 2^53)
        if value <= -(2 ** 53) or value >= 2 ** 53:
            raise ValueError('number out of range')
        return value

    def read_uint64(self):
        value = self._read_uleb(10)
        if value > 2 ** 64 - 1:
            raise ValueError('number out of range')
        return value

    def read_int64(self):
        value = self._read_sleb(10)
        if value < -(2 ** 63) or value > 2 ** 63 - 1:
            raise ValueError('number out of range')
        return value

    def read_raw_bytes(self, length):
        start = self.offset
        if start + length > len(self.buf):
            raise ValueError('subarray exceeds buffer size')
        self.offset += length
        return self.buf[start:self.offset]

    def read_raw_string(self, length):
        # bytes() is a no-op copy for bytes inputs; required for the
        # memoryview (zero-copy) path, which has no .decode
        return bytes(self.read_raw_bytes(length)).decode('utf-8')

    def read_prefixed_bytes(self):
        return self.read_raw_bytes(self.read_uint53())

    def read_prefixed_string(self):
        return bytes(self.read_prefixed_bytes()).decode('utf-8')

    def read_hex_string(self):
        return bytes_to_hex_string(self.read_prefixed_bytes())


class RLEEncoder(Encoder):
    """Run-length encoder over int/uint/utf8 values, nulls allowed.

    Wire format (ref encoding.js:536-557): a sequence of records, each a
    LEB128 signed repetition count n followed by: one value repeated n
    times (n > 0); n literal values (count encoded as -n); or, when the
    count is 0, a LEB128 unsigned count of nulls.
    """

    def __init__(self, type):
        super().__init__()
        self.type = type
        self.state = 'empty'
        self.last_value = None
        self.count = 0
        self.literal = []

    def append_value(self, value, repetitions=1):
        self._append_value(value, repetitions)

    def _append_value(self, value, repetitions=1):
        if repetitions <= 0:
            return
        if self.state == 'empty':
            self.state = ('nulls' if value is None
                          else ('loneValue' if repetitions == 1 else 'repetition'))
            self.last_value = value
            self.count = repetitions
        elif self.state == 'loneValue':
            if value is None:
                self.flush()
                self.state = 'nulls'
                self.count = repetitions
            elif value == self.last_value:
                self.state = 'repetition'
                self.count = 1 + repetitions
            elif repetitions > 1:
                self.flush()
                self.state = 'repetition'
                self.count = repetitions
                self.last_value = value
            else:
                self.state = 'literal'
                self.literal = [self.last_value]
                self.last_value = value
        elif self.state == 'repetition':
            if value is None:
                self.flush()
                self.state = 'nulls'
                self.count = repetitions
            elif value == self.last_value:
                self.count += repetitions
            elif repetitions > 1:
                self.flush()
                self.state = 'repetition'
                self.count = repetitions
                self.last_value = value
            else:
                self.flush()
                self.state = 'loneValue'
                self.last_value = value
        elif self.state == 'literal':
            if value is None:
                self.literal.append(self.last_value)
                self.flush()
                self.state = 'nulls'
                self.count = repetitions
            elif value == self.last_value:
                self.flush()
                self.state = 'repetition'
                self.count = 1 + repetitions
            elif repetitions > 1:
                self.literal.append(self.last_value)
                self.flush()
                self.state = 'repetition'
                self.count = repetitions
                self.last_value = value
            else:
                self.literal.append(self.last_value)
                self.last_value = value
        elif self.state == 'nulls':
            if value is None:
                self.count += repetitions
            elif repetitions > 1:
                self.flush()
                self.state = 'repetition'
                self.count = repetitions
                self.last_value = value
            else:
                self.flush()
                self.state = 'loneValue'
                self.last_value = value

    def copy_from(self, decoder, count=None, sum_values=False, sum_shift=None):
        """Copy `count` values (or all) from `decoder` without expanding runs.

        Returns (non_null_values, sum) where sum is None unless sum_values
        (ref encoding.js:667-737).
        """
        if not isinstance(decoder, RLEDecoder) or decoder.type != self.type:
            raise TypeError('incompatible type of decoder')
        remaining = count if count is not None else float('inf')
        non_null = 0
        total = 0
        if count and remaining > 0 and decoder.done:
            raise ValueError(f'cannot copy {count} values')
        if remaining == 0 or decoder.done:
            return (non_null, total if sum_values else None)

        # Copy the first value(s) through the state machine so that encoder
        # and decoder agree on run boundaries; then splice at record level.
        first_value = decoder.read_value()
        if first_value is None:
            num_nulls = min(decoder.count + 1, remaining)
            remaining -= num_nulls
            decoder.count -= num_nulls - 1
            self.append_value(None, num_nulls)
            if count and remaining > 0 and decoder.done:
                raise ValueError(f'cannot copy {count} values')
            if remaining == 0 or decoder.done:
                return (non_null, total if sum_values else None)
            first_value = decoder.read_value()
            if first_value is None:
                raise ValueError('null run must be followed by non-null value')
        self.append_value(first_value)
        remaining -= 1
        non_null += 1
        if sum_values:
            total += (first_value >> sum_shift) if sum_shift else first_value
        if count and remaining > 0 and decoder.done:
            raise ValueError(f'cannot copy {count} values')
        if remaining == 0 or decoder.done:
            return (non_null, total if sum_values else None)

        first_run = decoder.count > 0
        while remaining > 0 and not decoder.done:
            if not first_run:
                decoder.read_record()
            num_values = min(decoder.count, remaining)
            decoder.count -= num_values

            if decoder.state == 'literal':
                non_null += num_values
                for _ in range(num_values):
                    if decoder.done:
                        raise ValueError('incomplete literal')
                    value = decoder.read_raw_value()
                    if value == decoder.last_value:
                        raise ValueError('Repetition of values is not allowed in literal')
                    decoder.last_value = value
                    self._append_value(value)
                    if sum_values:
                        total += (value >> sum_shift) if sum_shift else value
            elif decoder.state == 'repetition':
                non_null += num_values
                if sum_values:
                    v = decoder.last_value
                    total += num_values * ((v >> sum_shift) if sum_shift else v)
                value = decoder.last_value
                self._append_value(value)
                if num_values > 1:
                    self._append_value(value)
                    if self.state != 'repetition':
                        raise ValueError(f'Unexpected state {self.state}')
                    self.count += num_values - 2
            elif decoder.state == 'nulls':
                self._append_value(None)
                if self.state != 'nulls':
                    raise ValueError(f'Unexpected state {self.state}')
                self.count += num_values - 1

            first_run = False
            remaining -= num_values
        if count and remaining > 0 and decoder.done:
            raise ValueError(f'cannot copy {count} values')
        return (non_null, total if sum_values else None)

    def flush(self):
        if self.state == 'loneValue':
            self.append_int32(-1)
            self.append_raw_value(self.last_value)
        elif self.state == 'repetition':
            self.append_int53(self.count)
            self.append_raw_value(self.last_value)
        elif self.state == 'literal':
            self.append_int53(-len(self.literal))
            for v in self.literal:
                self.append_raw_value(v)
        elif self.state == 'nulls':
            self.append_int32(0)
            self.append_uint53(self.count)
        self.state = 'empty'

    def append_raw_value(self, value):
        if self.type == 'int':
            self.append_int53(value)
        elif self.type == 'uint':
            self.append_uint53(value)
        elif self.type == 'utf8':
            self.append_prefixed_string(value)
        else:
            raise ValueError(f'Unknown RLEEncoder datatype: {self.type}')

    def finish(self):
        if self.state == 'literal':
            self.literal.append(self.last_value)
        # An all-null sequence encodes to nothing (ref encoding.js:778-782)
        if self.state != 'nulls' or len(self.buf) > 0:
            self.flush()


class RLEDecoder(Decoder):
    """Counterpart to RLEEncoder (ref encoding.js:789-920)."""

    def __init__(self, type, buffer):
        super().__init__(buffer)
        self.type = type
        self.last_value = None
        self.count = 0
        self.state = None

    @property
    def done(self):
        return self.count == 0 and self.offset == len(self.buf)

    def reset(self):
        self.offset = 0
        self.last_value = None
        self.count = 0
        self.state = None

    def read_value(self):
        if self.done:
            return None
        if self.count == 0:
            self.read_record()
        self.count -= 1
        if self.state == 'literal':
            value = self.read_raw_value()
            if value == self.last_value:
                raise ValueError('Repetition of values is not allowed in literal')
            self.last_value = value
            return value
        return self.last_value

    def skip_values(self, num_skip):
        while num_skip > 0 and not self.done:
            if self.count == 0:
                self.count = self.read_int53()
                if self.count > 0:
                    if self.count <= num_skip:
                        self.skip_raw_values(1)
                        self.last_value = None
                    else:
                        self.last_value = self.read_raw_value()
                    self.state = 'repetition'
                elif self.count < 0:
                    self.count = -self.count
                    self.state = 'literal'
                else:
                    self.count = self.read_uint53()
                    self.last_value = None
                    self.state = 'nulls'
            consume = min(num_skip, self.count)
            if self.state == 'literal':
                self.skip_raw_values(consume)
            num_skip -= consume
            self.count -= consume

    def read_record(self):
        self.count = self.read_int53()
        if self.count > 1:
            value = self.read_raw_value()
            if self.state in ('repetition', 'literal') and self.last_value == value:
                raise ValueError('Successive repetitions with the same value are not allowed')
            self.state = 'repetition'
            self.last_value = value
        elif self.count == 1:
            raise ValueError('Repetition count of 1 is not allowed, use a literal instead')
        elif self.count < 0:
            self.count = -self.count
            if self.state == 'literal':
                raise ValueError('Successive literals are not allowed')
            self.state = 'literal'
        else:
            if self.state == 'nulls':
                raise ValueError('Successive null runs are not allowed')
            self.count = self.read_uint53()
            if self.count == 0:
                raise ValueError('Zero-length null runs are not allowed')
            self.last_value = None
            self.state = 'nulls'

    def read_raw_value(self):
        if self.type == 'int':
            return self.read_int53()
        elif self.type == 'uint':
            return self.read_uint53()
        elif self.type == 'utf8':
            return self.read_prefixed_string()
        raise ValueError(f'Unknown RLEDecoder datatype: {self.type}')

    def skip_raw_values(self, num):
        if self.type == 'utf8':
            for _ in range(num):
                self.skip(self.read_uint53())
        else:
            while num > 0 and self.offset < len(self.buf):
                if self.buf[self.offset] & 0x80 == 0:
                    num -= 1
                self.offset += 1
            if num > 0:
                raise ValueError('cannot skip beyond end of buffer')


class DeltaEncoder(RLEEncoder):
    """RLE over successive differences (ref encoding.js:932-998)."""

    def __init__(self):
        super().__init__('int')
        self.absolute_value = 0

    def append_value(self, value, repetitions=1):
        if repetitions <= 0:
            return
        if isinstance(value, int) and not isinstance(value, bool):
            super().append_value(value - self.absolute_value, 1)
            self.absolute_value = value
            if repetitions > 1:
                super().append_value(0, repetitions - 1)
        else:
            super().append_value(value, repetitions)

    def copy_from(self, decoder, count=None, sum_values=False, sum_shift=None):
        if sum_values:
            raise ValueError('unsupported options for DeltaEncoder.copy_from()')
        if not isinstance(decoder, DeltaDecoder):
            raise TypeError('incompatible type of decoder')

        remaining = count
        if remaining is not None and remaining > 0 and decoder.done:
            raise ValueError(f'cannot copy {remaining} values')
        if remaining == 0 or decoder.done:
            return

        # First non-null value is copied via append_value so it is re-encoded
        # relative to this encoder's absolute value; the rest splice verbatim.
        value = decoder.read_value()
        nulls = 0
        self.append_value(value)
        if value is None:
            nulls = decoder.count + 1
            if remaining is not None and remaining < nulls:
                nulls = remaining
            decoder.count -= nulls - 1
            self.count += nulls - 1
            if remaining is not None and remaining > nulls and decoder.done:
                raise ValueError(f'cannot copy {remaining} values')
            if remaining == nulls or decoder.done:
                return
            if decoder.count == 0:
                self.append_value(decoder.read_value())

        if remaining is not None:
            remaining -= nulls + 1
        non_null, total = RLEEncoder.copy_from(self, decoder, count=remaining,
                                               sum_values=True)
        if non_null > 0:
            self.absolute_value = total
            decoder.absolute_value = total


class DeltaDecoder(RLEDecoder):
    """Counterpart to DeltaEncoder (ref encoding.js:1004-1051)."""

    def __init__(self, buffer):
        super().__init__('int', buffer)
        self.absolute_value = 0

    def reset(self):
        super().reset()
        self.absolute_value = 0

    def read_value(self):
        value = super().read_value()
        if value is None:
            return None
        self.absolute_value += value
        return self.absolute_value

    def skip_values(self, num_skip):
        while num_skip > 0 and not self.done:
            if self.count == 0:
                self.read_record()
            consume = min(num_skip, self.count)
            if self.state == 'literal':
                for _ in range(consume):
                    self.last_value = self.read_raw_value()
                    self.absolute_value += self.last_value
            elif self.state == 'repetition':
                self.absolute_value += consume * self.last_value
            num_skip -= consume
            self.count -= consume


class BooleanEncoder(Encoder):
    """Alternating false/true run lengths, starting with false (ref encoding.js:1061-1135)."""

    def __init__(self):
        super().__init__()
        self.last_value = False
        self.count = 0

    def append_value(self, value, repetitions=1):
        if value is not False and value is not True:
            raise ValueError(f'Unsupported value for BooleanEncoder: {value}')
        if repetitions <= 0:
            return
        if self.last_value == value:
            self.count += repetitions
        else:
            self.append_uint53(self.count)
            self.last_value = value
            self.count = repetitions

    def copy_from(self, decoder, count=None):
        if not isinstance(decoder, BooleanDecoder):
            raise TypeError('incompatible type of decoder')
        remaining = count if count is not None else float('inf')
        if count and remaining > 0 and decoder.done:
            raise ValueError(f'cannot copy {count} values')
        if remaining == 0 or decoder.done:
            return

        self.append_value(decoder.read_value())
        remaining -= 1
        first_copy = min(decoder.count, remaining)
        self.count += first_copy
        decoder.count -= first_copy
        remaining -= first_copy

        while remaining > 0 and not decoder.done:
            decoder.count = decoder.read_uint53()
            if decoder.count == 0:
                raise ValueError('Zero-length runs are not allowed')
            decoder.last_value = not decoder.last_value
            self.append_uint53(self.count)

            num_copied = min(decoder.count, remaining)
            self.count = num_copied
            self.last_value = decoder.last_value
            decoder.count -= num_copied
            remaining -= num_copied

        if count and remaining > 0 and decoder.done:
            raise ValueError(f'cannot copy {count} values')

    def finish(self):
        if self.count > 0:
            self.append_uint53(self.count)
            self.count = 0


class BooleanDecoder(Decoder):
    """Counterpart to BooleanEncoder (ref encoding.js:1141-1207)."""

    def __init__(self, buffer):
        super().__init__(buffer)
        self.last_value = True  # negated on the first run
        self.first_run = True
        self.count = 0

    @property
    def done(self):
        return self.count == 0 and self.offset == len(self.buf)

    def reset(self):
        self.offset = 0
        self.last_value = True
        self.first_run = True
        self.count = 0

    def read_value(self):
        if self.done:
            return False
        while self.count == 0:
            self.count = self.read_uint53()
            self.last_value = not self.last_value
            if self.count == 0 and not self.first_run:
                raise ValueError('Zero-length runs are not allowed')
            self.first_run = False
        self.count -= 1
        return self.last_value

    def skip_values(self, num_skip):
        while num_skip > 0 and not self.done:
            if self.count == 0:
                self.count = self.read_uint53()
                self.last_value = not self.last_value
                if self.count == 0 and not self.first_run:
                    raise ValueError('Zero-length runs are not allowed')
                self.first_run = False
            consume = min(num_skip, self.count)
            num_skip -= consume
            self.count -= consume
