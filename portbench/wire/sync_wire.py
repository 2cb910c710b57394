"""Frozen copy of the sync message format and the Bloom filter from
automerge_tpu_torch/backend/sync.py:29-222 (constants, `read_filter_header`,
`BloomFilter`, the hash runs, `encode_sync_message`,
`decode_sync_message`), kept here so that a change to the program cannot
move the benchmark's inputs or its reference."""

from .encoding import (Encoder, Decoder, hex_string_to_bytes,
                       bytes_to_hex_string, uleb_append as _uleb)
from .errors import MalformedSyncMessage, as_wire_error


HASH_SIZE = 32
MESSAGE_TYPE_SYNC = 0x42  # first byte of a sync message
PEER_STATE_TYPE = 0x43    # first byte of an encoded peer state

# ~1% false positive rate; the parameters are part of the wire format so they
# can change without breaking protocol compatibility (ref sync.js:29-31)
BITS_PER_ENTRY = 10
NUM_PROBES = 7


def read_filter_header(decoder):
    """THE wire-format filter-header reader (counterpart of
    fleet/bloom.py's `_append_filter_header` writer): every site that
    parses filter bytes — BloomFilter decode, the message-boundary
    framing check, the batched device probe — goes through this one
    function so the readers cannot drift. Returns (num_entries,
    bits_per_entry, num_probes, bitmap_byte_len); rejects the
    zero-width-probe shape (entries > 0 with bits_per_entry or
    num_probes of 0), which would divide by zero at probe time."""
    num_entries = decoder.read_uint32()
    bits_per_entry = decoder.read_uint32()
    num_probes = decoder.read_uint32()
    if num_entries and (bits_per_entry == 0 or num_probes == 0):
        raise MalformedSyncMessage('bloom filter with zero-width probes')
    return (num_entries, bits_per_entry, num_probes,
            (num_entries * bits_per_entry + 7) // 8)


class BloomFilter:
    """Bloom filter over SHA-256 change hashes, using triple hashing over the
    first 12 hash bytes (Dillinger & Manolios; ref sync.js:38-125)."""

    def __init__(self, arg):
        if isinstance(arg, (list, tuple)):
            self.num_entries = len(arg)
            self.num_bits_per_entry = BITS_PER_ENTRY
            self.num_probes = NUM_PROBES
            self.bits = bytearray(
                (self.num_entries * self.num_bits_per_entry + 7) // 8)
            for hash in arg:
                self.add_hash(hash)
        elif isinstance(arg, (bytes, bytearray, memoryview)):
            arg = bytes(arg)
            if len(arg) == 0:
                self.num_entries = 0
                self.num_bits_per_entry = 0
                self.num_probes = 0
                self.bits = bytearray()
            else:
                decoder = Decoder(arg)
                (self.num_entries, self.num_bits_per_entry,
                 self.num_probes, n_bytes) = read_filter_header(decoder)
                self.bits = bytearray(decoder.read_raw_bytes(n_bytes))
        else:
            raise TypeError('invalid argument')

    @property
    def bytes(self):
        if self.num_entries == 0:
            return b''
        encoder = Encoder()
        encoder.append_uint32(self.num_entries)
        encoder.append_uint32(self.num_bits_per_entry)
        encoder.append_uint32(self.num_probes)
        encoder.append_raw_bytes(self.bits)
        return encoder.buffer

    def get_probes(self, hash):
        hash_bytes = hex_string_to_bytes(hash)
        modulo = 8 * len(self.bits)
        if len(hash_bytes) != 32:
            raise ValueError(f'Not a 256-bit hash: {hash}')
        x = int.from_bytes(hash_bytes[0:4], 'little') % modulo
        y = int.from_bytes(hash_bytes[4:8], 'little') % modulo
        z = int.from_bytes(hash_bytes[8:12], 'little') % modulo
        probes = [x]
        for _ in range(1, self.num_probes):
            x = (x + y) % modulo
            y = (y + z) % modulo
            probes.append(x)
        return probes

    def add_hash(self, hash):
        for probe in self.get_probes(hash):
            self.bits[probe >> 3] |= 1 << (probe & 7)

    def contains_hash(self, hash):
        if self.num_entries == 0:
            return False
        return all(self.bits[probe >> 3] & (1 << (probe & 7))
                   for probe in self.get_probes(hash))


def _encode_hashes(encoder, hashes):
    out = bytearray()
    _hashes_raw(out, hashes)
    # (delegates to the bytearray fast path; the count uleb matches
    # append_uint32's encoding)
    encoder.append_raw_bytes(bytes(out))


def _decode_hashes(decoder):
    return [bytes_to_hex_string(decoder.read_raw_bytes(HASH_SIZE))
            for _ in range(decoder.read_uint32())]


def _hashes_raw(out, hashes):
    """Encode a sorted hash run: count uleb + raw 32-byte hashes, with
    one C-level hex decode for the whole run instead of a per-hash
    convert+append (sync messages encode by the thousand in the fleet
    driver, and this was its hottest line). Per-hash length is validated
    up front — a joined decode alone would let malformed hashes whose
    lengths cancel out slip through as shifted garbage."""
    if not isinstance(hashes, (list, tuple)):
        raise TypeError('hashes must be an array')
    _uleb(out, len(hashes))
    if not hashes:
        return
    if any(a >= b for a, b in zip(hashes, hashes[1:])):
        raise ValueError('hashes must be sorted')
    if any(len(h) != 2 * HASH_SIZE for h in hashes):
        raise TypeError('heads hashes must be 256 bits')
    try:
        data = bytes.fromhex(''.join(hashes))
    except ValueError:
        raise TypeError('heads hashes must be 256 bits')
    if len(data) != HASH_SIZE * len(hashes):
        raise TypeError('heads hashes must be 256 bits')
    out += data


def encode_sync_message(message):
    """(ref sync.js:157-172). Built with direct bytearray ops — the
    fleet driver encodes thousands of messages per round, and the
    general Encoder's per-int checks dominated its profile."""
    out = bytearray([MESSAGE_TYPE_SYNC])
    _hashes_raw(out, message['heads'])
    _hashes_raw(out, message['need'])
    _uleb(out, len(message['have']))
    for have in message['have']:
        _hashes_raw(out, have['lastSync'])
        bloom = bytes(have['bloom'])
        _uleb(out, len(bloom))
        out += bloom
    _uleb(out, len(message['changes']))
    for change in message['changes']:
        change = bytes(change)
        _uleb(out, len(change))
        out += change
    return bytes(out)


def _validate_filter_framing(bloom):
    """Cheap structural check of a filter's wire bytes at the decode
    boundary: a corrupt filter stored into `theirHave` would poison every
    LATER generate (unprobeable, or worse: probeable but all-False, which
    makes changes_to_send permanently nonempty against a full sentHashes
    and the peer solicit forever), so the whole message quarantines NOW,
    where the peer's retry/reset machinery handles it like any other
    corrupt message."""
    if not bloom:
        return
    decoder = Decoder(bytes(bloom))
    _entries, _bpe, _probes, n_bytes = read_filter_header(decoder)
    decoder.read_raw_bytes(n_bytes)


def decode_sync_message(data):
    """(ref sync.js:177-201). Undecodable bytes — including a structurally
    corrupt Bloom filter inside `have` — raise `MalformedSyncMessage`
    (a ValueError), never a bare decoder exception: one hostile message
    must be quarantinable by type, before any of it enters sync state."""
    try:
        decoder = Decoder(data)
        message_type = decoder.read_byte()
        if message_type != MESSAGE_TYPE_SYNC:
            raise ValueError(f'Unexpected message type: {message_type}')
        message = {'heads': _decode_hashes(decoder),
                   'need': _decode_hashes(decoder),
                   'have': [], 'changes': []}
        for _ in range(decoder.read_uint32()):
            last_sync = _decode_hashes(decoder)
            bloom = decoder.read_prefixed_bytes()
            _validate_filter_framing(bloom)
            message['have'].append({'lastSync': last_sync, 'bloom': bloom})
        for _ in range(decoder.read_uint32()):
            message['changes'].append(decoder.read_prefixed_bytes())
    except Exception as exc:
        raise as_wire_error(exc, MalformedSyncMessage, 'decode_sync_message')
    # Trailing bytes are ignored for forward compatibility
    return message
