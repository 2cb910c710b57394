"""Peer-to-peer data synchronisation protocol (ref backend/sync.js).

Based on Kleppmann & Howard, "Byzantine Eventual Consistency and the
Fundamental Limits of Peer-to-Peer Databases" (arXiv:2012.00472): each peer
remembers the shared heads after the last successful sync, and reconciliation
exchanges Bloom filters over the changes added since then. Wire format is
byte-compatible with the reference (message type 0x42, peer state 0x43,
explicit Bloom parameters).

The batched fleet-scale Bloom build/probe lives in
automerge_tpu_torch.fleet.bloom; this module is the host-side protocol
driver.
"""

from ..encoding import (Encoder, Decoder, hex_string_to_bytes,
    bytes_to_hex_string, uleb_append as _uleb)
from ..columnar import decode_change_meta
from ..errors import MalformedSyncMessage, as_wire_error
from ..observability import register_health_source
from ..observability.metrics import Counters
from . import get_heads, get_missing_deps, get_change_by_hash, get_changes, \
    apply_changes

# Containment counter: peer Bloom filters that failed to parse/probe and
# were treated as empty (send-everything) instead of crashing the
# generate round. Registered as a health source so bench.py and the
# chaos tests can see corruption being absorbed.
_wire_stats = Counters({'rejected_filters': 0})
register_health_source('rejected_filters',
                       lambda: _wire_stats['rejected_filters'])

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


def encode_sync_state(sync_state):
    """Only sharedHeads persists across restarts (ref sync.js:206-211)."""
    encoder = Encoder()
    encoder.append_byte(PEER_STATE_TYPE)
    _encode_hashes(encoder, sync_state['sharedHeads'])
    return encoder.buffer


def decode_sync_state(data):
    try:
        decoder = Decoder(data)
        record_type = decoder.read_byte()
        if record_type != PEER_STATE_TYPE:
            raise ValueError(f'Unexpected record type: {record_type}')
        state = init_sync_state()
        state['sharedHeads'] = _decode_hashes(decoder)
    except Exception as exc:
        raise as_wire_error(exc, MalformedSyncMessage, 'decode_sync_state')
    return state


# The reference re-decodes and re-hashes every change for each of the
# Bloom-filter build, the changes-to-send scan, and the sentHashes filter
# (its own TODO at sync.js:378). Change buffers are immutable, so a bounded
# memo of their metadata removes the O(rounds x changes) redundant SHA-256s.
_META_CACHE_MAX = 1 << 16
_meta_cache = {}


def _cached_meta(change):
    change = bytes(change)
    meta = _meta_cache.get(change)
    if meta is None:
        meta = decode_change_meta(change, True)
        if len(_meta_cache) >= _META_CACHE_MAX:
            _meta_cache.clear()
        _meta_cache[change] = meta
    return meta


def known_hash_flags(backend, hashes):
    """Membership of `hashes` in the backend's APPLIED history — the one
    helper behind theirHave lastSync reconciliation and received-heads
    lookup. A fleet document whose frontier index is warm
    (fleet/hashindex.py — registered by a batched sync round) answers
    from the index without ever touching the hash-graph dicts; every
    other backend takes the classic get_change_by_hash path. Both
    answers are exact and identical (the equivalence tests pin it)."""
    if not hashes:
        return []
    state = backend.get('state') if isinstance(backend, dict) else None
    probe = getattr(state, 'probe_hashes', None)
    if probe is not None:
        flags = probe(hashes)
        if flags is not None:
            return [bool(f) for f in flags]
    return [get_change_by_hash(backend, h) is not None for h in hashes]


def make_bloom_filter(backend, last_sync):
    """Bloom filter over changes applied since `last_sync` (ref sync.js:234-238)."""
    from . import get_change_hashes
    hashes = get_change_hashes(backend, last_sync)
    return {'lastSync': last_sync, 'bloom': BloomFilter(hashes).bytes}


def changes_to_send_prescan(backend, have, need):
    """Prologue of the changes-to-send scan (ref sync.js:246-306): collect
    candidate change metas and the peer filters to probe. The probe itself
    is pluggable so the fleet driver (fleet/sync_driver.py) can batch it on
    device. Returns ('need-only', final_changes) when no filters were
    attached, else ('probe', (changes_meta, filter_bytes_list))."""
    if not have:
        return 'need-only', [
            c for c in (get_change_by_hash(backend, h) for h in need)
            if c is not None]
    last_sync_hashes = set()
    for h in have:
        last_sync_hashes.update(h['lastSync'])
    changes = [_cached_meta(c)
               for c in get_changes(backend, sorted(last_sync_hashes))]
    return 'probe', (changes, [h['bloom'] for h in have])


def changes_to_send_finish(backend, changes, bloom_hits, need):
    """Epilogue of the changes-to-send scan, fed per-filter probe results
    (bloom_hits[f][j] = filter f possibly contains changes[j]): Bloom-
    negative changes, their transitive dependents, and explicit needs."""
    change_hashes = set()
    dependents = {}
    hashes_to_send = set()
    for j, change in enumerate(changes):
        change_hashes.add(change['hash'])
        for dep in change['deps']:
            dependents.setdefault(dep, []).append(change['hash'])
        if all(not hits[j] for hits in bloom_hits):
            hashes_to_send.add(change['hash'])

    # Include any changes that depend on a Bloom-negative change
    stack = list(hashes_to_send)
    while stack:
        hash = stack.pop()
        for dep in dependents.get(hash, []):
            if dep not in hashes_to_send:
                hashes_to_send.add(dep)
                stack.append(dep)

    changes_to_send = []
    for hash in need:
        hashes_to_send.add(hash)
        if hash not in change_hashes:
            change = get_change_by_hash(backend, hash)
            if change is not None:
                changes_to_send.append(change)

    for change in changes:
        if change['hash'] in hashes_to_send:
            changes_to_send.append(change['change'])
    return changes_to_send


def probe_filter_lenient(filter_bytes, hashes):
    """Probe one peer filter's wire bytes against `hashes`, CONTAINING
    corruption: a filter that fails to parse or probe (truncated framing,
    zero-width bits from a flipped byte, ...) reads as all-False —
    "peer has nothing", so every candidate change is resent. That costs
    bandwidth, never convergence, and it keeps a peer that stored a
    corrupt `theirHave` functional instead of crashing every subsequent
    generate (the filter arrived inside an already-checksummed message,
    so there is no retransmit to ask for)."""
    try:
        bloom = BloomFilter(bytes(filter_bytes))
        return [bloom.contains_hash(h) for h in hashes]
    except Exception:
        _wire_stats.inc('rejected_filters')
        return [False] * len(hashes)


def get_changes_to_send(backend, have, need):
    """Changes since lastSync whose hash misses every peer Bloom filter, plus
    transitive dependents of Bloom-negative changes, plus explicitly needed
    hashes (ref sync.js:246-306)."""
    mode, payload = changes_to_send_prescan(backend, have, need)
    if mode == 'need-only':
        return payload
    changes, filter_bytes = payload
    hashes = [c['hash'] for c in changes]
    bloom_hits = [probe_filter_lenient(fb, hashes) for fb in filter_bytes]
    return changes_to_send_finish(backend, changes, bloom_hits, need)


def init_sync_state():
    return {
        'sharedHeads': [],
        'lastSentHeads': [],
        'theirHeads': None,
        'theirNeed': None,
        'theirHave': None,
        'sentHashes': set(),
    }


def generate_sync_message(backend, sync_state):
    """Generate the next message to a peer, or None when in sync
    (ref sync.js:327-393)."""
    if backend is None:
        raise ValueError('generateSyncMessage called with no Automerge document')
    if sync_state is None:
        raise ValueError('generateSyncMessage requires a syncState, which can be '
                         'created with initSyncState()')

    shared_heads = sync_state['sharedHeads']
    last_sent_heads = sync_state['lastSentHeads']
    their_heads = sync_state['theirHeads']
    their_need = sync_state['theirNeed']
    their_have = sync_state['theirHave']
    sent_hashes = sync_state['sentHashes']
    our_heads = get_heads(backend)

    our_need = get_missing_deps(backend, their_heads or [])

    # Only attach a Bloom filter when we're not just chasing missing deps
    # caused by false positives (rationale: sync.js:341-348)
    our_have = []
    if their_heads is None or all(h in their_heads for h in our_need):
        our_have = [make_bloom_filter(backend, shared_heads)]

    # Full-resync reset if the peer's lastSync contains hashes unknown to us
    # (e.g. peer crashed without persisting; ref sync.js:352-362)
    if their_have:
        last_sync = their_have[0]['lastSync']
        if not all(known_hash_flags(backend, last_sync)):
            reset = {'heads': our_heads, 'need': [],
                     'have': [{'lastSync': [], 'bloom': b''}], 'changes': []}
            return [sync_state, encode_sync_message(reset)]

    changes_to_send = get_changes_to_send(backend, their_have, their_need) \
        if isinstance(their_have, list) and isinstance(their_need, list) else []

    heads_unchanged = isinstance(last_sent_heads, list) and \
        our_heads == last_sent_heads
    heads_equal = isinstance(their_heads, list) and our_heads == their_heads
    if heads_unchanged and heads_equal and not changes_to_send:
        return [sync_state, None]

    # A state promoted by the fleet driver carries its sentHashes as a
    # peer-space of the device table (fleet/hashindex.py PeerSentSet):
    # answer the whole filter in ONE batched probe, and stage new sends
    # in place — the copy-on-write below only ever shielded old state
    # dicts, which the peer-space path shares by identity instead.
    contains_many = getattr(sent_hashes, 'contains_many', None)
    if contains_many is not None and changes_to_send:
        already = contains_many([_cached_meta(c)['hash']
                                 for c in changes_to_send])
        changes_to_send = [c for c, hit in zip(changes_to_send, already)
                           if not hit]
    else:
        changes_to_send = [c for c in changes_to_send
                           if _cached_meta(c)['hash'] not in sent_hashes]

    message = {'heads': our_heads, 'have': our_have, 'need': our_need,
               'changes': changes_to_send}
    if changes_to_send:
        if contains_many is None:
            sent_hashes = set(sent_hashes)
        for change in changes_to_send:
            sent_hashes.add(_cached_meta(change)['hash'])

    new_state = dict(sync_state, lastSentHeads=our_heads, sentHashes=sent_hashes)
    return [new_state, encode_sync_message(message)]


def advance_heads(my_old_heads, my_new_heads, our_old_shared_heads):
    """Shared-heads algebra after applying received changes (ref sync.js:408-413)."""
    new_heads = [h for h in my_new_heads if h not in my_old_heads]
    common_heads = [h for h in our_old_shared_heads if h in my_new_heads]
    return sorted(set(new_heads + common_heads))


def receive_sync_message(backend, old_sync_state, binary_message):
    """Apply a received sync message; returns [backend, syncState, patch]
    (ref sync.js:420-473)."""
    if backend is None:
        raise ValueError('generateSyncMessage called with no Automerge document')
    if old_sync_state is None:
        raise ValueError('generateSyncMessage requires a syncState, which can be '
                         'created with initSyncState()')

    shared_heads = old_sync_state['sharedHeads']
    last_sent_heads = old_sync_state['lastSentHeads']
    sent_hashes = old_sync_state['sentHashes']
    patch = None
    message = decode_sync_message(binary_message)
    before_heads = get_heads(backend)

    # Apply received changes; Bloom false positives may leave missing deps, in
    # which case the backend queues them (repaired later via `need`)
    if message['changes']:
        backend, patch = apply_changes(backend, message['changes'])
        shared_heads = advance_heads(before_heads, get_heads(backend), shared_heads)

    if not message['changes'] and message['heads'] == before_heads:
        last_sent_heads = message['heads']

    known_heads = [h for h, known in
                   zip(message['heads'],
                       known_hash_flags(backend, message['heads']))
                   if known]
    if len(known_heads) == len(message['heads']):
        shared_heads = message['heads']
        # Remote peer lost all its data: reset for a full resync (a
        # peer-space sent set hands its table space back, see
        # fleet/hashindex.py — duck-typed so this module stays
        # fleet-agnostic)
        if len(message['heads']) == 0:
            last_sent_heads = []
            release = getattr(sent_hashes, 'release', None)
            if release is not None:
                release()
            sent_hashes = set()
    else:
        shared_heads = sorted(set(known_heads) | set(shared_heads))

    sync_state = {
        'sharedHeads': shared_heads,
        'lastSentHeads': last_sent_heads,
        'theirHave': message['have'],
        'theirHeads': message['heads'],
        'theirNeed': message['need'],
        'sentHashes': sent_hashes,
    }
    return [backend, sync_state, patch]
