"""Batched Bloom-filter construction and probing for fleet-scale sync
(torch port of automerge_tpu/fleet/bloom.py).

The flat packed build and probe, one dispatch each per round, are the
hand-written CUDA kernels of fleet/sync_kernels.py (`bloom_build`,
`bloom_probe`). The single-tensor API (`build_bloom_filters`,
`probe_bloom_filters`, over uniform [N, B] bool rows) serves no sync
round and runs as plain torch ops on the caller's device. Entry points
run on the card unless the caller passes `device='cpu'`. The four
dispatches are wrapped for the kernel cost ledger under the reference's
kind names (`bloom_build_varsize`, `bloom_probe_varsize`,
`bloom_build_flat_packed`, `bloom_probe_flat_packed`).

The reference's description follows.

The sync protocol's per-peer Bloom filter (ref backend/sync.js:38-125:
10 bits/entry, 7 probes, triple hashing over the first 12 bytes of each
change hash) becomes bit-tensor math over the whole fleet: hashes arrive as
[N, H, 3] uint32 words, probe indexes are computed with vectorized triple
hashing, and filters live as bit tensors built with one scatter. Probing is
a gather + reduce. Serialization (`bloom_filter_bytes`) is bit-exact with
the reference's wire format.

Batching across peers of DIFFERING filter sizes uses a flat packed layout:
every peer's filter occupies its exact wire-format byte span inside ONE
concatenated byte vector, with per-row bit offsets and per-row modulo
capacities. A whole fleet's build is therefore ONE device dispatch and a
whole fleet's probe another, regardless of how skewed the per-peer change
counts are — and batch memory stays proportional to real filter bytes.
Filters cross the host<->device link already in the wire format's
little-bit-order byte packing (8x less transfer than unpacked bools).
"""

import numpy as np
import torch

from . import sync_kernels
from .tensor_doc import resolve_device

BITS_PER_ENTRY = 10
NUM_PROBES = sync_kernels.NUM_PROBES     # 7, as the kernels compute

# Device dispatches issued by the batched build/probe entry points since
# import — the sync driver's equivalent of DocFleet.metrics.dispatches
# (the driver runs over host backends, which have no fleet to count on).
_dispatches = 0


def dispatch_count():
    """Monotonic count of batched Bloom device dispatches (build + probe)."""
    return _dispatches


from ..observability import hist as _hist  # noqa: E402
from ..observability import register_dispatch_source  # noqa: E402
from ..observability.perf import instrument_kernel  # noqa: E402
from ..observability.spans import spanned as _spanned  # noqa: E402
register_dispatch_source('bloom', dispatch_count)


def hashes_to_words(hashes_hex):
    """Convert a list of hash lists (hex strings) into an [N, H, 3] uint32
    array of the first three little-endian words of each hash, padded with
    an all-ones sentinel row mask. Returns (words, valid_mask).

    One C-level hex decode + reshape for the whole fleet instead of a
    per-hash fromhex/frombuffer pair (this fed every Bloom build)."""
    n = len(hashes_hex)
    counts = np.fromiter(map(len, hashes_hex), dtype=np.int64, count=n)
    h = int(counts.max()) if n else 0
    words = np.zeros((n, max(h, 1), 3), dtype=np.uint32)
    valid = np.zeros((n, max(h, 1)), dtype=bool)
    total = int(counts.sum())
    if total:
        raw = np.frombuffer(
            bytes.fromhex(''.join(h for row in hashes_hex for h in row)),
            dtype=np.uint8).reshape(total, 32)
        w3 = raw[:, :12].copy().view('<u4').reshape(total, 3)
        rows = np.repeat(np.arange(n), counts)
        starts = np.cumsum(counts) - counts
        cols = np.arange(total) - starts[rows]
        words[rows, cols] = w3
        valid[rows, cols] = True
    return words, valid


def num_filter_bits(num_entries):
    """Bit capacity of a filter with the reference's sizing rule (always a
    whole number of bytes)."""
    return 8 * ((num_entries * BITS_PER_ENTRY + 7) // 8)


def _words_tensor(words, device):
    """[N, H, 3] uint32 words (numpy or tensor) as contiguous int32 bit
    patterns on `device`."""
    if isinstance(words, torch.Tensor):
        return words.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32)
                            .view(np.int32)).to(device)


def _bool_tensor(mask, device):
    if isinstance(mask, torch.Tensor):
        return mask.to(device=device, dtype=torch.bool).contiguous()
    return torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(device)


def build_bloom_filters(words, valid, num_entries, device=None):
    """Build [N, B] bool filters for N peers, each over `num_entries` hashes
    ([N, H] padded with `valid` mask). All peers share the same B (sized for
    the max entry count) so the fleet batches into one tensor. The filters
    live on `device` (CUDA unless the caller asks otherwise)."""
    dev = resolve_device(device)
    words = _words_tensor(words, dev)
    n_docs = words.shape[0]
    n_bits = max(num_filter_bits(num_entries), 8)
    bits = torch.zeros((n_docs, n_bits), dtype=torch.bool, device=dev)
    row_bits = torch.full((n_docs,), n_bits, dtype=torch.int64, device=dev)
    return _build_varsize(words, _bool_tensor(valid, dev), row_bits, bits)


def probe_bloom_filters(bits, words, valid):
    """Probe [N, H] hashes against [N, B] filters (a bool tensor, whose
    device the probe runs on); returns [N, H] bool (True = possibly
    contained)."""
    bits = torch.as_tensor(bits)
    dev = bits.device
    n_docs, n_bits = bits.shape
    row_bits = torch.full((n_docs,), n_bits, dtype=torch.int64, device=dev)
    return _probe_varsize(bits.to(torch.bool), row_bits,
                          _words_tensor(words, dev), _bool_tensor(valid, dev))


def _append_filter_header(out, num_entries):
    """THE wire-format filter header (ref sync.js:67-76): explicit
    parameters ahead of the packed bits — shared by the single-row and
    batched serializers so the two cannot drift."""
    from ..encoding import uleb_append
    uleb_append(out, num_entries)
    out.append(BITS_PER_ENTRY)
    out.append(NUM_PROBES)


def bloom_filter_bytes(bits_row, num_entries):
    """Serialize one filter row ([B] bool) to the reference wire format
    (ref sync.js:67-76): explicit parameters + little-bit-order packed bits.

    The row must have been built with a filter sized for exactly
    `num_entries` (probe indexes are modulo the bit capacity, so truncating
    a larger filter would corrupt it into false negatives). Batch peers of
    differing entry counts into separate build_bloom_filters calls."""
    if num_entries == 0:
        return b''
    if isinstance(bits_row, torch.Tensor):
        bits_row = bits_row.cpu().numpy()
    bits_row = np.asarray(bits_row)
    if bits_row.shape[-1] != num_filter_bits(num_entries):
        raise ValueError(
            f'filter row has {bits_row.shape[-1]} bits but num_entries='
            f'{num_entries} requires {num_filter_bits(num_entries)}; '
            f'serialize only rows built with matching sizing')
    # direct uleb bytes (the Encoder round-trip showed up at fleet scale)
    out = bytearray()
    _append_filter_header(out, num_entries)
    n_bytes = (num_entries * BITS_PER_ENTRY + 7) // 8
    packed = np.packbits(bits_row, bitorder='little')[:n_bytes]
    out += packed.tobytes()
    return bytes(out)


# ---- Variable-size batching -----------------------------------------------
# Peers generally have different change counts, hence different filter bit
# capacities (the reference sizes each filter by its entry count,
# sync.js:44-47). The uniform [N, B] build/probe pair below pads rows to the
# widest filter and takes the modulo per row (plain torch ops: no sync
# round runs them); the flat packed pair, the sync_kernels CUDA kernels,
# concatenates every filter's exact byte span instead, so ONE dispatch
# covers arbitrarily skewed fleets without padding-driven memory blowup.

def _build_varsize(words, valid, row_bits, bits_init):
    n_rows, n_bits_max = bits_init.shape
    probes = sync_kernels.probe_indexes_plain(words, row_bits)
    row_idx = torch.arange(n_rows, device=bits_init.device).view(-1, 1, 1) \
        .expand_as(probes)
    # invalid lanes land in a scratch column past the filters (dropped)
    probes = torch.where(valid.unsqueeze(-1), probes, n_bits_max)
    padded = torch.zeros((n_rows, n_bits_max + 1), dtype=torch.bool,
                         device=bits_init.device)
    padded[:, :n_bits_max] = bits_init
    padded[row_idx, probes] = True
    return padded[:, :n_bits_max]


def _probe_varsize(bits, row_bits, words, valid):
    n_rows, _ = bits.shape
    probes = sync_kernels.probe_indexes_plain(words, row_bits)
    row_idx = torch.arange(n_rows, device=bits.device).view(-1, 1, 1) \
        .expand_as(probes)
    hit = bits[row_idx, probes]
    return hit.all(dim=-1) & valid


def _build_flat_packed(words, valid, row_bits, bit_off, total_bits):
    return sync_kernels.bloom_build(words, valid, row_bits, bit_off,
                                    total_bits)


def _probe_flat_packed(flat, row_bits, byte_off, words, valid):
    return sync_kernels.bloom_probe(flat, row_bits, byte_off, words, valid)


_build_varsize = instrument_kernel('bloom_build_varsize', _build_varsize)
_probe_varsize = instrument_kernel('bloom_probe_varsize', _probe_varsize)
_build_flat_packed = instrument_kernel('bloom_build_flat_packed',
                                       _build_flat_packed)
_probe_flat_packed = instrument_kernel('bloom_probe_flat_packed',
                                       _probe_flat_packed)


# Flat packed layout: filter i owns bits [bit_off[i], bit_off[i] +
# row_bits[i]) of one flat bit vector (byte-aligned: num_filter_bits is a
# whole number of bytes by construction). Build scatters every probe of
# every row into the flat vector, packed LSB-first (sync_kernels.bloom_build);
# probe gathers packed bytes through the same offsets
# (sync_kernels.bloom_probe). Row axes and the flat length are pow2-padded
# by the callers, as in the JAX package.

def _pow2(n, floor=1):
    out = max(int(floor), 1)
    n = int(n)
    while out < n:
        out *= 2
    return out


def _pad_rows(words, valid, row_bits, offs, pad_off):
    """Pad the row axis to a power of two: padded rows carry no valid
    hashes, an inert 8-bit capacity (the modulo must never be zero), and
    the caller's out-of-range/zero offset."""
    n = len(row_bits)
    n_pad = _pow2(n, floor=8)
    if n_pad == n:
        return words, valid, row_bits, offs
    h = words.shape[1]
    words = np.concatenate(
        [words, np.zeros((n_pad - n, h, 3), dtype=words.dtype)])
    valid = np.concatenate(
        [valid, np.zeros((n_pad - n, h), dtype=bool)])
    row_bits = np.concatenate(
        [row_bits, np.full(n_pad - n, 8, dtype=row_bits.dtype)])
    offs = np.concatenate(
        [offs, np.full(n_pad - n, pad_off, dtype=offs.dtype)])
    return words, valid, row_bits, offs


def _pad_hash_axis(words, valid):
    """Pad the hash axis to a power of two."""
    n, h, _ = words.shape
    h_pad = _pow2(h, floor=8)
    if h_pad == h:
        return words, valid
    words = np.concatenate(
        [words, np.zeros((n, h_pad - h, 3), dtype=words.dtype)], axis=1)
    valid = np.concatenate(
        [valid, np.zeros((n, h_pad - h), dtype=bool)], axis=1)
    return words, valid


def flat_build_lanes(hash_lists):
    """The flat packed build's inputs for the non-empty lists of
    `hash_lists`, as padded host arrays: (words [R, H, 3] uint32, valid
    [R, H], row_bits [R] uint32, bit_off [R] int64, total_bits, byte_off
    of each live row's filter), or None when every list is empty."""
    live = [row for row in hash_lists if row]
    if not live:
        return None
    words, valid = hashes_to_words(live)
    words, valid = _pad_hash_axis(words, valid)
    byte_counts = np.array([num_filter_bits(len(row)) // 8 for row in live],
                           dtype=np.int64)
    byte_off = np.cumsum(byte_counts) - byte_counts
    row_bits = (byte_counts * 8).astype(np.uint32)
    total_bits = _pow2(int(byte_counts.sum()) * 8, floor=64)
    words, valid, row_bits, bit_off = _pad_rows(
        words, valid, row_bits, byte_off * 8, pad_off=total_bits)
    return words, valid, row_bits, bit_off, total_bits, byte_off


def lanes_to(words, valid, row_bits, offs, device):
    """Padded host lanes as the kernels' tensors on `device`: words as
    int32 bit patterns, row capacities and offsets as int64."""
    return (_words_tensor(words, device), _bool_tensor(valid, device),
            torch.from_numpy(row_bits.astype(np.int64)).to(device),
            torch.from_numpy(np.asarray(offs, dtype=np.int64)).to(device))


@_spanned('bloom_build')
def build_bloom_filters_batch_begin(hash_lists, device=None):
    """Issue THE device dispatch for `build_bloom_filters_batch` without
    blocking on its result (CUDA launches are async). Returns an opaque
    handle for `build_bloom_filters_batch_finish`; host work interleaved
    between begin and finish overlaps with the device build. One dispatch
    regardless of how peers' entry counts are distributed. `device`
    (CUDA unless the caller asks otherwise) is resolved only when some
    list is non-empty."""
    global _dispatches
    entry_counts = [len(row) for row in hash_lists]
    live = [i for i, n in enumerate(entry_counts) if n > 0]
    # fabric fan-in visibility: how many peer links each fused build
    # actually carried
    if _hist.on():
        _hist.record_value('bloom_fused_links', len(live), unit='links')
    if not live:
        return len(hash_lists), entry_counts, live, None, None
    dev = resolve_device(device)
    words, valid, row_bits, bit_off, total_bits, byte_off = \
        flat_build_lanes(hash_lists)
    packed = _build_flat_packed(
        *lanes_to(words, valid, row_bits, bit_off, dev), total_bits)
    _dispatches += 1
    return len(hash_lists), entry_counts, live, byte_off, packed


@_spanned('bloom_build_wait')
def build_bloom_filters_batch_finish(handle):
    """Materialize a `build_bloom_filters_batch_begin` handle into the list
    of wire-format filter bytes."""
    n, entry_counts, live, byte_off, packed = handle
    out = [b''] * n
    if packed is None:
        return out
    arr = packed.cpu().numpy()
    for k, i in enumerate(live):
        num_entries = entry_counts[i]
        row = bytearray()
        _append_filter_header(row, num_entries)
        n_bytes = (num_entries * BITS_PER_ENTRY + 7) // 8
        off = int(byte_off[k])
        row += arr[off:off + n_bytes].tobytes()
        out[i] = bytes(row)
    return out


def build_bloom_filters_batch(hash_lists, device=None):
    """Build one wire-format Bloom filter per hash list — ONE device
    dispatch for the whole batch despite differing entry counts (flat
    packed layout; memory proportional to real filter bytes). Returns a
    list of `bytes` (b'' for empty lists), byte-identical to the host
    BloomFilter."""
    return build_bloom_filters_batch_finish(
        build_bloom_filters_batch_begin(hash_lists, device))


@_spanned('bloom_probe')
def probe_bloom_filters_batch_begin(filter_bytes, hash_lists, device=None):
    """Issue THE device dispatch for `probe_bloom_filters_batch` without
    blocking (filters are uploaded in their packed wire-format bytes, not
    unpacked bools, concatenated into one flat byte vector). Returns a
    handle for `probe_bloom_filters_batch_finish`."""
    global _dispatches
    from ..encoding import Decoder
    out = [[False] * len(row) for row in hash_lists]
    rows = []          # (orig index, packed byte array, n_bits)
    for i, fb in enumerate(filter_bytes):
        if not fb or not hash_lists[i]:
            continue
        try:
            from ..backend.sync import read_filter_header
            decoder = Decoder(bytes(fb))
            num_entries, bits_per_entry, num_probes, n_bytes = \
                read_filter_header(decoder)
            if num_entries == 0:
                continue
            if bits_per_entry != BITS_PER_ENTRY or num_probes != NUM_PROBES:
                # The wire format carries these so they can vary
                # (sync.js:68-76); nonstandard peers fall back to the
                # generic host filter rather than failing the whole batch
                from ..backend.sync import BloomFilter
                host = BloomFilter(bytes(fb))
                out[i] = [host.contains_hash(h) for h in hash_lists[i]]
                continue
            raw = decoder.read_raw_bytes(n_bytes)
        except Exception:
            # Corrupt filter bytes read as all-False ("peer has nothing":
            # resend everything) instead of aborting the other N-1 docs'
            # probes — same containment rule as the host path's
            # probe_filter_lenient; the shared counter records it
            from ..backend.sync import _wire_stats
            _wire_stats.inc('rejected_filters')
            continue
        rows.append((i, np.frombuffer(raw, dtype=np.uint8), 8 * len(raw)))
    if _hist.on():
        _hist.record_value('bloom_fused_probe_links', len(rows), unit='links')
    if not rows:
        return out, hash_lists, None, None
    dev = resolve_device(device)
    flat, words, valid, row_bits, byte_off = flat_probe_lanes(
        [raw for _, raw, _ in rows], [hash_lists[i] for i, _, _ in rows])
    words_t, valid_t, row_bits_t, off_t = lanes_to(
        words, valid, row_bits, byte_off, dev)
    hit = _probe_flat_packed(torch.from_numpy(flat).to(dev),
                             row_bits_t, off_t, words_t, valid_t)
    _dispatches += 1
    return out, hash_lists, rows, hit


def flat_probe_lanes(filters, hash_lists):
    """The flat packed probe's inputs, as padded host arrays: (flat
    uint8, words [R, H, 3] uint32, valid [R, H], row_bits [R] uint32,
    byte_off [R] int64) for the packed filter bytes `filters[k]` (no
    wire header) and the hex hashes `hash_lists[k]` to test against
    each."""
    words, valid = hashes_to_words(hash_lists)
    words, valid = _pad_hash_axis(words, valid)
    byte_counts = np.array([len(raw) for raw in filters], dtype=np.int64)
    byte_off = np.cumsum(byte_counts) - byte_counts
    flat = np.zeros(_pow2(int(byte_counts.sum()), floor=8), dtype=np.uint8)
    for k, raw in enumerate(filters):
        flat[byte_off[k]:byte_off[k] + len(raw)] = raw
    row_bits = (byte_counts * 8).astype(np.uint32)
    words, valid, row_bits, byte_off = _pad_rows(
        words, valid, row_bits, byte_off, pad_off=0)
    return flat, words, valid, row_bits, byte_off


@_spanned('bloom_probe_wait')
def probe_bloom_filters_batch_finish(handle):
    """Materialize a `probe_bloom_filters_batch_begin` handle into the
    per-row lists of probe results."""
    out, hash_lists, rows, hit = handle
    if rows is None:
        return out
    hit = hit.cpu().numpy()
    for k, (i, _, _) in enumerate(rows):
        out[i] = [bool(h) for h in hit[k, :len(hash_lists[i])]]
    return out


def probe_bloom_filters_batch(filter_bytes, hash_lists, device=None):
    """Probe each row's hashes against that row's wire-format filter, all
    rows in ONE device dispatch (flat packed layout). `filter_bytes[i]` is
    a serialized filter (b'' = empty: contains nothing); `hash_lists[i]`
    the hex hashes to test. Returns a list of lists of bool (True =
    possibly contained)."""
    return probe_bloom_filters_batch_finish(
        probe_bloom_filters_batch_begin(filter_bytes, hash_lists, device))
