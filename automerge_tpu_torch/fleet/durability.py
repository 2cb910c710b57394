"""Crash-safe durability for the fleet: change journal, checkpoints, recovery.

This is the torch port's copy of automerge_tpu/fleet/durability.py. Its
one difference is the `device=` keyword of `DurableFleet(...)` and
`DurableFleet.recover(...)`: the torch device of the DocFleet they build
(CUDA unless the caller names another; with `fleet=` given, that fleet's
own device rules). The on-disk formats are the reference's, byte for
byte. The reference's description follows.

A process crash loses every in-memory document — the per-doc
``save()``/``load()`` round trip is a backup policy, not a durability
story. This module is the fleet-level one, the snapshot-plus-log shape of
the LSM lineage (PAPERS.md: LSM-OPD; SynchroStore's cost-based
compaction):

- ``ChangeJournal`` — an append-only log of CRC-framed records, each
  carrying a durable doc id plus raw change bytes. Appends buffer in
  memory and land in ONE ``write`` per group commit; ``fsync`` batches
  under a byte threshold so the group-commit cost amortizes across the
  batched seam. A change is crash-durable once the commit that covered
  it has fsynced (``durable_bytes``); everything after the last fsync is
  the explicit loss window (``pending_fsync_bytes``, reported through
  ``DocFleet.memory_stats``).
- Whole-fleet **checkpoints** — one snapshot file holding every
  registered document's canonical ``save()`` bytes (plus causally
  held-back queue entries), written via temp file + fsync + atomic
  rename, with a ``MANIFEST`` binding snapshot ↔ journal file/offset the
  same way. The journal rotates at each checkpoint, so replay debt
  resets to zero, and the old generation is deleted only after the new
  manifest is durable — a crash at ANY step leaves a recoverable pair on
  disk.
- ``DurableFleet.recover`` — loads the latest valid snapshot, truncates
  any torn journal tail at the first bad CRC frame, resynchronizes past
  mid-file bit rot (frame-magic scan), and replays the surviving suffix
  through ``apply_changes_docs(on_error='quarantine')`` so a single
  rotted record quarantines ONE document (typed error in the report,
  health counter incremented) while the rest of the fleet recovers —
  the same one-doc blast radius hostile wire bytes already get.
- Cost-triggered **compaction** — ``maybe_compact`` checkpoints once the
  journal's replay debt (bytes or records since the last checkpoint)
  crosses a threshold, so recovery time stays bounded by the compaction
  policy instead of history length.

Journal hooks live on the backend's mutation seams (``DocFleet.journal``
is consulted by ``FleetDoc.apply_changes``, the turbo batch commit in
``apply_changes_docs``, ``FleetDoc.free``/``free_docs`` and
``FleetDoc.clone``), so ordinary workloads — local commits, batched
applies, sync rounds through ``receive_sync_messages_docs`` — journal
transparently once a journal is attached. Documents are keyed by a
durable id the journal assigns (NOT the fleet slot: slots recycle on
free and vanish on promotion; the durable id survives both).

Failure envelope: every decode path here raises only typed errors —
``MalformedJournal``/``TornTail`` for journal frames,
``MalformedSnapshot`` for snapshot/manifest damage — and the journal
scanner itself never raises on arbitrary corruption: it returns the
surviving records plus a damage report (containment is the contract;
tools/fuzz_wire.py enforces it).
"""

import contextlib
import json
import os
import struct
import time
import weakref
import zlib

import numpy as np

from ..errors import (AutomergeError, DocError, MalformedJournal,
                      MalformedSnapshot, TornTail, as_wire_error)
from ..observability import register_health_source
from ..observability.metrics import Counters
from ..observability.perf import register_mem_source
from ..observability import hist as _hist
from ..observability import recorder as _flight
from ..observability.spans import (span as _span, span_seq as _span_seq,
                                   spanned as _spanned)

__all__ = [
    'ChangeJournal', 'DurableFleet', 'RecoveryReport',
    'KIND_CHANGE', 'KIND_FREE', 'KIND_DOC', 'KIND_QUEUED', 'KIND_END',
    'KIND_INIT', 'KIND_SMETA',
    'encode_frame', 'parse_journal_bytes', 'parse_snapshot_bytes',
    'parse_manifest_bytes', 'read_state', 'durability_stats',
    'pending_fsync_bytes_total', 'set_fsync_alert_threshold',
]

# ---------------------------------------------------------------------------
# Frame layout (journal and snapshot share it):
#
#   magic   2B  b'\xa6J'
#   kind    1B  record type
#   doc_id  4B  <I durable doc id
#   length  4B  <I payload length
#   hcrc    4B  <I crc32 over the 11-byte magic|kind|doc_id|length prefix
#   payload length bytes
#   pcrc    4B  <I crc32 over payload
#
# Two CRCs on purpose: a rotted PAYLOAD leaves the header trustworthy, so
# recovery can attribute the loss to exactly one doc and keep the stream
# (the frame boundary is still known); a rotted HEADER forfeits
# attribution and recovery resynchronizes by scanning for the next valid
# frame — the victim doc's later records then hold back at the causal
# gate, which contains the damage to that one doc anyway.
# ---------------------------------------------------------------------------

FRAME_MAGIC = b'\xa6J'
_MHEAD = struct.Struct('<2sBII')       # magic, kind, doc_id, length
_U32 = struct.Struct('<I')
FRAME_OVERHEAD = _MHEAD.size + 4 + 4   # prefix + hcrc + pcrc

KIND_CHANGE = 1      # journal: raw change (or document-chunk) bytes
KIND_FREE = 2        # journal: document freed (empty payload); in a
#                      SNAPSHOT SEGMENT: tombstone — the doc was freed
#                      since the previous segment and must not resurrect
KIND_DOC = 3         # snapshot: document save() bytes
KIND_QUEUED = 4      # snapshot: causally held-back queue buffer
KIND_END = 5         # snapshot/manifest: terminator
KIND_INIT = 6        # journal: document created, no changes yet
KIND_SMETA = 8       # snapshot: segment metadata (JSON: base flag, seq)
#                      — absent in pre-segment snapshots, which read as
#                      base (full) snapshots. Written with the sentinel
#                      doc id below (never a real durable id, which are
#                      assigned monotonically from 0), so payload rot in
#                      the SMETA frame reads as STRUCTURAL damage
#                      instead of quarantining document 0 — a segment
#                      whose base-ness cannot be trusted must not be
#                      stitched at all.
SMETA_DOC_ID = 0xfffffffe
# Columnar batch frame — the hot-seam format (ChangeJournal.record_seam):
# ONE outer frame whose doc_id field carries the record count and whose
# payload is two independently-CRC'd copies of a (doc_id, length,
# payload-crc32) table followed by the concatenated change payloads.
# Encoding cost is one crc32 call per record instead of per-record
# framing (the <=15% journal-overhead budget lives here), while damage
# stays record-localized: payload rot is attributed through the table's
# per-record crc, table rot falls back to the duplicate copy, and a torn
# tail salvages every record whose payload fully landed (the tables are
# front-loaded). Residual envelope: rot inside the outer frame's
# magic/kind/count bytes (7 per batch) loses the whole batch to the
# resync scan; length/hcrc/pcrc rot fully salvages.
KIND_BATCH = 7

_TBL = struct.Struct('<III')           # per-record: doc_id, length, pcrc
_BATCH_MIN = 8                         # below this, per-record frames win

SNAP_MAGIC = b'AMSN\x01'
MANIFEST_MAGIC = b'AMMF\x01'
MANIFEST_NAME = 'MANIFEST'

_MAX_FRAME = 1 << 31   # sanity ceiling on a declared payload length


def _crc(data):
    return zlib.crc32(data) & 0xffffffff


def encode_frame(kind, doc_id, payload):
    prefix = _MHEAD.pack(FRAME_MAGIC, kind, doc_id, len(payload))
    return b''.join((prefix, _U32.pack(_crc(prefix)),
                     payload, _U32.pack(_crc(payload))))


_TBL_DTYPE = np.dtype([('d', '<u4'), ('l', '<u4'), ('c', '<u4')])


def _encode_batch(dids, bufs):
    """One KIND_BATCH frame for parallel (doc_id, payload) lists: the
    outer doc_id field carries the count; the payload is two CRC'd table
    copies + concatenated payloads (format note at KIND_BATCH)."""
    crc = zlib.crc32
    count = len(bufs)
    tbl = np.empty(count, dtype=_TBL_DTYPE)
    tbl['d'] = dids
    tbl['l'] = np.fromiter(map(len, bufs), dtype=np.uint32, count=count)
    tbl['c'] = np.fromiter(map(crc, bufs), dtype=np.uint32, count=count)
    tb = tbl.tobytes()
    block = _U32.pack(crc(tb)) + tb
    total = 2 * len(block) + int(tbl['l'].sum())
    prefix = _MHEAD.pack(FRAME_MAGIC, KIND_BATCH, count, total)
    payload = b''.join([block, block] + bufs)
    return b''.join((prefix, _U32.pack(crc(prefix)), payload,
                     _U32.pack(crc(payload))))


def _read_batch_table(data, poff, count, limit):
    """One table block (u4 crc + count x 12B) at poff; None when it does
    not fit below `limit` or its crc fails."""
    tlen = 12 * count
    if poff + 4 + tlen > limit:
        return None
    (tcrc,) = _U32.unpack_from(data, poff)
    tbl = data[poff + 4:poff + 4 + tlen]
    if _crc(tbl) != tcrc:
        return None
    arr = np.frombuffer(tbl, dtype=_TBL_DTYPE)
    return arr['d'], arr['l'].astype(np.int64), arr['c']


def _batch_spans(data, off, count, limit):
    """(dids, rcrcs, starts, ends, expected_end) for a batch frame at
    `off`, using whichever table copy validates — None when neither
    does (the batch cannot be decoded)."""
    poff = off + _MHEAD.size + 4
    blk = 4 + 12 * count
    tbl = _read_batch_table(data, poff, count, limit)
    if tbl is None:
        tbl = _read_batch_table(data, poff + blk, count, limit)
    if tbl is None:
        return None
    dids, lens, rcrcs = tbl
    pstart = poff + 2 * blk
    ends = pstart + np.cumsum(lens)
    starts = ends - lens
    expected_end = (int(ends[-1]) if count else pstart) + 4
    return dids, rcrcs, starts, ends, expected_end


def _batch_decode(data, off, count, records, rotted, verified):
    """Decode a batch frame's records into `records`/`rotted` in order.
    verified=True (outer pcrc passed) skips the per-record crc walk;
    otherwise every record re-validates against its table crc, so
    payload rot is attributed to exactly its doc. Returns (resume_end,
    complete) or None when neither table copy survives."""
    spans = _batch_spans(data, off, count, len(data))
    if spans is None:
        return None
    dids, rcrcs, starts, ends, expected_end = spans
    n = len(data)
    crc = _crc
    for i in range(count):
        s, e = int(starts[i]), int(ends[i])
        if e > n:
            return (s, False)      # torn mid-payload: prefix salvaged
        if verified or crc(data[s:e]) == int(rcrcs[i]):
            records.append((KIND_CHANGE, int(dids[i]), data[s:e]))
        else:
            rotted.append((int(dids[i]), s, len(records)))
    if expected_end > n:
        return (int(ends[-1]) if count else n, False)
    return (expected_end, True)


def _frame_at(data, off):
    """Decode one frame at `off`. Returns (kind, doc_id, payload, end,
    status) with status 'ok' | 'rotted' (header valid, payload CRC bad —
    the boundary is still known) | 'badhead' | 'nomagic' | 'short'.
    Never raises."""
    n = len(data)
    if data[off:off + 2] != FRAME_MAGIC:
        return (None, None, None, off, 'nomagic')
    if off + _MHEAD.size + 4 > n:
        return (None, None, None, n, 'short')
    prefix = data[off:off + _MHEAD.size]
    (hcrc,) = _U32.unpack_from(data, off + _MHEAD.size)
    if _crc(prefix) != hcrc:
        return (None, None, None, off, 'badhead')
    _magic, kind, doc_id, length = _MHEAD.unpack(prefix)
    if length > _MAX_FRAME:
        return (None, None, None, off, 'badhead')
    poff = off + _MHEAD.size + 4
    end = poff + length + 4
    if end > n:
        return (None, None, None, n, 'short')
    payload = data[poff:poff + length]
    (pcrc,) = _U32.unpack_from(data, poff + length)
    if _crc(payload) != pcrc:
        return (kind, doc_id, None, end, 'rotted')
    return (kind, doc_id, payload, end, 'ok')


def parse_journal_bytes(data, offset=0, strict=False):
    """Journal scan. Returns (records, info): records is
    [(kind, doc_id, payload)] for every intact frame in order; info
    carries 'torn_tail_bytes' (trailing bytes dropped at the first frame
    that runs past EOF, or trailing garbage with no later valid frame),
    'rotted' ([(doc_id | None, byte_offset, record_index)] for mid-stream
    frames whose payload or header CRC failed — record_index is the
    number of intact records BEFORE the rot, so consumers can keep the
    victim's prefix), 'valid_end' (the offset appends may safely resume
    at — records salvaged from a torn BATCH frame may lie beyond it;
    truncating there drops them from the file, so re-persist replayed
    records before resuming, as recovery's re-checkpoint does) and
    'scanned_bytes'.

    Default (lenient) mode NEVER raises on hostile bytes — containment
    is the contract and recovery consumes the report. strict=True raises
    instead: TornTail for a torn tail, MalformedJournal for mid-stream
    rot (integrity-audit mode, and the typed-raise surface the wire
    fuzzer exercises)."""
    data = bytes(data)
    records = []
    rotted = []
    off = offset
    n = len(data)
    valid_end = offset
    torn = 0
    while off < n:
        kind, doc_id, payload, end, status = _frame_at(data, off)
        # Batch frames decode through their own table-driven path, which
        # tolerates outer-frame damage (rot or a torn tail) as long as
        # one table copy validates — damage localizes to the records it
        # actually hit. The kind byte is consulted even when the header
        # crc failed: salvage validates it implicitly through the table.
        if kind == KIND_BATCH or (
                status in ('short', 'badhead') and off + 3 <= n and
                data[off:off + 2] == FRAME_MAGIC and
                data[off + 2] == KIND_BATCH):
            count = doc_id if status in ('ok', 'rotted') else (
                _MHEAD.unpack_from(data, off)[2]
                if off + _MHEAD.size <= n else -1)
            out = None
            if 0 <= count <= (n - off) // 12 + 1:
                out = _batch_decode(data, off, count, records, rotted,
                                    verified=status == 'ok')
            if out is not None:
                bend, complete = out
                if not complete:
                    # torn mid-batch: records up to `bend` salvaged.
                    # valid_end stays at the FRAME start — that is the
                    # only safe append-resume point (the frame's outer
                    # header claims bytes past the tear, so appending
                    # at `bend` would be swallowed by a later parse);
                    # salvaged records beyond valid_end are already in
                    # `records` and recovery re-checkpoints them. torn
                    # is >= 1 even when only the trailing pcrc was cut,
                    # so an incomplete frame always reports as torn.
                    torn = max(n - bend, 1)
                    break
                off = valid_end = bend
                continue
            if status in ('ok', 'rotted'):
                # both table copies dead inside a structurally-bounded
                # frame: the batch is lost, unattributable
                rotted.append((None, off, len(records)))
                off = valid_end = end
                continue
            # short/badhead/nomagic with no salvageable table: fall
            # through to the generic torn-tail / resync handling
        if status == 'ok':
            records.append((kind, doc_id, payload))
            off = valid_end = end
            continue
        if status == 'rotted':
            # header intact, payload rotted: boundary known, loss
            # attributable to exactly this doc
            rotted.append((doc_id, off, len(records)))
            off = valid_end = end
            continue
        if status == 'short':
            # frame runs past EOF: a torn tail (the crash landed
            # mid-write) — truncate here
            torn = n - off
            break
        # nomagic / badhead: resynchronize — scan forward for the next
        # offset where a decodable frame begins; the skipped span is rot
        resync = None
        scan = off + 1
        while scan < n:
            scan = data.find(FRAME_MAGIC, scan)
            if scan < 0:
                break
            _k, _d, _p, _e, s2 = _frame_at(data, scan)
            if s2 in ('ok', 'rotted'):
                resync = scan
                break
            scan += 1
        if resync is None:
            torn = n - off
            break
        rotted.append((None, off, len(records)))
        off = resync
    if strict:
        if rotted:
            did, at, _idx = rotted[0]
            raise MalformedJournal(
                f'journal: rotted frame at byte {at}'
                + (f' (doc {did})' if did is not None else ''),
                doc_index=did)
        if torn:
            raise TornTail(f'journal: torn tail, {torn} trailing bytes '
                           f'after offset {valid_end}')
    return records, {
        'torn_tail_bytes': torn,
        'rotted': rotted,
        'valid_end': valid_end,
        'scanned_bytes': n - offset,
    }


def parse_snapshot_bytes(data):
    """Decode a snapshot (base or incremental segment) body. Returns
    (docs, queued, errors, meta): docs is {doc_id: save_bytes | None}
    (None = KIND_FREE tombstone — the doc was freed since the previous
    segment), queued {doc_id: [buffers]}, errors
    [(doc_id | None, MalformedSnapshot)] for rotted per-doc frames (one
    rotted frame quarantines ONE doc — the rest of the snapshot still
    loads), meta the segment's KIND_SMETA JSON ({'base': True} for
    pre-segment snapshots without one). Raises MalformedSnapshot only
    for STRUCTURAL damage: bad file magic, or a missing/corrupt END
    terminator (the snapshot cannot be proven complete)."""
    data = bytes(data)
    if data[:len(SNAP_MAGIC)] != SNAP_MAGIC:
        raise MalformedSnapshot('snapshot: bad magic')
    records, info = parse_journal_bytes(data, offset=len(SNAP_MAGIC))
    if info['torn_tail_bytes'] or not records or records[-1][0] != KIND_END:
        raise MalformedSnapshot('snapshot: missing or torn END terminator')
    _kind, _doc, end_payload = records[-1]
    try:
        (declared,) = _U32.unpack(end_payload)
    except struct.error as exc:
        raise MalformedSnapshot('snapshot: bad END payload') from exc
    body = records[:-1]
    if declared != len(body) + len(info['rotted']):
        raise MalformedSnapshot(
            f'snapshot: END declares {declared} records, found '
            f'{len(body)} intact + {len(info["rotted"])} rotted')
    errors = []
    for doc_id, at, _idx in info['rotted']:
        if doc_id == SMETA_DOC_ID:
            # rotted segment metadata: the segment's identity (base vs
            # incremental) is unknowable — structural damage
            raise MalformedSnapshot(
                f'snapshot: rotted segment metadata at byte {at}')
        errors.append((doc_id, MalformedSnapshot(
            f'snapshot: rotted frame at byte {at}'
            + (f' (doc {doc_id})' if doc_id is not None else ''),
            doc_index=doc_id)))
    docs, queued = {}, {}
    meta = {'base': True}
    for kind, doc_id, payload in body:
        if kind == KIND_DOC:
            docs[doc_id] = bytes(payload)
        elif kind == KIND_QUEUED:
            queued.setdefault(doc_id, []).append(bytes(payload))
        elif kind == KIND_FREE:
            docs[doc_id] = None
            queued.pop(doc_id, None)
        elif kind == KIND_SMETA:
            try:
                meta = json.loads(bytes(payload).decode('utf8'))
            except Exception as exc:
                raise as_wire_error(exc, MalformedSnapshot,
                                    'snapshot segment meta')
            if not isinstance(meta, dict):
                raise MalformedSnapshot('snapshot: bad segment meta')
        # unknown kinds: forward-compatible skip
    return docs, queued, errors, meta


def parse_manifest_bytes(data):
    """Decode a manifest: magic + ONE CRC frame of JSON. Raises
    MalformedSnapshot (the manifest is checkpoint metadata) on any
    damage."""
    data = bytes(data)
    if data[:len(MANIFEST_MAGIC)] != MANIFEST_MAGIC:
        raise MalformedSnapshot('manifest: bad magic')
    kind, _doc, payload, _end, status = _frame_at(data, len(MANIFEST_MAGIC))
    if status != 'ok' or kind != KIND_END:
        raise MalformedSnapshot(f'manifest: bad frame ({status})')
    try:
        meta = json.loads(payload.decode('utf8'))
    except Exception as exc:
        raise as_wire_error(exc, MalformedSnapshot, 'manifest json')
    if not isinstance(meta, dict) or 'seq' not in meta:
        raise MalformedSnapshot('manifest: missing fields')
    return meta


# ---------------------------------------------------------------------------
# health counters (observability roll-up; monotonic, module-level)
# ---------------------------------------------------------------------------

_stats = Counters({
    'checkpoints': 0,            # snapshots written (incl. compactions)
    'compactions': 0,            # cost-triggered checkpoints
    'journal_commits': 0,        # group commits
    'journal_fsyncs': 0,         # actual fsync calls (batching visible)
    'journal_records': 0,        # records appended (lifetime)
    'replayed_records': 0,       # journal records replayed at recovery
    'journal_truncations': 0,    # torn tails truncated at recovery
    'rotted_records': 0,         # mid-stream CRC failures contained
    'recovered_docs': 0,         # documents recovered from disk
    'fsync_window_alerts': 0,    # loss-window threshold crossings
    'segments': 0,               # incremental (per-doc) compaction segments
    'segment_docs': 0,           # doc frames written by incremental
    #                              compaction — the O(churn) signal: after
    #                              touching K of N docs this grows by K
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])

# The durability LOSS WINDOW as a first-class health signal: the sum of
# written-but-not-fsynced bytes across every open journal. The brownout
# ladder WIDENS this window deliberately (stage 1 raises fsync_bytes);
# registering it here is what lets operators — and the overload tests —
# watch the window move instead of trusting the policy. Crossing the
# alert threshold is edge-triggered per journal into the
# 'fsync_window_alerts' counter + a flight-recorder event.

_open_journals = weakref.WeakSet()
# The alert only fires while pending < fsync_bytes (a commit at or past
# fsync_bytes fsyncs instead, closing the window), so the threshold must
# sit BELOW the widest fsync batching in use or it is unreachable: 1 MB
# default, under the brownout stage-1 widen ceiling (4 MB).
_fsync_alert_bytes = int(os.environ.get(
    'AUTOMERGE_TPU_FSYNC_ALERT_BYTES', 1 << 20))


def set_fsync_alert_threshold(n_bytes):
    """Configure the loss-window alert threshold (bytes; <= 0 disables).
    Returns the previous value."""
    global _fsync_alert_bytes
    prev = _fsync_alert_bytes
    _fsync_alert_bytes = int(n_bytes)
    return prev


def pending_fsync_bytes_total():
    """Sum of every open journal's pending_fsync_bytes — the bytes a
    crash right now would lose (on top of unwritten buffers)."""
    return sum(j.pending_fsync_bytes for j in _open_journals
               if not j.closed)


register_health_source('pending_fsync_bytes', pending_fsync_bytes_total)
# ...and the same number as a memory-watermark tier: the loss window is
# ALSO resident bytes (buffered records waiting on the fsync cadence)
register_mem_source('journal_pending_fsync_bytes',
                    pending_fsync_bytes_total)


def durability_stats():
    """Snapshot of this module's monotonic counters (also visible via
    observability.health_counts)."""
    return dict(_stats)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, data):
    """temp file + fsync + atomic rename + directory fsync: after this
    returns, `path` durably holds exactly `data` (or, across a crash,
    its previous content — never a torn mix)."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or '.')


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


class ChangeJournal:
    """Append-only CRC-framed change log with group commit.

    ``append`` only buffers; ``commit`` lands the whole buffer in ONE
    write and fsyncs when the unsynced backlog passes ``fsync_bytes``
    (0 = fsync on every commit, the strict default). ``sync`` forces
    write + fsync. The journal also owns the durable-doc-id registry:
    ``doc_id_for(state)`` assigns a monotonic id to a document the first
    time it journals and keeps a reference so checkpoints can snapshot
    every journaled document without callers maintaining a registry."""

    def __init__(self, path, fsync_bytes=0, docs=None, next_doc_id=0):
        self.path = path
        self.fsync_bytes = int(fsync_bytes)
        self.docs = docs if docs is not None else {}   # doc_id -> state
        self.next_doc_id = next_doc_id
        self._f = open(path, 'ab')
        self._pending = bytearray()
        self._group_depth = 0     # >0: commits defer to group() exit
        size = os.path.getsize(path)
        self.written_bytes = size       # bytes handed to the OS
        self.durable_bytes = size       # bytes known fsynced
        self.records = 0                # records appended this generation
        # Churn tracking for incremental compaction: every doc id that
        # journaled a record this generation (dirty), and the subset
        # freed. Compaction re-persists EXACTLY the dirty set — work
        # proportional to churn, not fleet size (SynchroStore).
        self.dirty = set()
        self.freed = set()
        self.closed = False
        self._window_alerted = False    # edge trigger for the loss alert
        _open_journals.add(self)

    # -- doc identity ---------------------------------------------------

    def doc_id_for(self, state):
        """Durable id for a document state, assigning and registering on
        first use. Ids are monotonic and never recycled, so they survive
        slot reuse and promotion."""
        did = getattr(state, '_dur_id', None)
        if did is not None and self.docs.get(did) is state:
            return did
        did = self.next_doc_id
        self.next_doc_id += 1
        try:
            state._dur_id = did
        except AttributeError:
            pass                      # non-slotted stand-ins (tests)
        self.docs[did] = state
        return did

    # -- appends --------------------------------------------------------

    @property
    def buffered_bytes(self):
        return len(self._pending)

    @property
    def pending_fsync_bytes(self):
        """Bytes written but not yet fsynced — the crash-loss window on
        top of whatever is still buffered."""
        return self.written_bytes - self.durable_bytes

    def append(self, doc_id, payload, kind=KIND_CHANGE):
        self._pending += encode_frame(kind, doc_id, bytes(payload))
        self.records += 1
        self.dirty.add(doc_id)
        _stats.inc('journal_records')

    def record_changes(self, state, buffers, commit=True):
        """Journal a batch of accepted change buffers for one document
        (the seam hook entry point)."""
        did = self.doc_id_for(state)
        for buf in buffers:
            self.append(did, buf)
        if commit:
            self.commit()

    @_spanned('journal_append')
    def record_seam(self, handles, per_doc_changes, errors=None):
        """The hot seam hook for the 10k-doc turbo batch: every ACCEPTED
        doc's buffers collected in one flattened pass and framed as a
        single columnar KIND_BATCH frame — one crc32 call per record
        instead of per-record framing; this path is what the <=15%
        journal-overhead budget is measured on. Small batches (below
        _BATCH_MIN) keep per-record frames, whose fixed overhead is
        lower. Docs with errors[d] set contribute nothing — the journal
        never holds refused bytes."""
        docs = self.docs
        next_id = self.next_doc_id
        dids = []
        bufs = []
        add_d = dids.append
        add_b = bufs.append
        for d, (handle, buffers) in enumerate(zip(handles,
                                                  per_doc_changes)):
            if not buffers or (errors is not None and
                               errors[d] is not None):
                continue
            state = handle['state']
            did = getattr(state, '_dur_id', None)
            if did is None or docs.get(did) is not state:
                did = next_id
                next_id += 1
                try:
                    state._dur_id = did
                except AttributeError:
                    pass
                docs[did] = state
            if len(buffers) == 1:        # the overwhelmingly common shape
                buf = buffers[0]
                add_d(did)
                add_b(buf if type(buf) is bytes else bytes(buf))
            else:
                for buf in buffers:
                    add_d(did)
                    add_b(buf if type(buf) is bytes else bytes(buf))
        n_rec = len(bufs)
        if not n_rec:
            return
        self.next_doc_id = next_id
        if n_rec < _BATCH_MIN:
            for did, buf in zip(dids, bufs):
                self._pending += encode_frame(KIND_CHANGE, did, buf)
        else:
            self._pending += _encode_batch(dids, bufs)
        self.records += n_rec
        self.dirty.update(dids)
        _stats.inc('journal_records', n_rec)
        self.commit()

    def record_free(self, state, commit=True):
        """Journal a document free. No-op for documents that never
        journaled (nothing durable to retract)."""
        did = getattr(state, '_dur_id', None)
        if did is None or self.docs.get(did) is not state:
            return
        self.append(did, b'', kind=KIND_FREE)
        self.freed.add(did)
        self.docs.pop(did, None)
        if commit:
            self.commit()

    # -- durability -----------------------------------------------------

    @contextlib.contextmanager
    def group(self):
        """Defer commits to the end of the block: per-doc apply paths
        inside a batched call journal through FleetDoc.apply_changes,
        whose own commit would otherwise write+fsync once per DOCUMENT
        instead of once per batch. Reentrant; the exit commit covers
        whatever was accepted even when the block raises mid-batch."""
        self._group_depth += 1
        try:
            yield
        finally:
            self._group_depth -= 1
            if self._group_depth == 0:
                self.commit()

    def commit(self):
        """Group commit: one write for everything buffered, fsync under
        the batching policy. Inside a group() block this is a no-op —
        the block's exit performs the single real commit."""
        if self._group_depth > 0:
            return
        with _span('journal_commit', bytes=len(self._pending)):
            if self._pending:
                self._f.write(self._pending)
                self._f.flush()
                self.written_bytes += len(self._pending)
                self._pending = bytearray()
            _stats.inc('journal_commits')
            if self.fsync_bytes <= 0 or \
                    self.pending_fsync_bytes >= self.fsync_bytes:
                self._fsync()
            else:
                self._check_loss_window()

    def sync(self):
        """Force full durability: write + fsync regardless of policy."""
        if self._pending:
            self._f.write(self._pending)
            self._f.flush()
            self.written_bytes += len(self._pending)
            self._pending = bytearray()
        self._fsync()

    def _fsync(self):
        if self.durable_bytes == self.written_bytes:
            return
        start = time.perf_counter()
        with _span('journal_fsync',
                   bytes=self.written_bytes - self.durable_bytes):
            os.fsync(self._f.fileno())
        _hist.record_value('fsync_s', time.perf_counter() - start,
                           scale=1e9, unit='s')
        self.durable_bytes = self.written_bytes
        _stats.inc('journal_fsyncs')
        self._window_alerted = False    # window closed; re-arm the alert

    def _check_loss_window(self):
        """Edge-triggered loss-window alert: the first commit that
        leaves pending_fsync_bytes above the configured threshold bumps
        'fsync_window_alerts' and lands a flight event; the alert
        re-arms when an fsync closes the window."""
        if _fsync_alert_bytes <= 0 or self._window_alerted:
            return
        pending = self.pending_fsync_bytes
        if pending >= _fsync_alert_bytes:
            self._window_alerted = True
            _stats.inc('fsync_window_alerts')
            _flight.record_event('fsync_window_alert', path=self.path,
                                 pending_bytes=pending,
                                 threshold=_fsync_alert_bytes,
                                 fsync_bytes=self.fsync_bytes)

    def close(self):
        if not self.closed:
            self.sync()
            self._f.close()
            self.closed = True

    def stats(self):
        return {
            'buffered_bytes': self.buffered_bytes,
            'pending_fsync_bytes': self.pending_fsync_bytes,
            'durable_bytes': self.durable_bytes,
            'written_bytes': self.written_bytes,
            'records': self.records,
            'registered_docs': len(self.docs),
        }


# ---------------------------------------------------------------------------
# recovery report
# ---------------------------------------------------------------------------


class RecoveryReport:
    """What recovery found and did. ``quarantined`` maps doc_id ->
    DocError for documents whose snapshot frame or journal records were
    rejected (typed; the rest of the fleet recovered); ``ok`` is True
    when nothing was quarantined or truncated."""

    __slots__ = ('manifest_seq', 'used_fallback_manifest', 'snapshot_docs',
                 'queued_buffers', 'replayed_records', 'replayed_bytes',
                 'torn_tail_bytes', 'rotted_records', 'quarantined',
                 'freed_docs')

    def __init__(self):
        self.manifest_seq = None
        self.used_fallback_manifest = False
        self.snapshot_docs = 0
        self.queued_buffers = 0
        self.replayed_records = 0
        self.replayed_bytes = 0
        self.torn_tail_bytes = 0
        self.rotted_records = 0
        self.quarantined = {}
        self.freed_docs = []

    @property
    def ok(self):
        return not self.quarantined and not self.torn_tail_bytes and \
            not self.rotted_records

    def __repr__(self):
        return (f'RecoveryReport(seq={self.manifest_seq}, '
                f'snapshot_docs={self.snapshot_docs}, '
                f'replayed={self.replayed_records}, '
                f'torn_tail={self.torn_tail_bytes}, '
                f'rotted={self.rotted_records}, '
                f'quarantined={sorted(self.quarantined)}, '
                f'freed={self.freed_docs})')


def _snap_name(seq):
    return f'snapshot-{seq:08d}.snap'


def _journal_name(seq):
    return f'journal-{seq:08d}.log'


def _stitch_segments(path, names):
    """Load + stitch a snapshot-segment chain (oldest -> newest). Raises
    MalformedSnapshot / OSError through — callers decide fallback
    policy."""
    results = []
    for name in names:
        with open(os.path.join(path, name), 'rb') as f:
            results.append(parse_snapshot_bytes(f.read()))
    return _stitch_parsed(results)


def _stitch_parsed(seg_results):
    """Stitch already-parsed segments (oldest -> newest): a later
    KIND_DOC supersedes earlier copies (and replaces the doc's queued
    list), a KIND_FREE tombstone erases the doc. Per-doc rot errors from
    an OLDER segment are dropped when a newer segment supersedes the doc
    (the newest persisted copy is what matters)."""
    docs, queued = {}, {}
    errors_by_doc = {}
    unattributed = []
    for seg_docs, seg_queued, seg_errors, _meta in seg_results:
        for did, payload in seg_docs.items():
            if payload is None:
                docs.pop(did, None)
                queued.pop(did, None)
                errors_by_doc.pop(did, None)
            else:
                docs[did] = payload
                queued[did] = seg_queued.get(did, [])
                if not queued[did]:
                    queued.pop(did, None)
                errors_by_doc.pop(did, None)
        for did, err in seg_errors:
            if did is None:
                unattributed.append((None, err))
            else:
                errors_by_doc[did] = err
                # the newest copy of this doc is rot: an older stitched
                # copy (if any) becomes the doc's last good prefix
    errors = unattributed + [(did, err)
                             for did, err in sorted(errors_by_doc.items())]
    return docs, queued, errors


def read_state(path):
    """Low-level recovery inputs from a durability directory, backend
    agnostic (the chaos harness rebuilds host-backend peers from this).
    Returns a dict with 'manifest', 'docs' {doc_id: save_bytes} (the
    STITCHED view over the manifest's segment chain — base snapshot plus
    incremental per-doc compaction segments, tombstones applied),
    'queued' {doc_id: [buffers]}, 'snapshot_errors'
    [(doc_id | None, MalformedSnapshot)], 'journal_records'
    [(kind, doc_id, payload)], 'journal_info' (parse_journal_bytes
    report) and 'used_fallback_manifest'. Raises MalformedSnapshot only
    when no valid manifest AND no structurally-valid snapshot exists but
    damaged ones do (an unrecoverable directory)."""
    manifest = None
    fallback = False
    stitched = None
    mpath = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(mpath):
        try:
            with open(mpath, 'rb') as f:
                manifest = parse_manifest_bytes(f.read())
        except (MalformedSnapshot, OSError):
            manifest = None
    if manifest is not None:
        chain = manifest.get('chain')
        if chain is None:           # pre-segment manifest
            chain = [manifest['snapshot']] if manifest.get('snapshot') \
                else []
        manifest['chain'] = chain
        try:
            stitched = _stitch_segments(path, chain)
        except (MalformedSnapshot, OSError):
            stitched = None
            manifest = None           # fall back to the directory scan
    journal_start = None
    if manifest is None:
        # manifest missing or pointing at damage: scan for the newest
        # structurally-valid BASE snapshot on disk, then stitch every
        # structurally-valid newer segment on top of it (invalid ones
        # are skipped — their docs fall back to older copies)
        fallback = True
        found_damaged = False
        snaps = []
        for name in os.listdir(path):
            if name.startswith('snapshot-') and name.endswith('.snap'):
                try:
                    snaps.append(
                        (int(name[len('snapshot-'):-len('.snap')]), name))
                except ValueError:
                    continue
        parsed = {}
        base_seq = None
        for fseq, name in sorted(snaps, reverse=True):
            try:
                with open(os.path.join(path, name), 'rb') as f:
                    parsed[fseq] = (name, parse_snapshot_bytes(f.read()))
            except (MalformedSnapshot, OSError):
                found_damaged = True
                continue
            if parsed[fseq][1][3].get('base', True):
                base_seq = fseq
                break
        if base_seq is not None:
            valid = sorted(s for s in parsed if s >= base_seq)
            chain = [parsed[s][0] for s in valid]
            # stitch from the results the scan ALREADY parsed — no
            # second read (and no unguarded I/O escaping the fallback)
            stitched = _stitch_parsed([parsed[s][1] for s in valid])
            manifest = {'seq': valid[-1], 'snapshot': chain[-1],
                        'chain': chain,
                        'journal': _journal_name(valid[-1]),
                        'journal_offset': 0}
            # older journals may survive retention: replay everything on
            # disk from the base generation up (idempotent over segment
            # content — the hash graph dedupes, FREE follows its doc's
            # changes within a journal, ids never recycle)
            journal_start = base_seq
        else:
            if found_damaged:
                raise MalformedSnapshot(
                    'no valid manifest or snapshot in durability dir '
                    '(damaged snapshots present)')
            # brand-new or journal-only directory: synthesize gen 0
            journals = sorted((f for f in os.listdir(path)
                               if f.startswith('journal-')
                               and f.endswith('.log')), reverse=True)
            seq = int(journals[0][len('journal-'):-len('.log')]) \
                if journals else 0
            manifest = {'seq': seq, 'snapshot': None, 'chain': [],
                        'journal': _journal_name(seq), 'journal_offset': 0}
            journal_start = 0
    docs, queued, snap_errors = stitched if stitched is not None \
        else ({}, {}, [])
    # Journal CHAIN replay: walk journal files upward from the chosen
    # generation (fallback mode: from the base generation, skipping
    # retention gaps). Normally there is exactly one; a crash
    # mid-checkpoint leaves an empty successor, and a fallback onto an
    # OLDER retained generation finds the retained journals — so a
    # single rotted segment never costs the suffix.
    journal_records, journal_info = [], {
        'torn_tail_bytes': 0, 'rotted': [], 'valid_end': 0,
        'scanned_bytes': 0}
    seq = int(manifest['seq'])
    if journal_start is not None:
        jseqs = []
        for name in os.listdir(path):
            if name.startswith('journal-') and name.endswith('.log'):
                try:
                    js = int(name[len('journal-'):-len('.log')])
                except ValueError:
                    continue
                if js >= journal_start:
                    jseqs.append(js)
        jseqs.sort()
    else:
        jseqs = []
        s = seq
        while os.path.exists(os.path.join(path, _journal_name(s))):
            jseqs.append(s)
            s += 1
    for s in jseqs:
        jp = os.path.join(path, _journal_name(s))
        if not os.path.exists(jp):
            continue
        with open(jp, 'rb') as f:
            jbytes = f.read()
        recs, inf = parse_journal_bytes(
            jbytes,
            offset=int(manifest.get('journal_offset') or 0)
            if s == seq else 0)
        base = len(journal_records)
        journal_records += recs
        journal_info['torn_tail_bytes'] += inf['torn_tail_bytes']
        journal_info['rotted'] += [(did, at, base + idx)
                                   for did, at, idx in inf['rotted']]
        journal_info['valid_end'] = inf['valid_end']
        journal_info['scanned_bytes'] += inf['scanned_bytes']
    return {
        'manifest': manifest,
        'docs': docs,
        'queued': queued,
        'snapshot_errors': snap_errors,
        'journal_records': journal_records,
        'journal_info': journal_info,
        'used_fallback_manifest': fallback,
        'max_journal_seq': jseqs[-1] if jseqs else seq,
    }


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class DurableFleet:
    """A DocFleet bound to a durability directory: journaled mutation
    seams, whole-fleet checkpoints, cost-triggered compaction, crash
    recovery.

    ``DurableFleet(path)`` starts a FRESH durability directory (raises
    if one already holds a manifest — recover instead);
    ``DurableFleet.recover(path)`` rebuilds the fleet from disk.
    Checkpointing is synchronous with the caller: do not interleave it
    with applies from another thread (the rest of the engine is
    single-threaded by contract too).

    ``device`` (the port's one difference from the reference) is the
    torch device of the DocFleet built here: CUDA unless the caller
    names another; ignored when ``fleet`` is given."""

    def __init__(self, path, fleet=None, *, exact_device=False, device=None,
                 fsync_bytes=0, compact_bytes=16 << 20,
                 compact_records=100_000, retain=2, max_chain=8,
                 doc_capacity=64, key_capacity=64, _recovered=None):
        from .backend import DocFleet
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.fsync_bytes = fsync_bytes
        self.compact_bytes = compact_bytes
        self.compact_records = compact_records
        # generations kept on disk: the newest (snapshot, journal) pair
        # plus retain-1 predecessors, so structural rot in the newest
        # snapshot falls back to the previous generation and replays the
        # retained journal chain instead of failing fleet-wide
        self.retain = max(int(retain), 1)
        # incremental segments allowed on top of the base snapshot before
        # compaction escalates to a full checkpoint (bounds recovery's
        # stitch work and the chain's disk amplification)
        self.max_chain = max(int(max_chain), 1)
        if _recovered is not None:
            # internal: recovery built the fleet + registry already; the
            # closing persist RE-JOURNALS what replay applied instead of
            # re-snapshotting the whole fleet — recovery work stays
            # proportional to the replayed suffix, not fleet size
            (self.fleet, last_seq, docs, next_doc_id, chain,
             rejournal) = _recovered
            self.chain = list(chain)
            new_seq = int(last_seq) + 1
            self.seq = new_seq
            self.journal = ChangeJournal(
                os.path.join(path, _journal_name(new_seq)),
                fsync_bytes=fsync_bytes, docs=docs,
                next_doc_id=next_doc_id)
            # re-frame the replayed records; runs of CHANGE records use
            # the columnar batch frame (one crc32 per record, the hot
            # seam format) so the closing persist stays cheap at scale
            pend_d, pend_b = [], []

            def _flush_changes():
                if not pend_b:
                    return
                if len(pend_b) < _BATCH_MIN:
                    for did, buf in zip(pend_d, pend_b):
                        self.journal._pending += encode_frame(
                            KIND_CHANGE, did, buf)
                else:
                    self.journal._pending += _encode_batch(pend_d, pend_b)
                self.journal.records += len(pend_b)
                self.journal.dirty.update(pend_d)
                _stats.inc('journal_records', len(pend_b))
                pend_d.clear()
                pend_b.clear()

            for kind, did, payload in rejournal:
                if kind == KIND_CHANGE:
                    pend_d.append(did)
                    pend_b.append(bytes(payload))
                    continue
                _flush_changes()
                self.journal.append(did, payload, kind=kind)
                if kind == KIND_FREE:
                    self.journal.freed.add(did)
            _flush_changes()
            self.journal.sync()
            self._fault('journal-rotated')
            self._write_manifest()
            self._fault('manifest-flipped')
            self._retention_sweep(new_seq)
            self.fleet.attach_journal(self.journal)
            return
        if os.path.exists(os.path.join(path, MANIFEST_NAME)) or \
                any(f.startswith(('snapshot-', 'journal-'))
                    for f in os.listdir(path)):
            raise ValueError(
                f'{path!r} already holds a durable fleet: use '
                f'DurableFleet.recover()')
        self.fleet = fleet if fleet is not None else DocFleet(
            doc_capacity=doc_capacity, key_capacity=key_capacity,
            exact_device=exact_device, device=device)
        self.seq = 0
        self.chain = []
        self.journal = ChangeJournal(
            os.path.join(path, _journal_name(0)), fsync_bytes=fsync_bytes)
        self._write_manifest()
        self.fleet.attach_journal(self.journal)

    # -- document lifecycle --------------------------------------------

    def init_docs(self, n):
        """Create n journaled fleet documents. Each gets an INIT record,
        so even never-edited documents survive a crash before the next
        checkpoint (alloc -> crash -> recover keeps the empty doc)."""
        from . import backend as fleet_backend
        handles = fleet_backend.init_docs(n, self.fleet)
        for handle in handles:
            did = self.journal.doc_id_for(handle['state'])
            self.journal.append(did, b'', kind=KIND_INIT)
        self.journal.commit()
        return handles

    def load_docs(self, buffers):
        """Bulk-load saved documents AND journal their chunks, so a crash
        before the next checkpoint replays the load."""
        from .loader import load_docs
        handles = load_docs([bytes(b) for b in buffers], self.fleet)
        for handle, buf in zip(handles, buffers):
            did = self.journal.doc_id_for(handle['state'])
            self.journal.append(did, bytes(buf))
        self.journal.commit()
        return handles

    def adopt(self, handle):
        """Bring an existing fleet document under durability: journal its
        full current history (one document chunk) as the baseline."""
        state = handle['state']
        did = self.journal.doc_id_for(state)
        self.journal.append(did, bytes(state.save()))
        self.journal.commit()
        return did

    def apply_changes(self, handles, per_doc_changes, mirror=False,
                      on_error='quarantine'):
        """Journaled batched apply (the seam hooks do the journaling;
        this wrapper adds the compaction check)."""
        from . import backend as fleet_backend
        out = fleet_backend.apply_changes_docs(
            handles, per_doc_changes, mirror=mirror, on_error=on_error)
        self.maybe_compact()
        return out

    def handles(self):
        """{doc_id: fresh backend handle} for every registered live
        document."""
        return {did: {'state': state, 'heads': list(state.heads)}
                for did, state in sorted(self.journal.docs.items())}

    def adopt_fleet(self, fleet):
        """Point the manager at a rebuilt fleet. backend.rebuild_docs
        (the donation-failure recovery) moves the journal and each doc's
        durable id to the new fleet already; this updates the manager's
        own reference so checkpoints keep re-attaching the rotated
        journal to the fleet that is actually live."""
        self.fleet = fleet
        if fleet.journal is None:
            fleet.attach_journal(self.journal)

    # -- replay debt / compaction --------------------------------------

    def replay_debt(self):
        """Bytes/records recovery would replay if the process died now."""
        j = self.journal
        return {'bytes': j.written_bytes + j.buffered_bytes,
                'records': j.records}

    def chain_debt(self):
        """Stitch debt of the incremental chain: the segments past the
        base snapshot and their on-disk bytes — what recovery must open
        and scan ON TOP of the base, and what the retention sweep must
        keep protected. Feeds CostModel.chain_escalate_due."""
        tail = self.chain[1:]
        total = 0
        for name in tail:
            try:
                total += os.path.getsize(os.path.join(self.path, name))
            except OSError:
                pass
        return {'segments': len(tail), 'bytes': total}

    def base_bytes(self):
        """On-disk size of the chain's base snapshot (0 when none) —
        the dominant term of a full checkpoint's rewrite cost."""
        if not self.chain:
            return 0
        try:
            return os.path.getsize(os.path.join(self.path, self.chain[0]))
        except OSError:
            return 0

    def maybe_compact(self, force=False):
        """Compact once replay debt crosses the byte/record threshold
        (the LSM-style cost trigger). Compaction is INCREMENTAL: only
        documents with journaled records this generation re-persist (a
        per-doc segment, SynchroStore-style) — touching K of N docs does
        O(K) work; the chain escalates to a full checkpoint after
        `max_chain` segments. Returns True if it compacted."""
        debt = self.replay_debt()
        if not force and debt['bytes'] < self.compact_bytes and \
                debt['records'] < self.compact_records:
            return False
        with _span('compaction', debt_bytes=debt['bytes'],
                   debt_records=debt['records']):
            did_work = self.compact()
        if did_work:
            _stats.inc('compactions')
        return did_work

    # -- checkpointing --------------------------------------------------

    def _write_manifest(self):
        meta = {'seq': self.seq,
                'snapshot': self.chain[-1] if self.chain else None,
                'chain': list(self.chain),
                'journal': _journal_name(self.seq), 'journal_offset': 0,
                'next_doc_id': self.journal.next_doc_id}
        payload = json.dumps(meta, sort_keys=True).encode('utf8')
        _atomic_write(os.path.join(self.path, MANIFEST_NAME),
                      MANIFEST_MAGIC + encode_frame(KIND_END, 0, payload))

    def _write_segment(self, new_seq, doc_items, tombstones, base):
        """Write one snapshot file (base or incremental segment) via
        temp + fsync + atomic rename. Returns (name, docs_written)."""
        snap_name = _snap_name(new_seq)
        tmp = os.path.join(self.path, snap_name + '.tmp')
        n_frames = 1
        n_docs = 0
        with open(tmp, 'wb') as f:
            f.write(SNAP_MAGIC)
            f.write(encode_frame(KIND_SMETA, SMETA_DOC_ID, json.dumps(
                {'base': bool(base), 'seq': new_seq},
                sort_keys=True).encode('utf8')))
            for did, state in doc_items:
                f.write(encode_frame(KIND_DOC, did, bytes(state.save())))
                n_frames += 1
                n_docs += 1
                for entry in getattr(state, 'queue', []) or []:
                    buf = entry.get('buffer') if isinstance(entry, dict) \
                        else None
                    if buf is not None:
                        f.write(encode_frame(KIND_QUEUED, did, bytes(buf)))
                        n_frames += 1
            for did in sorted(tombstones):
                f.write(encode_frame(KIND_FREE, did, b''))
                n_frames += 1
            f.write(encode_frame(KIND_END, 0, _U32.pack(n_frames)))
            f.flush()
            os.fsync(f.fileno())
        self._fault('snapshot-temp-written')
        os.replace(tmp, os.path.join(self.path, snap_name))
        _fsync_dir(self.path)
        self._fault('snapshot-renamed')
        return snap_name, n_docs

    def _rotate_and_flip(self, new_seq, live, next_doc_id):
        """Steps 3-5 of the checkpoint protocol: fresh journal
        generation, manifest flip, retention sweep."""
        # A stale successor journal (crash mid-checkpoint, or the
        # generation a fallback recovery just consumed) is removed only
        # NOW — after the snapshot that supersedes its records is
        # durable. Removing it earlier would lose fsynced changes if we
        # died during the snapshot write. The crash window between the
        # rename and this remove is safe: recovery would replay the
        # stale journal's records on top of a snapshot that already
        # contains them, and change application is idempotent (the hash
        # graph dedupes known changes — verified for turbo, exact and
        # bulk-loaded docs).
        new_path = os.path.join(self.path, _journal_name(new_seq))
        if os.path.exists(new_path):
            os.remove(new_path)
        if self.journal is not None:
            self.journal.close()
        self.seq = new_seq
        self.journal = ChangeJournal(
            new_path, fsync_bytes=self.fsync_bytes, docs=live,
            next_doc_id=next_doc_id)
        self.fleet.attach_journal(self.journal)
        self._fault('journal-rotated')
        self._write_manifest()
        self._fault('manifest-flipped')
        self._retention_sweep(new_seq)

    def _retention_sweep(self, new_seq):
        """Keep the newest `retain` generations plus every snapshot the
        live chain still references; delete the rest."""
        protected = set(self.chain)
        for name in os.listdir(self.path):
            for prefix, suffix in (('snapshot-', '.snap'),
                                   ('journal-', '.log')):
                if name.startswith(prefix) and name.endswith(suffix):
                    if name in protected:
                        continue
                    try:
                        fseq = int(name[len(prefix):-len(suffix)])
                    except ValueError:
                        continue
                    if fseq <= new_seq - self.retain or fseq > new_seq:
                        try:
                            os.remove(os.path.join(self.path, name))
                        except OSError:
                            pass

    @_spanned('checkpoint')
    def checkpoint(self):
        """Whole-fleet BASE snapshot + journal rotation, crash-safe at
        every step: (1) everything journaled so far is fsynced, (2) the
        snapshot lands via temp + fsync + atomic rename, (3) a fresh
        journal generation is created, (4) the manifest atomically
        flips to the new pair, (5) only then is the old generation
        deleted — a crash anywhere leaves the manifest pointing at a
        complete (snapshot chain, journal) pair. The segment chain
        resets to this snapshot."""
        self.journal.sync()
        docs = self.journal.docs
        next_doc_id = self.journal.next_doc_id
        # drop freed/dead documents from the registry (their FREE records
        # die with the rotated journal)
        live = {did: state for did, state in docs.items()
                if getattr(state, '_impl', True) is not None}
        new_seq = self.seq + 1
        snap_name, _n = self._write_segment(new_seq, sorted(live.items()),
                                            (), base=True)
        self.chain = [snap_name]
        self._rotate_and_flip(new_seq, live, next_doc_id)
        _stats.inc('checkpoints')

    @_spanned('compact_segment')
    def compact(self):
        """Incremental per-doc compaction: persist ONLY the documents
        that journaled records this generation (plus tombstones for the
        freed) as one segment appended to the chain, then rotate the
        journal — replay debt resets to zero at O(churn) cost. The
        chain escalates to a full checkpoint past `max_chain` segments
        (bounding stitch work and disk amplification). Returns True when
        anything was persisted (incl. the escalated full checkpoint),
        False when zero churn made it a no-op. Recovery stitches the
        chain; byte-identical to a full-checkpoint recovery."""
        escalate = not self.chain or len(self.chain) >= self.max_chain
        model = getattr(self, 'cost_model', None)
        if not escalate and model is not None:
            # the attached cost model (TieringController wires it) may
            # escalate EARLIER than the fixed ceiling when the chain's
            # stitch debt already outweighs the full rewrite; max_chain
            # stays the hard backstop bounding stitch work absolutely
            escalate = model.chain_escalate_due(
                self, stage=getattr(self, 'pressure_stage', 0))
        if escalate:
            # no base yet (a fleet that never checkpointed): segments
            # without a base are invisible to the manifest-rot fallback
            # scan, and retention would eventually delete the journals
            # holding their records — the first compaction MUST cut the
            # base snapshot
            self.checkpoint()
            return True
        self.journal.sync()
        docs = self.journal.docs
        next_doc_id = self.journal.next_doc_id
        dirty = set(self.journal.dirty)
        freed = set(self.journal.freed)
        live = {did: state for did, state in docs.items()
                if getattr(state, '_impl', True) is not None}
        # dirty docs that died without surviving to the registry (freed,
        # or detached by rebuild/promotion) tombstone — they must not
        # resurrect from an older segment copy
        tombstones = freed | {did for did in dirty if did not in live}
        doc_items = sorted((did, live[did]) for did in dirty
                           if did in live)
        if not doc_items and not tombstones:
            return False                 # nothing journaled: no-op
        new_seq = self.seq + 1
        snap_name, n_docs = self._write_segment(new_seq, doc_items,
                                                tombstones, base=False)
        self.chain = self.chain + [snap_name]
        self._rotate_and_flip(new_seq, live, next_doc_id)
        _stats.inc('segments')
        _stats.inc('segment_docs', n_docs)
        return True

    def _fault(self, point):
        """Crash-point hook: a no-op in production; tools/crashtest.py
        overrides it to simulate dying at each step of the checkpoint
        protocol (every step must leave a recoverable directory)."""

    def close(self):
        """Flush + fsync the journal and DETACH it from the fleet, so a
        closed manager's fleet can keep operating (un-journaled) instead
        of writing into a closed file."""
        if self.journal is not None:
            self.journal.close()
        if getattr(self, 'fleet', None) is not None and \
                self.fleet.journal is self.journal:
            self.fleet.attach_journal(None)

    # -- recovery -------------------------------------------------------

    @classmethod
    def recover(cls, path, *, exact_device=False, device=None, mirror=False,
                fsync_bytes=0, compact_bytes=16 << 20,
                compact_records=100_000, retain=2, max_chain=8,
                doc_capacity=64, key_capacity=64):
        """Rebuild a durable fleet from disk. Returns (manager, handles,
        report): handles is {doc_id: backend handle} for every recovered
        live document. Torn journal tails truncate at the first bad CRC
        frame; rotted records (and any records after them for the same
        doc) quarantine exactly their own doc; the replayed suffix goes
        through apply_changes_docs(on_error='quarantine') so hostile
        bytes ON DISK get the same one-doc blast radius as hostile bytes
        on the wire. Recovery ends with a fresh checkpoint, so the
        directory is compact and consistent when this returns.
        ``device`` places the recovered DocFleet (CUDA unless named; the
        port's one difference from the reference)."""
        rs = _span_seq()
        try:
            return cls._recover_impl(
                path, rs, exact_device=exact_device, device=device,
                mirror=mirror,
                fsync_bytes=fsync_bytes, compact_bytes=compact_bytes,
                compact_records=compact_records, retain=retain,
                max_chain=max_chain, doc_capacity=doc_capacity,
                key_capacity=key_capacity)
        finally:
            # done() is idempotent: on success the impl already closed
            # the last phase; on a raise this records it (with whatever
            # phase recovery died in still attributed)
            rs.done()

    @classmethod
    def _recover_impl(cls, path, rs, *, exact_device, device, mirror,
                      fsync_bytes,
                      compact_bytes, compact_records, retain, max_chain,
                      doc_capacity, key_capacity):
        from . import backend as fleet_backend
        from .backend import DocFleet
        from .loader import load_docs

        rs.mark('recovery_read', path=str(path))
        st = read_state(path)
        report = RecoveryReport()
        report.manifest_seq = st['manifest']['seq']
        report.used_fallback_manifest = st['used_fallback_manifest']
        info = st['journal_info']
        report.torn_tail_bytes = info['torn_tail_bytes']
        report.rotted_records = len(info['rotted'])
        if report.torn_tail_bytes:
            _stats.inc('journal_truncations')
            _flight.record_event('recovery_truncation',
                                 bytes=report.torn_tail_bytes,
                                 path=str(path))
        _stats.inc('rotted_records', report.rotted_records)
        for _did, _at, _rec in info['rotted']:
            _flight.record_event('journal_rot', durable_id=_did,
                                 at_byte=_at, record=_rec)

        fleet = DocFleet(doc_capacity=doc_capacity,
                         key_capacity=key_capacity,
                         exact_device=exact_device, device=device)
        states = {}               # doc_id -> FleetDoc state
        handles = {}              # doc_id -> current backend handle

        def quarantine(did, stage, exc):
            report.quarantined[did] = DocError(did, stage, exc)
            # did IS the durable id here — recovery keys everything by it
            _flight.record_event('quarantine', doc=did, durable_id=did,
                                 stage=stage, error=type(exc).__name__,
                                 message=str(exc)[:200])

        # ---- snapshot load (bulk native parse, per-doc typed fallback)
        rs.mark('recovery_snapshot_load', docs=len(st['docs']))
        snap_ids = sorted(st['docs'])
        report.snapshot_docs = len(snap_ids)
        payloads = [st['docs'][d] for d in snap_ids]
        loaded = None
        if payloads:
            try:
                loaded = load_docs(payloads, fleet)
            except AutomergeError:
                loaded = []
                for did, buf in zip(snap_ids, payloads):
                    try:
                        loaded.append(load_docs([buf], fleet)[0])
                    except AutomergeError as exc:
                        quarantine(did, 'snapshot', exc)
                        loaded.append(fleet_backend.init(fleet))
        for did, handle in zip(snap_ids, loaded or []):
            handles[did] = handle
            states[did] = handle['state']
        # rotted snapshot frames: the doc recovers EMPTY (its journal
        # suffix, if any, holds back at the causal gate) and is reported
        for did, err in st['snapshot_errors']:
            if did is not None and did not in handles:
                handle = fleet_backend.init(fleet)
                handles[did] = handle
                states[did] = handle['state']
            if did is not None:
                quarantine(did, 'snapshot', err)

        # ---- queued-at-checkpoint buffers re-apply (and re-queue)
        if st['queued']:
            qids = sorted(st['queued'])
            for did in qids:
                if did not in handles:
                    handle = fleet_backend.init(fleet)
                    handles[did] = handle
                    states[did] = handle['state']
            report.queued_buffers = sum(len(v) for v in st['queued'].values())
            out, _p, errs = fleet_backend.apply_changes_docs(
                [handles[d] for d in qids],
                [st['queued'][d] for d in qids], mirror=mirror,
                on_error='quarantine')
            for did, handle, err in zip(qids, out, errs):
                handles[did] = handle
                if err is not None and did not in report.quarantined:
                    quarantine(did, 'queued', err.error)

        # ---- journal replay: batched quarantining apply, segmented at
        # FREE records; records for a quarantined doc are skipped so the
        # doc lands exactly on its last good prefix. Every record that
        # APPLIES is collected into `rejournal` — recovery's closing
        # persist re-frames them into the fresh journal generation
        # instead of re-snapshotting the whole fleet (O(replayed), not
        # O(fleet))
        rs.mark('recovery_replay', records=len(st['journal_records']))
        skip = {did for did in report.quarantined}
        pending = {}              # doc_id -> [change payloads], in order
        rejournal = []            # (kind, did, payload) for the new gen

        def flush():
            if not pending:
                return
            ids = list(pending)
            for did in ids:
                if did not in handles:
                    handle = fleet_backend.init(fleet)
                    handles[did] = handle
                    states[did] = handle['state']
            start = time.perf_counter()
            out, _p, errs = fleet_backend.apply_changes_docs(
                [handles[d] for d in ids], [pending[d] for d in ids],
                mirror=mirror, on_error='quarantine')
            # per-doc AVERAGE replay cost, one sample per replay batch
            # (the batched apply cannot see true per-doc times; per-doc
            # outliers surface through doc_materialize_s instead)
            _hist.record_value('recovery_doc_s',
                               (time.perf_counter() - start) / len(ids),
                               scale=1e9, unit='s')
            for did, handle, err in zip(ids, out, errs):
                handles[did] = handle
                if err is not None:
                    skip.add(did)
                    if did not in report.quarantined:
                        quarantine(did, 'replay', err.error)
                else:
                    rejournal.extend((KIND_CHANGE, did, payload)
                                     for payload in pending[did])
            pending.clear()

        # attribute mid-stream rot: the victim keeps every record BEFORE
        # the rotted frame (its last good prefix) and loses the rotted
        # one plus everything after — exactly one doc's suffix
        cut = {}                  # doc_id -> record index of first loss
        for did, at, rec_idx in info['rotted']:
            if did is not None:
                cut[did] = min(cut.get(did, rec_idx), rec_idx)
                if did not in report.quarantined:
                    quarantine(did, 'replay', MalformedJournal(
                        f'journal: rotted record for doc {did} '
                        f'at byte {at}', doc_index=did))
        for rec_idx, (kind, did, payload) in \
                enumerate(st['journal_records']):
            if kind == KIND_CHANGE:
                if did in skip or rec_idx >= cut.get(did, 1 << 62):
                    continue
                pending.setdefault(did, []).append(bytes(payload))
                report.replayed_records += 1
                report.replayed_bytes += len(payload)
            elif kind == KIND_INIT:
                if did not in handles:
                    handle = fleet_backend.init(fleet)
                    handles[did] = handle
                    states[did] = handle['state']
                rejournal.append((KIND_INIT, did, b''))
            elif kind == KIND_FREE:
                flush()
                handle = handles.pop(did, None)
                states.pop(did, None)
                if handle is not None:
                    fleet_backend.free_docs([handle])
                report.freed_docs.append(did)
                rejournal.append((KIND_FREE, did, b''))
        flush()
        # a quarantined doc still recovers — to its last good prefix
        # (possibly empty), never silently vanishing from the fleet
        for did in report.quarantined:
            if did not in handles and did not in report.freed_docs:
                handle = fleet_backend.init(fleet)
                handles[did] = handle
                states[did] = handle['state']
        _stats.inc('replayed_records', report.replayed_records)
        _stats.inc('recovered_docs', len(handles))

        # quarantined docs stay registered (their handle holds the last
        # good prefix); rebuild the registry for the fresh journal.
        # next_doc_id folds in EVERY id the directory ever mentioned —
        # snapshot frames, journal records (incl. freed docs), rot
        # attributions — never just the live set: durable ids are
        # never recycled, and a fallback manifest carries no counter
        seen_ids = set(handles)
        seen_ids.update(st['docs'])
        seen_ids.update(report.freed_docs)
        seen_ids.update(did for _k, did, _p in st['journal_records'])
        seen_ids.update(did for did, _e in st['snapshot_errors']
                        if did is not None)
        next_doc_id = max(
            [st['manifest'].get('next_doc_id') or 0] +
            [d + 1 for d in seen_ids])
        for did, state in states.items():
            try:
                state._dur_id = did
            except AttributeError:
                pass
        rs.done(recovered_docs=len(handles))
        if report.torn_tail_bytes or report.rotted_records or \
                report.quarantined:
            # forensic dump: recovery found damage — name every affected
            # durable id, the stage it failed in, and the typed error,
            # with the surrounding event ring for context
            _flight.dump_flight_record('recovery', detail={
                'path': str(path),
                'manifest_seq': report.manifest_seq,
                'used_fallback_manifest': report.used_fallback_manifest,
                'torn_tail_bytes': report.torn_tail_bytes,
                'rotted_records': report.rotted_records,
                'errors': [e.describe(durable_id=did) for did, e in
                           sorted(report.quarantined.items())],
            })
        mgr = cls(path, fsync_bytes=fsync_bytes,
                  compact_bytes=compact_bytes,
                  compact_records=compact_records, retain=retain,
                  max_chain=max_chain,
                  _recovered=(fleet, st['max_journal_seq'],
                              dict(states), next_doc_id,
                              st['manifest']['chain'], rejournal))
        if not report.ok:
            # damage found: the chain still holds the rotted frames, so
            # a clean recovery would re-report them forever — heal with
            # one full checkpoint (damage is rare; the O(churn) fast
            # path stays for clean recoveries)
            mgr.checkpoint()
        return mgr, {did: handles[did] for did in sorted(handles)}, report
