"""Mmap-backed segment arena: the on-disk chunk tier under ``MainStore``.

The delta+main storage engine (fleet/storage.py) keeps a parked doc's
CAUSAL state in RAM-resident columnar lanes, but the chunk bytes
themselves — the overwhelming majority of a parked doc's footprint —
need none of that residency: every read they get is a sequential scan
(revive parse, ``materialize_at`` extraction, the rare ``chunk()``
export), which the kernel's page cache already serves better than a
Python ``bytes`` arena can. This module is that tier:

- ``SegmentArena`` — append-only segment files (``seg-<epoch>-<n>.dat``)
  holding CRC-framed chunk records. Reads come back as zero-copy
  ``memoryview``s into an ``mmap`` of the segment, so a parked chunk
  costs page-cache presence, not RSS; a cold chunk costs a page fault,
  not a decode. Appends land in the active segment through a buffered
  writer; the mapping is refreshed lazily when a read wants bytes
  beyond the mapped length.
- Crash safety rides two mechanisms, both scanned by ``open``:
  every record is CRC-framed (a torn append is detected and the tail
  dropped, exactly like the change journal's frame discipline), and the
  arena's MANIFEST names the current *epoch* via atomic
  rename + dir fsync (fleet/durability.py's ``_atomic_write``). Vacuum
  (``rewrite_begin``/``rewrite_commit``) writes the surviving chunks
  into next-epoch segments and flips the manifest ATOMICALLY — a crash
  at any point recovers either the complete old arena or the complete
  new one, never a mix; stale-epoch files are swept on open.
- Discards append a tombstone frame (so discard state survives a
  crash); vacuum drops dead records and tombstones (the repark path
  re-parks under the caller's original ids, so frames carry them
  directly).
- ``RamArena`` — the same interface over in-process bytes objects, for
  stores that want yesterday's RAM-resident behavior (tests, ephemeral
  scratch stores, the shard rebalance staging store). No files, no
  recovery, no framing overhead.

Concurrently-held views survive a vacuum: the swap drops the arena's
OWN references to the old epoch's maps and unlinks the files, but a
``memoryview`` keeps its mmap (and therefore the unlinked inode's
pages) alive until the holder releases it — POSIX semantics do the
reference counting the store would otherwise need.
"""

import mmap
import os
import re
import struct
import zlib

__all__ = ['SegmentArena', 'RamArena', 'ArenaCorrupt']

# record frame: [u32 crc] [u8 kind] [u32 payload_len] [i64 tag] [payload]
# crc covers kind|len|tag|payload (crc32, like the change journal's frames)
_HEAD = struct.Struct('<IBIq')
_BODY = struct.Struct('<BIq')
_U32 = struct.Struct('<I')

KIND_CHUNK = 1      # payload = parked chunk bytes
KIND_TOMB = 2       # record `tag` is discarded (payload empty)

MANIFEST_NAME = 'ARENA'
_SEG_RE = re.compile(r'^seg-(\d{8})-(\d{6})\.dat$')

DEFAULT_SEGMENT_BYTES = 32 << 20


class ArenaCorrupt(ValueError):
    """The arena directory cannot be interpreted (missing/garbled
    manifest). Torn record tails are NOT this — they are expected crash
    damage and handled leniently by the scan."""


def _seg_name(epoch, n):
    return f'seg-{epoch:08d}-{n:06d}.dat'


def _atomic_write(path, data):
    from .durability import _atomic_write as aw
    aw(path, data)


def _fsync_dir(path):
    from .durability import _fsync_dir as fd
    fd(path)


class _Segment:
    """One on-disk segment: durable size + a lazily refreshed mapping."""

    __slots__ = ('path', 'size', 'map', 'mapped')

    def __init__(self, path, size=0):
        self.path = path
        self.size = size
        self.map = None
        self.mapped = 0

    def view(self, off, length):
        if off + length > self.mapped:
            self.remap()
        return memoryview(self.map)[off:off + length]

    def remap(self):
        size = os.path.getsize(self.path)
        if size == 0:
            return
        with open(self.path, 'rb') as f:
            # dropping the old map object is safe even with exported
            # views: they keep it alive; unexported maps close on GC
            self.map = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
        self.mapped = size


class SegmentArena:
    """Append-only mmap'd chunk storage (see module docstring).

    ``append(tag, payload)`` returns ``(seg, off, length)`` addressing
    the payload; ``view(seg, off, length)`` serves it zero-copy. ``seg``
    indexes this epoch's segment list — addresses are only meaningful
    against the arena epoch that issued them (MainStore re-addresses on
    vacuum)."""

    def __init__(self, path, segment_bytes=DEFAULT_SEGMENT_BYTES,
                 epoch=0, _fresh=True):
        if segment_bytes >= 1 << 31:
            raise ValueError('segment_bytes must stay below 2 GiB')
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.epoch = int(epoch)
        self.segments = []          # [_Segment]
        self._f = None              # buffered writer on the active segment
        self.data_bytes = 0         # live payload bytes (chunks only)
        self.garbage_bytes = 0      # dead payload + frame/tombstone overhead
        self.fault_point = None     # test hook: name -> raise/_exit there
        if _fresh:
            os.makedirs(path, exist_ok=True)
            self._write_manifest()
            self._open_segment()

    # -- manifest ---------------------------------------------------------

    def _write_manifest(self):
        _atomic_write(os.path.join(self.path, MANIFEST_NAME),
                      b'arena-epoch %d\n' % self.epoch)

    @classmethod
    def open(cls, path, segment_bytes=DEFAULT_SEGMENT_BYTES):
        """Recover an arena: read the manifest epoch, sweep stale-epoch
        files (a killed vacuum's debris), frame-scan this epoch's
        segments dropping any torn tail, and return
        ``(arena, records)`` where records is ``{tag: (seg, off, len)}``
        for every live (non-tombstoned) chunk in append order."""
        mpath = os.path.join(path, MANIFEST_NAME)
        try:
            with open(mpath, 'rb') as f:
                head = f.read(64).split()
        except OSError as exc:
            raise ArenaCorrupt(f'no arena manifest at {mpath}') from exc
        if len(head) < 2 or head[0] != b'arena-epoch':
            raise ArenaCorrupt(f'garbled arena manifest at {mpath}')
        epoch = int(head[1])
        arena = cls(path, segment_bytes=segment_bytes, epoch=epoch,
                    _fresh=False)
        names = []
        for name in sorted(os.listdir(path)):
            m = _SEG_RE.match(name)
            if not m:
                continue
            if int(m.group(1)) != epoch:
                # a vacuum died before (future epoch) or after (past
                # epoch) its manifest flip: either way not ours
                try:
                    os.unlink(os.path.join(path, name))
                except OSError:
                    pass
                continue
            names.append(name)
        records = {}
        for name in names:
            seg_path = os.path.join(path, name)
            seg = _Segment(seg_path)
            seg_idx = len(arena.segments)
            arena.segments.append(seg)
            arena._scan_segment(seg_idx, seg_path, seg, records)
        arena.data_bytes = sum(ln for _s, _o, ln in records.values())
        # everything on disk that is not a live payload is vacuum-able
        # debt: dead records, tombstones, frame headers
        arena.garbage_bytes = max(
            0, arena.disk_bytes() - arena.data_bytes
            - len(records) * _HEAD.size)
        if not arena.segments:
            arena._open_segment()
        else:
            # append into the last segment past its verified tail (the
            # torn bytes, if any, were truncated by the scan)
            last = arena.segments[-1]
            arena._f = open(last.path, 'r+b')
            arena._f.seek(last.size)
            arena._f.truncate(last.size)
        return arena, records

    def _scan_segment(self, seg_idx, seg_path, seg, records):
        with open(seg_path, 'rb') as f:
            data = f.read()
        off = 0
        valid = 0
        while off + _HEAD.size <= len(data):
            crc, kind, ln, tag = _HEAD.unpack_from(data, off)
            end = off + _HEAD.size + ln
            if end > len(data):
                break
            body = data[off + 4:end]
            if zlib.crc32(body) & 0xffffffff != crc:
                break
            if kind == KIND_CHUNK:
                records[tag] = (seg_idx, off + _HEAD.size, ln)
            elif kind == KIND_TOMB:
                records.pop(tag, None)
            off = end
            valid = off
        seg.size = valid

    # -- appends ----------------------------------------------------------

    def _open_segment(self):
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        name = _seg_name(self.epoch, len(self.segments))
        seg_path = os.path.join(self.path, name)
        self._f = open(seg_path, 'wb')
        self.segments.append(_Segment(seg_path))

    def _emit(self, kind, tag, payload):
        if self.fault_point is not None:
            self._check_fault(f'append_{kind}')
        seg = len(self.segments) - 1
        active = self.segments[seg]
        if active.size >= self.segment_bytes:
            self._open_segment()
            seg += 1
            active = self.segments[seg]
        n = len(payload)
        body = _BODY.pack(kind, n, tag)
        crc = (zlib.crc32(payload, zlib.crc32(body)) & 0xffffffff) \
            if n else (zlib.crc32(body) & 0xffffffff)
        off = active.size + _HEAD.size
        # ONE buffered write per record (the bulk-park hot path)
        self._f.write(b''.join((_U32.pack(crc), body, payload)) if n
                      else _U32.pack(crc) + body)
        active.size = off + n
        return seg, off, n

    def append(self, tag, payload):
        """Store one chunk under stable tag; returns (seg, off, len)."""
        out = self._emit(KIND_CHUNK, tag, payload)
        self.data_bytes += len(payload)
        return out

    def append_many(self, tags, payloads):
        """Bulk append: frames accumulate host-side and land in ONE
        buffered write per segment span (the 1M/10M-doc ingest path —
        per-record write() calls would dominate the park rate).
        Returns [(seg, off, len)] aligned with the inputs."""
        if self.fault_point is not None:
            self._check_fault('append_1')
        out = []
        frames = []
        seg = len(self.segments) - 1
        active = self.segments[seg]
        size = active.size
        crc32, u32, body_pack = zlib.crc32, _U32.pack, _BODY.pack
        for tag, payload in zip(tags, payloads):
            if size >= self.segment_bytes:
                if frames:
                    self._f.write(b''.join(frames))
                    frames.clear()
                active.size = size
                self._open_segment()
                seg += 1
                active = self.segments[seg]
                size = 0
            n = len(payload)
            body = body_pack(KIND_CHUNK, n, tag)
            crc = (crc32(payload, crc32(body)) if n else crc32(body)) \
                & 0xffffffff
            frames.append(u32(crc))
            frames.append(body)
            frames.append(payload)
            off = size + _HEAD.size
            out.append((seg, off, n))
            size = off + n
            self.data_bytes += n
        if frames:
            self._f.write(b''.join(frames))
        active.size = size
        return out

    def tombstone(self, tag, length):
        """Record `tag`'s discard durably; its `length` payload bytes
        become arena garbage until the next vacuum."""
        self._emit(KIND_TOMB, tag, b'')
        self.data_bytes -= length
        self.garbage_bytes += length + 2 * _HEAD.size

    # -- reads ------------------------------------------------------------

    def view(self, seg, off, length):
        """Zero-copy memoryview of a stored payload. Flushes the writer
        first when the address lies beyond the mapped span (read-after-
        write consistency without per-append flushes)."""
        segment = self.segments[seg]
        if off + length > segment.mapped and self._f is not None:
            self._f.flush()
        return segment.view(off, length)

    # -- accounting / maintenance ----------------------------------------

    def disk_bytes(self):
        return sum(s.size for s in self.segments)

    def resident_bytes(self):
        return 0            # chunk bytes live on the page cache, not RSS

    def flush(self):
        """Push buffered frames to the kernel (no fsync): after this, a
        PROCESS kill cannot lose or resurrect records — only an OS/power
        crash can, whose window ``sync`` closes. The storage engine
        flushes after every batched mutation (park/ingest/discard), the
        same group-commit granularity the change journal uses."""
        if self._f is not None:
            self._f.flush()

    def sync(self):
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())

    def advise_cold(self):
        """Drop this arena's clean pages from the page cache
        (posix_fadvise DONTNEED) — the bench's cold-read lever. Best
        effort; a platform without fadvise is a no-op."""
        if not hasattr(os, 'posix_fadvise'):
            return
        self.sync()
        for seg in self.segments:
            try:
                fd = os.open(seg.path, os.O_RDONLY)
                try:
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            except OSError:
                pass

    # -- vacuum: rewrite + atomic swap ------------------------------------

    def rewrite_begin(self):
        """A writer arena for the NEXT epoch in the same directory. Its
        files are invisible to recovery until ``rewrite_commit`` flips
        the manifest; a crash before that leaves this epoch authoritative
        and the writer's files swept on the next open."""
        writer = SegmentArena.__new__(SegmentArena)
        writer.path = self.path
        writer.segment_bytes = self.segment_bytes
        writer.epoch = self.epoch + 1
        writer.segments = []
        writer._f = None
        writer.data_bytes = 0
        writer.garbage_bytes = 0
        writer.fault_point = self.fault_point
        writer._open_segment()
        return writer

    def rewrite_commit(self, writer):
        """Atomic swap: fsync the writer's segments, flip the manifest
        to the writer's epoch (rename is the commit point), then sweep
        this epoch's files. Concurrently-held views into the old maps
        stay valid (see module docstring)."""
        self._check_fault('pre_commit')
        writer.sync()
        writer._write_manifest()
        _fsync_dir(self.path)
        self._check_fault('post_manifest')
        # the old epoch is now garbage whatever happens below
        old = self.segments
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
        for seg in old:
            seg.map = None          # views keep theirs alive
            try:
                os.unlink(seg.path)
            except OSError:
                pass

    def _check_fault(self, point):
        fault = self.fault_point
        if fault is None:
            return
        if fault == point:
            raise RuntimeError(f'injected arena fault at {point}')
        if fault == f'exit:{point}':
            os._exit(71)        # kill-style crash for recovery tests

    def close(self):
        if self._f is not None:
            try:
                self._f.flush()
                self._f.close()
            except OSError:
                pass
            self._f = None
        for seg in self.segments:
            seg.map = None


class RamArena:
    """The arena interface over in-process bytes (no files, no frames):
    yesterday's RAM-resident MainStore behavior for ephemeral stores."""

    def __init__(self):
        self._items = []
        self.data_bytes = 0
        self.garbage_bytes = 0

    def append(self, tag, payload):
        payload = payload if type(payload) is bytes else bytes(payload)
        self._items.append(payload)
        self.data_bytes += len(payload)
        return 0, len(self._items) - 1, len(payload)

    def append_many(self, tags, payloads):
        return [self.append(t, p) for t, p in zip(tags, payloads)]

    def tombstone(self, tag, length):
        self.data_bytes -= length
        self.garbage_bytes += length

    def view(self, seg, off, length):
        return memoryview(self._items[off])

    def discard_slot(self, off):
        self._items[off] = None

    def flush(self):
        pass

    def disk_bytes(self):
        return 0

    def resident_bytes(self):
        return self.data_bytes

    def sync(self):
        pass

    def advise_cold(self):
        pass

    def rewrite_begin(self):
        return RamArena()

    def rewrite_commit(self, writer):
        self._items = []

    def close(self):
        self._items = []
