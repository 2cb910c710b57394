"""ctypes bindings for the native codec kernels (codec.cpp).

Compiled on demand with g++ into the package's git-ignored build
directory (``automerge_tpu_torch/_build/``); all entry points
have pure-Python fallbacks so the library works without a toolchain, but the
native path is the production one (SURVEY.md section 2.9 native accounting):
SHA-256 (single + batched across documents), raw DEFLATE, and the
LEB128/RLE/delta/boolean column decoders emitting int64 arrays + null masks.

Multi-core contract (BASELINE.md "Multi-core contract"): the batched
change parse and batched SHA run over a persistent native thread pool
sized by ``AUTOMERGE_TPU_NATIVE_THREADS`` (default: the machine's cores,
capped at 16; ``set_native_threads`` overrides at runtime). Parallel
output is byte-identical to ``AUTOMERGE_TPU_NATIVE_THREADS=1`` — same
column bytes, hashes, interned-table order, and typed-error verdicts —
pinned by tests/test_native_parallel.py. The GIL is released across the
whole batch (CDLL entry points release it implicitly; the zero-copy list
entry releases it inside C++ after gathering buffer pointers), so other
Python threads run while a batch parses.

The parser's row format is named here, beside the binding that returns
it: the row-flag codes of ``ingest_changes``' ``flags`` column
(``FLAG_*``), the packed-id layout (``ACTOR_BITS``, ``ACTOR_MASK``) and
``format_op_id``, the one packed id -> ``counter@actor`` formatter.

A compiled binary carries an ABI stamp (``am_abi_version``); a stale .so
that cannot be rebuilt fails loudly at import instead of silently running
an old single-threaded codec.
"""

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from ..errors import MalformedChange
from ..observability import hist as _hist
from ..observability.metrics import register_health_source
from ..observability.spans import on as _spans_on
from ..observability.spans import record_span as _record_span
from ..observability.spans import span as _span

# Bumped in lockstep with codec.cpp's am_abi_version whenever the C
# surface changes shape. A mismatch means the cached .so predates this
# wrapper (or vice versa) and MUST NOT be used.
_ABI_VERSION = 4


class NativeAbiMismatch(RuntimeError):
    """A compiled codec binary is stale and could not be rebuilt."""

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'codec.cpp')
# AUTOMERGE_TPU_NATIVE_SO points the wrapper at an alternate prebuilt
# binary — the sanitizer plane loads the ASan/UBSan build this way
# (tools/build_native.sh --sanitize). The override is loaded VERBATIM:
# never rebuilt, and any failure (missing file, ABI skew) is loud —
# silently falling back to the normal .so would make a sanitizer replay
# quietly test the wrong library.
_SO_OVERRIDE = os.environ.get('AUTOMERGE_TPU_NATIVE_SO') or None
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '_build')
_LIB_PATH = _SO_OVERRIDE or os.path.join(
    _BUILD_DIR, f'_codec_{sys.implementation.cache_tag}.so')

_lib = None
_load_error = None


_pylib = None


def _load_pydll():
    """PyDLL handle (GIL held during calls) for the zero-copy list
    entry; None when the .so was built without CPython headers."""
    global _pylib
    if _pylib is not None:
        return _pylib if _pylib is not False else None
    if _load() is None:
        _pylib = False
        return None
    try:
        lib = ctypes.PyDLL(_LIB_PATH)
        lib.am_ingest_changes_list.argtypes = [ctypes.py_object,
                                               ctypes.c_int, ctypes.c_int]
        lib.am_ingest_changes_list.restype = ctypes.c_int64
        _pylib = lib
        return lib
    except (OSError, AttributeError):
        _pylib = False
        return None


def _build():
    """Compile codec.cpp to a process-private temporary name and
    os.replace it into place: concurrent builders (pytest-xdist workers)
    each publish a complete binary atomically, never a torn one. An
    exclusive lock on the build directory lets the first builder work
    while the rest wait and then reuse its output."""
    import fcntl
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, '.codec.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH) and \
                os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
            return
        tmp = f'{_LIB_PATH}.{os.getpid()}.tmp'
        try:
            _compile(tmp)
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _compile(out_path):
    # -pthread: the codec spawns a persistent worker pool (NativePool)
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-pthread',
           _SRC, '-lz', '-o', out_path]
    # CPython headers enable the zero-copy list ingest entry
    # (am_ingest_changes_list); codec.cpp compiles without them too
    try:
        import sysconfig
        inc = sysconfig.get_paths().get('include')
        if inc and os.path.exists(os.path.join(inc, 'Python.h')):
            cmd.insert(1, f'-I{inc}')
    except (ImportError, KeyError, OSError):
        pass    # no headers: build without the zero-copy list entry
    subprocess.run(cmd, check=True, capture_output=True)


def _abi_of(lib):
    """The binary's ABI stamp, or -1 when the symbol predates stamping."""
    try:
        fn = lib.am_abi_version
    except AttributeError:
        return -1
    fn.argtypes = []
    fn.restype = ctypes.c_int64
    return int(fn())


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if _SO_OVERRIDE:
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError as exc:
                raise NativeAbiMismatch(
                    f'AUTOMERGE_TPU_NATIVE_SO={_LIB_PATH} could not be '
                    f'loaded ({exc}) — the override is never rebuilt or '
                    f'fallen back from; fix the path or unset it'
                ) from exc
            if _abi_of(lib) != _ABI_VERSION:
                raise NativeAbiMismatch(
                    f'AUTOMERGE_TPU_NATIVE_SO={_LIB_PATH} reports ABI '
                    f'{_abi_of(lib)}, wrapper expects {_ABI_VERSION} — '
                    f'rebuild it (tools/build_native.sh --sanitize=... '
                    f'for sanitized binaries)')
            return _finish_load(lib)
        if not os.path.exists(_LIB_PATH) or \
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        if _abi_of(lib) != _ABI_VERSION:
            # Stale binary (mtime lied — e.g. a prebuilt .so shipped with
            # a fresher timestamp than the source). Rebuild; if that is
            # impossible, fail LOUDLY rather than run the old codec
            # single-threaded with a mismatched C surface.
            try:
                # unlink first: the stale mapping is still dlopen'd, and
                # glibc dedups by (dev, inode) — rebuilding in place and
                # re-dlopening the same inode would return the OLD library
                os.remove(_LIB_PATH)
                _build()
            except Exception as exc:
                raise NativeAbiMismatch(
                    f'native codec binary {_LIB_PATH} has ABI '
                    f'{_abi_of(lib)}, wrapper expects {_ABI_VERSION}, and '
                    f'rebuilding failed ({exc}); delete the stale .so'
                ) from exc
            lib = ctypes.CDLL(_LIB_PATH)
            if _abi_of(lib) != _ABI_VERSION:
                raise NativeAbiMismatch(
                    f'native codec binary {_LIB_PATH} still reports ABI '
                    f'{_abi_of(lib)} after a rebuild (wrapper expects '
                    f'{_ABI_VERSION}) — source/wrapper version skew')
        return _finish_load(lib)
    except NativeAbiMismatch:
        raise                     # stale binaries fail loudly, not silently
    except Exception as exc:  # toolchain missing or compile failure
        _load_error = exc
        _lib = None
    return _lib


def _finish_load(lib):
    """Declare the C surface and adopt `lib` as THE loaded codec."""
    global _lib, _threads
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.am_sha256.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.am_sha256_batch.argtypes = [u8p, u64p, u64p, ctypes.c_uint64, u8p]
    lib.am_deflate_raw.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64]
    lib.am_deflate_raw.restype = ctypes.c_int64
    lib.am_inflate_raw.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64]
    lib.am_inflate_raw.restype = ctypes.c_int64
    lib.am_decode_rle.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int,
                                  i64p, u8p, ctypes.c_int64]
    lib.am_decode_rle.restype = ctypes.c_int64
    lib.am_decode_delta.argtypes = [u8p, ctypes.c_uint64, i64p, u8p,
                                    ctypes.c_int64]
    lib.am_decode_delta.restype = ctypes.c_int64
    lib.am_decode_boolean.argtypes = [u8p, ctypes.c_uint64, i64p, u8p,
                                      ctypes.c_int64]
    lib.am_decode_boolean.restype = ctypes.c_int64
    lib.am_count_rle.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int]
    lib.am_count_rle.restype = ctypes.c_int64
    lib.am_pool_configure.argtypes = [ctypes.c_int]
    lib.am_pool_configure.restype = ctypes.c_int64
    lib.am_pool_threads.argtypes = []
    lib.am_pool_threads.restype = ctypes.c_int64
    lib.am_pool_stats.argtypes = [i64p, i64p, i64p]
    lib.am_pool_stats.restype = ctypes.c_int64
    lib.am_ingest_parse_stats.argtypes = [i64p, i64p, i64p, i64p,
                                          ctypes.c_int64]
    lib.am_ingest_parse_stats.restype = ctypes.c_int64
    _threads = int(lib.am_pool_configure(_default_threads()))
    _lib = lib
    return _lib


_threads = 1


def _default_threads():
    """Pool width: AUTOMERGE_TPU_NATIVE_THREADS, else cores capped at 16
    (the codec's slices are memory-bandwidth-bound past that)."""
    env = os.environ.get('AUTOMERGE_TPU_NATIVE_THREADS')
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(os.cpu_count() or 1, 16))


def native_threads():
    """The configured parse-pool width (1 when the codec is unavailable)."""
    return _threads if _load() is not None else 1


def set_native_threads(n):
    """Resize the native parse pool; returns the previous width. The
    determinism contract makes this a pure performance knob — outputs are
    byte-identical at every width."""
    global _threads
    lib = _load()
    if lib is None:
        return 1
    prev = _threads
    with _ingest_lock:
        _threads = int(lib.am_pool_configure(int(n)))
    return prev


def pool_stats():
    """{'threads', 'tasks', 'busy_s'} — lifetime pool occupancy counters."""
    lib = _load()
    if lib is None:
        return {'threads': 1, 'tasks': 0, 'busy_s': 0.0}
    t = ctypes.c_int64(0)
    n = ctypes.c_int64(0)
    b = ctypes.c_int64(0)
    lib.am_pool_stats(ctypes.byref(t), ctypes.byref(n), ctypes.byref(b))
    return {'threads': int(t.value), 'tasks': int(n.value),
            'busy_s': float(b.value) / 1e9}


register_health_source('native_pool_tasks',
                       lambda: pool_stats()['tasks'] if _lib else 0)


def _note_parse_stats(lib):
    """After an ingest: inject per-slice `parse_chunk` spans (worker-tagged
    tids — each pool lane renders as its own Perfetto track) and record the
    parse_chunk_s / parse_pool_occupancy histograms. Only runs when the
    observability switches are on; called under _ingest_lock so the C-side
    stats belong to OUR parse."""
    spans_on = _spans_on()
    hist_on = _hist.on()
    if not (spans_on or hist_on):
        return
    wall_t0 = ctypes.c_int64(0)
    wall_t1 = ctypes.c_int64(0)
    threads = ctypes.c_int64(1)
    rows = np.zeros(5 * 256, dtype=np.int64)
    n = int(lib.am_ingest_parse_stats(
        ctypes.byref(wall_t0), ctypes.byref(wall_t1), ctypes.byref(threads),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 256))
    if n <= 0:
        return
    rows = rows[:5 * n].reshape(n, 5)
    busy_ns = 0
    for t0, t1, first, count, worker in rows.tolist():
        busy_ns += t1 - t0
        if spans_on:
            _record_span('parse_chunk', t0, t1, tid=1_000_000 + worker,
                         first_chunk=first, chunks=count, worker=worker)
        if hist_on:
            _hist.record_value('parse_chunk_s', (t1 - t0) / 1e9,
                               scale=1e9, unit='s')
    if hist_on:
        wall = max(int(wall_t1.value) - int(wall_t0.value), 1)
        occ = 100.0 * busy_ns / (wall * max(int(threads.value), 1))
        _hist.record_value('parse_pool_occupancy', occ, scale=1,
                           unit='%')


# The native ingest context is single-flight (two-phase parse+fetch over
# one global C context); concurrent callers (any two threads that parse
# at once) serialize here instead of corrupting each other's fetches.
_ingest_lock = threading.RLock()


# ---- the parser's row format ----------------------------------------------
# The row-flag codes of ingest_changes' `flags` column: what op each row
# is. codec.cpp writes them (am_ingest_changes' out_flags); every reader
# names them from here.
FLAG_SET = 1             # map-key set, or del (a del carries value -1)
FLAG_INC = 2             # map-key inc
# with_seq=True only: ops on sequence elements,
FLAG_SEQ_INSERT = 3
FLAG_SEQ_SET = 4
FLAG_SEQ_DEL = 5
FLAG_SEQ_INC = 6
# makes at a map key (root or nested; `obj` is the parent),
FLAG_MAKE_TEXT = 7
FLAG_MAKE_LIST = 8
FLAG_MAKE_MAP = 9
FLAG_MAKE_TABLE = 10
# and makes as sequence elements (the value lane carries the insert bit).
FLAG_ELEM_MAKE_TEXT = 11
FLAG_ELEM_MAKE_LIST = 12
FLAG_ELEM_MAKE_MAP = 13
FLAG_ELEM_MAKE_TABLE = 14
# the object type each make code creates
MAKE_TYPES = {FLAG_MAKE_TEXT: 'text', FLAG_MAKE_LIST: 'list',
              FLAG_MAKE_MAP: 'map', FLAG_MAKE_TABLE: 'table',
              FLAG_ELEM_MAKE_TEXT: 'text', FLAG_ELEM_MAKE_LIST: 'list',
              FLAG_ELEM_MAKE_MAP: 'map', FLAG_ELEM_MAKE_TABLE: 'table'}

# Packed ids (the packed, obj, ref and pred columns): counter <<
# ACTOR_BITS | the actor's index in the actor table of the same call
# (codec.cpp's kActorBits).
ACTOR_BITS = 8
ACTOR_MASK = (1 << ACTOR_BITS) - 1


def format_op_id(packed, actors):
    """The `counter@actor` id of a packed id, `actors` the actor table
    that ingest_changes returned with it."""
    return f'{packed >> ACTOR_BITS}@{actors[packed & ACTOR_MASK]}'


def available():
    return _load() is not None


def _u8(buf):
    """Byte buffer -> (uint8 array, pointer) WITHOUT an owned-bytes
    copy: bytes, bytearray, and memoryview (incl. views into mmap'd
    storage segments) go straight through the buffer protocol, so the
    native codec reads compressed chunks off the page cache in place."""
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        buf = bytes(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    if arr.size == 0:
        arr = np.zeros(1, dtype=np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sha256(data):
    """SHA-256 digest (native; falls back to hashlib)."""
    lib = _load()
    if lib is None:
        import hashlib
        return hashlib.sha256(bytes(data)).digest()
    arr, ptr = _u8(data)
    out = np.zeros(32, dtype=np.uint8)
    lib.am_sha256(ptr, arr.size if len(data) else 0,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


def sha256_batch(buffers):
    """Hash many buffers (e.g. one change per document across a fleet)."""
    with _span('sha256_batch', buffers=len(buffers)):
        return _sha256_batch(buffers)


def _sha256_batch(buffers):
    lib = _load()
    if lib is None:
        import hashlib
        return [hashlib.sha256(bytes(b)).digest() for b in buffers]
    blob = b''.join(bytes(b) for b in buffers)
    offsets = np.zeros(len(buffers), dtype=np.uint64)
    lens = np.array([len(b) for b in buffers], dtype=np.uint64)
    np.cumsum(lens[:-1], out=offsets[1:]) if len(buffers) > 1 else None
    arr, ptr = _u8(blob)
    out = np.zeros(32 * len(buffers), dtype=np.uint8)
    lib.am_sha256_batch(
        ptr, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(buffers),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    raw = out.tobytes()
    return [raw[32 * i:32 * i + 32] for i in range(len(buffers))]


def deflate_raw(data):
    lib = _load()
    if lib is None:
        import zlib
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        return c.compress(bytes(data)) + c.flush()
    data = bytes(data)
    cap = len(data) + (len(data) >> 3) + 64
    out = np.zeros(cap, dtype=np.uint8)
    arr, ptr = _u8(data)
    size = lib.am_deflate_raw(ptr, len(data),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              cap)
    if size < 0:
        raise ValueError('deflate failed')
    return out[:size].tobytes()


def inflate_raw(data, max_size=1 << 28):
    lib = _load()
    if lib is None:
        import zlib
        return zlib.decompress(bytes(data), -15)
    data = bytes(data)
    cap = min(max(len(data) * 8, 1 << 16), max_size)
    arr, ptr = _u8(data)
    while True:
        out = np.zeros(cap, dtype=np.uint8)
        size = lib.am_inflate_raw(
            ptr, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap)
        if size >= 0:
            return out[:size].tobytes()
        if cap >= max_size:
            # hostile wire bytes reach this decoder (deflated columns in
            # change/document chunks), so the failure is typed
            raise MalformedChange('inflate failed: corrupt or oversized '
                                  'deflate stream')
        cap = min(cap * 4, max_size)


def _decode_column(fn_name, buf, signed=False):
    lib = _load()
    if lib is None:
        return None  # caller falls back to the Python codecs
    data = bytes(buf)
    arr, ptr = _u8(data)
    if fn_name == 'rle':
        count = lib.am_count_rle(ptr, len(data), int(signed))
    elif fn_name == 'delta':
        count = lib.am_count_rle(ptr, len(data), 1)
    else:
        count = len(data) * 8  # upper bound for boolean runs is large; count below
    if fn_name == 'boolean':
        # booleans: decode with a growing buffer. -2 = capacity too
        # small (retry bigger), -1 = malformed — the distinction keeps a
        # hostile run count from driving the retry loop into multi-GB
        # allocations before the typed failure; the ceiling matches the
        # C side's kMaxColumnValues.
        cap = max(64, len(data) * 8)
        while True:
            out = np.zeros(cap, dtype=np.int64)
            mask = np.zeros(cap, dtype=np.uint8)
            n = lib.am_decode_boolean(
                ptr, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n >= 0:
                return out[:n], mask[:n].astype(bool)
            if n != -2:
                raise MalformedChange('malformed boolean column')
            cap *= 4
            if cap > 1 << 26:
                raise MalformedChange('boolean column too large')
    if count < 0:
        raise MalformedChange('malformed column')
    out = np.zeros(max(count, 1), dtype=np.int64)
    mask = np.zeros(max(count, 1), dtype=np.uint8)
    fn = lib.am_decode_rle if fn_name == 'rle' else lib.am_decode_delta
    args = [ptr, len(data)]
    if fn_name == 'rle':
        args.append(int(signed))
    args += [out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
             mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
             max(count, 1)]
    n = fn(*args)
    if n < 0:
        raise MalformedChange('malformed column')
    return out[:n], mask[:n].astype(bool)


def decode_rle_column(buf, signed=False):
    """Decode an entire RLE column to (values int64[], valid bool[])."""
    return _decode_column('rle', buf, signed)


def decode_delta_column(buf):
    """Decode a delta column to absolute values (values int64[], valid bool[])."""
    return _decode_column('delta', buf)


def decode_boolean_column(buf):
    return _decode_column('boolean', buf)


def ingest_changes(buffers, doc_ids, with_meta=False, with_seq=False,
                   blob=None, lens=None):
    """Batched native change ingest: parse N binary changes into flat op-row
    arrays (doc, key_id, packed_opid, value, flags) with C++-side dictionary
    encoding of keys and actors.

    Returns (rows dict, key_strings list, actor_hex list), or None if any
    change falls outside the fleet-kernel subset (caller falls back to the
    general host engine). With with_meta=True, a fourth element carries
    per-change header metadata (the whole hash-graph feed: SHA-256 hash with
    checksum verification, deps, actor/seq/startOp/time/message, op counts)
    so no Python-side header decode is needed. With with_seq=True, the
    parser also accepts sequence ops (insert/set/del/inc on sequence
    objects), make ops at map keys (root or nested), and keyed set/del/inc
    on nested map/table objects; the rows dict gains obj/ref/vtype columns
    (packed containing objectId — 0 = root, packed referent elemId, wire
    value-type tag), and the flags extend past FLAG_SET / FLAG_INC to the
    sequence ops (FLAG_SEQ_*), makes at map keys (FLAG_MAKE_*) and makes
    as sequence elements (FLAG_ELEM_MAKE_*), named above.

    doc_ids=None means the identity mapping (buffer i -> doc i, the
    turbo shape) and enables the zero-copy list entry: C walks the
    Python list's bytes objects in place — no blob join, no length
    array, no type scan (those Python-side passes cost more than the
    parse itself at fleet scale).

    The parse itself is chunk-parallel over the native thread pool with
    the GIL released (see the module docstring's multi-core contract);
    concurrent callers serialize on the module ingest lock."""
    with _span('native_parse', buffers=len(buffers), with_meta=with_meta,
               threads=_threads):
        with _ingest_lock:
            out = _ingest_changes(buffers, doc_ids, with_meta, with_seq,
                                  blob, lens)
            lib = _lib
            if lib is not None:
                _note_parse_stats(lib)
            return out


def _ingest_changes(buffers, doc_ids, with_meta, with_seq, blob, lens):
    lib = _load()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    n_rows = None
    if doc_ids is None:
        if blob is None:
            plib = _load_pydll()
            if plib is not None and type(buffers) is list:
                # no Python-side type scan: the C entry PyBytes-checks
                # each item and returns -2 to select the blob path
                n_rows = plib.am_ingest_changes_list(
                    buffers, 1 if with_meta else 0, 1 if with_seq else 0)
                if n_rows == -2:
                    n_rows = None    # non-bytes item: blob path below
                elif n_rows < 0:
                    return None
        if n_rows is None:
            doc_ids = list(range(len(buffers)))
    if n_rows is None:
        n_bufs = len(buffers)
        if blob is None:
            bufs = buffers if all(type(b) is bytes for b in buffers) else \
                [bytes(b) for b in buffers]
            blob = b''.join(bufs)
            lens = np.fromiter(map(len, bufs), dtype=np.uint64, count=n_bufs)
        offsets = np.zeros(n_bufs, dtype=np.uint64)
        if n_bufs > 1:
            np.cumsum(lens[:-1], out=offsets[1:])
        docs = np.asarray(doc_ids, dtype=np.int32)
        arr, ptr = _u8(blob)
        lib.am_ingest_changes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.am_ingest_changes.restype = i64
        n_rows = lib.am_ingest_changes(
            ptr, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(buffers), 1 if with_meta else 0, 1 if with_seq else 0)
        if n_rows < 0:
            return None
    metas = None
    preds = None
    seq_cols = None
    if with_meta:
        metas = _fetch_ingest_meta(lib, len(buffers))
        if metas is None:
            return None
        preds = _fetch_ingest_preds(lib, int(n_rows))
        if preds is None:
            return None
    if with_seq:
        i32p_ = ctypes.POINTER(ctypes.c_int32)
        u8p_ = ctypes.POINTER(ctypes.c_uint8)
        obj = np.zeros(max(int(n_rows), 1), dtype=np.int32)
        ref = np.zeros(max(int(n_rows), 1), dtype=np.int32)
        vtype = np.zeros(max(int(n_rows), 1), dtype=np.uint8)
        lib.am_ingest_seq_fetch.argtypes = [i32p_, i32p_, u8p_]
        lib.am_ingest_seq_fetch.restype = i64
        got = lib.am_ingest_seq_fetch(
            obj.ctypes.data_as(i32p_), ref.ctypes.data_as(i32p_),
            vtype.ctypes.data_as(u8p_))
        if got < 0:
            return None
        seq_cols = (obj[:int(n_rows)], ref[:int(n_rows)],
                    vtype[:int(n_rows)])
        # boxed-value passthrough: per-row wire byte lengths + raw arena
        lib.am_ingest_val_size.argtypes = []
        lib.am_ingest_val_size.restype = i64
        arena_size = int(lib.am_ingest_val_size())
        if arena_size < 0:
            return None
        vlen = np.zeros(max(int(n_rows), 1), dtype=np.int32)
        arena = np.zeros(max(arena_size, 1), dtype=np.uint8)
        lib.am_ingest_val_fetch.argtypes = [i32p_, u8p_, ctypes.c_uint64]
        lib.am_ingest_val_fetch.restype = i64
        if lib.am_ingest_val_fetch(vlen.ctypes.data_as(i32p_),
                                   arena.ctypes.data_as(u8p_),
                                   arena.size) != arena_size:
            return None
        seq_cols = seq_cols + (vlen[:int(n_rows)],
                               arena[:arena_size].tobytes())
    n = max(int(n_rows), 1)
    doc = np.zeros(n, dtype=np.int32)
    key = np.zeros(n, dtype=np.int32)
    packed = np.zeros(n, dtype=np.int32)
    val = np.zeros(n, dtype=np.int32)
    flags = np.zeros(n, dtype=np.uint8)
    kb_used = i64(0)
    ab_used = i64(0)
    lib.am_ingest_blob_sizes.argtypes = [ctypes.POINTER(i64),
                                         ctypes.POINTER(i64)]
    lib.am_ingest_blob_sizes.restype = i64
    if lib.am_ingest_blob_sizes(ctypes.byref(kb_used),
                                ctypes.byref(ab_used)) < 0:
        return None
    key_blob = np.empty(max(int(kb_used.value), 1), dtype=np.uint8)
    actor_blob = np.empty(max(int(ab_used.value), 1), dtype=np.uint8)
    n_keys = i64(0)
    n_actors = i64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.am_ingest_fetch.argtypes = [i32p, i32p, i32p, i32p, u8p, u8p,
                                    ctypes.c_uint64, ctypes.POINTER(i64),
                                    u8p, ctypes.c_uint64, ctypes.POINTER(i64)]
    lib.am_ingest_fetch.restype = i64
    ret = lib.am_ingest_fetch(
        doc.ctypes.data_as(i32p), key.ctypes.data_as(i32p),
        packed.ctypes.data_as(i32p), val.ctypes.data_as(i32p),
        flags.ctypes.data_as(u8p), key_blob.ctypes.data_as(u8p),
        key_blob.size, ctypes.byref(n_keys),
        actor_blob.ctypes.data_as(u8p), actor_blob.size,
        ctypes.byref(n_actors))
    if ret < 0:
        raise ValueError('ingest fetch failed')

    def read_blob(blob_arr, count):
        from ..encoding import Decoder
        decoder = Decoder(blob_arr.tobytes())
        return [decoder.read_prefixed_string() for _ in range(count)]

    keys = read_blob(key_blob, int(n_keys.value))
    actors = read_blob(actor_blob, int(n_actors.value))
    rows = {'doc': doc[:int(n_rows)], 'key': key[:int(n_rows)],
            'packed': packed[:int(n_rows)], 'value': val[:int(n_rows)],
            'flags': flags[:int(n_rows)]}
    if seq_cols is not None:
        (rows['obj'], rows['ref'], rows['vtype'], rows['vlen'],
         rows['vblob']) = seq_cols
    if with_meta:
        rows['pred_off'], rows['pred'] = preds
        return rows, keys, actors, metas
    return rows, keys, actors


def _fetch_ingest_preds(lib, n_rows):
    """Copy out per-op pred lists (packed opIds with native actor numbers).
    Must run before am_ingest_fetch."""
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.am_ingest_pred_count.argtypes = []
    lib.am_ingest_pred_count.restype = i64
    n_preds = int(lib.am_ingest_pred_count())
    if n_preds < 0:
        return None
    pred_off = np.zeros(max(n_rows, 1) + 1, dtype=np.int64)
    pred_blob = np.zeros(max(n_preds, 1), dtype=np.int32)
    lib.am_ingest_pred_fetch.argtypes = [i64p, i32p, ctypes.c_uint64]
    lib.am_ingest_pred_fetch.restype = i64
    got = lib.am_ingest_pred_fetch(
        pred_off.ctypes.data_as(i64p), pred_blob.ctypes.data_as(i32p),
        pred_blob.size)
    if got < 0:
        return None
    return pred_off[:n_rows + 1], pred_blob[:int(got)]


def _fetch_ingest_meta(lib, n_changes):
    """Copy out the per-change metadata captured by am_ingest_changes.
    Must run before am_ingest_fetch (which frees the native context)."""
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = max(n_changes, 1)
    actor = np.zeros(n, dtype=np.int32)
    seq = np.zeros(n, dtype=np.int64)
    start_op = np.zeros(n, dtype=np.int64)
    time = np.zeros(n, dtype=np.int64)
    nops = np.zeros(n, dtype=np.int64)
    hash32 = np.zeros(32 * n, dtype=np.uint8)
    deps_off = np.zeros(n + 1, dtype=np.int64)
    msg_off = np.zeros(n + 1, dtype=np.int64)
    buf_len = np.zeros(n, dtype=np.int64)
    deps_bytes = i64(0)
    msg_bytes = i64(0)
    lib.am_ingest_meta_sizes.argtypes = [i64p, i64p]
    lib.am_ingest_meta_sizes.restype = i64
    if lib.am_ingest_meta_sizes(ctypes.byref(deps_bytes),
                                ctypes.byref(msg_bytes)) < 0:
        return None
    deps_blob = np.zeros(max(int(deps_bytes.value), 1), dtype=np.uint8)
    msg_blob = np.zeros(max(int(msg_bytes.value), 1), dtype=np.uint8)
    lib.am_ingest_meta_fetch.argtypes = [
        i32p, i64p, i64p, i64p, i64p, u8p, i64p, u8p, ctypes.c_uint64,
        i64p, u8p, ctypes.c_uint64, i64p]
    lib.am_ingest_meta_fetch.restype = i64
    got = lib.am_ingest_meta_fetch(
        actor.ctypes.data_as(i32p), seq.ctypes.data_as(i64p),
        start_op.ctypes.data_as(i64p), time.ctypes.data_as(i64p),
        nops.ctypes.data_as(i64p), hash32.ctypes.data_as(u8p),
        deps_off.ctypes.data_as(i64p), deps_blob.ctypes.data_as(u8p),
        deps_blob.size, msg_off.ctypes.data_as(i64p),
        msg_blob.ctypes.data_as(u8p), msg_blob.size,
        buf_len.ctypes.data_as(i64p))
    if got != n_changes:
        return None
    # Raw arrays/blobs only — hex strings and per-change dicts are built
    # lazily by the caller (most changes never need them on the fast path)
    return {
        'actor': actor[:n_changes], 'seq': seq[:n_changes],
        'startOp': start_op[:n_changes], 'time': time[:n_changes],
        'nops': nops[:n_changes], 'hash32': hash32.reshape(n, 32)[:n_changes],
        'deps_off': deps_off[:n_changes + 1],
        'deps_blob': deps_blob[:32 * int(deps_off[n_changes])].tobytes(),
        'msg_off': msg_off[:n_changes + 1],
        'msg_blob': msg_blob[:int(msg_off[n_changes])].tobytes(),
        'buf_len': buf_len[:n_changes],
    }


def turbo_gate(doc_off, actor, seq, hash32, deps_off, deps_blob,
               head32, head_n):
    """Batched causal-run gate (codec.cpp am_turbo_gate): the whole
    batch's deps-present / seq-contiguity checks and every doc's new
    head frontier in one native call over the extractor's hash lanes,
    GIL released.

    Inputs are the am_ingest_changes meta arrays plus the fleet's
    columnar head lanes gathered for this batch's docs: ``head32``
    [docs, lanes, 32] and ``head_n`` (heads in use; -1 when the
    frontier is wider than the lanes, which holds that doc to the chain
    shape and routes its first change's deps check back to the host).
    A doc's run passes when every dep is a start head or an earlier
    change of the same run, so buffer order is causal. Returns None
    when the codec is unavailable, else ``(doc_ok, doc_hostcheck,
    new_head32, new_n, g_doc, g_actor, g_first, g_last)``: per doc 1 (a
    chain), 2 (a causal run) or 0 (the host's gate), the host-check
    flags (1: first deps against the host's heads; 2: the end frontier
    is wider than the lanes, so the doc went to the host), the end
    frontier sorted by bytes ([docs, lanes, 32], ``new_n`` in use), and
    the per-(doc, actor) seq-run group records whose ``g_first`` the
    caller checks against its clock columns (and whose ``g_last`` it
    scatters back as the clock advance)."""
    lib = _load()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if not hasattr(lib, '_turbo_gate_ready'):
        lib.am_turbo_gate.argtypes = [
            i64p, i32p, i64p, u8p, i64p, u8p, u8p, i32p,
            i64, i64, i64, i64,
            u8p, u8p, u8p, i32p, i32p, i32p, i64p, i64p]
        lib.am_turbo_gate.restype = i64
        lib._turbo_gate_ready = True
    n_docs = len(doc_off) - 1
    n_changes = len(actor)
    doc_off = np.ascontiguousarray(doc_off, dtype=np.int64)
    actor = np.ascontiguousarray(actor, dtype=np.int32)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    hash32 = np.ascontiguousarray(hash32, dtype=np.uint8)
    deps_off = np.ascontiguousarray(deps_off, dtype=np.int64)
    deps_arr = np.frombuffer(deps_blob, dtype=np.uint8) \
        if isinstance(deps_blob, (bytes, bytearray)) else \
        np.ascontiguousarray(deps_blob, dtype=np.uint8)
    if deps_arr.size == 0:
        deps_arr = np.zeros(1, dtype=np.uint8)
    head32 = np.ascontiguousarray(head32, dtype=np.uint8)
    head_n = np.ascontiguousarray(head_n, dtype=np.int32)
    if head32.shape[0] != n_docs or head32.shape[2:] != (32,) or \
            head_n.shape != (n_docs,):
        raise ValueError('turbo_gate: head32 must be [docs, lanes, 32] '
                         'and head_n [docs]')
    n_lanes = head32.shape[1]
    # the actor column's ids are dense interned indexes; the scratch
    # tables size to the max id + 1
    n_actors = int(actor.max()) + 1 if n_changes else 1
    doc_ok = np.zeros(max(n_docs, 1), dtype=np.uint8)
    hostcheck = np.zeros(max(n_docs, 1), dtype=np.uint8)
    new32 = np.zeros((max(n_docs, 1), n_lanes, 32), dtype=np.uint8)
    new_n = np.zeros(max(n_docs, 1), dtype=np.int32)
    cap = max(n_changes, 1)
    g_doc = np.zeros(cap, dtype=np.int32)
    g_actor = np.zeros(cap, dtype=np.int32)
    g_first = np.zeros(cap, dtype=np.int64)
    g_last = np.zeros(cap, dtype=np.int64)
    n_groups = lib.am_turbo_gate(
        doc_off.ctypes.data_as(i64p), actor.ctypes.data_as(i32p),
        seq.ctypes.data_as(i64p), hash32.ctypes.data_as(u8p),
        deps_off.ctypes.data_as(i64p), deps_arr.ctypes.data_as(u8p),
        head32.ctypes.data_as(u8p), head_n.ctypes.data_as(i32p),
        n_lanes, n_docs, n_changes, n_actors,
        doc_ok.ctypes.data_as(u8p), hostcheck.ctypes.data_as(u8p),
        new32.ctypes.data_as(u8p), new_n.ctypes.data_as(i32p),
        g_doc.ctypes.data_as(i32p), g_actor.ctypes.data_as(i32p),
        g_first.ctypes.data_as(i64p), g_last.ctypes.data_as(i64p))
    if n_groups < 0:
        return None
    k = int(n_groups)
    return (doc_ok[:n_docs], hostcheck[:n_docs], new32[:n_docs],
            new_n[:n_docs], g_doc[:k], g_actor[:k], g_first[:k],
            g_last[:k])


def parse_documents(buffers):
    """Batched native document-container parse (ref columnar.js:1006-1047):
    one call parses N saved documents straight to flat columns — per-doc
    actor tables / heads / maxOp, per-change (actor, seq, maxOp) metadata,
    and document-order op rows with succ lists — with no per-change
    re-encode or hashing (the deferred-hash-graph load of ref
    new.js:1709-1749).

    Returns None when the native codec is unavailable, else a dict:
      ok          [N] uint8   1 = parsed; 0 = doc needs the Python path
      n_changes / n_ops / max_op   [N] int64 per doc
      heads_off   [N+1] int64 into heads
      heads       [H, 32] uint8 head hashes
      actor_off   [N+1] int64 into doc_actors
      doc_actors  [.] int32   per-doc actor tables (global actor numbers)
      c_doc/c_actor [C] int32, c_seq/c_max_op [C] int64 per change
      op columns  [M]: doc(i32), obj_ctr(i64), obj_actor(i32, -1=root),
                  key_ctr(i64), key_actor(i32, -1=none), key_str(i32,
                  -1=none), insert(u8), action(u8), vtype(u8), id_ctr(i64),
                  id_actor(i32), val_int(i64; int-family value or single
                  text codepoint, -1 = multi-char), val_off(i64)/val_len(i32)
                  into val_blob, succ_off [M+1] int64 into succ_ctr(i64)/
                  succ_actor(i32)
      val_blob    raw value bytes; actors / keys: global string tables
    Actions are wire numbers (0 makeMap, 1 set, 2 makeList, 4 makeText,
    5 inc, 6 makeTable); del rows never appear in documents
    (columnar.js:892)."""
    with _span('native_doc_parse', buffers=len(buffers)):
        return _parse_documents(buffers)


def _parse_documents(buffers):
    lib = _load()
    if lib is None:
        return None
    # same unowned-buffer discipline as _extract_changes: memoryviews
    # (mmap'd parked chunks on the revive path) join without a
    # per-buffer copy, and a single doc parses fully in place
    bufs = buffers if all(type(b) is bytes for b in buffers) else \
        [b if type(b) is bytes or isinstance(b, memoryview) else bytes(b)
         for b in buffers]
    n_docs = len(bufs)
    blob = bufs[0] if n_docs == 1 else b''.join(bufs)
    lens = np.fromiter(map(len, bufs), dtype=np.uint64, count=n_docs)
    offsets = np.zeros(max(n_docs, 1), dtype=np.uint64)
    if n_docs > 1:
        np.cumsum(lens[:-1], out=offsets[1:])
    arr, ptr = _u8(blob)
    u8p_ = ctypes.POINTER(ctypes.c_uint8)
    u64p_ = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.am_parse_documents.argtypes = [u8p_, u64p_, u64p_, ctypes.c_uint64]
    lib.am_parse_documents.restype = ctypes.c_int64
    if n_docs == 0:
        lens_arr = np.zeros(1, dtype=np.uint64)
    else:
        lens_arr = lens
    n_ops = int(lib.am_parse_documents(
        ptr, offsets.ctypes.data_as(u64p_),
        lens_arr.ctypes.data_as(u64p_), n_docs))
    if n_ops < 0:
        return None
    sizes = [ctypes.c_int64() for _ in range(9)]
    lib.am_docparse_sizes.argtypes = [i64p] * 9
    lib.am_docparse_sizes.restype = ctypes.c_int64
    if lib.am_docparse_sizes(*(ctypes.byref(s) for s in sizes)) != 0:
        return None
    (n_changes, n_succ, n_heads, val_bytes, actor_blob_bytes, n_actors,
     key_blob_bytes, n_keys, n_doc_actors) = (int(s.value) for s in sizes)

    def a(n, dtype):
        return np.zeros(max(n, 1), dtype=dtype)

    d_ok = a(n_docs, np.uint8)
    d_n_changes, d_n_ops, d_max_op = (a(n_docs, np.int64) for _ in range(3))
    d_heads_off = a(n_docs + 1, np.int64)
    d_actor_off = a(n_docs + 1, np.int64)
    d_actor_ids = a(n_doc_actors, np.int32)
    heads = a(n_heads * 32, np.uint8)
    c_doc, c_actor = a(n_changes, np.int32), a(n_changes, np.int32)
    c_seq, c_max_op = a(n_changes, np.int64), a(n_changes, np.int64)
    o_doc = a(n_ops, np.int32)
    o_obj_ctr = a(n_ops, np.int64)
    o_obj_actor = a(n_ops, np.int32)
    o_key_ctr = a(n_ops, np.int64)
    o_key_actor = a(n_ops, np.int32)
    o_key_str = a(n_ops, np.int32)
    o_insert, o_action, o_vtype = (a(n_ops, np.uint8) for _ in range(3))
    o_id_ctr = a(n_ops, np.int64)
    o_id_actor = a(n_ops, np.int32)
    o_val_int, o_val_off = a(n_ops, np.int64), a(n_ops, np.int64)
    o_val_len = a(n_ops, np.int32)
    val_blob = a(val_bytes, np.uint8)
    o_succ_off = a(n_ops + 1, np.int64)
    s_ctr, s_actor = a(n_succ, np.int64), a(n_succ, np.int32)
    key_blob = a(key_blob_bytes, np.uint8)
    actor_blob = a(actor_blob_bytes, np.uint8)

    lib.am_docparse_fetch.argtypes = [
        u8p_, i64p, i64p, i64p, i64p, i64p, i32p, u8p_,
        i32p, i32p, i64p, i64p,
        i32p, i64p, i32p, i64p, i32p, i32p, u8p_, u8p_, u8p_,
        i64p, i32p, i64p, i64p, i32p, u8p_, i64p, i64p, i32p,
        u8p_, ctypes.c_uint64, u8p_, ctypes.c_uint64]
    lib.am_docparse_fetch.restype = ctypes.c_int64
    got = lib.am_docparse_fetch(
        d_ok.ctypes.data_as(u8p_), d_n_changes.ctypes.data_as(i64p),
        d_n_ops.ctypes.data_as(i64p), d_max_op.ctypes.data_as(i64p),
        d_heads_off.ctypes.data_as(i64p), d_actor_off.ctypes.data_as(i64p),
        d_actor_ids.ctypes.data_as(i32p), heads.ctypes.data_as(u8p_),
        c_doc.ctypes.data_as(i32p), c_actor.ctypes.data_as(i32p),
        c_seq.ctypes.data_as(i64p), c_max_op.ctypes.data_as(i64p),
        o_doc.ctypes.data_as(i32p), o_obj_ctr.ctypes.data_as(i64p),
        o_obj_actor.ctypes.data_as(i32p), o_key_ctr.ctypes.data_as(i64p),
        o_key_actor.ctypes.data_as(i32p), o_key_str.ctypes.data_as(i32p),
        o_insert.ctypes.data_as(u8p_), o_action.ctypes.data_as(u8p_),
        o_vtype.ctypes.data_as(u8p_), o_id_ctr.ctypes.data_as(i64p),
        o_id_actor.ctypes.data_as(i32p), o_val_int.ctypes.data_as(i64p),
        o_val_off.ctypes.data_as(i64p), o_val_len.ctypes.data_as(i32p),
        val_blob.ctypes.data_as(u8p_), o_succ_off.ctypes.data_as(i64p),
        s_ctr.ctypes.data_as(i64p), s_actor.ctypes.data_as(i32p),
        key_blob.ctypes.data_as(u8p_), key_blob.size,
        actor_blob.ctypes.data_as(u8p_), actor_blob.size)
    if got != n_ops:
        return None

    def read_blob(blob_arr, count):
        from ..encoding import Decoder
        decoder = Decoder(blob_arr.tobytes())
        return [decoder.read_prefixed_string() for _ in range(count)]

    return {
        'ok': d_ok[:n_docs], 'n_changes': d_n_changes[:n_docs],
        'n_ops': d_n_ops[:n_docs], 'max_op': d_max_op[:n_docs],
        'heads_off': d_heads_off[:n_docs + 1],
        'heads': heads[:n_heads * 32].reshape(max(n_heads, 1) if n_heads
                                              else 0, 32),
        'actor_off': d_actor_off[:n_docs + 1],
        'doc_actors': d_actor_ids[:n_doc_actors],
        'c_doc': c_doc[:n_changes], 'c_actor': c_actor[:n_changes],
        'c_seq': c_seq[:n_changes], 'c_max_op': c_max_op[:n_changes],
        'doc': o_doc[:n_ops], 'obj_ctr': o_obj_ctr[:n_ops],
        'obj_actor': o_obj_actor[:n_ops], 'key_ctr': o_key_ctr[:n_ops],
        'key_actor': o_key_actor[:n_ops], 'key_str': o_key_str[:n_ops],
        'insert': o_insert[:n_ops], 'action': o_action[:n_ops],
        'vtype': o_vtype[:n_ops], 'id_ctr': o_id_ctr[:n_ops],
        'id_actor': o_id_actor[:n_ops], 'val_int': o_val_int[:n_ops],
        'val_off': o_val_off[:n_ops], 'val_len': o_val_len[:n_ops],
        'val_blob': val_blob[:val_bytes].tobytes(),
        'succ_off': o_succ_off[:n_ops + 1], 'succ_ctr': s_ctr[:n_succ],
        'succ_actor': s_actor[:n_succ],
        'actors': read_blob(actor_blob, n_actors),
        'keys': read_blob(key_blob, n_keys),
    }


def build_document(change_buffers, heads):
    """Native mirror-free save (ref columnar.js:983-1004 + the canonical
    ordering of op_set.OpSet.save): parse the doc's change log, replay into
    a succ-annotated op store, and serialize the canonical document chunk —
    all in C++. `heads` are hex hash strings. Returns the container bytes,
    or None when the log needs the Python path (link/child ops, unknown
    columns, or no native codec)."""
    lib = _load()
    if lib is None or not change_buffers:
        return None
    bufs = [bytes(b) for b in change_buffers]
    blob = b''.join(bufs)
    lens = np.fromiter(map(len, bufs), dtype=np.uint64, count=len(bufs))
    offsets = np.zeros(len(bufs), dtype=np.uint64)
    if len(bufs) > 1:
        np.cumsum(lens[:-1], out=offsets[1:])
    heads_blob = b''.join(bytes.fromhex(h) for h in heads)
    arr, ptr = _u8(blob)
    harr, hptr = _u8(heads_blob)
    u8p_ = ctypes.POINTER(ctypes.c_uint8)
    u64p_ = ctypes.POINTER(ctypes.c_uint64)
    lib.am_build_document.argtypes = [u8p_, u64p_, u64p_, ctypes.c_uint64,
                                      u8p_, ctypes.c_uint64]
    lib.am_build_document.restype = ctypes.c_int64
    lib.am_build_fetch.argtypes = [u8p_, ctypes.c_uint64]
    lib.am_build_fetch.restype = ctypes.c_int64
    size = int(lib.am_build_document(
        ptr, offsets.ctypes.data_as(u64p_), lens.ctypes.data_as(u64p_),
        len(bufs), hptr, len(heads)))
    if size < 0:
        return None
    out = np.zeros(max(size, 1), dtype=np.uint8)
    got = int(lib.am_build_fetch(out.ctypes.data_as(u8p_), out.size))
    if got != size:
        return None
    return out[:size].tobytes()


def extract_changes(buffers):
    """Native change-list extraction (the delta+main materialize kernel,
    inverse of build_document): each document chunk splits into its
    canonical per-change chunks + SHA-256 hashes + per-change maxOp,
    byte-identical to Python's ``decode_document`` + ``encode_change``
    round trip, with the header heads verified against the re-encoded
    hash frontier. Docs are independent, so the batch fans over the
    native thread pool with byte-identical output at every width.

    Returns None when the native codec is unavailable, else a list with
    one entry per input doc: ``(chunks, hashes, max_ops)`` — lists of
    change-chunk bytes, hex hash strings, and ints — or None for docs
    the extractor routed to the Python path (unknown columns, link ops,
    non-canonical payloads, or any integrity failure: the Python
    fallback reproduces the exact typed verdict)."""
    with _span('native_doc_extract', buffers=len(buffers)):
        return _extract_changes(buffers)


def _extract_changes(buffers):
    lib = _load()
    if lib is None:
        return None
    # buffer-protocol inputs pass through unowned (memoryviews into the
    # storage engine's mmap'd segments included): a single doc reads in
    # place with ZERO copies; a multi-doc batch pays exactly one join
    bufs = [b if type(b) is bytes or isinstance(b, memoryview)
            else bytes(b) for b in buffers]
    n_docs = len(bufs)
    if n_docs == 0:
        return []
    blob = bufs[0] if n_docs == 1 else b''.join(bufs)
    lens = np.fromiter(map(len, bufs), dtype=np.uint64, count=n_docs)
    offsets = np.zeros(n_docs, dtype=np.uint64)
    if n_docs > 1:
        np.cumsum(lens[:-1], out=offsets[1:])
    arr, ptr = _u8(blob)
    u8p_ = ctypes.POINTER(ctypes.c_uint8)
    u64p_ = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.am_extract_changes.argtypes = [u8p_, u64p_, u64p_, ctypes.c_uint64]
    lib.am_extract_changes.restype = ctypes.c_int64
    lib.am_extract_sizes.argtypes = [i64p, i64p]
    lib.am_extract_sizes.restype = ctypes.c_int64
    lib.am_extract_fetch.argtypes = [u8p_, i64p, i64p, u8p_, u8p_, i64p]
    lib.am_extract_fetch.restype = ctypes.c_int64
    total = int(lib.am_extract_changes(
        ptr, offsets.ctypes.data_as(u64p_), lens.ctypes.data_as(u64p_),
        n_docs))
    if total < 0:
        return None
    tc, tb = ctypes.c_int64(), ctypes.c_int64()
    if lib.am_extract_sizes(ctypes.byref(tc), ctypes.byref(tb)) != 0:
        return None
    n_changes, blob_bytes = int(tc.value), int(tb.value)
    ok = np.zeros(max(n_docs, 1), dtype=np.uint8)
    d_off = np.zeros(n_docs + 1, dtype=np.int64)
    c_off = np.zeros(n_changes + 1, dtype=np.int64)
    out_blob = np.zeros(max(blob_bytes, 1), dtype=np.uint8)
    hashes = np.zeros(max(32 * n_changes, 1), dtype=np.uint8)
    max_ops = np.zeros(max(n_changes, 1), dtype=np.int64)
    got = int(lib.am_extract_fetch(
        ok.ctypes.data_as(u8p_), d_off.ctypes.data_as(i64p),
        c_off.ctypes.data_as(i64p), out_blob.ctypes.data_as(u8p_),
        hashes.ctypes.data_as(u8p_), max_ops.ctypes.data_as(i64p)))
    if got != n_changes:
        return None
    blob_b = out_blob[:blob_bytes].tobytes()
    hash_hex = hashes[:32 * n_changes].tobytes().hex()
    out = []
    for d in range(n_docs):
        if not ok[d]:
            out.append(None)
            continue
        lo, hi = int(d_off[d]), int(d_off[d + 1])
        chunks = [blob_b[int(c_off[i]):int(c_off[i + 1])]
                  for i in range(lo, hi)]
        doc_hashes = [hash_hex[64 * i:64 * (i + 1)] for i in range(lo, hi)]
        doc_max_ops = [int(m) for m in max_ops[lo:hi]]
        out.append((chunks, doc_hashes, doc_max_ops))
    return out
