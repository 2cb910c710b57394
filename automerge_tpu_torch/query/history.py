"""Causal-history selection for the query engine.

Both query families (time-travel reads and incremental patch
subscriptions) reduce to the same primitive: given a document's change
log and a heads frontier, partition the log into the frontier's ANCESTOR
CLOSURE (everything causally at-or-before the frontier) and its
complement (everything past it). This module answers that question over
every document form the system has, without ever inflating op columns
for the selection step:

- **Live fleet docs** use the HashGraph the engine already maintains
  (``dependencies_by_hash`` / ``change_index_by_hash``). For bulk-loaded
  or parked-then-revived docs those dicts materialize through the native
  extractor's change-meta lanes (``_doc_resolve``: per-change hash +
  header-only decode — op columns untouched).
- **Parked MainStore docs** never leave the store: the chunk splits into
  canonical per-change buffers + hashes via ``native.extract_changes``
  (Python ``decode_document`` fallback), and deps come from header-only
  ``decode_change_meta`` reads of those buffers, resolved lazily — a
  selection touching K ancestors decodes K headers, not the whole log.

Selections come back as change BUFFERS in log order. Log order is
causally valid by construction (a change's deps always precede it, both
in application order and in the document container's canonical order),
so a selection replays through the ordinary batched apply path with no
re-sorting. Frontier hashes outside the history raise typed
``UnknownHeads`` — the caller (query/timetravel.py, subscriptions.py)
decides between rejection and resync.
"""

from .. import native
from ..columnar import decode_change_meta, decode_document, encode_change
from ..errors import MalformedDocument, UnknownHeads, as_wire_error

__all__ = ['ChunkHistory', 'history_of', 'select_ancestors',
           'select_descendants', 'frontier_of']


class ChunkHistory:
    """Change-log view over a parked document chunk: canonical per-change
    buffers + hashes from the extractor, deps decoded header-only and
    lazily per change. Shaped like the slice of HashGraph the selection
    walk needs (``change_index_by_hash`` / ``changes`` / ``heads``)."""

    __slots__ = ('changes', 'hashes', 'change_index_by_hash', '_deps',
                 'heads')

    def __init__(self, chunk, heads=None):
        # memoryview chunks (parked docs in the mmap'd segment arena)
        # extract in place — the time-travel read path never copies the
        # compressed bytes off the page cache
        if not isinstance(chunk, (bytes, memoryview)):
            chunk = bytes(chunk)
        extracted = native.extract_changes([chunk]) \
            if native.available() else None
        if extracted is not None and extracted[0] is not None:
            buffers, hashes, _max_ops = extracted[0]
            self._deps = [None] * len(buffers)
        else:
            try:
                decoded = decode_document(chunk)
            except MalformedDocument:
                raise
            except Exception as exc:
                raise as_wire_error(exc, MalformedDocument, 'ChunkHistory')
            buffers = [encode_change(ch) for ch in decoded]
            hashes = [ch['hash'] for ch in decoded]
            self._deps = [list(ch['deps']) for ch in decoded]
        self.changes = buffers
        self.hashes = hashes
        self.change_index_by_hash = {h: i for i, h in enumerate(hashes)}
        if heads is not None:
            self.heads = sorted(heads)
        else:
            deps = set()
            for i in range(len(buffers)):
                deps.update(self.deps_of(i))
            self.heads = sorted(h for h in hashes if h not in deps)

    def deps_of(self, i):
        deps = self._deps[i]
        if deps is None:
            deps = self._deps[i] = \
                list(decode_change_meta(self.changes[i])['deps'])
        return deps


def history_of(source, heads=None):
    """Normalize a query source into a selection-capable history view.

    Accepts a backend handle dict (``{'state': ...}``), a bare engine
    state, raw document-chunk ``bytes``, or a ``(store, id)`` pair where
    ``store`` is a ``StorageEngine`` or ``MainStore`` — the parked form;
    the chunk is read compute-on-compressed, the doc is NOT revived."""
    if isinstance(source, (bytes, bytearray)):
        return ChunkHistory(source, heads=heads)
    if isinstance(source, tuple) and len(source) == 2:
        store, doc_id = source
        return ChunkHistory(store.chunk(doc_id), heads=store.heads(doc_id))
    state = source.get('state') if isinstance(source, dict) else source
    if state is None or not hasattr(state, 'change_index_by_hash'):
        raise ValueError(f'not a query source: {source!r}')
    return state


def _deps_fn(history):
    """hash -> deps-list lookup over either history form. Live engines'
    graph dicts materialize lazily (FleetDoc properties ensure it; bare
    HashGraph subclasses expose _ensure_graph)."""
    if isinstance(history, ChunkHistory):
        index = history.change_index_by_hash
        return lambda h: history.deps_of(index[h])
    ensure = getattr(history, '_ensure_graph', None)
    if ensure is not None:
        ensure()
    deps_by_hash = history.dependencies_by_hash
    return deps_by_hash.__getitem__


def _walk(deps, roots):
    """Hash closure of `roots` under the deps relation (inclusive)."""
    seen = set()
    stack = list(roots)
    while stack:
        h = stack.pop()
        if h in seen:
            continue
        seen.add(h)
        stack.extend(deps(h))
    return seen


def _check_known(history, heads, what):
    index = history.change_index_by_hash
    missing = sorted(h for h in heads if h not in index)
    if missing:
        raise UnknownHeads(
            f'{what}: {len(missing)} hash(es) outside the document '
            f'history: {", ".join(m[:16] for m in missing[:4])}'
            f'{"..." if len(missing) > 4 else ""}', missing=missing)


def select_ancestors(history, heads, what='select_ancestors'):
    """Change buffers of the ancestor closure of `heads`, in log order
    (causally valid for replay). `heads` == [] selects nothing (the
    empty document frontier)."""
    if not heads:
        return []
    _check_known(history, heads, what)
    seen = _walk(_deps_fn(history), heads)
    index = history.change_index_by_hash
    rows = sorted(index[h] for h in seen)
    changes = history.changes
    return [changes[i] for i in rows]


def select_descendants(history, have_heads, what='select_descendants'):
    """Change buffers PAST the `have_heads` frontier (the log minus the
    frontier's ancestor closure), in log order — the incremental patch a
    subscriber at that cursor is owed. `have_heads` == [] returns the
    whole log (the full-resync payload)."""
    changes = history.changes      # materialize first: the index needs it
    if not have_heads:
        return list(changes)
    _check_known(history, have_heads, what)
    seen = _walk(_deps_fn(history), have_heads)
    index = history.change_index_by_hash
    keep = sorted(i for h, i in index.items() if h not in seen)
    return [changes[i] for i in keep]


def frontier_of(history, heads, what='frontier_of'):
    """Normalize a requested frontier to its MAXIMAL elements: the subset
    of `heads` not in the strict ancestor closure of the others (a
    frontier listing both a change and its ancestor is legal input; the
    ancestor is redundant). This is what the replayed document's heads
    will equal."""
    heads = list(dict.fromkeys(heads))
    _check_known(history, heads, what)
    deps = _deps_fn(history)
    strict = _walk(deps, [d for h in heads for d in deps(h)])
    return sorted(h for h in heads if h not in strict)
