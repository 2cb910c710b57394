"""Causal change-log machinery shared by every backend engine.

The reference keeps this state inside BackendDoc (new.js:1694-1768): the
SHA-256 hash graph over changes (changes, changeIndexByHash,
dependenciesByHash, dependentsByHash, hashesByActor), the vector clock and
heads, and the queue of causally-premature changes with the per-actor seq
contiguity gate (new.js:1550-1597). Both the host OpSet engine
(automerge_tpu.backend.op_set) and the device fleet documents
(automerge_tpu.fleet.backend) need exactly this bookkeeping — it is
inherently host-side, irregular dict/graph work — so it lives here once.
"""

from ..columnar import (
    decode_change, decode_change_meta, decode_document, encode_change,
    split_containers, CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE,
    CHUNK_TYPE_DOCUMENT,
)


def decode_change_buffers(change_buffers):
    """Decode a list of byte buffers (change chunks, deflated changes, or
    whole document chunks) into decoded-change dicts carrying their binary
    form under 'buffer' (ref new.js:1797-1813)."""
    if isinstance(change_buffers, (bytes, bytearray)):
        raise TypeError('applyChanges takes an array of byte buffers, '
                        'not just a single buffer')
    decoded = []
    for buffer in change_buffers:
        for chunk in split_containers(buffer):
            if chunk[8] in (CHUNK_TYPE_CHANGE, CHUNK_TYPE_DEFLATE):
                change = decode_change(chunk)
                change['buffer'] = chunk
                decoded.append(change)
            elif chunk[8] == CHUNK_TYPE_DOCUMENT:
                # decode_document normalizes each change through an
                # encode/decode round-trip, so only the buffer is missing
                for change in decode_document(chunk):
                    change['buffer'] = encode_change(change)
                    decoded.append(change)
    return decoded


class HashGraph:
    """Hash-graph + causal-gate state over a change log.

    __slots__ keeps per-document construction cheap: fleets create one
    engine per doc, so bulk init at 10k+ docs is on the turbo seam's
    critical path. Subclasses that want ad-hoc attributes (the host OpSet)
    simply omit __slots__ and get a __dict__ as usual."""

    __slots__ = ('max_op', 'actor_ids', 'heads', 'clock', 'queue',
                 'changes', 'changes_meta', 'change_index_by_hash',
                 'dependencies_by_hash', 'dependents_by_hash',
                 'hashes_by_actor', '_deferred')

    def __init__(self):
        self.max_op = 0
        self.actor_ids = []
        self.heads = []
        self.clock = {}
        self.queue = []
        self.changes = []           # binary changes, in application order
        self.changes_meta = []      # per-change metadata for document encoding
        self.change_index_by_hash = {}
        self.dependencies_by_hash = {}
        self.dependents_by_hash = {}
        self.hashes_by_actor = {}
        # Deferred-index log (the reference's deferred hash graph,
        # new.js:1709-1749): bulk appends record only (index, hash, deps,
        # actor, meta) tuples here; the query dicts above materialize lazily
        self._deferred = []

    def _defer_record(self, change):
        """Record an applied change without building the graph indexes;
        self.changes must already hold its buffer at the captured index."""
        self._deferred.append((len(self.changes) - 1, change['hash'],
                               list(change['deps']), change['actor'], {
            'actor': change['actor'], 'seq': change['seq'],
            'maxOp': change['startOp'] + len(change['ops']) - 1,
            'time': change.get('time', 0),
            'message': change.get('message') or '',
            'deps': list(change['deps']),
            'extraBytes': change.get('extraBytes'),
        }))

    def _ensure_graph(self):
        """Materialize the query dicts from the deferred log. Entries are
        either eager 5-tuples (index, hash, deps, actor, meta) or lazy
        3-tuples (index, batch, i) resolved via batch.resolve(i)."""
        if not self._deferred:
            return

        def record(index, hash, deps, actor, meta):
            self.hashes_by_actor.setdefault(actor, []).append(hash)
            self.change_index_by_hash[hash] = index
            self.dependencies_by_hash[hash] = deps
            self.dependents_by_hash.setdefault(hash, [])
            for dep in deps:
                self.dependents_by_hash.setdefault(dep, []).append(hash)
            self.changes_meta.append(meta)

        for entry in self._deferred:
            if len(entry) == 3:
                index, batch, i = entry
                if isinstance(i, (list, tuple, range)):
                    # One record covering a run of log entries [index, ...)
                    for off, j in enumerate(i):
                        record(index + off, *batch.resolve(int(j)))
                    continue
                record(index, *batch.resolve(i))
            else:
                index, hash, deps, actor, meta = entry
                record(index, hash, deps, actor, meta)
        self._deferred = []

    def _causal_gate(self, changes, applied_hashes=None):
        """Partition changes into causally-ready (applied to clock/heads) and
        enqueued (ref new.js:1550-1586). `applied_hashes` carries the hashes
        applied by earlier passes of the same apply_changes call (they are not
        yet in change_index_by_hash, but satisfy deps and must be deduped)."""
        self._ensure_graph()
        heads = set(self.heads)
        change_hashes = applied_hashes if applied_hashes is not None else set()
        clock = dict(self.clock)
        applied, enqueued = [], []
        for change in changes:
            if change['hash'] in self.change_index_by_hash or change['hash'] in change_hashes:
                continue
            expected_seq = clock.get(change['actor'], 0) + 1
            ready = all(dep in self.change_index_by_hash or dep in change_hashes
                        for dep in change['deps'])
            if not ready:
                enqueued.append(change)
            elif change['seq'] < expected_seq:
                raise ValueError(
                    f"Reuse of sequence number {change['seq']} for actor {change['actor']}")
            elif change['seq'] > expected_seq:
                raise ValueError(
                    f"Skipped sequence number {expected_seq} for actor {change['actor']}")
            else:
                clock[change['actor']] = change['seq']
                change_hashes.add(change['hash'])
                for dep in change['deps']:
                    heads.discard(dep)
                heads.add(change['hash'])
                applied.append(change)
        if applied:
            self.heads = sorted(heads)
            self.clock = clock
        return applied, enqueued

    def _drain_queue(self, decoded, apply_fn):
        """Run the causal-gate drain loop (ref new.js:1825-1841): repeatedly
        gate `decoded` + the held-back queue, calling apply_fn(change) for
        each causally-ready change, until a pass applies nothing new.
        Returns (all_applied, remaining_queue); does not commit the queue."""
        queue = decoded + self.queue
        all_applied = []
        applied_hashes = set()
        while True:
            applied, queue = self._causal_gate(queue, applied_hashes)
            for change in applied:
                apply_fn(change)
            all_applied.extend(applied)
            if not applied or not queue:
                break
        return all_applied, queue

    def _record_applied(self, change):
        """Record one applied change into the log and hash graph
        (ref new.js appendChange:1680-1692)."""
        self.changes.append(change['buffer'])
        self.hashes_by_actor.setdefault(change['actor'], []).append(change['hash'])
        self.change_index_by_hash[change['hash']] = len(self.changes) - 1
        self.dependencies_by_hash[change['hash']] = list(change['deps'])
        self.dependents_by_hash.setdefault(change['hash'], [])
        for dep in change['deps']:
            self.dependents_by_hash.setdefault(dep, []).append(change['hash'])
        self.changes_meta.append({
            'actor': change['actor'], 'seq': change['seq'],
            'maxOp': change['startOp'] + len(change['ops']) - 1,
            'time': change.get('time', 0), 'message': change.get('message') or '',
            'deps': list(change['deps']),
            'extraBytes': change.get('extraBytes'),
        })

    # ------------------------------------------------------------------
    # History / hash graph queries (ref new.js:1921-2028)
    # ------------------------------------------------------------------

    def get_changes(self, have_deps):
        if not have_deps:
            self._ensure_graph()
            return list(self.changes)
        return [self.changes[self.change_index_by_hash[h]]
                for h in self.get_change_hashes(have_deps)]

    def get_change_hashes(self, have_deps):
        """Hashes of get_changes(have_deps), without touching the change
        buffers — the sync driver's Bloom builds need only hashes, and
        re-decoding every buffer per round (the reference's own TODO at
        sync.js:378) dominated fleet-scale sync profiles. get_changes is
        a buffer lookup over this (single copy of the traversal)."""
        if have_deps and sorted(have_deps) == sorted(self.heads):
            # have_deps IS the current frontier: every change is an
            # ancestor of it, so the delta is empty BY DEFINITION — a
            # heads compare, no graph walk, and crucially no _ensure_graph
            # (a freshly loaded doc answering a converged handshake would
            # otherwise build its whole O(history) dict set to learn
            # "nothing since lastSync"). The quiet steady state of every
            # sync/replication round lands here.
            return []
        self._ensure_graph()

        def ordered_hashes():
            out = [None] * len(self.changes)
            for h, i in self.change_index_by_hash.items():
                out[i] = h
            return out

        if not have_deps:
            return ordered_hashes()
        stack, seen, to_return = [], set(), []
        for h in have_deps:
            seen.add(h)
            successors = self.dependents_by_hash.get(h)
            if successors is None:
                raise ValueError(f'hash not found: {h}')
            stack.extend(successors)
        while stack:
            h = stack.pop()
            seen.add(h)
            to_return.append(h)
            if not all(dep in seen for dep in self.dependencies_by_hash[h]):
                break
            stack.extend(self.dependents_by_hash[h])
        if not stack and all(head in seen for head in self.heads):
            return to_return
        # Slow path: collect ancestors of have_deps, return everything else
        stack, seen = list(have_deps), set()
        while stack:
            h = stack.pop()
            if h not in seen:
                deps = self.dependencies_by_hash.get(h)
                if deps is None:
                    raise ValueError(f'hash not found: {h}')
                stack.extend(deps)
                seen.add(h)
        return [h for h in ordered_hashes() if h not in seen]

    def get_changes_added(self, other):
        self._ensure_graph()
        if isinstance(other, HashGraph):
            other._ensure_graph()
        stack, seen, to_return = list(self.heads), set(), []
        while stack:
            h = stack.pop()
            if h not in seen and h not in other.change_index_by_hash:
                seen.add(h)
                to_return.append(h)
                stack.extend(self.dependencies_by_hash[h])
        return [self.changes[self.change_index_by_hash[h]] for h in reversed(to_return)]

    def get_change_by_hash(self, hash):
        self._ensure_graph()
        index = self.change_index_by_hash.get(hash)
        return self.changes[index] if index is not None else None

    def get_missing_deps(self, heads=()):
        self._ensure_graph()
        all_deps = set(heads)
        in_queue = set()
        for change in self.queue:
            in_queue.add(change['hash'])
            all_deps.update(change['deps'])
        return sorted(h for h in all_deps
                      if h not in self.change_index_by_hash and h not in in_queue)
