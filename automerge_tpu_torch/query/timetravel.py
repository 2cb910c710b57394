"""Time-travel reads: materialize a document at any historical frontier.

The change journal and hash graph make every historical version of every
document addressable; this module serves them. ``materialize_at(source,
heads)`` reconstructs the document state at the heads frontier by
selecting the frontier's ancestor closure from the causal history
(query/history.py — hash-graph / extractor change-meta lanes only, no op
columns inflated for the selection) and replaying the selected buffers
through the existing batched apply path onto a FRESH fleet slot. The
batched ``materialize_at_docs`` variant runs N audit reads as one fused
dispatch: one ``init_docs`` allocation + one quarantining
``apply_changes_docs`` for the whole batch, regardless of N.

Sources can be live fleet docs, promoted host docs, parked
``MainStore``/``StorageEngine`` rows (read compute-on-compressed — the
parked doc is NOT revived into the fleet), or raw saved chunks. The
result is an ordinary backend handle: read it, save it, diff it, free it
(the caller owns the ephemeral slot).

Frontiers outside the history raise typed ``UnknownHeads`` (with a
forensic flight-recorder dump in quarantine mode); replay divergence —
the reconstructed doc's heads not matching the normalized frontier — is
an internal invariant violation and raises hard.

With no ``fleet`` and no live fleet doc among the sources, the reads go
to ``fleet.backend.default_fleet()``, which is on CUDA: CPU callers pass
``fleet=DocFleet(device='cpu')``.
"""

import time

from ..errors import DocError, UnknownHeads, WireCorruption
from ..observability import hist as _hist
from ..observability import recorder as _flight
from ..observability.spans import span as _span
from .history import frontier_of, history_of, select_ancestors

__all__ = ['materialize_at', 'materialize_at_docs']


def materialize_at_docs(sources, heads_list, fleet=None, deadline=None,
                        on_error='raise'):
    """Reconstruct N historical reads in one fused dispatch.

    ``sources[i]`` is any query source (see ``history.history_of``);
    ``heads_list[i]`` its requested frontier (hex hash list; ``[]`` is
    the empty document). Returns handles in input order.

    ``on_error='raise'`` (default) aborts the batch on the first bad
    frontier (typed ``UnknownHeads`` carrying ``doc_index``).
    ``on_error='quarantine'`` returns ``(handles, errors)``: a bad
    frontier, an unreadable (rotted) source chunk, or a history the
    apply gate rejects costs ONLY its own slot (``errors[i]`` is a
    ``DocError``, ``handles[i]`` is None) while the other reads commit
    in the same fused dispatch. ``deadline`` is checked before the selection walk
    and again by the apply seam before the fused dispatch — a read is
    served whole or not at all (reads mutate nothing, so the bound is
    purely latency)."""
    from ..fleet import backend as fleet_backend
    from . import _stats

    n = len(sources)
    if len(heads_list) != n:
        raise ValueError('sources and heads_list must align')
    quarantine = on_error == 'quarantine'
    if not quarantine and on_error != 'raise':
        raise ValueError(f"on_error must be 'raise' or 'quarantine', "
                         f'got {on_error!r}')
    if fleet is None:
        for source in sources:
            state = source.get('state') if isinstance(source, dict) else None
            if state is not None and getattr(state, 'is_fleet', False):
                fleet = state.fleet
                break
        if fleet is None:
            fleet = fleet_backend.default_fleet()

    start = time.perf_counter()
    errors = [None] * n
    per_doc = [None] * n
    expect = [None] * n
    with _span('materialize_at', docs=n):
        if deadline is not None:
            deadline.check(what='materialize_at_docs')
        for i, (source, heads) in enumerate(zip(sources, heads_list)):
            heads = [str(h) for h in heads]
            try:
                history = history_of(source)
                expect[i] = frontier_of(history, heads,
                                        what='materialize_at')
                per_doc[i] = select_ancestors(history, expect[i],
                                              what='materialize_at')
            except (UnknownHeads, WireCorruption) as exc:
                # UnknownHeads: the frontier names missing history;
                # WireCorruption (MalformedDocument): a rotted parked
                # chunk failed extraction. Both are THIS doc's problem.
                if getattr(exc, 'doc_index', None) is None:
                    exc.doc_index = i
                if isinstance(exc, UnknownHeads):
                    _stats.inc('unknown_heads')
                if not quarantine:
                    raise
                errors[i] = DocError(i, 'select', exc)
                per_doc[i] = []
                expect[i] = []
        if any(e is not None for e in errors):
            _flight.dump_flight_record('query', detail={'errors': [
                e.describe() for e in errors if e is not None]})
        handles = fleet_backend.init_docs(n, fleet)
        if any(per_doc):
            try:
                if quarantine:
                    # a history whose selected buffers fail the apply
                    # gate (e.g. a rotted chunk's extracted change) must
                    # cost only ITS slot, like a bad frontier does
                    handles, _patches, apply_errors = \
                        fleet_backend.apply_changes_docs(
                            handles, per_doc, mirror=False,
                            on_error='quarantine', deadline=deadline)
                    for i, err in enumerate(apply_errors):
                        if err is not None and errors[i] is None:
                            errors[i] = err
                else:
                    handles, _patches = fleet_backend.apply_changes_docs(
                        handles, per_doc, mirror=False, deadline=deadline)
            except Exception:
                # nothing committed (all-or-nothing seam): release the
                # freshly allocated slots before propagating
                fleet_backend.free_docs(handles)
                raise
        to_free = []
        diverged = None
        for i, handle in enumerate(handles):
            if errors[i] is not None:
                to_free.append(handle)
                handles[i] = None
                continue
            got = sorted(fleet_backend.get_heads(handle))
            if got != expect[i] and diverged is None:
                diverged = (i, got)
        if diverged is not None:
            # internal invariant violation: free the WHOLE batch before
            # raising (nothing here is safe to hand out)
            fleet_backend.free_docs([h for h in handles if h is not None])
            i, got = diverged
            raise AssertionError(
                f'materialize_at doc {i}: replay reached frontier '
                f'{got} instead of {expect[i]}')
        if to_free:
            fleet_backend.free_docs(to_free)
    elapsed = time.perf_counter() - start
    _stats.inc('timetravel_reads', n)
    _hist.record_value('materialize_at_s', elapsed, scale=1e9, unit='s')
    if quarantine:
        return handles, errors
    return handles


def materialize_at(source, heads, fleet=None, deadline=None):
    """One historical read: the document at frontier `heads`, as a fresh
    backend handle (see ``materialize_at_docs`` for the batched form —
    N reads there cost the same dispatches as one here)."""
    return materialize_at_docs([source], [heads], fleet=fleet,
                               deadline=deadline)[0]
