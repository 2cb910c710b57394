"""Scripts of the public `Automerge.*` API for the card checks
(tests/test_torch_cuda.py and chip_smoke.py): run one under the host
backend and once under a `FleetBackend`, and compare what comes out.

- `integration_docs(A)`: the shapes of tests/test_integration.py (maps,
  nested maps, lists, rows-in-lists, Text, Table, Counter, a concurrent
  merge with conflicts, save/load, history, the changes API and a sync
  round) as one script;
- `mixed_doc(A)`: the realistic mixed document of the reference's
  `bench_backend_mixed` (bench.py): a nested config map, rows-in-lists,
  strings, floats and bools, then 15 changes;
- `query_history(n_docs)`: the query engine's workload of the reference's
  `_sec_query` (bench.py): per doc six single-set changes, change c
  setting `k{c}` to `d * 100 + c`, with the frontier after change 3.

Every change carries the fixed time `T` and every script fixes its
actors and uuids, so two runs give the same bytes.
"""

import contextlib

import numpy as np

from .columnar import decode_change_meta, encode_change

T = 1_700_000_000        # every change's time: bytes must not follow the clock
MIXED_ACTOR = 'ab' * 16


@contextlib.contextmanager
def fixed_uuids(A):
    """Deterministic uuids (Table row ids) for the script's duration."""
    count = [0]

    def factory():
        count[0] += 1
        return f'{count[0]:08x}' * 4

    A.set_uuid_factory(factory)
    try:
        yield
    finally:
        A.set_uuid_factory(None)


def from_(A, state, actor):
    """`A.from_` with the fixed time (from_ itself stamps the clock)."""
    state = A.Frontend.normalize_initial_state(state)
    return A.change(A.init(actor), {'message': 'Initialization', 'time': T},
                    lambda doc: doc.update(state))


def change(A, doc, callback, message=None):
    options = {'time': T}
    if message is not None:
        options['message'] = message
    return A.change(doc, options, callback)


def sync(A, doc1, doc2, rounds=10):
    """Run the sync protocol between two docs until both go quiet."""
    s1, s2 = A.init_sync_state(), A.init_sync_state()
    for _ in range(rounds):
        s1, m1 = A.generate_sync_message(doc1, s1)
        if m1 is not None:
            doc2, s2, _ = A.receive_sync_message(doc2, s2, m1)
        s2, m2 = A.generate_sync_message(doc2, s2)
        if m2 is not None:
            doc1, s1, _ = A.receive_sync_message(doc1, s1, m2)
        if m1 is None and m2 is None:
            break
    return doc1, doc2


def integration_docs(A):
    """{name: document} for the integration shapes, run through package
    `A`'s API under whatever backend is installed."""
    out = {}
    with fixed_uuids(A):
        d = from_(A, {'str': 's', 'int': 42, 'float': 1.5, 'bool': True,
                      'none': None, 'i': A.Int(-5), 'u': A.Uint(5),
                      'f': A.Float64(2.0)}, 'a1' * 4)
        d = change(A, d, lambda r: r.__delitem__('int'))
        d = change(A, d, lambda r: r.update(
            {'outer': {'inner': {'deep': 'value'}}}))
        d = change(A, d, lambda r: r['outer']['inner'].update(
            {'deep': 'new'}))
        out['maps'] = d

        d1 = from_(A, {'config': {'theme': {'color': 'blue',
                                            'sizes': {'h1': 32}}},
                       'title': 'doc'}, 'a2' * 4)
        d1 = change(A, d1, lambda r: r['config']['theme'].update(
            {'color': 'red'}))
        d2 = A.merge(A.init('b2' * 4), d1)
        d1 = change(A, d1, lambda r: r['config'].update({'lang': 'en'}))
        d2 = change(A, d2, lambda r: r['config']['theme']['sizes'].update(
            {'h2': 24}))
        out['nested_maps'] = A.merge(d1, d2)

        d = from_(A, {'list': [1]}, 'a3' * 4)
        d = change(A, d, lambda r: r['list'].append(2, 3))
        d = change(A, d, lambda r: r['list'].insert(0, 0))
        d = change(A, d, lambda r: r['list'].delete_at(1, 2))
        d = change(A, d, lambda r: r['list'].extend([4, 5, 6]))
        d = change(A, d, lambda r: r['list'].__setitem__(1, 'B'))
        d = change(A, d, lambda r: r['list'].insert_at(2, 'a', 'b'))
        out['lists'] = d

        d1 = from_(A, {'todo': [{'title': 'wash', 'done': False}, 'plain',
                                [1, 2]]}, 'a4' * 4)
        d1 = change(A, d1, lambda r: r['todo'][0].update({'done': True}))
        d1 = change(A, d1, lambda r: r['todo'][2].append(3))
        d2 = A.merge(A.init('b4' * 4), d1)
        d1 = change(A, d1, lambda r: r['todo'][0].update({'who': 'a'}))
        d2 = change(A, d2, lambda r: r['todo'][0].update({'who': 'b'}))
        d1 = change(A, d1, lambda r: r['todo'].delete_at(1))
        out['rows_in_lists'] = A.merge(d1, d2)

        s1 = from_(A, {'text': A.Text('abc')}, 'a5' * 4)
        s2 = A.merge(A.init('b5' * 4), s1)
        s1 = change(A, s1, lambda r: r['text'].insert_at(0, '1'))
        s2 = change(A, s2, lambda r: r['text'].insert_at(3, '2'))
        s1 = change(A, s1, lambda r: r['text'].delete_at(2, 1))
        s2 = change(A, s2, lambda r: r['text'].set(0, 'A'))
        out['text'] = A.merge(s1, s2)

        ids = []
        d = from_(A, {'books': A.Table()}, 'a6' * 4)
        d = change(A, d, lambda r: ids.append(r['books'].add(
            {'authors': 'Kleppmann', 'title': 'DDIA'})))
        d = change(A, d, lambda r: ids.append(r['books'].add(
            {'authors': 'KB', 'title': 'STP'})))
        d = change(A, d, lambda r: r['books'].by_id(ids[1]).update(
            {'authors': 'Kleppmann'}))
        d = change(A, d, lambda r: r['books'].remove(ids[0]))
        out['table'] = d

        s1 = from_(A, {'n': A.Counter(0)}, 'a7' * 4)
        s2 = A.merge(A.init('b7' * 4), s1)
        s1 = change(A, s1, lambda r: r['n'].increment(2))
        s2 = change(A, s2, lambda r: r['n'].increment(3))
        s1 = change(A, s1, lambda r: r['n'].decrement(1))
        out['counter'] = A.merge(s1, s2)

        s1 = from_(A, {'k': 'init', 'list': ['a', 'b', 'c']}, 'a8' * 4)
        s2 = A.merge(A.init('b8' * 4), s1)
        s1 = change(A, s1, lambda r: (r.update({'k': 'one'}),
                                      r['list'].delete_at(1)))
        s2 = change(A, s2, lambda r: (r.update({'k': 'two'}),
                                      r['list'].__setitem__(1, 'B')))
        out['concurrent'] = A.merge(s1, s2)

        d = A.load(A.save(out['maps']), 'a9' * 4)
        out['save_load'] = change(A, d, lambda r: r.update({'after': 1}))

        d = from_(A, {'n': 1}, 'aa' * 4)
        d = change(A, d, lambda r: r.update({'n': 2}), 'two')
        d = change(A, d, lambda r: r.update({'n': 3}), 'three')
        out['history'] = d
        for i, entry in enumerate(A.get_history(d)):
            out[f'history_{i}'] = entry.snapshot

        base = A.clone(out['lists'], 'ad' * 4)
        other, _ = A.apply_changes(A.init('ab' * 4),
                                   A.get_all_changes(base))
        newer = change(A, base, lambda r: r['list'].append(7))
        other, _ = A.apply_changes(other, A.get_changes(base, newer))
        out['changes_api'] = other

        _, out['sync'] = sync(A, A.clone(out['rows_in_lists'], 'ae' * 4),
                              A.init('ac' * 4))
    return out


def reading(A, value):
    """What the fleet's `materialize_docs` renders for a frontend value:
    its `to_py()` form, but a Table's rows without the `id` key that the
    frontend adds to each row."""
    if isinstance(value, A.Table):
        return {rid: {k: reading(A, v) for k, v in value.by_id(rid).items()
                      if k != 'id'} for rid in value.ids}
    if isinstance(value, A.MapView):
        return {k: reading(A, v) for k, v in value.items()}
    if isinstance(value, A.ListView):
        return [reading(A, v) for v in value]
    return value.to_py() if hasattr(value, 'to_py') else value


def mixed_doc(A, n_changes=16, seed=0):
    """The reference's bench_backend_mixed document (bench.py), built
    through package `A`'s API with the fixed time: `from_` of a nested
    config map, rows-in-lists, strings, floats and bools, then
    `n_changes - 1` changes. Returns the document."""
    rng = np.random.default_rng(seed)
    d = from_(A, {'cfg': {'name': 'base', 'opts': {'depth': 1}},
                  'tags': {}, 'todo': [{'t': 'first', 'done': False}],
                  'n': 0, 'rate': 1.5, 'on': True}, MIXED_ACTOR)
    for c in range(n_changes - 1):
        k = f'k{int(rng.integers(0, 12))}'

        def edit(r, c=c, k=k):
            r['cfg']['opts'][k] = f'value-{c}'
            r['tags'][k] = float(c) if c % 3 else c
            r['n'] = c
            if c % 4 == 0:
                r['todo'].append({'t': f'task-{c}', 'done': False})
            else:
                r['todo'][0]['done'] = c % 2 == 1
        d = change(A, d, edit)
    return d


def set_change(d, seq, deps, key, value):
    """Doc `d`'s change number `seq`: one int set of `key` at the root,
    by the doc's actor (the reference's _sec_query shape)."""
    return encode_change({
        'actor': f'{d % 128:04x}' * 4, 'seq': seq, 'startOp': seq,
        'time': 0, 'message': '', 'deps': deps,
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': value, 'datatype': 'int', 'pred': []}]})


def query_history(n_docs, n_changes=6):
    """(batches, heads, mid): `batches[c]` holds every doc's change c
    (one list per doc, for `apply_changes_docs`), `heads[d]` doc d's
    heads after the last change, `mid[d]` after change n_changes // 2."""
    heads = [[] for _ in range(n_docs)]
    mid = [None] * n_docs
    batches = []
    for c in range(n_changes):
        per_doc = []
        for d in range(n_docs):
            buf = set_change(d, c + 1, heads[d], f'k{c}', d * 100 + c)
            heads[d] = [decode_change_meta(buf, True)['hash']]
            if c == n_changes // 2:
                mid[d] = list(heads[d])
            per_doc.append([buf])
        batches.append(per_doc)
    return batches, heads, mid
