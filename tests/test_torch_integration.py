# The port's copy of tests/test_integration.py, imports re-pointed at automerge_tpu_torch.
"""Integration tests for the public API, modeled on reference test/test.js:
init/change semantics, lists, nested maps, counters, concurrent use and
convergence, save/load round trips, history, and the changes API."""

import datetime

import pytest

import automerge_tpu_torch as A


def assert_equals_one_of(actual, *expected):
    assert any(A.equals(actual, e) for e in expected), \
        f'{actual!r} not equal to any of {expected!r}'


class TestInitAndChange:
    def test_init_empty(self):
        doc = A.init()
        assert A.equals(doc, {})

    def test_no_change_returns_same_doc(self):
        doc = A.init()
        doc2 = A.change(doc, 'empty', lambda d: None)
        assert doc2 is doc

    def test_set_root_key(self):
        doc = A.change(A.init('aabbcc'), lambda d: d.update({'bird': 'magpie'}))
        assert dict(doc) == {'bird': 'magpie'}

    def test_from_initial_state(self):
        doc = A.from_({'birds': {'wrens': 3, 'sparrows': 15}})
        assert A.equals(doc, {'birds': {'wrens': 3, 'sparrows': 15}})
        history = A.get_history(doc)
        assert len(history) == 1
        assert history[0].change['message'] == 'Initialization'

    def test_delete_key(self):
        doc = A.from_({'a': 1, 'b': 2})
        doc = A.change(doc, lambda d: d.__delitem__('a'))
        assert A.equals(doc, {'b': 2})

    def test_nested_maps(self):
        doc = A.change(A.init(), lambda d: d.update(
            {'outer': {'inner': {'deep': 'value'}}}))
        assert doc['outer']['inner']['deep'] == 'value'
        doc = A.change(doc, lambda d: d['outer']['inner'].update({'deep': 'new'}))
        assert doc['outer']['inner']['deep'] == 'new'

    def test_types(self):
        now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
        doc = A.from_({'str': 's', 'int': 42, 'float': 1.5, 'bool': True,
                       'none': None, 'when': now})
        doc2 = A.load(A.save(doc))
        assert doc2['str'] == 's'
        assert doc2['int'] == 42
        assert doc2['float'] == 1.5
        assert doc2['bool'] is True
        assert doc2['none'] is None
        assert doc2['when'] == now

    def test_int_uint_float_wrappers(self):
        doc = A.from_({'i': A.Int(-5), 'u': A.Uint(5), 'f': A.Float64(2.0)})
        doc2 = A.load(A.save(doc))
        assert doc2['i'] == -5
        assert doc2['u'] == 5
        assert doc2['f'] == 2.0

    def test_nested_change_raises(self):
        doc = A.init()
        with pytest.raises(TypeError, match='cannot be nested'):
            A.change(doc, lambda d: A.change(d, lambda d2: None))

    def test_empty_change(self):
        doc = A.from_({'a': 1})
        doc2 = A.empty_change(doc, 'ack')
        changes = A.get_all_changes(doc2)
        assert len(changes) == 2
        assert A.decode_change(changes[1])['message'] == 'ack'
        assert A.decode_change(changes[1])['ops'] == []


class TestLists:
    def test_create_and_read(self):
        doc = A.from_({'birds': ['chaffinch', 'goldfinch']})
        assert list(doc['birds']) == ['chaffinch', 'goldfinch']
        assert len(doc['birds']) == 2

    def test_append_insert_delete(self):
        doc = A.from_({'list': [1]})
        doc = A.change(doc, lambda d: d['list'].append(2, 3))
        assert list(doc['list']) == [1, 2, 3]
        doc = A.change(doc, lambda d: d['list'].insert(0, 0))
        assert list(doc['list']) == [0, 1, 2, 3]
        doc = A.change(doc, lambda d: d['list'].delete_at(1, 2))
        assert list(doc['list']) == [0, 3]

    def test_set_index(self):
        doc = A.from_({'list': ['a', 'b', 'c']})
        doc = A.change(doc, lambda d: d['list'].__setitem__(1, 'B'))
        assert list(doc['list']) == ['a', 'B', 'c']

    def test_assign_past_end_pads_with_none(self):
        doc = A.from_({'list': ['a']})
        doc = A.change(doc, lambda d: d['list'].__setitem__(3, 'd'))
        assert list(doc['list']) == ['a', None, None, 'd']

    def test_nested_objects_in_lists(self):
        doc = A.from_({'todos': [{'title': 'one', 'done': False}]})
        doc = A.change(doc, lambda d: d['todos'][0].update({'done': True}))
        assert doc['todos'][0]['done'] is True

    def test_element_ids_stable(self):
        doc = A.from_({'list': ['a', 'b']}, 'aa')
        ids1 = A.Frontend.get_element_ids(doc['list'])
        doc = A.change(doc, lambda d: d['list'].insert(1, 'x'))
        ids2 = A.Frontend.get_element_ids(doc['list'])
        assert ids2[0] == ids1[0]
        assert ids2[2] == ids1[1]

    def test_multi_insert_positions(self):
        doc = A.from_({'list': []})
        doc = A.change(doc, lambda d: d['list'].extend([1, 2, 3, 4, 5]))
        doc = A.change(doc, lambda d: d['list'].insert_at(2, 'a', 'b'))
        assert list(doc['list']) == [1, 2, 'a', 'b', 3, 4, 5]
        doc2 = A.load(A.save(doc))
        assert list(doc2['list']) == [1, 2, 'a', 'b', 3, 4, 5]


class TestConcurrentUse:
    def test_concurrent_map_updates_converge(self):
        s1 = A.from_({'k': 'init'}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d.update({'k': 'one'}))
        s2 = A.change(s2, lambda d: d.update({'k': 'two'}))
        m1 = A.merge(s1, s2)
        m2 = A.merge(s2, m1)
        assert A.equals(m1, m2)
        # higher actor wins LWW
        assert m1['k'] == 'two'
        assert A.get_conflicts(m1, 'k') == {'2@111111': 'one', '2@222222': 'two'}

    def test_concurrent_different_keys(self):
        s1 = A.from_({'a': 1}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d.update({'b': 2}))
        s2 = A.change(s2, lambda d: d.update({'c': 3}))
        m1 = A.merge(s1, s2)
        assert A.equals(m1, {'a': 1, 'b': 2, 'c': 3})

    def test_concurrent_list_inserts_converge(self):
        s1 = A.from_({'list': ['m']}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d['list'].insert(0, 'a1'))
        s2 = A.change(s2, lambda d: d['list'].insert(0, 'a2'))
        m1 = A.merge(s1, s2)
        m2 = A.merge(s2, m1)
        assert A.equals(m1, m2)
        assert_equals_one_of(list(m1['list']),
                             ['a1', 'a2', 'm'], ['a2', 'a1', 'm'])

    def test_concurrent_delete_and_update(self):
        s1 = A.from_({'list': ['a', 'b', 'c']}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d['list'].delete_at(1))
        s2 = A.change(s2, lambda d: d['list'].__setitem__(1, 'B'))
        m1 = A.merge(s1, s2)
        m2 = A.merge(s2, m1)
        assert A.equals(m1, m2)
        # The concurrent update resurrects the deleted element
        assert list(m1['list']) == ['a', 'B', 'c']

    def test_three_way_convergence(self):
        base = A.from_({'seen': []}, 'aa0011')
        docs = [A.merge(A.init(actor), base) for actor in ('bb0011', 'cc0011')]
        docs.insert(0, base)
        for i, doc in enumerate(docs):
            docs[i] = A.change(doc, lambda d, i=i: d['seen'].append(f'actor{i}'))
        merged = docs[0]
        for other in docs[1:]:
            merged = A.merge(merged, other)
        final0 = A.merge(docs[1], merged)
        final1 = A.merge(docs[2], final0)
        assert A.equals(final0, final1)
        assert sorted(final1['seen']) == ['actor0', 'actor1', 'actor2']


class TestCounters:
    def test_counter_in_map(self):
        doc = A.from_({'n': A.Counter(0)}, '111111')
        doc = A.change(doc, lambda d: d['n'].increment())
        doc = A.change(doc, lambda d: d['n'].increment(3))
        doc = A.change(doc, lambda d: d['n'].decrement(2))
        assert doc['n'].value == 2

    def test_concurrent_counter_increments_add(self):
        s1 = A.from_({'n': A.Counter(0)}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d['n'].increment(2))
        s2 = A.change(s2, lambda d: d['n'].increment(3))
        m1 = A.merge(s1, s2)
        m2 = A.merge(s2, m1)
        assert A.equals(m1, m2)
        assert m1['n'].value == 5

    def test_counter_overwrite_rejected(self):
        doc = A.from_({'n': A.Counter(1)})
        with pytest.raises(ValueError, match='Cannot overwrite a Counter'):
            A.change(doc, lambda d: d.update({'n': 5}))

    def test_counter_round_trip(self):
        doc = A.from_({'n': A.Counter(10)})
        doc = A.change(doc, lambda d: d['n'].increment(5))
        doc2 = A.load(A.save(doc))
        assert doc2['n'].value == 15


class TestSaveLoad:
    def test_round_trip_complex(self):
        doc = A.from_({
            'map': {'nested': {'deep': [1, 2, {'x': 'y'}]}},
            'list': ['a', 1, True, None],
            'text': A.Text('hello'),
            'counter': A.Counter(5),
        }, 'abcdef')
        doc2 = A.load(A.save(doc))
        assert A.equals(doc, doc2)
        assert str(doc2['text']) == 'hello'
        assert doc2['counter'].value == 5

    def test_incremental_via_changes(self):
        doc = A.from_({'a': 1}, '111111')
        changes = A.get_all_changes(doc)
        doc = A.change(doc, lambda d: d.update({'b': 2}))
        incremental = A.get_all_changes(doc)[len(changes):]
        other = A.init('222222')
        other, _ = A.apply_changes(other, changes + incremental)
        assert A.equals(other, {'a': 1, 'b': 2})

    def test_get_last_local_change(self):
        doc = A.from_({'a': 1})
        last = A.get_last_local_change(doc)
        assert last is not None
        assert A.decode_change(last)['message'] == 'Initialization'

    def test_save_load_preserves_conflicts(self):
        s1 = A.from_({'k': 'init'}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d.update({'k': 'one'}))
        s2 = A.change(s2, lambda d: d.update({'k': 'two'}))
        m = A.merge(s1, s2)
        loaded = A.load(A.save(m))
        assert A.get_conflicts(loaded, 'k') == {'2@111111': 'one', '2@222222': 'two'}


class TestHistory:
    def test_history_snapshots(self):
        doc = A.from_({'n': 1}, 'aa')
        doc = A.change(doc, 'two', lambda d: d.update({'n': 2}))
        doc = A.change(doc, 'three', lambda d: d.update({'n': 3}))
        history = A.get_history(doc)
        assert len(history) == 3
        assert [h.change['message'] for h in history] == \
            ['Initialization', 'two', 'three']
        assert [h.snapshot['n'] for h in history] == [1, 2, 3]


class TestChangesAPI:
    def test_get_changes_between_docs(self):
        doc1 = A.from_({'a': 1}, '111111')
        doc2 = A.change(doc1, lambda d: d.update({'b': 2}))
        changes = A.get_changes(doc1, doc2)
        assert len(changes) == 1
        assert A.decode_change(changes[0])['ops'][0]['key'] == 'b'

    def test_patch_callback(self):
        calls = []

        def cb(patch, before, after, local, changes):
            calls.append((patch, local, len(changes)))
        doc = A.init({'actorId': 'aabb', 'patchCallback': cb})
        doc = A.change(doc, lambda d: d.update({'bird': 'magpie'}))
        assert len(calls) == 1
        patch, local, n = calls[0]
        assert local is True and n == 1
        assert patch['diffs']['props']['bird']

    def test_observable(self):
        observed = []
        observable = A.Observable()
        doc = A.init({'actorId': 'aabb', 'observable': observable})
        doc = A.change(doc, lambda d: d.update({'bird': 'magpie'}))
        observable.observe(doc, lambda diff, before, after, local, changes:
                           observed.append((diff, local)))
        doc = A.change(doc, lambda d: d.update({'bird': 'jay'}))
        assert len(observed) == 1
        assert observed[0][1] is True

    def test_uuid_factory(self):
        counter = [0]

        def factory():
            counter[0] += 1
            return f'{counter[0]:04d}' * 8
        A.set_uuid_factory(factory)
        try:
            doc = A.init()
            assert A.get_actor_id(doc) == '0001' * 8
        finally:
            A.set_uuid_factory(None)


class TestText:
    def test_text_editing(self):
        doc = A.from_({'text': A.Text()}, 'aa')
        doc = A.change(doc, lambda d: d['text'].insert_at(0, 'h', 'i'))
        assert str(doc['text']) == 'hi'
        doc = A.change(doc, lambda d: d['text'].insert_at(0, 'H', 'I', ' '))
        assert str(doc['text']) == 'HI hi'
        doc = A.change(doc, lambda d: d['text'].delete_at(3, 2))
        assert str(doc['text']) == 'HI '

    def test_text_set(self):
        doc = A.from_({'text': A.Text('abc')})
        doc = A.change(doc, lambda d: d['text'].set(1, 'B'))
        assert str(doc['text']) == 'aBc'

    def test_text_spans(self):
        doc = A.from_({'text': A.Text('ab')}, 'aa')
        doc = A.change(doc, lambda d: d['text'].insert_at(2, {'type': 'em'}))
        doc = A.change(doc, lambda d: d['text'].insert_at(3, 'c', 'd'))
        spans = doc['text'].to_spans()
        assert spans[0] == 'ab'
        assert dict(spans[1]) == {'type': 'em'}
        assert spans[2] == 'cd'

    def test_concurrent_text_editing_converges(self):
        s1 = A.from_({'text': A.Text('abc')}, '111111')
        s2 = A.merge(A.init('222222'), s1)
        s1 = A.change(s1, lambda d: d['text'].insert_at(0, '1'))
        s2 = A.change(s2, lambda d: d['text'].insert_at(3, '2'))
        m1 = A.merge(s1, s2)
        m2 = A.merge(s2, m1)
        assert A.equals(m1, m2)
        assert str(m1['text']) == '1abc2'


class TestTable:
    def test_table_add_query_remove(self):
        doc = A.from_({'books': A.Table()}, 'aa')
        row_id = []
        doc = A.change(doc, lambda d: row_id.append(d['books'].add(
            {'authors': 'Kleppmann', 'title': 'DDIA'})))
        assert doc['books'].count == 1
        row = doc['books'].by_id(row_id[0])
        assert row['title'] == 'DDIA'
        assert row['id'] == row_id[0]
        rows = doc['books'].filter(lambda r: r['title'] == 'DDIA')
        assert len(rows) == 1
        doc = A.change(doc, lambda d: d['books'].remove(row_id[0]))
        assert doc['books'].count == 0

    def test_table_round_trip(self):
        doc = A.from_({'t': A.Table()}, 'aa')
        doc = A.change(doc, lambda d: d['t'].add({'n': 1}))
        doc = A.change(doc, lambda d: d['t'].add({'n': 2}))
        doc2 = A.load(A.save(doc))
        assert doc2['t'].count == 2
        assert sorted(r['n'] for r in doc2['t'].rows) == [1, 2]


class TestFrontendRequestQueue:
    """Backend-less frontend mode: change requests are queued and patches
    applied asynchronously (ref test/frontend_test.js:241-300)."""

    def test_request_queue_roundtrip(self):
        from automerge_tpu_torch import frontend as Frontend
        from automerge_tpu_torch import backend as Backend

        doc = Frontend.init({'actorId': 'aabb', 'deferActorId': False})
        doc, req = Frontend.change(doc, lambda d: d.update({'bird': 'magpie'}))
        assert req['ops'][0]['key'] == 'bird'
        assert dict(doc) == {'bird': 'magpie'}  # optimistically applied

        # Round-trip the request through a separate backend
        b = Backend.init()
        b, patch, binary = Backend.apply_local_change(b, req)
        doc2 = Frontend.apply_patch(doc, patch)
        assert dict(doc2) == {'bird': 'magpie'}

    def test_concurrent_local_requests_rebase(self):
        from automerge_tpu_torch import frontend as Frontend
        from automerge_tpu_torch import backend as Backend

        doc = Frontend.init({'actorId': 'aabb'})
        doc, req1 = Frontend.change(doc, lambda d: d.update({'a': 1}))
        doc, req2 = Frontend.change(doc, lambda d: d.update({'b': 2}))
        assert dict(doc) == {'a': 1, 'b': 2}

        b = Backend.init()
        b, patch1, _ = Backend.apply_local_change(b, req1)
        doc = Frontend.apply_patch(doc, patch1)
        assert dict(doc) == {'a': 1, 'b': 2}
        b, patch2, _ = Backend.apply_local_change(b, req2)
        doc = Frontend.apply_patch(doc, patch2)
        assert dict(doc) == {'a': 1, 'b': 2}
