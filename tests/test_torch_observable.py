# The port's copy of tests/test_observable.py, imports re-pointed at automerge_tpu_torch.
"""Observable conformance tests (ported semantics of reference
test/observable_test.js: per-object subscriptions, before/after states,
remote changes, tables, text, multiple observers)."""

import pytest

import automerge_tpu_torch as am
from automerge_tpu_torch.frontend import Observable, Table, Text


class TestObservable:
    def test_callback_on_root(self):
        observable = Observable()
        doc = am.init({'observable': observable})
        actor = am.get_actor_id(doc)
        calls = []
        observable.observe(doc, lambda diff, before, after, local, changes:
                           calls.append((diff, before, after, local)))
        doc2 = am.change(doc, lambda d: d.update({'bird': 'Goldfinch'}))
        assert len(calls) == 1
        diff, before, after, local = calls[0]
        assert diff['props'] == {'bird': {f'1@{actor}': {
            'type': 'value', 'value': 'Goldfinch'}}}
        assert dict(before) == {}
        assert dict(after) == {'bird': 'Goldfinch'}
        assert local is True

    def test_callback_on_text(self):
        observable = Observable()
        doc = am.init({'observable': observable})
        doc = am.change(doc, lambda d: d.update({'text': Text('hello')}))
        calls = []
        observable.observe(doc['text'],
                           lambda diff, before, after, local, changes:
                           calls.append((diff, before, after)))
        doc2 = am.change(doc, lambda d: d['text'].delete_at(0, 5))
        assert len(calls) == 1
        diff, before, after = calls[0]
        assert diff['edits'] == [{'action': 'remove', 'index': 0, 'count': 5}]
        assert str(before) == 'hello'
        assert str(after) == ''

    def test_callback_on_remote_changes(self):
        observable = Observable()
        local = am.init({'observable': observable})
        local = am.change(local, lambda d: d.update({'bird': 'Goldfinch'}))
        calls = []
        observable.observe(local, lambda diff, before, after, local_, changes:
                           calls.append((after, local_)))
        remote, _ = am.apply_changes(am.init(), am.get_all_changes(local))
        remote = am.change(remote, lambda d: d.update({'fish': 'Herring'}))
        local2, _patch = am.apply_changes(local,
                                          am.get_all_changes(remote)[1:])
        assert len(calls) == 1
        after, was_local = calls[0]
        assert dict(after) == {'bird': 'Goldfinch', 'fish': 'Herring'}
        assert was_local is False

    def test_observe_nested_in_list(self):
        observable = Observable()
        doc = am.init({'observable': observable})
        doc = am.change(doc, lambda d: d.update(
            {'birds': [{'species': 'Goldfinch', 'count': 3}]}))
        calls = []
        observable.observe(doc['birds'][0],
                           lambda diff, before, after, local, changes:
                           calls.append((before, after)))
        doc2 = am.change(doc, lambda d: d['birds'][0].update({'count': 4}))
        assert len(calls) == 1
        before, after = calls[0]
        assert before == {'species': 'Goldfinch', 'count': 3}
        assert after == {'species': 'Goldfinch', 'count': 4}

    def test_before_after_with_shifted_list_indexes(self):
        observable = Observable()
        doc = am.init({'observable': observable})
        doc = am.change(doc, lambda d: d.update(
            {'birds': [{'species': 'Goldfinch', 'count': 3}]}))
        calls = []
        observable.observe(doc['birds'][0],
                           lambda diff, before, after, local, changes:
                           calls.append((before, after)))

        def edit(d):
            d['birds'].insert_at(0, {'species': 'Chaffinch', 'count': 1})
            d['birds'][1]['count'] = 4
        doc2 = am.change(doc, edit)
        assert len(calls) == 1
        before, after = calls[0]
        assert before == {'species': 'Goldfinch', 'count': 3}
        assert after == {'species': 'Goldfinch', 'count': 4}

    def test_observe_table_rows(self):
        observable = Observable()
        doc = am.init({'observable': observable})
        holder = {}

        def setup(d):
            d['books'] = Table()
            holder['id'] = d['books'].add({'title': 'old'})
        doc = am.change(doc, setup)
        calls = []
        observable.observe(doc['books'].by_id(holder['id']),
                           lambda diff, before, after, local, changes:
                           calls.append((before, after)))
        doc2 = am.change(
            doc, lambda d: d['books'].by_id(holder['id']).update(
                {'title': 'new'}))
        assert len(calls) == 1
        before, after = calls[0]
        assert before['title'] == 'old'
        assert after['title'] == 'new'

    def test_observe_nested_object_inside_text(self):
        observable = Observable()
        doc = am.init({'observable': observable})

        def setup(d):
            d['text'] = Text('ab')
            d['text'].insert_at(1, {'attribute': 'bold'})
        doc = am.change(doc, setup)
        calls = []
        observable.observe(doc['text'][1],
                           lambda diff, before, after, local, changes:
                           calls.append((before, after)))
        doc2 = am.change(doc,
                         lambda d: d['text'][1].update({'attribute': 'italic'}))
        assert len(calls) == 1
        before, after = calls[0]
        assert before == {'attribute': 'bold'}
        assert after == {'attribute': 'italic'}

    def test_rejects_non_document_objects(self):
        observable = Observable()
        with pytest.raises(TypeError):
            observable.observe({'not': 'a doc object'}, lambda *a: None)

    def test_multiple_observers(self):
        observable = Observable()
        doc = am.init({'observable': observable})
        calls_a, calls_b = [], []
        observable.observe(doc, lambda *a: calls_a.append(a))
        observable.observe(doc, lambda *a: calls_b.append(a))
        am.change(doc, lambda d: d.update({'x': 1}))
        assert len(calls_a) == 1 and len(calls_b) == 1
