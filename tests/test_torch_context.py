# The port's copy of tests/test_context.py, imports re-pointed at automerge_tpu_torch.
"""Mutation-context conformance tests: assert the exact ops and local diffs
each mutation emits (ported semantics of reference test/context_test.js, which
replaces applyPatch with a sinon spy and inspects context.ops)."""

import datetime

import pytest

import automerge_tpu_torch as am
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.frontend.context import Context
from automerge_tpu_torch.frontend.apply_patch import interpret_patch
from automerge_tpu_torch.frontend.proxies import root_object_proxy
from automerge_tpu_torch.frontend import Text, Table, Counter

ACTOR = 'aabbcc'


class PatchSpy:
    """Records every local diff handed to applyPatch, then really applies it
    so multi-step mutations inside one test still see their own writes."""

    def __init__(self):
        self.calls = []

    def __call__(self, diff, root, updated):
        self.calls.append(diff)
        interpret_patch(diff, root, updated)


def make_doc(setup=None):
    """A document built through the real API (so caches/conflicts are real),
    plus a fresh Context with a recording patch spy."""
    doc = am.init(ACTOR)
    if setup is not None:
        doc = am.change(doc, setup)
    spy = PatchSpy()
    context = Context(doc, ACTOR, apply_patch=spy)
    root_object_proxy(context)   # wires context.instantiate_object
    return doc, context, spy


class TestSetMapKey:
    def test_assign_primitive_to_map_key(self):
        _doc, context, spy = make_doc()
        context.set_map_key([], 'sparrows', 5)
        assert context.ops == [{'obj': '_root', 'action': 'set',
                                'key': 'sparrows', 'insert': False, 'value': 5,
                                'datatype': 'int', 'pred': []}]
        assert spy.calls == [{
            'objectId': '_root', 'type': 'map', 'props': {
                'sparrows': {f'1@{ACTOR}': {'type': 'value', 'value': 5,
                                            'datatype': 'int'}}}}]

    def test_noop_if_value_unchanged(self):
        _doc, context, spy = make_doc(lambda d: d.update({'goldfinches': 3}))
        context.set_map_key([], 'goldfinches', 3)
        assert context.ops == []
        assert spy.calls == []

    def test_allows_conflict_resolution(self):
        # A doc with a conflict on 'magpies': assigning even the winning value
        # must emit an op (it resolves the conflict)
        doc1 = am.init('aa11')
        doc1 = am.change(doc1, lambda d: d.update({'magpies': 1}))
        doc2 = am.init('bb22')
        doc2 = am.change(doc2, lambda d: d.update({'magpies': 2}))
        merged = am.merge(doc1, doc2)
        assert am.get_conflicts(merged, 'magpies') is not None
        spy = PatchSpy()
        context = Context(merged, ACTOR, apply_patch=spy)
        context.set_map_key([], 'magpies', merged['magpies'])
        assert len(context.ops) == 1
        assert len(context.ops[0]['pred']) == 2

    def test_create_nested_maps(self):
        _doc, context, spy = make_doc()
        context.set_map_key([], 'birds', {'goldfinches': 3})
        assert context.ops == [
            {'obj': '_root', 'action': 'makeMap', 'key': 'birds',
             'insert': False, 'pred': []},
            {'obj': f'1@{ACTOR}', 'action': 'set', 'key': 'goldfinches',
             'insert': False, 'value': 3, 'datatype': 'int', 'pred': []},
        ]
        assert spy.calls == [{
            'objectId': '_root', 'type': 'map', 'props': {'birds': {
                f'1@{ACTOR}': {'objectId': f'1@{ACTOR}', 'type': 'map',
                               'props': {'goldfinches': {
                                   f'2@{ACTOR}': {'type': 'value', 'value': 3,
                                                  'datatype': 'int'}}}}}}}]

    def test_assignment_inside_nested_maps(self):
        doc, context, spy = make_doc(lambda d: d.update({'birds': {'goldfinches': 3}}))
        birds_id = Frontend.get_object_id(doc['birds'])
        context.set_map_key([{'key': 'birds', 'objectId': birds_id}],
                            'goldfinches', 15)
        assert context.ops == [{'obj': birds_id, 'action': 'set',
                                'key': 'goldfinches', 'insert': False,
                                'value': 15, 'datatype': 'int', 'pred': [f'2@{ACTOR}']}]

    def test_create_nested_lists(self):
        _doc, context, spy = make_doc()
        context.set_map_key([], 'birds', ['sparrow', 'goldfinch'])
        assert context.ops == [
            {'obj': '_root', 'action': 'makeList', 'key': 'birds',
             'insert': False, 'pred': []},
            {'obj': f'1@{ACTOR}', 'action': 'set', 'elemId': '_head',
             'insert': True, 'values': ['sparrow', 'goldfinch'], 'pred': []},
        ]

    def test_create_nested_text(self):
        _doc, context, spy = make_doc()
        context.set_map_key([], 'text', Text('hi'))
        assert context.ops == [
            {'obj': '_root', 'action': 'makeText', 'key': 'text',
             'insert': False, 'pred': []},
            {'obj': f'1@{ACTOR}', 'action': 'set', 'elemId': '_head',
             'insert': True, 'values': ['h', 'i'], 'pred': []},
        ]

    def test_create_nested_table(self):
        _doc, context, spy = make_doc()
        context.set_map_key([], 'books', Table())
        assert context.ops == [{'obj': '_root', 'action': 'makeTable',
                                'key': 'books', 'insert': False, 'pred': []}]
        assert spy.calls == [{
            'objectId': '_root', 'type': 'map', 'props': {'books': {
                f'1@{ACTOR}': {'objectId': f'1@{ACTOR}', 'type': 'table',
                               'props': {}}}}}]

    def test_assign_date_value(self):
        now = datetime.datetime.now(datetime.timezone.utc)
        _doc, context, spy = make_doc()
        context.set_map_key([], 'now', now)
        ts = int(round(now.timestamp() * 1000))
        assert context.ops == [{'obj': '_root', 'action': 'set', 'key': 'now',
                                'insert': False, 'value': ts,
                                'datatype': 'timestamp', 'pred': []}]

    def test_assign_counter_value(self):
        _doc, context, spy = make_doc()
        context.set_map_key([], 'counter', Counter(3))
        assert context.ops == [{'obj': '_root', 'action': 'set',
                                'key': 'counter', 'insert': False, 'value': 3,
                                'datatype': 'counter', 'pred': []}]


class TestDeleteMapKey:
    def test_remove_existing_key(self):
        _doc, context, spy = make_doc(lambda d: d.update({'sparrows': 5}))
        context.delete_map_key([], 'sparrows')
        assert context.ops == [{'obj': '_root', 'action': 'del',
                                'key': 'sparrows', 'insert': False,
                                'pred': [f'1@{ACTOR}']}]
        assert spy.calls == [{'objectId': '_root', 'type': 'map',
                              'props': {'sparrows': {}}}]

    def test_noop_if_key_missing(self):
        _doc, context, spy = make_doc()
        context.delete_map_key([], 'sparrows')
        assert context.ops == []
        assert spy.calls == []


class TestListManipulation:
    def setup_list(self):
        doc, context, spy = make_doc(lambda d: d.update({'birds': ['sparrow',
                                                                  'goldfinch']}))
        list_id = Frontend.get_object_id(doc['birds'])
        path = [{'key': 'birds', 'objectId': list_id}]
        return doc, context, spy, list_id, path

    def test_overwrite_existing_element(self):
        _doc, context, _spy, list_id, path = self.setup_list()
        context.set_list_index(path, 0, 'starling')
        assert context.ops == [{'obj': list_id, 'action': 'set',
                                'elemId': f'2@{ACTOR}', 'insert': False,
                                'value': 'starling', 'pred': [f'2@{ACTOR}']}]

    def test_nested_objects_on_assignment(self):
        _doc, context, _spy, list_id, path = self.setup_list()
        context.set_list_index(path, 1, {'english': 'goldfinch'})
        assert context.ops == [
            {'obj': list_id, 'action': 'makeMap', 'elemId': f'3@{ACTOR}',
             'insert': False, 'pred': [f'3@{ACTOR}']},
            {'obj': f'4@{ACTOR}', 'action': 'set', 'key': 'english',
             'insert': False, 'value': 'goldfinch', 'pred': []},
        ]

    def test_nested_objects_on_insertion(self):
        _doc, context, _spy, list_id, path = self.setup_list()
        context.splice(path, 2, 0, [{'english': 'goldfinch'}])
        assert context.ops == [
            {'obj': list_id, 'action': 'makeMap', 'elemId': f'3@{ACTOR}',
             'insert': True, 'pred': []},
            {'obj': f'4@{ACTOR}', 'action': 'set', 'key': 'english',
             'insert': False, 'value': 'goldfinch', 'pred': []},
        ]

    def test_multi_insert_for_primitive_runs(self):
        _doc, context, _spy, list_id, path = self.setup_list()
        context.splice(path, 2, 0, ['greenfinch', 'bullfinch'])
        assert context.ops == [{'obj': list_id, 'action': 'set',
                                'elemId': f'3@{ACTOR}', 'insert': True,
                                'values': ['greenfinch', 'bullfinch'],
                                'pred': []}]

    def test_delete_single_element(self):
        _doc, context, spy, list_id, path = self.setup_list()
        context.splice(path, 0, 1, [])
        assert context.ops == [{'obj': list_id, 'action': 'del',
                                'elemId': f'2@{ACTOR}', 'insert': False,
                                'pred': [f'2@{ACTOR}']}]
        subpatch = next(iter(spy.calls[-1]['props']['birds'].values()))
        assert subpatch['edits'] == [{'action': 'remove', 'index': 0,
                                      'count': 1}]

    def test_multi_delete_compression(self):
        # Consecutive elemIds with consecutive preds compress to one multiOp
        _doc, context, _spy, list_id, path = self.setup_list()
        context.splice(path, 0, 2, [])
        assert context.ops == [{'obj': list_id, 'action': 'del',
                                'elemId': f'2@{ACTOR}', 'insert': False,
                                'pred': [f'2@{ACTOR}'], 'multiOp': 2}]

    def test_multi_delete_broken_run(self):
        # Overwriting the middle element breaks the consecutive-pred run:
        # deletion must emit separate del ops
        doc = am.init(ACTOR)
        doc = am.change(doc, lambda d: d.update({'birds': ['a', 'b', 'c']}))
        doc = am.change(doc, lambda d: d['birds'].__setitem__(1, 'B'))
        spy = PatchSpy()
        context = Context(doc, ACTOR, apply_patch=spy)
        list_id = Frontend.get_object_id(doc['birds'])
        path = [{'key': 'birds', 'objectId': list_id}]
        context.splice(path, 0, 3, [])
        del_ops = [op for op in context.ops if op['action'] == 'del']
        assert len(del_ops) > 1

    def test_splice_delete_and_insert(self):
        _doc, context, spy, list_id, path = self.setup_list()
        context.splice(path, 0, 1, ['wren'])
        assert context.ops == [
            {'obj': list_id, 'action': 'del', 'elemId': f'2@{ACTOR}',
             'insert': False, 'pred': [f'2@{ACTOR}']},
            {'obj': list_id, 'action': 'set', 'elemId': '_head',
             'insert': True, 'value': 'wren', 'pred': []},
        ]

    def test_counter_delete_from_list_rejected(self):
        doc = am.init(ACTOR)
        doc = am.change(doc, lambda d: d.update({'counts': [Counter(1)]}))
        spy = PatchSpy()
        context = Context(doc, ACTOR, apply_patch=spy)
        context.instantiate_object = lambda *a, **k: None
        list_id = Frontend.get_object_id(doc['counts'])
        path = [{'key': 'counts', 'objectId': list_id}]
        with pytest.raises(TypeError):
            context.splice(path, 0, 1, [])


class TestTableManipulation:
    def test_add_table_row(self):
        doc = am.init(ACTOR)
        doc = am.change(doc, lambda d: d.update({'books': Table()}))
        spy = PatchSpy()
        context = Context(doc, ACTOR, apply_patch=spy)
        table_id = Frontend.get_object_id(doc['books'])
        path = [{'key': 'books', 'objectId': table_id}]
        am.set_uuid_factory(lambda: '11111111-1111-1111-1111-111111111111')
        try:
            row_id = context.add_table_row(
                path, {'title': 'Korm', 'author': 'Fravia'})
        finally:
            am.set_uuid_factory(None)
        assert row_id == '11111111-1111-1111-1111-111111111111'
        assert context.ops == [
            {'obj': table_id, 'action': 'makeMap', 'key': row_id,
             'insert': False, 'pred': []},
            {'obj': f'2@{ACTOR}', 'action': 'set', 'key': 'author',
             'insert': False, 'value': 'Fravia', 'pred': []},
            {'obj': f'2@{ACTOR}', 'action': 'set', 'key': 'title',
             'insert': False, 'value': 'Korm', 'pred': []},
        ]

    def test_delete_table_row(self):
        doc = am.init(ACTOR)

        def setup(d):
            d['books'] = Table()
            d['books'].add({'title': 'Korm', 'author': 'Fravia'})
        doc = am.change(doc, setup)
        table = doc['books']
        row_id = table.ids[0]
        row_op_id = table.op_ids[row_id]
        spy = PatchSpy()
        context = Context(doc, ACTOR, apply_patch=spy)
        table_id = Frontend.get_object_id(table)
        path = [{'key': 'books', 'objectId': table_id}]
        context.delete_table_row(path, row_id, row_op_id)
        assert context.ops == [{'obj': table_id, 'action': 'del',
                                'key': row_id, 'insert': False,
                                'pred': [row_op_id]}]


class TestIncrement:
    def test_increment_counter(self):
        doc, context, spy = make_doc(lambda d: d.update({'counter': Counter(0)}))
        context.increment([], 'counter', 1)
        assert context.ops == [{'obj': '_root', 'action': 'inc',
                                'key': 'counter', 'insert': False, 'value': 1,
                                'pred': [f'1@{ACTOR}']}]
        assert spy.calls == [{'objectId': '_root', 'type': 'map', 'props': {
            'counter': {f'2@{ACTOR}': {'value': 1, 'datatype': 'counter'}}}}]


class TestConflictedContexts:
    """Remaining context cases (ref context_test.js:80-119, 205-218,
    344-359), built through the real API so conflicts are genuine."""

    def test_assignment_inside_conflicted_maps(self):
        # Two actors concurrently assign a nested map to the same key; a
        # write through the winner must patch BOTH conflict branches (the
        # loser gets an empty props node)
        doc1 = am.change(am.init('aa11'),
                         lambda d: d.update({'birds': {'robins': 1}}))
        doc2 = am.change(am.init('bb22'),
                         lambda d: d.update({'birds': {'wrens': 2}}))
        merged = am.merge(doc1, doc2)
        conflicts = am.get_conflicts(merged, 'birds')
        assert len(conflicts) == 2
        winner_id = Frontend.get_object_id(merged['birds'])
        spy = PatchSpy()
        context = Context(merged, ACTOR, apply_patch=spy)
        context.set_map_key([{'key': 'birds', 'objectId': winner_id}],
                            'goldfinches', 3)
        assert context.ops == [
            {'obj': winner_id, 'action': 'set', 'key': 'goldfinches',
             'insert': False, 'value': 3, 'datatype': 'int', 'pred': []}]
        branches = spy.calls[0]['props']['birds']
        assert len(branches) == 2
        winner_key = next(k for k, v in branches.items()
                          if v['objectId'] == winner_id)
        assert list(branches[winner_key]['props']['goldfinches'].values()) \
            == [{'type': 'value', 'value': 3, 'datatype': 'int'}]
        loser = next(v for v in branches.values()
                     if v['objectId'] != winner_id)
        assert loser['props'] == {}

    def test_conflict_values_of_various_types(self):
        # Conflicting values of different types all surface in the patch
        # with their correct datatypes
        now = datetime.datetime.now(
            datetime.timezone.utc).replace(microsecond=0)
        docs = [
            am.change(am.init('aa11'), lambda d: d.update({'v': now})),
            am.change(am.init('bb22'), lambda d: d.update({'v': Counter()})),
            am.change(am.init('cc33'), lambda d: d.update({'v': 42})),
            am.change(am.init('dd44'), lambda d: d.update({'v': None})),
            am.change(am.init('ee55'), lambda d: d.update({'v': {'x': 1}})),
        ]
        merged = docs[0]
        for other in docs[1:]:
            merged = am.merge(merged, other)
        conflicts = am.get_conflicts(merged, 'v')
        assert len(conflicts) == 5
        # Update inside the nested-map branch (if it won) or assign through
        # the root; either way the context must describe all five branches
        spy = PatchSpy()
        context = Context(merged, ACTOR, apply_patch=spy)
        nested_id = Frontend.get_object_id(docs[4]['v'])
        context.set_map_key([{'key': 'v', 'objectId': nested_id}], 'x', 2)
        branches = spy.calls[0]['props']['v']
        assert len(branches) == 5
        values = {k: v for k, v in branches.items()}
        assert {'type': 'value', 'value': 42,
                'datatype': 'int'} in values.values()
        assert {'type': 'value', 'value': None} in values.values()
        assert any(v.get('datatype') == 'timestamp'
                   for v in values.values())
        assert any(v.get('datatype') == 'counter' for v in values.values())
        assert any(v.get('type') == 'map' for v in values.values())

    def test_delete_key_in_nested_object(self):
        doc, context, spy = make_doc(
            lambda d: d.update({'birds': {'goldfinches': 3}}))
        birds_id = Frontend.get_object_id(doc['birds'])
        context.delete_map_key([{'key': 'birds', 'objectId': birds_id}],
                               'goldfinches')
        assert context.ops == [
            {'obj': birds_id, 'action': 'del', 'key': 'goldfinches',
             'insert': False, 'pred': [f'2@{ACTOR}']}]
        branch = next(iter(spy.calls[0]['props']['birds'].values()))
        assert branch['props'] == {'goldfinches': {}}

    def test_multi_delete_consecutive_preds_after_overwrite(self):
        # An overwritten element (pred points at the overwrite op) followed
        # by an original element: preds 3@.. then 2@.. are NOT consecutive,
        # so two separate del ops are emitted; but overwriting in a way that
        # leaves preds consecutive compresses (ref context_test.js:344)
        doc = am.change(am.init(ACTOR),
                        lambda d: d.update({'birds': ['swallow', 'magpie']}))
        doc = am.change(doc, lambda d: d['birds'].__setitem__(1, 'sparrow'))
        spy = PatchSpy()
        context = Context(doc, ACTOR, apply_patch=spy)
        list_id = Frontend.get_object_id(doc['birds'])
        path = [{'key': 'birds', 'objectId': list_id}]
        context.splice(path, 0, 2, [])
        # elemIds 2@,3@ are consecutive and preds 2@,4@ are not: the run
        # must break on preds
        del_ops = [op for op in context.ops if op['action'] == 'del']
        assert [op.get('multiOp') for op in del_ops] == [None, None]
        subpatch = next(iter(spy.calls[-1]['props']['birds'].values()))
        assert subpatch['edits'] == [
            {'action': 'remove', 'index': 0, 'count': 2}]
