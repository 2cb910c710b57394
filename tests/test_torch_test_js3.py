# The port's copy of tests/test_test_js3.py, imports re-pointed at automerge_tpu_torch.
"""Port of the reference public-API suite, part 3 (ref test/test.js:873-1508):
concurrent use, multiple insertions at the same list position, saving and
loading, the history API, and the changes API.
"""

import re

import pytest

import automerge_tpu_torch as A
from automerge_tpu_torch.backend import get_heads, get_missing_deps
from automerge_tpu_torch.frontend import get_backend_state

UUID_PATTERN = re.compile(r'^[0-9a-f]{32}$')


def assert_equals_one_of(actual, *expected):
    assert any(A.equals(actual, e) for e in expected), \
        f'{actual!r} not equal to any of {expected!r}'


class TestConcurrentUse:
    """ref test/test.js:873-1131"""

    def test_merges_concurrent_updates_of_different_properties(self):
        s1 = A.change(A.init(), lambda d: d.update({'foo': 'bar'}))
        s2 = A.change(A.init(), lambda d: d.update({'hello': 'world'}))
        s3 = A.merge(s1, s2)
        assert s3['foo'] == 'bar'
        assert s3['hello'] == 'world'
        assert A.equals(s3, {'foo': 'bar', 'hello': 'world'})
        assert A.get_conflicts(s3, 'foo') is None
        assert A.get_conflicts(s3, 'hello') is None

    def test_adds_concurrent_increments_of_same_property(self):
        s1 = A.change(A.init(), lambda d: d.update({'counter': A.Counter()}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['counter'].increment())
        s2 = A.change(s2, lambda d: d['counter'].increment(2))
        s3 = A.merge(s1, s2)
        assert s1['counter'].value == 1
        assert s2['counter'].value == 2
        assert s3['counter'].value == 3
        assert A.get_conflicts(s3, 'counter') is None

    def test_adds_increments_only_to_the_values_they_precede(self):
        s1 = A.change(A.init(), lambda d: d.update({'counter': A.Counter(0)}))
        s1 = A.change(s1, lambda d: d['counter'].increment())
        s2 = A.change(A.init(), lambda d: d.update({'counter': A.Counter(100)}))
        s2 = A.change(s2, lambda d: d['counter'].increment(3))
        s3 = A.merge(s1, s2)
        if A.get_actor_id(s1) > A.get_actor_id(s2):
            assert s3['counter'].value == 1
        else:
            assert s3['counter'].value == 103
        conflicts = A.get_conflicts(s3, 'counter')
        assert conflicts[f'1@{A.get_actor_id(s1)}'].value == 1
        assert conflicts[f'1@{A.get_actor_id(s2)}'].value == 103

    def test_detects_concurrent_updates_of_same_field(self):
        s1 = A.change(A.init(), lambda d: d.update({'field': 'one'}))
        s2 = A.change(A.init(), lambda d: d.update({'field': 'two'}))
        s3 = A.merge(s1, s2)
        if A.get_actor_id(s1) > A.get_actor_id(s2):
            assert A.equals(s3, {'field': 'one'})
        else:
            assert A.equals(s3, {'field': 'two'})
        assert A.get_conflicts(s3, 'field') == {
            f'1@{A.get_actor_id(s1)}': 'one',
            f'1@{A.get_actor_id(s2)}': 'two'}

    def test_detects_concurrent_updates_of_same_list_element(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['finch']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].__setitem__(0, 'greenfinch'))
        s2 = A.change(s2, lambda d: d['birds'].__setitem__(0, 'goldfinch'))
        s3 = A.merge(s1, s2)
        if A.get_actor_id(s1) > A.get_actor_id(s2):
            assert list(s3['birds']) == ['greenfinch']
        else:
            assert list(s3['birds']) == ['goldfinch']
        assert A.get_conflicts(s3['birds'], 0) == {
            f'3@{A.get_actor_id(s1)}': 'greenfinch',
            f'3@{A.get_actor_id(s2)}': 'goldfinch'}

    def test_assignment_conflicts_of_different_types(self):
        s1 = A.change(A.init(), lambda d: d.update({'field': 'string'}))
        s2 = A.change(A.init(), lambda d: d.update({'field': ['list']}))
        s3 = A.change(A.init(), lambda d: d.update({'field': {'thing': 'map'}}))
        s1 = A.merge(A.merge(s1, s2), s3)
        assert_equals_one_of(s1['field'], 'string', ['list'], {'thing': 'map'})
        conflicts = A.get_conflicts(s1, 'field')
        assert conflicts[f'1@{A.get_actor_id(s1)}'] == 'string'
        assert A.equals(conflicts[f'1@{A.get_actor_id(s2)}'], ['list'])
        assert A.equals(conflicts[f'1@{A.get_actor_id(s3)}'], {'thing': 'map'})

    def test_changes_within_a_conflicting_map_field(self):
        s1 = A.change(A.init(), lambda d: d.update({'field': 'string'}))
        s2 = A.change(A.init(), lambda d: d.update({'field': {}}))
        s2 = A.change(s2, lambda d: d['field'].update({'innerKey': 42}))
        s3 = A.merge(s1, s2)
        assert_equals_one_of(s3['field'], 'string', {'innerKey': 42})
        conflicts = A.get_conflicts(s3, 'field')
        assert conflicts[f'1@{A.get_actor_id(s1)}'] == 'string'
        assert A.equals(conflicts[f'1@{A.get_actor_id(s2)}'], {'innerKey': 42})

    def test_changes_within_a_conflicting_list_element(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': ['hello']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['list'].__setitem__(0, {'map1': True}))
        s1 = A.change(s1, lambda d: d['list'][0].update({'key': 1}))
        s2 = A.change(s2, lambda d: d['list'].__setitem__(0, {'map2': True}))
        s2 = A.change(s2, lambda d: d['list'][0].update({'key': 2}))
        s3 = A.merge(s1, s2)
        if A.get_actor_id(s1) > A.get_actor_id(s2):
            assert A.equals(s3['list'], [{'map1': True, 'key': 1}])
        else:
            assert A.equals(s3['list'], [{'map2': True, 'key': 2}])
        conflicts = A.get_conflicts(s3['list'], 0)
        assert A.equals(conflicts[f'3@{A.get_actor_id(s1)}'],
                        {'map1': True, 'key': 1})
        assert A.equals(conflicts[f'3@{A.get_actor_id(s2)}'],
                        {'map2': True, 'key': 2})

    def test_does_not_merge_concurrently_assigned_nested_maps(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'config': {'background': 'blue'}}))
        s2 = A.change(A.init(), lambda d: d.update(
            {'config': {'logo_url': 'logo.png'}}))
        s3 = A.merge(s1, s2)
        assert_equals_one_of(s3['config'],
                             {'background': 'blue'}, {'logo_url': 'logo.png'})
        conflicts = A.get_conflicts(s3, 'config')
        assert A.equals(conflicts[f'1@{A.get_actor_id(s1)}'],
                        {'background': 'blue'})
        assert A.equals(conflicts[f'1@{A.get_actor_id(s2)}'],
                        {'logo_url': 'logo.png'})

    def test_clears_conflicts_after_assigning_new_value(self):
        s1 = A.change(A.init(), lambda d: d.update({'field': 'one'}))
        s2 = A.change(A.init(), lambda d: d.update({'field': 'two'}))
        s3 = A.merge(s1, s2)
        s3 = A.change(s3, lambda d: d.update({'field': 'three'}))
        assert A.equals(s3, {'field': 'three'})
        assert A.get_conflicts(s3, 'field') is None
        s2 = A.merge(s2, s3)
        assert A.equals(s2, {'field': 'three'})
        assert A.get_conflicts(s2, 'field') is None

    def test_concurrent_insertions_at_different_list_positions(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': ['one', 'three']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['list'].insert(1, 'two'))
        s2 = A.change(s2, lambda d: d['list'].append('four'))
        s3 = A.merge(s1, s2)
        assert A.equals(s3, {'list': ['one', 'two', 'three', 'four']})
        assert A.get_conflicts(s3, 'list') is None

    def test_concurrent_insertions_at_same_list_position(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['parakeet']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].append('starling'))
        s2 = A.change(s2, lambda d: d['birds'].append('chaffinch'))
        s3 = A.merge(s1, s2)
        assert_equals_one_of(s3['birds'],
                             ['parakeet', 'starling', 'chaffinch'],
                             ['parakeet', 'chaffinch', 'starling'])
        s2 = A.merge(s2, s3)
        assert A.equals(s2, s3)

    def test_concurrent_assignment_and_deletion_of_map_entry(self):
        # Add-wins semantics
        s1 = A.change(A.init(), lambda d: d.update({'bestBird': 'robin'}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d.__delitem__('bestBird'))
        s2 = A.change(s2, lambda d: d.update({'bestBird': 'magpie'}))
        s3 = A.merge(s1, s2)
        assert A.equals(s1, {})
        assert A.equals(s2, {'bestBird': 'magpie'})
        assert A.equals(s3, {'bestBird': 'magpie'})
        assert A.get_conflicts(s3, 'bestBird') is None

    def test_concurrent_assignment_and_deletion_of_list_element(self):
        # Concurrent assignment resurrects a deleted list element
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': ['blackbird', 'thrush', 'goldfinch']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].__setitem__(1, 'starling'))
        s2 = A.change(s2, lambda d: d['birds'].delete_at(1))
        s3 = A.merge(s1, s2)
        assert list(s1['birds']) == ['blackbird', 'starling', 'goldfinch']
        assert list(s2['birds']) == ['blackbird', 'goldfinch']
        assert list(s3['birds']) == ['blackbird', 'starling', 'goldfinch']

    def test_insertion_after_a_deleted_list_element(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': ['blackbird', 'thrush', 'goldfinch']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].delete_at(1, 2))
        s2 = A.change(s2, lambda d: d['birds'].insert(2, 'starling'))
        s3 = A.merge(s1, s2)
        assert A.equals(s3, {'birds': ['blackbird', 'starling']})
        assert A.equals(A.merge(s2, s3), {'birds': ['blackbird', 'starling']})

    def test_concurrent_deletion_of_same_element(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': ['albatross', 'buzzard', 'cormorant']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].delete_at(1))
        s2 = A.change(s2, lambda d: d['birds'].delete_at(1))
        s3 = A.merge(s1, s2)
        assert list(s3['birds']) == ['albatross', 'cormorant']

    def test_concurrent_deletion_of_different_elements(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': ['albatross', 'buzzard', 'cormorant']}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].delete_at(0))
        s2 = A.change(s2, lambda d: d['birds'].delete_at(1))
        s3 = A.merge(s1, s2)
        assert list(s3['birds']) == ['cormorant']

    def test_concurrent_updates_at_different_tree_levels(self):
        s1 = A.change(A.init(), lambda d: d.update({'animals': {
            'birds': {'pink': 'flamingo', 'black': 'starling'},
            'mammals': ['badger']}}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['animals']['birds'].update(
            {'brown': 'sparrow'}))
        s2 = A.change(s2, lambda d: d['animals'].__delitem__('birds'))
        s3 = A.merge(s1, s2)
        assert A.equals(s1['animals'], {
            'birds': {'pink': 'flamingo', 'brown': 'sparrow',
                      'black': 'starling'},
            'mammals': ['badger']})
        assert A.equals(s2['animals'], {'mammals': ['badger']})
        assert A.equals(s3['animals'], {'mammals': ['badger']})

    def test_updates_of_concurrently_deleted_objects(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': {'blackbird': {'feathers': 'black'}}}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['birds'].__delitem__('blackbird'))
        s2 = A.change(s2, lambda d: d['birds']['blackbird'].update(
            {'beak': 'orange'}))
        s3 = A.merge(s1, s2)
        assert A.equals(s1, {'birds': {}})

    def test_does_not_interleave_sequence_insertions_at_same_position(self):
        s1 = A.change(A.init(), lambda d: d.update({'wisdom': []}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['wisdom'].append(
            'to', 'be', 'is', 'to', 'do'))
        s2 = A.change(s2, lambda d: d['wisdom'].append(
            'to', 'do', 'is', 'to', 'be'))
        s3 = A.merge(s1, s2)
        assert_equals_one_of(
            s3['wisdom'],
            ['to', 'be', 'is', 'to', 'do', 'to', 'do', 'is', 'to', 'be'],
            ['to', 'do', 'is', 'to', 'be', 'to', 'be', 'is', 'to', 'do'])


class TestMultipleInsertionsAtSamePosition:
    """ref test/test.js:1133-1171"""

    def test_insertion_by_greater_actor_id(self):
        s1 = A.init('aaaa')
        s2 = A.init('bbbb')
        s1 = A.change(s1, lambda d: d.update({'list': ['two']}))
        s2 = A.merge(s2, s1)
        s2 = A.change(s2, lambda d: d['list'].insert(0, 'one'))
        assert list(s2['list']) == ['one', 'two']

    def test_insertion_by_lesser_actor_id(self):
        s1 = A.init('bbbb')
        s2 = A.init('aaaa')
        s1 = A.change(s1, lambda d: d.update({'list': ['two']}))
        s2 = A.merge(s2, s1)
        s2 = A.change(s2, lambda d: d['list'].insert(0, 'one'))
        assert list(s2['list']) == ['one', 'two']

    def test_insertion_regardless_of_actor_id(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': ['two']}))
        s2 = A.merge(A.init(), s1)
        s2 = A.change(s2, lambda d: d['list'].insert(0, 'one'))
        assert list(s2['list']) == ['one', 'two']

    def test_insertion_order_consistent_with_causality(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': ['four']}))
        s2 = A.merge(A.init(), s1)
        s2 = A.change(s2, lambda d: d['list'].insert(0, 'three'))
        s1 = A.merge(s1, s2)
        s1 = A.change(s1, lambda d: d['list'].insert(0, 'two'))
        s2 = A.merge(s2, s1)
        s2 = A.change(s2, lambda d: d['list'].insert(0, 'one'))
        assert list(s2['list']) == ['one', 'two', 'three', 'four']


class TestSavingAndLoading:
    """ref test/test.js:1172-1305"""

    def test_save_and_restore_empty_document(self):
        assert A.equals(A.load(A.save(A.init())), {})

    def test_generates_a_new_random_actor_id(self):
        s1 = A.init()
        s2 = A.load(A.save(s1))
        assert UUID_PATTERN.match(A.get_actor_id(s1))
        assert UUID_PATTERN.match(A.get_actor_id(s2))
        assert A.get_actor_id(s1) != A.get_actor_id(s2)

    def test_allows_custom_actor_id_on_load(self):
        s = A.load(A.save(A.init()), '333333')
        assert A.get_actor_id(s) == '333333'

    def test_reconstitutes_complex_datatypes(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'todos': [{'title': 'water plants', 'done': False}]}))
        s2 = A.load(A.save(s1))
        assert A.equals(s2, {'todos': [{'title': 'water plants',
                                        'done': False}]})

    def test_saves_and_loads_keys_with_at_symbols(self):
        s1 = A.change(A.init(), lambda d: d.update({'123@4567': 'hello'}))
        s2 = A.load(A.save(s1))
        assert A.equals(s2, {'123@4567': 'hello'})

    def test_reconstitutes_conflicts(self):
        s1 = A.change(A.init('111111'), lambda d: d.update({'x': 3}))
        s2 = A.change(A.init('222222'), lambda d: d.update({'x': 5}))
        s1 = A.merge(s1, s2)
        s3 = A.load(A.save(s1))
        assert s1['x'] == 5
        assert s3['x'] == 5
        assert A.get_conflicts(s1, 'x') == {'1@111111': 3, '1@222222': 5}
        assert A.get_conflicts(s3, 'x') == {'1@111111': 3, '1@222222': 5}

    def test_reconstitutes_element_id_counters(self):
        s1 = A.init('01234567')
        s2 = A.change(s1, lambda d: d.update({'list': ['a']}))
        list_id = A.get_object_id(s2['list'])
        changes12 = [A.decode_change(c) for c in A.get_all_changes(s2)]
        assert len(changes12) == 1
        assert changes12[0]['actor'] == '01234567'
        assert changes12[0]['seq'] == 1
        assert changes12[0]['startOp'] == 1
        assert changes12[0]['deps'] == []
        assert changes12[0]['ops'] == [
            {'obj': '_root', 'action': 'makeList', 'key': 'list',
             'insert': False, 'pred': []},
            {'obj': list_id, 'action': 'set', 'elemId': '_head',
             'insert': True, 'value': 'a', 'pred': []}]
        s3 = A.change(s2, lambda d: d['list'].delete_at(0))
        s4 = A.load(A.save(s3), '01234567')
        s5 = A.change(s4, lambda d: d['list'].append('b'))
        changes45 = [A.decode_change(c) for c in A.get_all_changes(s5)]
        assert A.equals(s5, {'list': ['b']})
        assert changes45[2]['actor'] == '01234567'
        assert changes45[2]['seq'] == 3
        assert changes45[2]['startOp'] == 4
        assert changes45[2]['deps'] == [changes45[1]['hash']]
        assert changes45[2]['ops'] == [
            {'obj': list_id, 'action': 'set', 'elemId': '_head',
             'insert': True, 'value': 'b', 'pred': []}]

    def test_allows_a_reloaded_list_to_be_mutated(self):
        doc = A.change(A.init(), lambda d: d.update({'foo': []}))
        doc = A.load(A.save(doc))
        doc = A.change(doc, 'add', lambda d: d['foo'].append(1))
        doc = A.load(A.save(doc))
        assert A.equals(doc['foo'], [1])

    def test_reloads_document_containing_deflated_columns(self):
        import random
        rng = random.Random(0)

        def cb(doc):
            doc['list'] = []
            for i in range(200):
                doc['list'].insert(rng.randint(0, max(i, 0)), 'a')
        doc = A.change(A.init(), cb)
        A.load(A.save(doc))
        assert list(doc['list']) == ['a'] * 200

    def test_calls_patch_callback_on_load(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Goldfinch']}))
        s2 = A.change(s1, lambda d: d['birds'].append('Chaffinch'))
        callbacks = []
        actor = A.get_actor_id(s1)
        reloaded = A.load(A.save(s2), {
            'patchCallback': lambda patch, before, after, local, changes:
                callbacks.append((patch, before, after, local))})
        assert len(callbacks) == 1
        patch, before, after, local = callbacks[0]
        second_hash = A.decode_change(A.get_all_changes(s2)[1])['hash']
        assert patch == {
            'maxOp': 3, 'deps': [second_hash], 'clock': {actor: 2},
            'pendingChanges': 0,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {f'1@{actor}': {
                    'objectId': f'1@{actor}', 'type': 'list', 'edits': [
                        {'action': 'multi-insert', 'index': 0,
                         'elemId': f'2@{actor}',
                         'values': ['Goldfinch', 'Chaffinch']}]}}}},
        }
        assert A.equals(before, {})
        assert after is reloaded
        assert local is False

    def test_reconstructs_original_changes_if_needed(self):
        doc = A.init()
        for i in range(10):
            doc = A.change(doc, lambda d, i=i: d.update({'x': i}))
        doc = A.load(A.save(doc))
        assert len(A.get_all_changes(doc)) == 10

    def test_deduplicates_changes_after_save_and_reload(self):
        init_change = A.get_last_local_change(A.change(
            A.init('0000'), {'time': 0}, lambda d: d.update({'panels': []})))
        s1, _ = A.apply_changes(A.init(), [init_change])
        s2, _ = A.apply_changes(A.init(), [init_change])
        s1 = A.change(s1, lambda d: d['panels'].append({'id': 'panel1'}))
        s2 = A.change(s2, lambda d: d['panels'].append({'id': 'panel2'}))
        s1 = A.load(A.save(s1))
        s3, _ = A.apply_changes(s1, A.get_all_changes(s2))
        assert len(s3['panels']) == 2


class TestHistoryAPI:
    """ref test/test.js:1305-1333"""

    def test_empty_history_for_empty_document(self):
        assert A.get_history(A.init()) == []

    def test_makes_past_document_states_accessible(self):
        s = A.init()
        s = A.change(s, lambda d: d.update({'config': {'background': 'blue'}}))
        s = A.change(s, lambda d: d.update({'birds': ['mallard']}))
        s = A.change(s, lambda d: d['birds'].insert(0, 'oystercatcher'))
        snapshots = [h.snapshot for h in A.get_history(s)]
        assert A.equals(snapshots[0], {'config': {'background': 'blue'}})
        assert A.equals(snapshots[1],
                        {'config': {'background': 'blue'},
                         'birds': ['mallard']})
        assert A.equals(snapshots[2],
                        {'config': {'background': 'blue'},
                         'birds': ['oystercatcher', 'mallard']})

    def test_makes_change_messages_accessible(self):
        s = A.init()
        s = A.change(s, 'Empty Bookshelf', lambda d: d.update({'books': []}))
        s = A.change(s, 'Add Orwell',
                     lambda d: d['books'].append('Nineteen Eighty-Four'))
        s = A.change(s, 'Add Huxley',
                     lambda d: d['books'].append('Brave New World'))
        assert list(s['books']) == ['Nineteen Eighty-Four', 'Brave New World']
        assert [h.change['message'] for h in A.get_history(s)] == \
            ['Empty Bookshelf', 'Add Orwell', 'Add Huxley']


class TestChangesAPI:
    """ref test/test.js:1333-1507"""

    def test_empty_list_on_empty_document(self):
        assert A.get_all_changes(A.init()) == []

    def test_empty_list_when_nothing_changed(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Chaffinch']}))
        assert A.get_changes(s1, s1) == []

    def test_does_nothing_applying_empty_list_of_changes(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Chaffinch']}))
        assert A.equals(A.apply_changes(s1, [])[0], s1)

    def test_useful_error_for_wrong_apply_changes_argument(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Chaffinch']}))
        changes = A.get_all_changes(s1)
        with pytest.raises(Exception):
            A.apply_changes(A.init(), changes[0])
        with pytest.raises(Exception):
            A.apply_changes(A.init(), ['this is a string'])

    def test_returns_all_changes_compared_to_empty_document(self):
        s1 = A.change(A.init(), 'Add Chaffinch',
                      lambda d: d.update({'birds': ['Chaffinch']}))
        s2 = A.change(s1, 'Add Bullfinch',
                      lambda d: d['birds'].append('Bullfinch'))
        changes = A.get_changes(A.init(), s2)
        assert len(changes) == 2

    def test_allows_document_copy_reconstruction_from_scratch(self):
        s1 = A.change(A.init(), 'Add Chaffinch',
                      lambda d: d.update({'birds': ['Chaffinch']}))
        s2 = A.change(s1, 'Add Bullfinch',
                      lambda d: d['birds'].append('Bullfinch'))
        changes = A.get_all_changes(s2)
        s3, _ = A.apply_changes(A.init(), changes)
        assert list(s3['birds']) == ['Chaffinch', 'Bullfinch']

    def test_returns_changes_since_last_given_version(self):
        s1 = A.change(A.init(), 'Add Chaffinch',
                      lambda d: d.update({'birds': ['Chaffinch']}))
        changes1 = A.get_all_changes(s1)
        s2 = A.change(s1, 'Add Bullfinch',
                      lambda d: d['birds'].append('Bullfinch'))
        changes2 = A.get_changes(s1, s2)
        assert len(changes1) == 1
        assert len(changes2) == 1

    def test_incrementally_applies_changes_since_last_version(self):
        s1 = A.change(A.init(), 'Add Chaffinch',
                      lambda d: d.update({'birds': ['Chaffinch']}))
        changes1 = A.get_all_changes(s1)
        s2 = A.change(s1, 'Add Bullfinch',
                      lambda d: d['birds'].append('Bullfinch'))
        changes2 = A.get_changes(s1, s2)
        s3, _ = A.apply_changes(A.init(), changes1)
        s4, _ = A.apply_changes(s3, changes2)
        assert list(s3['birds']) == ['Chaffinch']
        assert list(s4['birds']) == ['Chaffinch', 'Bullfinch']

    def test_handles_updates_to_a_list_element(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': ['Chaffinch', 'Bullfinch']}))
        s2 = A.change(s1, lambda d: d['birds'].__setitem__(0, 'Goldfinch'))
        s3, _ = A.apply_changes(A.init(), A.get_all_changes(s2))
        assert list(s3['birds']) == ['Goldfinch', 'Bullfinch']
        assert A.get_conflicts(s3['birds'], 0) is None

    def test_handles_updates_to_a_text_object(self):
        s1 = A.change(A.init(), lambda d: d.update({'text': A.Text('ab')}))
        s2 = A.change(s1, lambda d: d['text'].set(0, 'A'))
        s3, _ = A.apply_changes(A.init(), A.get_all_changes(s2))
        assert list(s3['text']) == ['A', 'b']

    def test_reports_missing_dependencies(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Chaffinch']}))
        s2 = A.merge(A.init(), s1)
        s2 = A.change(s2, lambda d: d['birds'].append('Bullfinch'))
        changes = A.get_all_changes(s2)
        s3, patch = A.apply_changes(A.init(), [changes[1]])
        assert A.equals(s3, {})
        assert get_missing_deps(get_backend_state(s3)) == \
            A.decode_change(changes[1])['deps']
        assert patch['pendingChanges'] == 1
        s3, patch = A.apply_changes(s3, [changes[0]])
        assert list(s3['birds']) == ['Chaffinch', 'Bullfinch']
        assert get_missing_deps(get_backend_state(s3)) == []
        assert patch['pendingChanges'] == 0

    def test_allows_changes_to_be_applied_in_any_order(self):
        s1 = A.change(A.init(), lambda d: d.update({'bird': 'Goldfinch'}))
        s2 = A.change(s1, lambda d: d.update({'bird': 'Chaffinch'}))
        s3 = A.change(s2, lambda d: d.update({'bird': 'Greenfinch'}))
        changes = list(reversed(A.get_all_changes(s3)))
        s4, _ = A.apply_changes(A.init(), changes)
        assert A.equals(s4, {'bird': 'Greenfinch'})

    def test_missing_dependencies_with_out_of_order_apply_changes(self):
        s0 = A.init()
        s1 = A.change(s0, lambda d: d.update({'test': ['a']}))
        changes01 = A.get_all_changes(s1)
        s2 = A.change(s1, lambda d: d.update({'test': ['b']}))
        changes12 = A.get_changes(s1, s2)
        s3 = A.change(s2, lambda d: d.update({'test': ['c']}))
        changes23 = A.get_changes(s2, s3)
        s4 = A.init()
        s5, _ = A.apply_changes(s4, changes23)
        s6, patch6 = A.apply_changes(s5, changes12)
        assert get_missing_deps(get_backend_state(s6)) == \
            [A.decode_change(changes01[0])['hash']]
        assert patch6['pendingChanges'] == 2

    def test_calls_patch_callback_when_applying_changes(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Goldfinch']}))
        callbacks = []
        actor = A.get_actor_id(s1)
        before = A.init()
        after, patch = A.apply_changes(
            before, A.get_all_changes(s1),
            {'patchCallback': lambda patch, before, after, local, changes:
             callbacks.append((patch, before, after, local))})
        assert len(callbacks) == 1
        cb_patch, cb_before, cb_after, cb_local = callbacks[0]
        first_hash = A.decode_change(A.get_all_changes(s1)[0])['hash']
        assert cb_patch == {
            'maxOp': 2, 'deps': [first_hash], 'clock': {actor: 1},
            'pendingChanges': 0,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {f'1@{actor}': {
                    'objectId': f'1@{actor}', 'type': 'list', 'edits': [
                        {'action': 'insert', 'index': 0,
                         'elemId': f'2@{actor}', 'opId': f'2@{actor}',
                         'value': {'type': 'value', 'value': 'Goldfinch'}}]}}}},
        }
        assert cb_patch is patch
        assert cb_before is before
        assert cb_after is after
        assert cb_local is False

    def test_merges_multiple_applied_changes_into_one_patch(self):
        s1 = A.change(A.init(), lambda d: d.update({'birds': ['Goldfinch']}))
        s2 = A.change(s1, lambda d: d['birds'].append('Chaffinch'))
        patches = []
        actor = A.get_actor_id(s2)
        A.apply_changes(A.init(), A.get_all_changes(s2),
                        {'patchCallback':
                         lambda p, *args: patches.push(p)
                         if hasattr(patches, 'push') else patches.append(p)})
        second_hash = A.decode_change(A.get_all_changes(s2)[1])['hash']
        assert patches == [{
            'maxOp': 3, 'deps': [second_hash], 'clock': {actor: 2},
            'pendingChanges': 0,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {f'1@{actor}': {
                    'objectId': f'1@{actor}', 'type': 'list', 'edits': [
                        {'action': 'multi-insert', 'index': 0,
                         'elemId': f'2@{actor}',
                         'values': ['Goldfinch', 'Chaffinch']}]}}}},
        }]

    def test_calls_patch_callback_registered_on_initialisation(self):
        s1 = A.change(A.init(), lambda d: d.update({'bird': 'Goldfinch'}))
        patches = []
        actor = A.get_actor_id(s1)
        before = A.init({'patchCallback': lambda p, *args: patches.append(p)})
        A.apply_changes(before, A.get_all_changes(s1))
        first_hash = A.decode_change(A.get_all_changes(s1)[0])['hash']
        assert patches == [{
            'maxOp': 1, 'deps': [first_hash], 'clock': {actor: 1},
            'pendingChanges': 0,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'bird': {f'1@{actor}': {'type': 'value',
                                        'value': 'Goldfinch'}}}},
        }]
