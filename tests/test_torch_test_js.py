# The port's copy of tests/test_test_js.py, imports re-pointed at automerge_tpu_torch.
"""Port of the reference public-API suite, part 1 (ref test/test.js:8-574):
initialization, sequential use, the changes section, emptyChange, root
object semantics, and nested maps. Parts 2/3 live in test_test_js2.py /
test_test_js3.py; a first subset was ported earlier in test_integration.py.
"""

import datetime
import re

import pytest

import automerge_tpu_torch as A
from automerge_tpu_torch.backend import get_heads, get_missing_deps
from automerge_tpu_torch.frontend import get_backend_state

OPID_PATTERN = re.compile(r'^[0-9]+@[0-9a-f]+$')


def assert_equals_one_of(actual, *expected):
    assert any(A.equals(actual, e) for e in expected), \
        f'{actual!r} not equal to any of {expected!r}'


class TestInitialization:
    """ref test/test.js:10-60"""

    def test_initially_an_empty_map(self):
        assert A.equals(A.init(), {})

    def test_instantiating_from_existing_object(self):
        initial = {'birds': {'wrens': 3, 'magpies': 4}}
        assert A.equals(A.from_(initial), initial)

    def test_merging_of_object_initialized_with_from(self):
        doc1 = A.from_({'cards': []})
        doc2 = A.merge(A.init(), doc1)
        assert A.equals(doc2, {'cards': []})

    def test_actor_id_when_instantiating_from_object(self):
        doc = A.from_({'foo': 1}, '1234')
        assert A.get_actor_id(doc) == '1234'

    def test_accepts_empty_object_as_initial_state(self):
        assert A.equals(A.from_({}), {})

    def test_accepts_array_as_initial_state_converted_to_object(self):
        doc = A.from_(['a', 'b', 'c'])
        assert A.equals(doc, {'0': 'a', '1': 'b', '2': 'c'})

    def test_accepts_strings_as_array_of_characters(self):
        doc = A.from_('abc')
        assert A.equals(doc, {'0': 'a', '1': 'b', '2': 'c'})

    def test_ignores_numbers_as_initial_values(self):
        assert A.equals(A.from_(123), {})

    def test_ignores_booleans_as_initial_values(self):
        assert A.equals(A.from_(False), {})
        assert A.equals(A.from_(True), {})

    def test_frontend_from_shares_initial_state_semantics(self):
        assert A.equals(A.Frontend.from_(['a', 'b']), {'0': 'a', '1': 'b'})
        assert A.equals(A.Frontend.from_(7), {})

    def test_rejects_non_mapping_rich_initial_state(self):
        with pytest.raises(TypeError, match='Unsupported initial state'):
            A.from_(A.Text('abc'))


class TestSequentialUse:
    """ref test/test.js:62-93"""

    def test_should_not_mutate_objects(self):
        s1 = A.init()
        s2 = A.change(s1, lambda d: d.update({'foo': 'bar'}))
        assert 'foo' not in s1
        assert s2['foo'] == 'bar'

    def test_changes_should_be_retrievable(self):
        s1 = A.init()
        assert A.get_last_local_change(s1) is None
        s2 = A.change(s1, lambda d: d.update({'foo': 'bar'}))
        change = A.decode_change(A.get_last_local_change(s2))
        assert change['deps'] == []
        assert change['seq'] == 1
        assert change['startOp'] == 1
        assert change['message'] == ''
        assert change['ops'] == [
            {'obj': '_root', 'key': 'foo', 'action': 'set', 'insert': False,
             'value': 'bar', 'pred': []}]

    def test_no_conflicts_on_repeated_assignment(self):
        s1 = A.init()
        assert A.get_conflicts(s1, 'foo') is None
        s1 = A.change(s1, 'change', lambda d: d.update({'foo': 'one'}))
        assert A.get_conflicts(s1, 'foo') is None
        s1 = A.change(s1, 'change', lambda d: d.update({'foo': 'two'}))
        assert A.get_conflicts(s1, 'foo') is None


class TestChanges:
    """ref test/test.js:95-333"""

    def test_should_group_several_changes(self):
        s1 = A.init()

        def cb(doc):
            doc['first'] = 'one'
            assert doc['first'] == 'one'
            doc['second'] = 'two'
            assert dict(doc) == {'first': 'one', 'second': 'two'}

        s2 = A.change(s1, 'change message', cb)
        assert A.equals(s1, {})
        assert A.equals(s2, {'first': 'one', 'second': 'two'})

    def test_repeated_reading_and_writing_of_values(self):
        s1 = A.init()

        def cb(doc):
            doc['value'] = 'a'
            assert doc['value'] == 'a'
            doc['value'] = 'b'
            doc['value'] = 'c'
            assert doc['value'] == 'c'

        s2 = A.change(s1, 'change message', cb)
        assert A.equals(s1, {})
        assert A.equals(s2, {'value': 'c'})

    def test_no_conflicts_writing_same_field_multiple_times_in_one_change(self):
        def cb(doc):
            doc['value'] = 'a'
            doc['value'] = 'b'
            doc['value'] = 'c'
        s1 = A.change(A.init(), 'change message', cb)
        assert s1['value'] == 'c'
        assert A.get_conflicts(s1, 'value') is None

    def test_returns_unchanged_state_object_if_nothing_changed(self):
        s1 = A.init()
        assert A.change(s1, lambda d: None) is s1

    def test_ignores_field_updates_that_write_existing_value(self):
        s1 = A.change(A.init(), lambda d: d.update({'field': 123}))
        s2 = A.change(s1, lambda d: d.update({'field': 123}))
        assert s2 is s1

    def test_does_not_ignore_updates_that_resolve_a_conflict(self):
        s1 = A.init()
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d.update({'field': 123}))
        s2 = A.change(s2, lambda d: d.update({'field': 321}))
        s1 = A.merge(s1, s2)
        assert len(A.get_conflicts(s1, 'field')) == 2
        resolved = A.change(s1, lambda d: d.update({'field': s1['field']}))
        assert resolved is not s1
        assert A.equals(resolved, {'field': s1['field']})
        assert A.get_conflicts(resolved, 'field') is None

    def test_ignores_list_element_updates_that_write_existing_value(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': [123]}))
        s2 = A.change(s1, lambda d: d['list'].__setitem__(0, 123))
        assert s2 is s1

    def test_does_not_ignore_list_updates_that_resolve_a_conflict(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': [1]}))
        s2 = A.merge(A.init(), s1)
        s1 = A.change(s1, lambda d: d['list'].__setitem__(0, 123))
        s2 = A.change(s2, lambda d: d['list'].__setitem__(0, 321))
        s1 = A.merge(s1, s2)
        assert A.get_conflicts(s1['list'], 0) == {
            f'3@{A.get_actor_id(s1)}': 123,
            f'3@{A.get_actor_id(s2)}': 321,
        }
        resolved = A.change(s1, lambda d: d['list'].__setitem__(0, s1['list'][0]))
        assert A.equals(resolved, s1)
        assert resolved is not s1
        assert A.get_conflicts(resolved['list'], 0) is None

    def test_sanity_checks_arguments(self):
        s1 = A.change(A.init(), lambda d: d.update({'nested': {}}))
        with pytest.raises(Exception, match='document root'):
            A.change({}, lambda d: d.update({'foo': 'bar'}))
        with pytest.raises(Exception, match='document root'):
            A.change(s1['nested'], lambda d: d.update({'foo': 'bar'}))

    def test_does_not_allow_nested_change_blocks(self):
        s1 = A.init()
        with pytest.raises(Exception, match='nested'):
            A.change(s1, lambda d1: A.change(d1, lambda d2: d2.update({'foo': 'bar'})))

    def test_same_base_document_cannot_be_used_for_multiple_changes(self):
        s1 = A.init()
        A.change(s1, lambda d: d.update({'one': 1}))
        with pytest.raises(Exception, match='outdated'):
            A.change(s1, lambda d: d.update({'two': 2}))

    def test_allows_document_to_be_cloned(self):
        s1 = A.change(A.init(), lambda d: d.update({'zero': 0}))
        s2 = A.clone(s1)
        s1 = A.change(s1, lambda d: d.update({'one': 1}))
        s2 = A.change(s2, lambda d: d.update({'two': 2}))
        assert A.equals(s1, {'zero': 0, 'one': 1})
        assert A.equals(s2, {'zero': 0, 'two': 2})
        A.free(s1)
        A.free(s2)

    def test_applies_changes_to_a_clone(self):
        s1 = A.change(A.init(), lambda d: d.update({'x': 1}))
        s1 = A.change(s1, lambda d: d.update({'x': 2}))
        changes = A.get_all_changes(s1)
        s2 = A.clone(A.load(A.save(s1)))
        s2, _ = A.apply_changes(s2, changes)
        assert s2['x'] == 2

    def test_object_assign_style_merges(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'stuff': {'foo': 'bar', 'baz': 'blur'}}))
        s1 = A.change(s1, lambda d: d.update(
            {'stuff': dict(d['stuff'], baz='updated!')}))
        assert A.equals(s1, {'stuff': {'foo': 'bar', 'baz': 'updated!'}})

    def test_date_objects_in_maps(self):
        now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
        s1 = A.change(A.init(), lambda d: d.update({'now': now}))
        s2, _ = A.apply_changes(A.init(), A.get_all_changes(s1))
        assert isinstance(s2['now'], datetime.datetime)
        assert s2['now'] == now

    def test_date_objects_in_lists(self):
        now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
        s1 = A.change(A.init(), lambda d: d.update({'list': [now]}))
        s2, _ = A.apply_changes(A.init(), A.get_all_changes(s1))
        assert isinstance(s2['list'][0], datetime.datetime)
        assert s2['list'][0] == now

    def test_many_date_objects_in_lists(self):
        base = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
        nows = [base + datetime.timedelta(seconds=i) for i in range(3)]
        s1 = A.change(A.init(), lambda d: d.update({'list': list(nows)}))
        s2, _ = A.apply_changes(A.init(), A.get_all_changes(s1))
        for i in range(3):
            assert isinstance(s2['list'][i], datetime.datetime)
            assert s2['list'][i] == nows[i]

    def test_calls_patch_callback_if_supplied(self):
        s1 = A.init()
        callbacks = []
        actor = A.get_actor_id(s1)
        s2 = A.change(
            s1,
            {'patchCallback': lambda patch, before, after, local, changes:
                callbacks.append((patch, before, after, local))},
            lambda d: d.update({'birds': ['Goldfinch']}))
        assert len(callbacks) == 1
        patch, before, after, local = callbacks[0]
        assert patch == {
            'actor': actor, 'seq': 1, 'maxOp': 2, 'deps': [],
            'clock': {actor: 1}, 'pendingChanges': 0,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {f'1@{actor}': {
                    'objectId': f'1@{actor}', 'type': 'list', 'edits': [
                        {'action': 'insert', 'index': 0,
                         'elemId': f'2@{actor}', 'opId': f'2@{actor}',
                         'value': {'type': 'value', 'value': 'Goldfinch'}}]}}}},
        }
        assert before is s1
        assert after is s2
        assert local is True

    def test_calls_patch_callback_set_up_on_initialisation(self):
        callbacks = []
        s1 = A.init({'patchCallback':
                     lambda patch, before, after, local, changes:
                     callbacks.append((patch, before, after, local))})
        s2 = A.change(s1, lambda d: d.update({'bird': 'Goldfinch'}))
        actor = A.get_actor_id(s1)
        assert len(callbacks) == 1
        patch, before, after, local = callbacks[0]
        assert patch == {
            'actor': actor, 'seq': 1, 'maxOp': 1, 'deps': [],
            'clock': {actor: 1}, 'pendingChanges': 0,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'bird': {f'1@{actor}': {'type': 'value',
                                        'value': 'Goldfinch'}}}},
        }
        assert before is s1
        assert after is s2
        assert local is True


class TestEmptyChange:
    """ref test/test.js:333-365"""

    def test_appends_an_empty_change_to_history(self):
        s1 = A.change(A.init(), 'first change', lambda d: d.update({'field': 123}))
        s2 = A.empty_change(s1, 'empty change')
        assert s2 is not s1
        assert A.equals(s2, s1)
        assert [h.change['message'] for h in A.get_history(s2)] == \
            ['first change', 'empty change']

    def test_references_dependencies(self):
        s1 = A.change(A.init(), lambda d: d.update({'field': 123}))
        s2 = A.merge(A.init(), s1)
        s2 = A.change(s2, lambda d: d.update({'other': 'hello'}))
        s1 = A.empty_change(A.merge(s1, s2))
        history = A.get_history(s1)
        empty_change = history[2].change
        assert empty_change['deps'] == sorted(
            [history[0].change['hash'], history[1].change['hash']])
        assert empty_change['ops'] == []

    def test_empty_change_encodes_and_decodes(self):
        s1 = A.empty_change(A.init())
        s1 = A.change(s1, lambda d: d.update({'z': 1}))
        s1 = A.change(s1, lambda d: d.update({'z': 1000}))
        changes = A.get_all_changes(A.load(A.save(s1)))
        s2, _ = A.apply_changes(A.init(), changes)
        assert get_heads(get_backend_state(s1)) == \
            get_heads(get_backend_state(s2))
        assert A.equals(s1, s2)


class TestRootObject:
    """ref test/test.js:367-440"""

    def test_single_property_assignment(self):
        s1 = A.change(A.init(), 'set bar', lambda d: d.update({'foo': 'bar'}))
        s1 = A.change(s1, 'set zap', lambda d: d.update({'zip': 'zap'}))
        assert s1['foo'] == 'bar'
        assert s1['zip'] == 'zap'
        assert A.equals(s1, {'foo': 'bar', 'zip': 'zap'})

    def test_allows_floating_point_values(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': 1589032171.1}))
        assert s1['number'] == 1589032171.1

    def test_multi_property_assignment(self):
        s1 = A.change(A.init(), 'multi-assign',
                      lambda d: d.update({'foo': 'bar', 'answer': 42}))
        assert s1['foo'] == 'bar'
        assert s1['answer'] == 42
        assert A.equals(s1, {'foo': 'bar', 'answer': 42})

    def test_root_property_deletion(self):
        def set_cb(doc):
            doc['foo'] = 'bar'
            doc['something'] = None
        s1 = A.change(A.init(), 'set foo', set_cb)
        s1 = A.change(s1, 'del foo', lambda d: d.__delitem__('foo'))
        assert 'foo' not in s1
        assert s1['something'] is None
        assert A.equals(s1, {'something': None})

    def test_allows_type_of_property_to_be_changed(self):
        s1 = A.change(A.init(), 'set number', lambda d: d.update({'prop': 123}))
        assert s1['prop'] == 123
        s1 = A.change(s1, 'set string', lambda d: d.update({'prop': '123'}))
        assert s1['prop'] == '123'
        s1 = A.change(s1, 'set null', lambda d: d.update({'prop': None}))
        assert s1['prop'] is None
        s1 = A.change(s1, 'set bool', lambda d: d.update({'prop': True}))
        assert s1['prop'] is True

    def test_requires_property_names_to_be_valid(self):
        with pytest.raises(Exception, match='empty string'):
            A.change(A.init(), 'foo', lambda d: d.update({'': 'x'}))

    def test_does_not_allow_unsupported_datatypes(self):
        s1 = A.init()
        with pytest.raises(Exception, match='[Uu]nsupported'):
            A.change(s1, lambda d: d.update({'foo': object()}))
        s1 = A.init()
        with pytest.raises(Exception, match='[Uu]nsupported'):
            A.change(s1, lambda d: d.update({'foo': lambda: None}))


class TestNestedMaps:
    """ref test/test.js:441-574"""

    def test_assigns_object_id_to_nested_maps(self):
        s1 = A.change(A.init(), lambda d: d.update({'nested': {}}))
        assert OPID_PATTERN.match(A.get_object_id(s1['nested']))
        assert A.get_object_id(s1['nested']) != '_root'

    def test_assignment_of_nested_property(self):
        def cb(doc):
            doc['nested'] = {}
            doc['nested']['foo'] = 'bar'
        s1 = A.change(A.init(), 'first change', cb)
        s1 = A.change(s1, 'second change',
                      lambda d: d['nested'].update({'one': 1}))
        assert A.equals(s1, {'nested': {'foo': 'bar', 'one': 1}})
        assert A.equals(s1['nested'], {'foo': 'bar', 'one': 1})
        assert s1['nested']['foo'] == 'bar'
        assert s1['nested']['one'] == 1

    def test_assignment_of_object_literal(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'textStyle': {'bold': False, 'fontSize': 12}}))
        assert A.equals(s1, {'textStyle': {'bold': False, 'fontSize': 12}})
        assert s1['textStyle']['bold'] is False
        assert s1['textStyle']['fontSize'] == 12

    def test_assignment_of_multiple_nested_properties(self):
        def cb(doc):
            doc['textStyle'] = {'bold': False, 'fontSize': 12}
            doc['textStyle'].update({'typeface': 'Optima', 'fontSize': 14})
        s1 = A.change(A.init(), cb)
        assert s1['textStyle']['typeface'] == 'Optima'
        assert s1['textStyle']['bold'] is False
        assert s1['textStyle']['fontSize'] == 14
        assert A.equals(s1['textStyle'],
                        {'typeface': 'Optima', 'bold': False, 'fontSize': 14})

    def test_arbitrary_depth_nesting(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'a': {'b': {'c': {'d': {'e': {'f': {'g': 'h'}}}}}}}))
        s1 = A.change(s1, lambda d:
                      d['a']['b']['c']['d']['e']['f'].update({'i': 'j'}))
        assert A.equals(s1, {'a': {'b': {'c': {'d': {'e': {'f':
                        {'g': 'h', 'i': 'j'}}}}}}})
        assert s1['a']['b']['c']['d']['e']['f']['g'] == 'h'
        assert s1['a']['b']['c']['d']['e']['f']['i'] == 'j'

    def test_allows_old_object_to_be_replaced_with_new_one(self):
        s1 = A.change(A.init(), 'change 1', lambda d: d.update(
            {'myPet': {'species': 'dog', 'legs': 4, 'breed': 'dachshund'}}))
        s2 = A.change(s1, 'change 2', lambda d: d.update(
            {'myPet': {'species': 'koi', 'variety': '紅白',
                       'colors': {'red': True, 'white': True, 'black': False}}}))
        assert A.equals(s1['myPet'],
                        {'species': 'dog', 'legs': 4, 'breed': 'dachshund'})
        assert s1['myPet']['breed'] == 'dachshund'
        assert A.equals(s2['myPet'],
                        {'species': 'koi', 'variety': '紅白',
                         'colors': {'red': True, 'white': True, 'black': False}})
        assert 'breed' not in s2['myPet']
        assert s2['myPet']['variety'] == '紅白'

    def test_allows_fields_to_change_between_primitive_and_nested_map(self):
        s1 = A.change(A.init(), lambda d: d.update({'color': '#ff7f00'}))
        assert s1['color'] == '#ff7f00'
        s1 = A.change(s1, lambda d: d.update(
            {'color': {'red': 255, 'green': 127, 'blue': 0}}))
        assert A.equals(s1['color'], {'red': 255, 'green': 127, 'blue': 0})
        s1 = A.change(s1, lambda d: d.update({'color': '#ff7f00'}))
        assert s1['color'] == '#ff7f00'

    def test_does_not_allow_several_references_to_same_map_object(self):
        s1 = A.change(A.init(), lambda d: d.update({'object': {}}))
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, lambda d: d.update({'x': d['object']}))
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, lambda d: d.update({'x': s1['object']}))

        def copy_cb(doc):
            doc['x'] = {}
            doc['y'] = doc['x']
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, copy_cb)

    def test_does_not_allow_object_copying_idioms(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'items': [{'id': 'id1', 'name': 'one'},
                       {'id': 'id2', 'name': 'two'}]}))
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, lambda d: d.update(
                {'items': list(d['items']) + [{'id': 'id3', 'name': 'three'}]}))

    def test_deletion_of_properties_within_a_map(self):
        s1 = A.change(A.init(), 'set style', lambda d: d.update(
            {'textStyle': {'typeface': 'Optima', 'bold': False,
                           'fontSize': 12}}))
        s1 = A.change(s1, 'non-bold',
                      lambda d: d['textStyle'].__delitem__('bold'))
        assert 'bold' not in s1['textStyle']
        assert A.equals(s1['textStyle'], {'typeface': 'Optima', 'fontSize': 12})

    def test_deletion_of_references_to_a_map(self):
        s1 = A.change(A.init(), 'make rich text doc', lambda d: d.update(
            {'title': 'Hello',
             'textStyle': {'typeface': 'Optima', 'fontSize': 12}}))
        s1 = A.change(s1, lambda d: d.__delitem__('textStyle'))
        assert 'textStyle' not in s1
        assert A.equals(s1, {'title': 'Hello'})

    def test_validates_field_names(self):
        s1 = A.change(A.init(), lambda d: d.update({'nested': {}}))
        with pytest.raises(Exception, match='empty string'):
            A.change(s1, lambda d: d['nested'].update({'': 'x'}))
        with pytest.raises(Exception, match='empty string'):
            A.change(s1, lambda d: d.update({'nested': {'': 'x'}}))
