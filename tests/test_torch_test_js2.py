# The port's copy of tests/test_test_js2.py, imports re-pointed at automerge_tpu_torch.
"""Port of the reference public-API suite, part 2 (ref test/test.js:575-872):
lists, numbers, and counters.
"""

import datetime

import pytest

import automerge_tpu_torch as A


def assert_equals_one_of(actual, *expected):
    assert any(A.equals(actual, e) for e in expected), \
        f'{actual!r} not equal to any of {expected!r}'


class TestLists:
    """ref test/test.js:575-800"""

    def test_allows_elements_to_be_inserted(self):
        s1 = A.change(A.init(), lambda d: d.update({'noodles': []}))
        s1 = A.change(s1, lambda d: d['noodles'].insert_at(0, 'udon', 'soba'))
        s1 = A.change(s1, lambda d: d['noodles'].insert_at(1, 'ramen'))
        assert A.equals(s1, {'noodles': ['udon', 'ramen', 'soba']})
        assert list(s1['noodles']) == ['udon', 'ramen', 'soba']
        assert s1['noodles'][0] == 'udon'
        assert s1['noodles'][1] == 'ramen'
        assert s1['noodles'][2] == 'soba'
        assert len(s1['noodles']) == 3

    def test_assignment_of_list_literal(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': ['udon', 'ramen', 'soba']}))
        assert A.equals(s1, {'noodles': ['udon', 'ramen', 'soba']})
        assert list(s1['noodles']) == ['udon', 'ramen', 'soba']
        assert len(s1['noodles']) == 3

    def test_only_numeric_indexes(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': ['udon', 'ramen', 'soba']}))
        s1 = A.change(s1, lambda d: d['noodles'].__setitem__(1, 'Ramen!'))
        assert s1['noodles'][1] == 'Ramen!'
        with pytest.raises(Exception):
            A.change(s1, lambda d: d['noodles'].__setitem__('favourite', 'udon'))
        with pytest.raises(Exception):
            A.change(s1, lambda d: d['noodles'].__setitem__('', 'udon'))
        with pytest.raises(Exception):
            A.change(s1, lambda d: d['noodles'].__setitem__('1e6', 'udon'))

    def test_deletion_of_list_elements(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': ['udon', 'ramen', 'soba']}))
        s1 = A.change(s1, lambda d: d['noodles'].__delitem__(1))
        assert list(s1['noodles']) == ['udon', 'soba']
        s1 = A.change(s1, lambda d: d['noodles'].delete_at(1))
        assert list(s1['noodles']) == ['udon']
        assert s1['noodles'][0] == 'udon'
        assert len(s1['noodles']) == 1

    def test_assignment_of_individual_list_indexes(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'japaneseFood': ['udon', 'ramen', 'soba']}))
        s1 = A.change(s1, lambda d: d['japaneseFood'].__setitem__(1, 'sushi'))
        assert list(s1['japaneseFood']) == ['udon', 'sushi', 'soba']
        assert len(s1['japaneseFood']) == 3

    def test_out_by_one_assignment_is_insertion(self):
        s1 = A.change(A.init(), lambda d: d.update({'japaneseFood': ['udon']}))
        s1 = A.change(s1, lambda d: d['japaneseFood'].__setitem__(1, 'sushi'))
        assert list(s1['japaneseFood']) == ['udon', 'sushi']
        assert len(s1['japaneseFood']) == 2

    def test_bulk_assignment_of_multiple_list_indexes(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': ['udon', 'ramen', 'soba']}))

        def cb(doc):
            doc['noodles'][0] = 'うどん'
            doc['noodles'][2] = 'そば'
        s1 = A.change(s1, cb)
        assert list(s1['noodles']) == ['うどん', 'ramen', 'そば']
        assert len(s1['noodles']) == 3

    def test_nested_objects_in_lists(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': [{'type': 'ramen', 'dishes': ['tonkotsu', 'shoyu']}]}))
        s1 = A.change(s1, lambda d: d['noodles'].append(
            {'type': 'udon', 'dishes': ['tempura udon']}))
        s1 = A.change(s1, lambda d: d['noodles'][0]['dishes'].append('miso'))
        assert A.equals(s1, {'noodles': [
            {'type': 'ramen', 'dishes': ['tonkotsu', 'shoyu', 'miso']},
            {'type': 'udon', 'dishes': ['tempura udon']}]})
        assert A.equals(s1['noodles'][0],
                        {'type': 'ramen', 'dishes': ['tonkotsu', 'shoyu', 'miso']})
        assert A.equals(s1['noodles'][1],
                        {'type': 'udon', 'dishes': ['tempura udon']})

    def test_nested_lists(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodleMatrix': [['ramen', 'tonkotsu', 'shoyu']]}))
        s1 = A.change(s1, lambda d: d['noodleMatrix'].append(
            ['udon', 'tempura udon']))
        s1 = A.change(s1, lambda d: d['noodleMatrix'][0].append('miso'))
        assert A.equals(s1['noodleMatrix'],
                        [['ramen', 'tonkotsu', 'shoyu', 'miso'],
                         ['udon', 'tempura udon']])

    def test_deep_nesting_mutations(self):
        s1 = A.change(A.init(), lambda d: d.update({'nesting': {
            'maps': {'m1': {'m2': {'foo': 'bar', 'baz': {}}, 'm2a': {}}},
            'lists': [[1, 2, 3], [[3, 4, 5, [6]], 7]],
            'mapsinlists': [{'foo': 'bar'}, [{'bar': 'baz'}]],
            'listsinmaps': {'foo': [1, 2, 3], 'bar': [[{'baz': '123'}]]},
        }}))

        def cb(doc):
            doc['nesting']['maps']['m1a'] = '123'
            doc['nesting']['maps']['m1']['m2']['baz']['xxx'] = '123'
            del doc['nesting']['maps']['m1']['m2a']
            doc['nesting']['lists'].delete_at(0)
            doc['nesting']['lists'][0][0].pop()
            doc['nesting']['lists'][0][0].append(100)
            doc['nesting']['mapsinlists'][0]['foo'] = 'baz'
            doc['nesting']['mapsinlists'][1][0]['foo'] = 'bar'
            del doc['nesting']['mapsinlists'][1]
            doc['nesting']['listsinmaps']['foo'].append(4)
            doc['nesting']['listsinmaps']['bar'][0][0]['baz'] = '456'
            del doc['nesting']['listsinmaps']['bar']
        s1 = A.change(s1, cb)
        assert A.equals(s1, {'nesting': {
            'maps': {'m1': {'m2': {'foo': 'bar', 'baz': {'xxx': '123'}}},
                     'm1a': '123'},
            'lists': [[[3, 4, 5, 100], 7]],
            'mapsinlists': [{'foo': 'baz'}],
            'listsinmaps': {'foo': [1, 2, 3, 4]},
        }})

    def test_replacement_of_the_entire_list(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': ['udon', 'soba', 'ramen']}))
        s1 = A.change(s1, lambda d: d.update(
            {'japaneseNoodles': list(d['noodles'])}))
        s1 = A.change(s1, lambda d: d.update({'noodles': ['wonton', 'pho']}))
        assert A.equals(s1, {'noodles': ['wonton', 'pho'],
                             'japaneseNoodles': ['udon', 'soba', 'ramen']})
        assert list(s1['noodles']) == ['wonton', 'pho']
        assert len(s1['noodles']) == 2

    def test_assignment_changes_type_of_list_element(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'noodles': ['udon', 'soba', 'ramen']}))
        s1 = A.change(s1, lambda d: d['noodles'].__setitem__(
            1, {'type': 'soba', 'options': ['hot', 'cold']}))
        assert A.equals(s1['noodles'],
                        ['udon', {'type': 'soba', 'options': ['hot', 'cold']},
                         'ramen'])
        s1 = A.change(s1, lambda d: d['noodles'].__setitem__(
            1, ['hot soba', 'cold soba']))
        assert A.equals(s1['noodles'],
                        ['udon', ['hot soba', 'cold soba'], 'ramen'])
        s1 = A.change(s1, lambda d: d['noodles'].__setitem__(
            1, 'soba is the best'))
        assert A.equals(s1['noodles'], ['udon', 'soba is the best', 'ramen'])

    def test_list_creation_and_assignment_in_same_change(self):
        def cb(doc):
            doc['letters'] = ['a', 'b', 'c']
            doc['letters'][1] = 'd'
        s1 = A.change(A.init(), cb)
        assert s1['letters'][1] == 'd'

    def test_add_and_remove_list_elements_in_same_change(self):
        s1 = A.change(A.init(), lambda d: d.update({'noodles': []}))

        def cb(doc):
            doc['noodles'].append('udon')
            doc['noodles'].delete_at(0)
        s1 = A.change(s1, cb)
        assert A.equals(s1, {'noodles': []})
        # twice (the upstream reference's #151)

        def cb2(doc):
            doc['noodles'].append('soba')
            doc['noodles'].delete_at(0)
        s1 = A.change(s1, cb2)
        assert A.equals(s1, {'noodles': []})

    def test_arbitrary_depth_list_nesting(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'maze': [[[[[[[['noodles', ['here']]]]]]]]]}))
        s1 = A.change(s1, lambda d:
                      d['maze'][0][0][0][0][0][0][0][1].insert(0, 'found'))
        assert A.equals(s1['maze'], [[[[[[[['noodles', ['found', 'here']]]]]]]]])
        assert s1['maze'][0][0][0][0][0][0][0][1][1] == 'here'

    def test_does_not_allow_several_references_to_same_list(self):
        s1 = A.change(A.init(), lambda d: d.update({'list': []}))
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, lambda d: d.update({'x': d['list']}))
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, lambda d: d.update({'x': s1['list']}))

        def copy_cb(doc):
            doc['x'] = []
            doc['y'] = doc['x']
        with pytest.raises(Exception, match='reference to an existing'):
            A.change(s1, copy_cb)

    def test_concurrent_edits_insert_in_reverse_actorid_order(self):
        s1 = A.init('aaaa')
        s2 = A.init('bbbb')
        s1 = A.change(s1, lambda d: d.update({'list': []}))
        s2 = A.merge(s2, s1)
        s1 = A.change(s1, lambda d: d['list'].insert(0, '2@aaaa'))
        s2 = A.change(s2, lambda d: d['list'].insert(0, '2@bbbb'))
        s2 = A.merge(s2, s1)
        assert list(s2['list']) == ['2@bbbb', '2@aaaa']

    def test_concurrent_edits_insert_in_reverse_counter_order(self):
        s1 = A.init('aaaa')
        s2 = A.init('bbbb')
        s1 = A.change(s1, lambda d: d.update({'list': []}))
        s2 = A.merge(s2, s1)
        s1 = A.change(s1, lambda d: d['list'].insert(0, '2@aaaa'))
        s2 = A.change(s2, lambda d: d.update({'foo': '2@bbbb'}))
        s2 = A.change(s2, lambda d: d['list'].insert(0, '3@bbbb'))
        s2 = A.merge(s2, s1)
        assert list(s2['list']) == ['3@bbbb', '2@aaaa']


class TestNumbers:
    """ref test/test.js:800-844"""

    def _last_op(self, s1):
        return A.decode_change(A.get_last_local_change(s1))['ops'][0]

    def test_defaults_to_int_for_positive_numbers(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': 1}))
        assert self._last_op(s1) == {
            'action': 'set', 'datatype': 'int', 'insert': False,
            'key': 'number', 'obj': '_root', 'pred': [], 'value': 1}

    def test_defaults_to_int_for_negative_numbers(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': -1}))
        assert self._last_op(s1) == {
            'action': 'set', 'datatype': 'int', 'insert': False,
            'key': 'number', 'obj': '_root', 'pred': [], 'value': -1}

    def test_defaults_to_float64_for_floats(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': 1.1}))
        assert self._last_op(s1) == {
            'action': 'set', 'datatype': 'float64', 'insert': False,
            'key': 'number', 'obj': '_root', 'pred': [], 'value': 1.1}

    def test_float64_can_be_specified_manually(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': A.Float64(3)}))
        assert self._last_op(s1) == {
            'action': 'set', 'datatype': 'float64', 'insert': False,
            'key': 'number', 'obj': '_root', 'pred': [], 'value': 3}

    def test_int_can_be_specified_manually(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': A.Int(3)}))
        assert self._last_op(s1) == {
            'action': 'set', 'datatype': 'int', 'insert': False,
            'key': 'number', 'obj': '_root', 'pred': [], 'value': 3}

    def test_uint_can_be_specified_manually(self):
        s1 = A.change(A.init(), lambda d: d.update({'number': A.Uint(3)}))
        assert self._last_op(s1) == {
            'action': 'set', 'datatype': 'uint', 'insert': False,
            'key': 'number', 'obj': '_root', 'pred': [], 'value': 3}


class TestCounters:
    """ref test/test.js:844-871 (the fuller counter matrix lives in
    test_new_backend.py / test_backend.py)"""

    def test_allows_deleting_counters_from_maps(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'birds': {'wrens': A.Counter(1)}}))
        s2 = A.change(s1, lambda d: d['birds']['wrens'].increment(2))
        s3 = A.change(s2, lambda d: d['birds'].__delitem__('wrens'))
        assert s2['birds']['wrens'].value == 3
        assert A.equals(s3, {'birds': {}})

    def test_does_not_allow_deleting_counters_from_lists(self):
        s1 = A.change(A.init(), lambda d: d.update(
            {'recordings': [A.Counter(1)]}))
        s2 = A.change(s1, lambda d: d['recordings'][0].increment(2))
        assert s2['recordings'][0].value == 3
        with pytest.raises(Exception):
            A.change(s2, lambda d: d['recordings'].delete_at(0))

    def test_allows_multiple_counters_in_a_list(self):
        s1 = A.from_({'counters': [A.Counter(1), A.Counter(2)]})
        assert s1['counters'][0].value == 1
        assert s1['counters'][1].value == 2

    def test_allows_counters_in_a_list_with_non_counters(self):
        date = datetime.datetime.now(
            datetime.timezone.utc).replace(microsecond=0)
        s1 = A.from_({'counters': [A.Counter(1), -1, A.Counter(2), 2.2,
                                   True, date]})
        lst = s1['counters']
        assert lst[0].value == 1
        assert lst[1] == -1
        assert lst[2].value == 2
        assert lst[3] == 2.2
        assert lst[4] is True
        assert lst[5] == date
