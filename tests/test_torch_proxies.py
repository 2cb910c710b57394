# The port's copy of tests/test_proxies.py, imports re-pointed at automerge_tpu_torch.
"""Proxy API conformance tests: the mutable document objects handed to change
callbacks behave like ordinary Python mappings/sequences (ported semantics of
reference test/proxies_test.js, whose ES6 Proxy list supports the full JS
Array API; here the Python MutableMapping/MutableSequence protocols)."""

import json

import pytest

import automerge_tpu_torch as am
from automerge_tpu_torch import frontend as Frontend


class TestRootObject:
    def test_fixed_object_id(self):
        def check(doc):
            assert Frontend.get_object_id(doc._target()) == '_root'
        am.change(am.init(), check)

    def test_knows_actor_id(self):
        def check(doc):
            actor = am.get_actor_id(doc._target())
            assert isinstance(actor, str) and len(actor) > 0
        # a raw init doc also reports its actor
        assert am.get_actor_id(am.init('01234567')) == '01234567'

    def test_keys_as_properties_and_items(self):
        def check(doc):
            doc.magpies = 42
            assert doc.magpies == 42
            assert doc['magpies'] == 42
        am.change(am.init(), check)

    def test_unknown_property(self):
        def check(doc):
            with pytest.raises(AttributeError):
                doc.sparrows
            with pytest.raises(KeyError):
                doc['sparrows']
            assert doc.get('sparrows') is None
        am.change(am.init(), check)

    def test_in_operator_and_len(self):
        def check(doc):
            doc['key1'] = 'value1'
            doc['key2'] = 'value2'
            assert 'key1' in doc
            assert 'key3' not in doc
            assert len(doc) == 2
            assert sorted(doc.keys()) == ['key1', 'key2']
        am.change(am.init(), check)

    def test_bulk_assignment(self):
        # Python analogue of Object.assign()
        def check(doc):
            doc.update({'two': 2, 'three': 3})
        doc = am.change(am.init(), check)
        assert dict(doc) == {'two': 2, 'three': 3}

    def test_json_round_trip(self):
        def check(doc):
            doc['nested'] = {'a': [1, 2], 'b': 'x'}
        doc = am.change(am.init(), check)
        assert json.loads(json.dumps(doc.to_py())) == \
            {'nested': {'a': [1, 2], 'b': 'x'}}

    def test_access_by_object_id(self):
        doc = am.change(am.init(), lambda d: d.update({'deep': {'key': 'v'}}))
        obj_id = Frontend.get_object_id(doc['deep'])
        assert am.Frontend.get_object_by_id(doc, obj_id)['key'] == 'v'


def list_doc():
    return am.change(am.init(), lambda d: d.update(
        {'noble': ['silver', 'gold', 'platinum']}))


class TestListObject:
    def test_looks_like_a_sequence(self):
        def check(doc):
            lst = doc['noble']
            assert len(lst) == 3
            assert list(lst) == ['silver', 'gold', 'platinum']
            assert lst == ['silver', 'gold', 'platinum']
        am.change(list_doc(), check)

    def test_fetch_by_index(self):
        def check(doc):
            lst = doc['noble']
            assert lst[0] == 'silver'
            assert lst[-1] == 'platinum'
            assert lst[0:2] == ['silver', 'gold']
            with pytest.raises(IndexError):
                lst[10]
        am.change(list_doc(), check)

    def test_iteration_and_membership(self):
        def check(doc):
            lst = doc['noble']
            assert 'gold' in list(lst)
            assert [x for x in lst] == ['silver', 'gold', 'platinum']
            assert lst.index('gold') == 1
            assert lst.count('gold') == 1
        am.change(list_doc(), check)

    def test_readonly_style_operations(self):
        def check(doc):
            lst = doc['noble']
            # join / filter / map analogues
            assert ','.join(lst) == 'silver,gold,platinum'
            assert [x for x in lst if x.endswith('um')] == ['platinum']
            assert [x.upper() for x in lst] == ['SILVER', 'GOLD', 'PLATINUM']
            assert any(x == 'gold' for x in lst)
            assert not all(x == 'gold' for x in lst)
        am.change(list_doc(), check)

    def test_mutation_methods(self):
        doc = list_doc()

        def m1(d):
            d['noble'].append('copernicium')   # push
            d['noble'].insert(0, 'hydrogen')   # unshift
        doc = am.change(doc, m1)
        assert doc['noble'] == ['hydrogen', 'silver', 'gold', 'platinum',
                                'copernicium']

        def m2(d):
            assert d['noble'].pop() == 'copernicium'
            assert d['noble'].pop(0) == 'hydrogen'
        doc = am.change(doc, m2)
        assert doc['noble'] == ['silver', 'gold', 'platinum']

    def test_fill(self):
        doc = am.change(am.init(), lambda d: d.update({'xs': [1, 2, 3, 4]}))
        doc = am.change(doc, lambda d: d['xs'].fill(0, 1, 3))
        assert doc['xs'] == [1, 0, 0, 4]
        doc = am.change(doc, lambda d: d['xs'].fill(9))
        assert doc['xs'] == [9, 9, 9, 9]

    def test_insert_at_delete_at(self):
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].insert_at(1, 'a', 'b'))
        assert doc['noble'] == ['silver', 'a', 'b', 'gold', 'platinum']
        doc = am.change(doc, lambda d: d['noble'].delete_at(1, 2))
        assert doc['noble'] == ['silver', 'gold', 'platinum']

    def test_slice_assignment(self):
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].__setitem__(
            slice(0, 2), ['x']))
        assert doc['noble'] == ['x', 'platinum']

    def test_del_item_and_slice(self):
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].__delitem__(0))
        assert doc['noble'] == ['gold', 'platinum']
        doc = am.change(doc, lambda d: d['noble'].__delitem__(slice(0, 2)))
        assert doc['noble'] == []

    def test_length_extension_with_nulls(self):
        # JS `list.length = 5`-style extension: assigning past the end pads
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].__setitem__(4, 'iridium'))
        assert doc['noble'] == ['silver', 'gold', 'platinum', None, 'iridium']

    def test_nested_object_mutation_through_list(self):
        doc = am.change(am.init(), lambda d: d.update(
            {'rows': [{'n': 1}, {'n': 2}]}))

        def bump(d):
            for row in d['rows']:
                row['n'] = row['n'] + 10
        doc = am.change(doc, bump)
        assert doc['rows'] == [{'n': 11}, {'n': 12}]

    def test_extend_and_iadd(self):
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].extend(['pd', 'rh']))
        assert doc['noble'] == ['silver', 'gold', 'platinum', 'pd', 'rh']

    def test_remove_by_value(self):
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].remove('gold'))
        assert doc['noble'] == ['silver', 'platinum']

    def test_reverse_rejected_or_correct(self):
        # MutableSequence.reverse mutates in place via __setitem__
        doc = list_doc()
        doc = am.change(doc, lambda d: d['noble'].reverse())
        assert doc['noble'] == ['platinum', 'gold', 'silver']


def num_doc():
    """ref proxies_test.js:97-105 fixture: list [1,2,3] + empty + objects."""
    return am.change(am.init(), lambda d: d.update(
        {'list': [1, 2, 3], 'empty': [],
         'listObjects': [{'id': 'first'}, {'id': 'second'}]}))


class TestListReadOnlyMethods:
    """Pythonic equivalents of the reference's JS Array read-only method
    suite (ref proxies_test.js:181-392)."""

    def test_concat(self):
        def check(d):
            assert list(d['list']) + [4] == [1, 2, 3, 4]
            assert list(d['list']) + [4, 5, 6] == [1, 2, 3, 4, 5, 6]
        am.change(num_doc(), check)

    def test_entries(self):
        def check(d):
            assert list(enumerate(d['list'])) == [(0, 1), (1, 2), (2, 3)]
        am.change(num_doc(), check)

    def test_every(self):
        def check(d):
            assert all(x > 0 for x in d['list'])
            assert not all(x > 2 for x in d['list'])
        am.change(num_doc(), check)

    def test_filter(self):
        def check(d):
            assert [x for x in d['list'] if False] == []
            assert [x for x in d['list'] if x % 2 == 1] == [1, 3]
            assert [x for x in d['list'] if True] == [1, 2, 3]
        am.change(num_doc(), check)

    def test_find(self):
        def check(d):
            assert next((x for x in d['list'] if x >= 2), None) == 2
            assert next((x for x in d['list'] if x >= 4), None) is None
        am.change(num_doc(), check)

    def test_find_index(self):
        def check(d):
            assert next((i for i, x in enumerate(d['list']) if x >= 2),
                        -1) == 1
            assert next((i for i, x in enumerate(d['list']) if x >= 4),
                        -1) == -1
        am.change(num_doc(), check)

    def test_for_each(self):
        def check(d):
            copy = []
            for x in d['list']:
                copy.append(x)
            assert copy == [1, 2, 3]
        am.change(num_doc(), check)

    def test_includes(self):
        def check(d):
            assert 3 in list(d['list'])
            assert 0 not in list(d['list'])
        am.change(num_doc(), check)

    def test_index_of(self):
        def check(d):
            assert d['list'].index(2) == 1
            with pytest.raises(ValueError):
                d['list'].index(4)
        am.change(num_doc(), check)

    def test_index_of_with_objects(self):
        def check(d):
            objs = d['listObjects']
            assert [o['id'] for o in objs].index('second') == 1
        am.change(num_doc(), check)

    def test_join(self):
        def check(d):
            assert ','.join(str(x) for x in d['list']) == '1,2,3'
            assert ' '.join(str(x) for x in d['list']) == '1 2 3'
        am.change(num_doc(), check)

    def test_keys(self):
        def check(d):
            assert list(range(len(d['list']))) == [0, 1, 2]
        am.change(num_doc(), check)

    def test_last_index_of(self):
        doc = am.change(am.init(), lambda d: d.update({'list': [1, 2, 3, 2]}))

        def check(d):
            lst = list(d['list'])
            assert len(lst) - 1 - lst[::-1].index(2) == 3
        am.change(doc, check)

    def test_map(self):
        def check(d):
            assert [x * 2 for x in d['list']] == [2, 4, 6]
        am.change(num_doc(), check)

    def test_reduce(self):
        import functools
        def check(d):
            assert functools.reduce(lambda a, x: a + x, d['list'], 0) == 6
        am.change(num_doc(), check)

    def test_reduce_right(self):
        import functools
        def check(d):
            assert functools.reduce(lambda a, x: a + str(x),
                                    reversed(list(d['list'])), '') == '321'
        am.change(num_doc(), check)

    def test_slice(self):
        def check(d):
            assert d['list'][1:] == [2, 3]
            assert d['list'][:2] == [1, 2]
            assert d['list'][1:2] == [2]
        am.change(num_doc(), check)

    def test_some(self):
        def check(d):
            assert any(x == 2 for x in d['list'])
            assert not any(x == 9 for x in d['list'])
        am.change(num_doc(), check)

    def test_to_string(self):
        def check(d):
            assert str(list(d['list'])) == '[1, 2, 3]'
        am.change(num_doc(), check)

    def test_values(self):
        def check(d):
            assert list(iter(d['list'])) == [1, 2, 3]
        am.change(num_doc(), check)

    def test_mutation_of_objects_from_iteration(self):
        doc = num_doc()

        def mutate(d):
            for obj in d['listObjects']:
                if obj['id'] == 'first':
                    obj['id'] = 'FIRST'
        doc = am.change(doc, mutate)
        assert doc['listObjects'][0]['id'] == 'FIRST'

    def test_mutation_of_objects_from_readonly_lookup(self):
        doc = num_doc()

        def mutate(d):
            found = next(o for o in d['listObjects'] if o['id'] == 'second')
            found['id'] = 'SECOND'
        doc = am.change(doc, mutate)
        assert doc['listObjects'][1]['id'] == 'SECOND'


class TestListMutationMethods:
    """ref proxies_test.js:394-456"""

    def test_pop(self):
        doc = num_doc()

        def m(d):
            assert d['list'].pop() == 3
            assert d['list'].pop() == 2
            assert d['list'].pop() == 1
            with pytest.raises(IndexError):
                d['list'].pop()
        doc = am.change(doc, m)
        assert list(doc['list']) == []

    def test_push(self):
        doc = am.change(am.init(), lambda d: d.update({'noodles': []}))
        doc = am.change(doc, lambda d: d['noodles'].append('udon', 'soba'))
        doc = am.change(doc, lambda d: d['noodles'].append('ramen'))
        assert list(doc['noodles']) == ['udon', 'soba', 'ramen']
        assert len(doc['noodles']) == 3

    def test_shift(self):
        doc = num_doc()

        def m(d):
            assert d['list'].pop(0) == 1
            assert d['list'].pop(0) == 2
            assert d['list'].pop(0) == 3
            with pytest.raises(IndexError):
                d['list'].pop(0)
        doc = am.change(doc, m)
        assert list(doc['list']) == []

    def test_splice(self):
        doc = num_doc()
        doc = am.change(doc, lambda d: d['list'].delete_at(1, 2))
        assert list(doc['list']) == [1]
        doc = am.change(doc, lambda d: d['list'].insert_at(1, 'a', 'b'))
        assert list(doc['list']) == [1, 'a', 'b']

    def test_unshift(self):
        doc = am.change(am.init(), lambda d: d.update({'noodles': []}))
        doc = am.change(doc, lambda d: d['noodles'].insert_at(0, 'soba'))
        doc = am.change(doc, lambda d: d['noodles'].insert_at(0, 'udon'))
        assert list(doc['noodles']) == ['udon', 'soba']
        assert len(doc['noodles']) == 2
