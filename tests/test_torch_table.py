# The port's copy of tests/test_table.py, imports re-pointed at automerge_tpu_torch.
"""Table conformance tests (ported semantics of reference
test/table_test.js: row CRUD, queries, sorting, JSON, concurrent insertion)."""

import json

import pytest

import automerge_tpu_torch as am
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.frontend import Table

DDIA = {'authors': ['Kleppmann, Martin'], 'title': 'Designing Data-Intensive '
        'Applications', 'isbn': '1449373321'}
RSDP = {'authors': ['Cachin, Christian', 'Guerraoui, Rachid',
                    'Rodrigues, Luís'],
        'title': 'Introduction to Reliable and Secure Distributed Programming',
        'isbn': '3642152597'}


def make_books():
    def setup(d):
        d['books'] = Table()
        d._row_id = d['books'].add(DDIA)
    doc = am.init()
    row_holder = {}

    def setup2(d):
        d['books'] = Table()
        row_holder['id'] = d['books'].add(DDIA)
    doc = am.change(doc, setup2)
    return doc, row_holder['id']


class TestTableFrontend:
    def test_create_table_ops(self):
        doc, change = Frontend.change(
            Frontend.init(), lambda d: d.update({'books': Table()}))
        assert change['ops'][0]['action'] == 'makeTable'

    def test_insert_row_ops(self):
        row_holder = {}

        def setup(d):
            d['books'] = Table()
            row_holder['id'] = d['books'].add({'title': 'T', 'isbn': 'x'})
        doc, change = Frontend.change(Frontend.init(), setup)
        actions = [op['action'] for op in change['ops']]
        assert actions[0] == 'makeTable'
        assert 'makeMap' in actions
        row = doc['books'].by_id(row_holder['id'])
        assert row['title'] == 'T'
        assert row['id'] == row_holder['id']


class TestTableQueries:
    def test_lookup_by_id(self):
        doc, row_id = make_books()
        row = doc['books'].by_id(row_id)
        assert row['title'] == DDIA['title']
        assert row['id'] == row_id

    def test_row_count(self):
        doc, _ = make_books()
        assert doc['books'].count == 1
        assert len(doc['books']) == 1

    def test_row_ids(self):
        doc, row_id = make_books()
        assert doc['books'].ids == [row_id]

    def test_iterate_rows(self):
        doc, row_id = make_books()
        rows = list(doc['books'])
        assert len(rows) == 1 and rows[0]['id'] == row_id

    def test_query_methods(self):
        doc, row_id = make_books()
        books = doc['books']
        assert books.filter(lambda r: len(r['authors']) == 1)[0]['id'] == row_id
        assert books.find(lambda r: r['isbn'] == '1449373321')['id'] == row_id
        assert books.map(lambda r: r['title'])[0] == DDIA['title']
        assert books.find(lambda r: False) is None

    def test_save_and_reload(self):
        doc, row_id = make_books()
        reloaded = am.load(am.save(doc))
        assert reloaded['books'].by_id(row_id)['title'] == DDIA['title']
        assert reloaded['books'].count == 1


class TestTableMutation:
    def test_update_row(self):
        doc, row_id = make_books()

        def update(d):
            d['books'].by_id(row_id)['isbn'] = '9781449373320'
        doc2 = am.change(doc, update)
        assert doc2['books'].by_id(row_id)['isbn'] == '9781449373320'
        # Old doc unchanged (immutability)
        assert doc['books'].by_id(row_id)['isbn'] == '1449373321'

    def test_remove_row(self):
        doc, row_id = make_books()
        doc2 = am.change(doc, lambda d: d['books'].remove(row_id))
        assert doc2['books'].count == 0
        assert doc2['books'].by_id(row_id) is None
        with pytest.raises(ValueError, match='no row with ID'):
            am.change(doc2, lambda d: d['books'].remove(row_id))

    def test_row_id_cannot_be_specified(self):
        doc = am.change(am.init(), lambda d: d.update({'books': Table()}))
        with pytest.raises(TypeError, match='must not have an "id"'):
            am.change(doc, lambda d: d['books'].add({'id': 'abc', 'title': 'x'}))

    def test_row_must_be_object(self):
        doc = am.change(am.init(), lambda d: d.update({'books': Table()}))
        with pytest.raises(TypeError):
            am.change(doc, lambda d: d['books'].add(['a', 'list']))

    def test_create_update_delete_same_change(self):
        def edit(d):
            d['books'] = Table()
            rid = d['books'].add({'title': 'a'})
            d['books'].by_id(rid)['title'] = 'b'
            rid2 = d['books'].add({'title': 'gone'})
            d['books'].remove(rid2)
        doc = am.change(am.init(), edit)
        assert doc['books'].count == 1
        assert doc['books'].rows[0]['title'] == 'b'


class TestTableConcurrency:
    def test_concurrent_row_insertion(self):
        a0 = am.change(am.init('aa01'), lambda d: d.update({'books': Table()}))
        b0 = am.load(am.save(a0), 'bb02')
        ra, rb = {}, {}
        a1 = am.change(a0, lambda d: ra.update(id=d['books'].add(DDIA)))
        b1 = am.change(b0, lambda d: rb.update(id=d['books'].add(RSDP)))
        m = am.merge(a1, b1)
        assert m['books'].count == 2
        assert m['books'].by_id(ra['id'])['title'] == DDIA['title']
        assert m['books'].by_id(rb['id'])['title'] == RSDP['title']


class TestTableSortAndJson:
    def make_three(self):
        rows = [{'authors': 'c', 'title': 'C', 'isbn': '3'},
                {'authors': 'a', 'title': 'A', 'isbn': '1'},
                {'authors': 'b', 'title': 'B', 'isbn': '2'}]

        def setup(d):
            d['books'] = Table()
            for r in rows:
                d['books'].add(r)
        return am.change(am.init(), setup)

    def test_sort_by_column(self):
        doc = self.make_three()
        titles = [r['title'] for r in doc['books'].sort('title')]
        assert titles == ['A', 'B', 'C']
        isbns = [r['isbn'] for r in doc['books'].sort(['isbn'])]
        assert isbns == ['1', '2', '3']

    def test_sort_by_comparator(self):
        doc = self.make_three()

        def cmp(a, b):
            return (a['isbn'] > b['isbn']) - (a['isbn'] < b['isbn'])
        isbns = [r['isbn'] for r in doc['books'].sort(cmp)]
        assert isbns == ['1', '2', '3']

    def test_json_serialization(self):
        doc, row_id = make_books()
        payload = doc['books'].to_json()
        assert json.loads(json.dumps(payload))[row_id]['title'] == DDIA['title']
