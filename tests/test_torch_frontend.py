# The port's copy of tests/test_frontend.py, imports re-pointed at automerge_tpu_torch.
"""Frontend-only conformance tests: the backend is mocked by construction —
change requests are inspected directly and patches injected by hand (ported
semantics of reference test/frontend_test.js, incl. the request-queue
async-mode reconciliation at frontend/index.js:288-327)."""

import pytest

import automerge_tpu_torch as am
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch.columnar import decode_change
from automerge_tpu_torch.common import uuid
from automerge_tpu_torch.frontend import Counter, Text


def get_requests(doc):
    return [{'actor': r['actor'], 'seq': r['seq']}
            for r in doc._state['requests']]


class TestInitializing:
    def test_empty_by_default(self):
        doc = Frontend.init()
        assert Frontend.get_object_id(doc) == '_root'
        assert dict(doc) == {}

    def test_defer_actor_id(self):
        doc0 = Frontend.init({'deferActorId': True})
        assert Frontend.get_actor_id(doc0) is None
        doc1 = Frontend.set_actor_id(doc0, uuid())
        doc2, _req = Frontend.change(doc1, lambda d: d.update({'wrens': 3}))
        assert dict(doc2) == {'wrens': 3}

    def test_change_requires_actor_id(self):
        doc = Frontend.init({'deferActorId': True})
        with pytest.raises(ValueError):
            Frontend.change(doc, lambda d: d.update({'wrens': 3}))

    def test_from_initial_state(self):
        doc = Frontend.from_({'birds': {'wrens': 3}})
        assert doc == {'birds': {'wrens': 3}}

    def test_from_empty_object(self):
        doc = Frontend.from_({})
        assert dict(doc) == {}


class TestPerformingChanges:
    def test_unmodified_doc_if_no_change(self):
        doc0 = Frontend.init()
        doc1, req = Frontend.change(doc0, lambda d: None)
        assert doc1 is doc0
        assert req is None

    def test_set_root_property_request(self):
        actor = uuid()
        doc, change = Frontend.change(Frontend.init(actor),
                                      lambda d: d.update({'bird': 'magpie'}))
        assert dict(doc) == {'bird': 'magpie'}
        assert change == {
            'actor': actor, 'seq': 1, 'startOp': 1, 'deps': [],
            'time': change['time'], 'message': '',
            'ops': [{'obj': '_root', 'action': 'set', 'key': 'bird',
                     'insert': False, 'value': 'magpie', 'pred': []}]}
        assert get_requests(doc) == [{'actor': actor, 'seq': 1}]

    def test_create_nested_maps_request(self):
        doc, change = Frontend.change(Frontend.init(),
                                      lambda d: d.update({'birds': {'wrens': 3}}))
        actor = Frontend.get_actor_id(doc)
        birds = Frontend.get_object_id(doc['birds'])
        assert doc == {'birds': {'wrens': 3}}
        assert birds == f'1@{actor}'
        assert change['ops'] == [
            {'obj': '_root', 'action': 'makeMap', 'key': 'birds',
             'insert': False, 'pred': []},
            {'obj': birds, 'action': 'set', 'key': 'wrens', 'insert': False,
             'value': 3, 'datatype': 'int', 'pred': []}]

    def test_updates_inside_nested_maps(self):
        doc1, _ = Frontend.change(Frontend.init(),
                                  lambda d: d.update({'birds': {'wrens': 3}}))
        doc2, change2 = Frontend.change(
            doc1, lambda d: d['birds'].update({'sparrows': 15}))
        birds = Frontend.get_object_id(doc2['birds'])
        actor = Frontend.get_actor_id(doc1)
        assert doc1 == {'birds': {'wrens': 3}}
        assert doc2 == {'birds': {'wrens': 3, 'sparrows': 15}}
        assert change2['ops'] == [
            {'obj': birds, 'action': 'set', 'key': 'sparrows', 'insert': False,
             'value': 15, 'datatype': 'int', 'pred': []}]
        assert change2['startOp'] == 3
        assert change2['actor'] == actor

    def test_delete_keys(self):
        actor = uuid()
        doc1, _ = Frontend.change(
            Frontend.init(actor),
            lambda d: d.update({'magpies': 2, 'sparrows': 15}))
        doc2, change2 = Frontend.change(
            doc1, lambda d: d.__delitem__('magpies'))
        assert dict(doc2) == {'sparrows': 15}
        assert change2['ops'] == [
            {'obj': '_root', 'action': 'del', 'key': 'magpies',
             'insert': False, 'pred': [f'1@{actor}']}]

    def test_create_lists(self):
        doc, change = Frontend.change(Frontend.init(),
                                      lambda d: d.update({'birds': ['chaffinch']}))
        actor = Frontend.get_actor_id(doc)
        birds = Frontend.get_object_id(doc['birds'])
        assert doc == {'birds': ['chaffinch']}
        assert change['ops'] == [
            {'obj': '_root', 'action': 'makeList', 'key': 'birds',
             'insert': False, 'pred': []},
            {'obj': birds, 'action': 'set', 'elemId': '_head', 'insert': True,
             'value': 'chaffinch', 'pred': []}]

    def test_updates_inside_lists(self):
        doc1, _ = Frontend.change(Frontend.init(),
                                  lambda d: d.update({'birds': ['chaffinch']}))
        doc2, change2 = Frontend.change(
            doc1, lambda d: d['birds'].__setitem__(0, 'greenfinch'))
        birds = Frontend.get_object_id(doc2['birds'])
        actor = Frontend.get_actor_id(doc1)
        assert doc2 == {'birds': ['greenfinch']}
        assert change2['ops'] == [
            {'obj': birds, 'action': 'set', 'elemId': f'2@{actor}',
             'insert': False, 'value': 'greenfinch', 'pred': [f'2@{actor}']}]

    def test_assign_past_end_inserts_nulls(self):
        doc1, _ = Frontend.change(Frontend.init(),
                                  lambda d: d.update({'birds': ['chaffinch']}))
        doc2, _ = Frontend.change(
            doc1, lambda d: d['birds'].__setitem__(2, 'greenfinch'))
        assert doc2 == {'birds': ['chaffinch', None, 'greenfinch']}

    def test_delete_list_elements(self):
        actor = uuid()
        doc1, _ = Frontend.change(
            Frontend.init(actor),
            lambda d: d.update({'birds': ['chaffinch', 'goldfinch']}))
        doc2, change2 = Frontend.change(doc1, lambda d: d['birds'].delete_at(0))
        birds = Frontend.get_object_id(doc2['birds'])
        assert doc2 == {'birds': ['goldfinch']}
        assert change2['ops'] == [
            {'obj': birds, 'action': 'del', 'elemId': f'2@{actor}',
             'insert': False, 'pred': [f'2@{actor}']}]

    def test_date_stored_as_timestamp(self):
        import datetime
        now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
        doc, change = Frontend.change(Frontend.init(),
                                      lambda d: d.update({'now': now}))
        assert change['ops'][0]['datatype'] == 'timestamp'
        assert isinstance(doc['now'], datetime.datetime)
        assert doc['now'] == now


class TestCounters:
    def test_counter_in_map(self):
        actor = uuid()
        doc1, change1 = Frontend.change(
            Frontend.init(actor), lambda d: d.update({'wrens': Counter(0)}))
        assert doc1['wrens'] == Counter(0)
        doc2, change2 = Frontend.change(
            doc1, lambda d: d['wrens'].increment())
        assert doc2['wrens'] == Counter(1)
        assert change1['ops'] == [
            {'obj': '_root', 'action': 'set', 'key': 'wrens', 'insert': False,
             'value': 0, 'datatype': 'counter', 'pred': []}]
        assert change2['ops'] == [
            {'obj': '_root', 'action': 'inc', 'key': 'wrens', 'insert': False,
             'value': 1, 'pred': [f'1@{actor}']}]

    def test_counter_in_list(self):
        actor = uuid()
        doc1, _ = Frontend.change(
            Frontend.init(actor), lambda d: d.update({'counts': [Counter(1)]}))
        doc2, change2 = Frontend.change(
            doc1, lambda d: d['counts'][0].increment(2))
        assert doc2['counts'][0] == Counter(3)
        assert change2['ops'] == [
            {'obj': f'1@{actor}', 'action': 'inc', 'elemId': f'2@{actor}',
             'insert': False, 'value': 2, 'pred': [f'2@{actor}']}]

    def test_refuse_overwriting_counter(self):
        doc1, _ = Frontend.change(
            Frontend.init(), lambda d: d.update({'counter': Counter(1)}))
        with pytest.raises(ValueError, match='Cannot overwrite a Counter'):
            Frontend.change(doc1, lambda d: d.update({'counter': 42}))

    def test_counter_behaves_like_number(self):
        doc, _ = Frontend.change(
            Frontend.init(), lambda d: d.update({'birds': Counter(3)}))
        c = doc['birds']
        assert c + 10 == 13
        assert c < 4 and c >= 3
        assert int(c) == 3
        assert str(c) == '3'

    def test_counter_json_serializable(self):
        import json
        doc, _ = Frontend.change(
            Frontend.init(), lambda d: d.update({'birds': Counter()}))
        assert json.dumps({'birds': doc['birds'].to_json()}) == '{"birds": 0}'


class TestBackendConcurrency:
    """Async request-queue mode: frontend and backend on separate threads."""

    def test_version_and_seq_from_backend(self):
        local, remote1, remote2 = uuid(), uuid(), uuid()
        patch1 = {
            'clock': {local: 4, remote1: 11, remote2: 41}, 'maxOp': 4,
            'deps': [],
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'blackbirds': {local: {'type': 'value', 'value': 24}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(local), patch1)
        doc2, change = Frontend.change(doc1,
                                       lambda d: d.update({'partridges': 1}))
        assert change == {
            'actor': local, 'seq': 5, 'deps': [], 'startOp': 5,
            'time': change['time'], 'message': '',
            'ops': [{'obj': '_root', 'action': 'set', 'key': 'partridges',
                     'insert': False, 'datatype': 'int', 'value': 1,
                     'pred': []}]}
        assert get_requests(doc2) == [{'actor': local, 'seq': 5}]

    def test_remove_pending_requests_once_handled(self):
        actor = uuid()
        doc1, change1 = Frontend.change(Frontend.init(actor),
                                        lambda d: d.update({'blackbirds': 24}))
        doc2, change2 = Frontend.change(doc1,
                                        lambda d: d.update({'partridges': 1}))
        assert change1['seq'] == 1 and change1['startOp'] == 1
        assert change2['seq'] == 2 and change2['startOp'] == 2
        assert get_requests(doc2) == [{'actor': actor, 'seq': 1},
                                      {'actor': actor, 'seq': 2}]

        doc2 = Frontend.apply_patch(doc2, {
            'actor': actor, 'seq': 1, 'clock': {actor: 1}, 'deps': [],
            'maxOp': 1,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'blackbirds': {actor: {'type': 'value', 'value': 24}}}}})
        assert get_requests(doc2) == [{'actor': actor, 'seq': 2}]
        assert doc2 == {'blackbirds': 24, 'partridges': 1}

        doc2 = Frontend.apply_patch(doc2, {
            'actor': actor, 'seq': 2, 'clock': {actor: 2}, 'deps': [],
            'maxOp': 2,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'partridges': {actor: {'type': 'value', 'value': 1}}}}})
        assert doc2 == {'blackbirds': 24, 'partridges': 1}
        assert get_requests(doc2) == []

    def test_remote_patches_leave_queue_unchanged(self):
        actor, other = uuid(), uuid()
        doc, req = Frontend.change(Frontend.init(actor),
                                   lambda d: d.update({'blackbirds': 24}))
        assert get_requests(doc) == [{'actor': actor, 'seq': 1}]

        doc = Frontend.apply_patch(doc, {
            'clock': {other: 1}, 'deps': [], 'maxOp': 1,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'pheasants': {other: {'type': 'value', 'value': 2}}}}})
        # Remote value not visible yet: the local request is still in flight
        assert doc == {'blackbirds': 24}
        assert get_requests(doc) == [{'actor': actor, 'seq': 1}]

        doc = Frontend.apply_patch(doc, {
            'actor': actor, 'seq': 1, 'clock': {actor: 1, other: 1},
            'deps': [], 'maxOp': 1,
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'blackbirds': {actor: {'type': 'value', 'value': 24}}}}})
        assert doc == {'blackbirds': 24, 'pheasants': 2}
        assert get_requests(doc) == []

    def test_out_of_order_request_patches_rejected(self):
        doc1, _ = Frontend.change(Frontend.init(),
                                  lambda d: d.update({'blackbirds': 24}))
        doc2, _ = Frontend.change(doc1, lambda d: d.update({'partridges': 1}))
        actor = Frontend.get_actor_id(doc2)
        diffs = {'objectId': '_root', 'type': 'map', 'props': {
            'partridges': {actor: {'type': 'value', 'value': 1}}}}
        with pytest.raises(ValueError, match='Mismatched sequence number'):
            Frontend.apply_patch(doc2, {'actor': actor, 'seq': 2,
                                        'clock': {actor: 2}, 'deps': [],
                                        'maxOp': 2, 'diffs': diffs})

    def test_concurrent_insertions_into_lists(self):
        doc1, _ = Frontend.change(Frontend.init(),
                                  lambda d: d.update({'birds': ['goldfinch']}))
        birds = Frontend.get_object_id(doc1['birds'])
        actor = Frontend.get_actor_id(doc1)
        doc1 = Frontend.apply_patch(doc1, {
            'actor': actor, 'seq': 1, 'clock': {actor: 1}, 'maxOp': 2,
            'deps': [],
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {actor: {'objectId': birds, 'type': 'list', 'edits': [
                    {'action': 'insert', 'elemId': f'2@{actor}',
                     'opId': f'2@{actor}', 'index': 0,
                     'value': {'type': 'value', 'value': 'goldfinch'}}]}}}}})
        assert doc1 == {'birds': ['goldfinch']}
        assert get_requests(doc1) == []

        def ins(d):
            d['birds'].insert_at(0, 'chaffinch')
            d['birds'].insert_at(2, 'greenfinch')
        doc2, _ = Frontend.change(doc1, ins)
        assert doc2 == {'birds': ['chaffinch', 'goldfinch', 'greenfinch']}

        remote_actor = uuid()
        doc3 = Frontend.apply_patch(doc2, {
            'clock': {actor: 1, remote_actor: 1}, 'maxOp': 4, 'deps': [],
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {actor: {'objectId': birds, 'type': 'list', 'edits': [
                    {'action': 'insert', 'elemId': f'1@{remote_actor}',
                     'opId': f'1@{remote_actor}', 'index': 1,
                     'value': {'type': 'value', 'value': 'bullfinch'}}]}}}}})
        # Remote insert does not take effect until our request round-trips
        assert doc3 == {'birds': ['chaffinch', 'goldfinch', 'greenfinch']}

        doc4 = Frontend.apply_patch(doc3, {
            'actor': actor, 'seq': 2, 'clock': {actor: 2, remote_actor: 1},
            'maxOp': 4, 'deps': [],
            'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                'birds': {actor: {'objectId': birds, 'type': 'list', 'edits': [
                    {'action': 'insert', 'index': 0, 'elemId': f'3@{actor}',
                     'opId': f'3@{actor}',
                     'value': {'type': 'value', 'value': 'chaffinch'}},
                    {'action': 'insert', 'index': 2, 'elemId': f'4@{actor}',
                     'opId': f'4@{actor}',
                     'value': {'type': 'value', 'value': 'greenfinch'}}]}}}}})
        assert doc4 == {'birds': ['chaffinch', 'goldfinch', 'greenfinch',
                                  'bullfinch']}
        assert get_requests(doc4) == []

    def test_interleaving_patches_and_changes(self):
        actor = uuid()
        doc1, change1 = Frontend.change(Frontend.init(actor),
                                        lambda d: d.update({'number': 1}))
        doc2, change2 = Frontend.change(doc1, lambda d: d.update({'number': 2}))
        assert change2['ops'] == [
            {'obj': '_root', 'action': 'set', 'key': 'number', 'insert': False,
             'datatype': 'int', 'value': 2, 'pred': [f'1@{actor}']}]
        state0 = Backend.init()
        _state1, patch1, _bin1 = Backend.apply_local_change(state0, change1)
        doc2a = Frontend.apply_patch(doc2, patch1)
        _doc3, change3 = Frontend.change(doc2a, lambda d: d.update({'number': 3}))
        assert change3['seq'] == 3 and change3['startOp'] == 3
        assert change3['ops'] == [
            {'obj': '_root', 'action': 'set', 'key': 'number', 'insert': False,
             'datatype': 'int', 'value': 3, 'pred': [f'2@{actor}']}]

    def test_deps_filled_in_when_frontend_behind(self):
        actor1, actor2 = uuid(), uuid()
        _doc1, change1 = Frontend.change(Frontend.init(actor1),
                                         lambda d: d.update({'number': 1}))
        _s, _p, bin1 = Backend.apply_local_change(Backend.init(), change1)

        state1a, patch1a = Backend.apply_changes(Backend.init(), [bin1])
        doc1a = Frontend.apply_patch(Frontend.init(actor2), patch1a)
        doc2, change2 = Frontend.change(doc1a, lambda d: d.update({'number': 2}))
        doc3, change3 = Frontend.change(doc2, lambda d: d.update({'number': 3}))
        hash1 = decode_change(bin1)['hash']
        assert change2['deps'] == [hash1]
        assert change2['startOp'] == 2
        assert change2['ops'][0]['pred'] == [f'1@{actor1}']
        assert change3['deps'] == []
        assert change3['ops'][0]['pred'] == [f'2@{actor2}']

        state2, patch2, bin2 = Backend.apply_local_change(state1a, change2)
        state3, patch3, bin3 = Backend.apply_local_change(state2, change3)
        assert decode_change(bin2)['deps'] == [hash1]
        assert decode_change(bin3)['deps'] == [decode_change(bin2)['hash']]
        assert patch1a['deps'] == [hash1]
        assert patch2['deps'] == []

        doc2a = Frontend.apply_patch(doc3, patch2)
        doc3a = Frontend.apply_patch(doc2a, patch3)
        _doc4, change4 = Frontend.change(doc3a, lambda d: d.update({'number': 4}))
        assert change4['seq'] == 3 and change4['startOp'] == 4
        assert change4['deps'] == []
        _s4, _p4, bin4 = Backend.apply_local_change(state3, change4)
        assert decode_change(bin4)['deps'] == [decode_change(bin3)['hash']]


class TestApplyingPatches:
    def test_set_root_properties(self):
        actor = uuid()
        patch = {'clock': {actor: 1}, 'deps': [], 'maxOp': 1,
                 'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                     'bird': {f'1@{actor}': {'type': 'value',
                                             'value': 'magpie'}}}}}
        doc = Frontend.apply_patch(Frontend.init(), patch)
        assert dict(doc) == {'bird': 'magpie'}

    def test_reveal_conflicts_on_root(self):
        actor1, actor2 = '02ef21', '2a1d37'
        patch = {'clock': {actor1: 1, actor2: 1}, 'deps': [], 'maxOp': 1,
                 'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                     'favoriteBird': {
                         f'1@{actor1}': {'type': 'value', 'value': 'robin'},
                         f'1@{actor2}': {'type': 'value', 'value': 'wagtail'}}}}}
        doc = Frontend.apply_patch(Frontend.init(), patch)
        # Lamport: higher actorId wins at equal counter
        assert dict(doc) == {'favoriteBird': 'wagtail'}
        assert Frontend.get_conflicts(doc, 'favoriteBird') == {
            f'1@{actor1}': 'robin', f'1@{actor2}': 'wagtail'}

    def test_create_nested_maps_from_patch(self):
        actor = uuid()
        patch = {'clock': {actor: 1}, 'deps': [], 'maxOp': 2,
                 'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                     'birds': {f'1@{actor}': {
                         'objectId': f'1@{actor}', 'type': 'map', 'props': {
                             'wrens': {f'2@{actor}': {'type': 'value',
                                                      'value': 3,
                                                      'datatype': 'int'}}}}}}}}
        doc = Frontend.apply_patch(Frontend.init(), patch)
        assert doc == {'birds': {'wrens': 3}}

    def test_create_lists_from_patch(self):
        actor = uuid()
        patch = {'clock': {actor: 1}, 'deps': [], 'maxOp': 2,
                 'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                     'birds': {f'1@{actor}': {
                         'objectId': f'1@{actor}', 'type': 'list', 'edits': [
                             {'action': 'insert', 'index': 0,
                              'elemId': f'2@{actor}', 'opId': f'2@{actor}',
                              'value': {'type': 'value',
                                        'value': 'chaffinch'}}]}}}}}
        doc = Frontend.apply_patch(Frontend.init(), patch)
        assert doc == {'birds': ['chaffinch']}

    def test_multi_insert_patch(self):
        actor = uuid()
        patch = {'clock': {actor: 1}, 'deps': [], 'maxOp': 4,
                 'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                     'birds': {f'1@{actor}': {
                         'objectId': f'1@{actor}', 'type': 'list', 'edits': [
                             {'action': 'multi-insert', 'index': 0,
                              'elemId': f'2@{actor}',
                              'values': ['a', 'b', 'c']}]}}}}}
        doc = Frontend.apply_patch(Frontend.init(), patch)
        assert doc == {'birds': ['a', 'b', 'c']}
        assert Frontend.get_element_ids(doc['birds']) == \
            [f'2@{actor}', f'3@{actor}', f'4@{actor}']

    def test_text_patch(self):
        actor = uuid()
        patch = {'clock': {actor: 1}, 'deps': [], 'maxOp': 3,
                 'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                     'text': {f'1@{actor}': {
                         'objectId': f'1@{actor}', 'type': 'text', 'edits': [
                             {'action': 'multi-insert', 'index': 0,
                              'elemId': f'2@{actor}', 'values': ['h', 'i']}]}}}}}
        doc = Frontend.apply_patch(Frontend.init(), patch)
        assert isinstance(doc['text'], Text)
        assert str(doc['text']) == 'hi'


class TestApplyingPatchesMore:
    """Remaining patch-application cases (ref frontend_test.js:478-763)."""

    def test_updates_inside_nested_maps_from_patch(self):
        birds, actor = uuid(), uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 2,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {actor: {
                          'objectId': birds, 'type': 'map', 'props': {
                              'wrens': {actor: {'type': 'value',
                                                'value': 3}}}}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 3,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {actor: {
                          'objectId': birds, 'type': 'map', 'props': {
                              'sparrows': {actor: {'type': 'value',
                                                   'value': 15}}}}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'birds': {'wrens': 3}}
        assert doc2 == {'birds': {'wrens': 3, 'sparrows': 15}}

    def test_updates_inside_map_key_conflicts(self):
        birds1, birds2 = uuid(), uuid()
        patch1 = {'clock': {birds1: 1, birds2: 1}, 'deps': [], 'maxOp': 2,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'favoriteBirds': {
                          'actor1': {'objectId': birds1, 'type': 'map',
                                     'props': {'blackbirds': {
                                         'actor1': {'type': 'value',
                                                    'value': 1}}}},
                          'actor2': {'objectId': birds2, 'type': 'map',
                                     'props': {'wrens': {
                                         'actor2': {'type': 'value',
                                                    'value': 3}}}}}}}}
        patch2 = {'clock': {birds1: 2, birds2: 1}, 'deps': [], 'maxOp': 3,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'favoriteBirds': {
                          'actor1': {'objectId': birds1, 'type': 'map',
                                     'props': {'blackbirds': {
                                         'actor1': {'value': 2}}}},
                          'actor2': {'objectId': birds2, 'type': 'map'}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'favoriteBirds': {'wrens': 3}}
        assert doc2 == {'favoriteBirds': {'wrens': 3}}
        assert Frontend.get_conflicts(doc1, 'favoriteBirds') == {
            'actor1': {'blackbirds': 1}, 'actor2': {'wrens': 3}}
        assert Frontend.get_conflicts(doc2, 'favoriteBirds') == {
            'actor1': {'blackbirds': 2}, 'actor2': {'wrens': 3}}

    def test_structure_shares_unmodified_objects(self):
        birds, mammals, actor = uuid(), uuid(), uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 4,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {actor: {
                          'objectId': birds, 'type': 'map', 'props': {
                              'wrens': {actor: {'value': 3}}}}},
                      'mammals': {actor: {
                          'objectId': mammals, 'type': 'map', 'props': {
                              'badgers': {actor: {'value': 1}}}}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 5,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {actor: {
                          'objectId': birds, 'type': 'map', 'props': {
                              'sparrows': {actor: {'value': 15}}}}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'birds': {'wrens': 3}, 'mammals': {'badgers': 1}}
        assert doc2 == {'birds': {'wrens': 3, 'sparrows': 15},
                        'mammals': {'badgers': 1}}
        assert doc1['mammals'] is doc2['mammals']

    def test_delete_keys_in_maps_from_patch(self):
        actor = uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 2,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'magpies': {actor: {'value': 2}},
                      'sparrows': {actor: {'value': 15}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 3,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'magpies': {}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'magpies': 2, 'sparrows': 15}
        assert doc2 == {'sparrows': 15}

    def test_updates_inside_lists_from_patch(self):
        birds, actor = uuid(), uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 2,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {actor: {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'insert', 'index': 0,
                               'elemId': f'2@{actor}', 'opId': f'2@{actor}',
                               'value': {'value': 'chaffinch'}}]}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 3,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {actor: {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'update', 'index': 0,
                               'opId': f'3@{actor}',
                               'value': {'value': 'greenfinch'}}]}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'birds': ['chaffinch']}
        assert doc2 == {'birds': ['greenfinch']}

    def test_updates_inside_list_element_conflicts(self):
        actor1, actor2 = '01234567', '89abcdef'
        birds = f'1@{actor1}'
        patch1 = {'clock': {actor1: 2, actor2: 1}, 'deps': [], 'maxOp': 4,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {birds: {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'insert', 'index': 0,
                               'elemId': f'2@{actor1}', 'opId': f'2@{actor1}',
                               'value': {
                                   'objectId': f'2@{actor1}', 'type': 'map',
                                   'props': {
                                       'species': {f'3@{actor1}': {
                                           'type': 'value',
                                           'value': 'woodpecker'}},
                                       'numSeen': {f'4@{actor1}': {
                                           'type': 'value', 'value': 1}}}}},
                              {'action': 'update', 'index': 0,
                               'opId': f'2@{actor2}', 'value': {
                                   'objectId': f'2@{actor2}', 'type': 'map',
                                   'props': {
                                       'species': {f'3@{actor2}': {
                                           'type': 'value',
                                           'value': 'lapwing'}},
                                       'numSeen': {f'4@{actor2}': {
                                           'type': 'value', 'value': 2}}}}}]}}}}}
        patch2 = {'clock': {actor1: 3, actor2: 1}, 'deps': [], 'maxOp': 5,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {birds: {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'update', 'index': 0,
                               'opId': f'2@{actor1}', 'value': {
                                   'objectId': f'2@{actor1}', 'type': 'map',
                                   'props': {'numSeen': {f'5@{actor1}': {
                                       'type': 'value', 'value': 2}}}}},
                              {'action': 'update', 'index': 0,
                               'opId': f'2@{actor2}', 'value': {
                                   'objectId': f'2@{actor2}', 'type': 'map',
                                   'props': {}}}]}}}}}
        patch3 = {'clock': {actor1: 3, actor2: 1}, 'deps': [], 'maxOp': 6,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {birds: {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'update', 'index': 0,
                               'opId': f'2@{actor1}', 'value': {
                                   'objectId': f'2@{actor1}', 'type': 'map',
                                   'props': {'numSeen': {f'6@{actor1}': {
                                       'type': 'value', 'value': 2}}}}}]}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        doc3 = Frontend.apply_patch(doc2, patch3)
        assert doc1 == {'birds': [{'species': 'lapwing', 'numSeen': 2}]}
        assert doc2 == {'birds': [{'species': 'lapwing', 'numSeen': 2}]}
        assert doc3 == {'birds': [{'species': 'woodpecker', 'numSeen': 2}]}
        assert doc1['birds'][0] is doc2['birds'][0]
        assert Frontend.get_conflicts(doc1['birds'], 0) == {
            f'2@{actor1}': {'species': 'woodpecker', 'numSeen': 1},
            f'2@{actor2}': {'species': 'lapwing', 'numSeen': 2}}
        assert Frontend.get_conflicts(doc2['birds'], 0) == {
            f'2@{actor1}': {'species': 'woodpecker', 'numSeen': 2},
            f'2@{actor2}': {'species': 'lapwing', 'numSeen': 2}}
        assert Frontend.get_conflicts(doc3['birds'], 0) is None

    def test_delete_list_elements_from_patch(self):
        birds, actor = uuid(), uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 3,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {f'1@{actor}': {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'insert', 'index': 0,
                               'elemId': f'2@{actor}', 'opId': f'2@{actor}',
                               'value': {'value': 'chaffinch'}},
                              {'action': 'insert', 'index': 1,
                               'elemId': f'3@{actor}', 'opId': f'3@{actor}',
                               'value': {'value': 'goldfinch'}}]}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 4,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {f'1@{actor}': {
                          'objectId': birds, 'type': 'list', 'props': {},
                          'edits': [{'action': 'remove', 'index': 0,
                                     'count': 1}]}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'birds': ['chaffinch', 'goldfinch']}
        assert doc2 == {'birds': ['goldfinch']}

    def test_delete_multiple_list_elements_from_patch(self):
        birds, actor = uuid(), uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 3,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {f'1@{actor}': {
                          'objectId': birds, 'type': 'list', 'edits': [
                              {'action': 'insert', 'index': 0,
                               'elemId': f'2@{actor}', 'opId': f'2@{actor}',
                               'value': {'value': 'chaffinch'}},
                              {'action': 'insert', 'index': 1,
                               'elemId': f'3@{actor}', 'opId': f'3@{actor}',
                               'value': {'value': 'goldfinch'}}]}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 4,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'birds': {f'1@{actor}': {
                          'objectId': birds, 'type': 'list', 'props': {},
                          'edits': [{'action': 'remove', 'index': 0,
                                     'count': 2}]}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'birds': ['chaffinch', 'goldfinch']}
        assert doc2 == {'birds': []}

    def test_updates_at_different_tree_levels(self):
        actor = uuid()
        patch1 = {'clock': {actor: 1}, 'deps': [], 'maxOp': 6,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'counts': {f'1@{actor}': {
                          'objectId': f'1@{actor}', 'type': 'map', 'props': {
                              'magpies': {f'2@{actor}': {'value': 2}}}}},
                      'details': {f'3@{actor}': {
                          'objectId': f'3@{actor}', 'type': 'list', 'edits': [
                              {'action': 'insert', 'index': 0,
                               'elemId': f'4@{actor}', 'opId': f'4@{actor}',
                               'value': {
                                   'objectId': f'4@{actor}', 'type': 'map',
                                   'props': {
                                       'species': {f'5@{actor}': {
                                           'type': 'value',
                                           'value': 'magpie'}},
                                       'family': {f'6@{actor}': {
                                           'type': 'value',
                                           'value': 'corvidae'}}}}}]}}}}}
        patch2 = {'clock': {actor: 2}, 'deps': [], 'maxOp': 8,
                  'diffs': {'objectId': '_root', 'type': 'map', 'props': {
                      'counts': {f'1@{actor}': {
                          'objectId': f'1@{actor}', 'type': 'map', 'props': {
                              'magpies': {f'7@{actor}': {'type': 'value',
                                                         'value': 3}}}}},
                      'details': {f'3@{actor}': {
                          'objectId': f'3@{actor}', 'type': 'list', 'edits': [
                              {'action': 'update', 'index': 0,
                               'opId': f'4@{actor}', 'value': {
                                   'objectId': f'4@{actor}', 'type': 'map',
                                   'props': {'species': {f'8@{actor}': {
                                       'type': 'value',
                                       'value': 'Eurasian magpie'}}}}}]}}}}}
        doc1 = Frontend.apply_patch(Frontend.init(), patch1)
        doc2 = Frontend.apply_patch(doc1, patch2)
        assert doc1 == {'counts': {'magpies': 2},
                        'details': [{'species': 'magpie',
                                     'family': 'corvidae'}]}
        assert doc2 == {'counts': {'magpies': 3},
                        'details': [{'species': 'Eurasian magpie',
                                     'family': 'corvidae'}]}
