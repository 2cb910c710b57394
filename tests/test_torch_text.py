# The port's copy of tests/test_text.py, imports re-pointed at automerge_tpu_torch.
"""Text CRDT conformance tests (ported semantics of reference
test/text_test.js: editing, control characters, spans, elemIds)."""

import json

import pytest

import automerge_tpu_torch as am
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch.frontend import Text


def fresh_pair():
    s1 = am.change(am.init(), lambda d: d.update({'text': Text()}))
    s2 = am.load(am.save(s1))
    return s1, s2


class TestTextEditing:
    def test_insertion(self):
        s1, _ = fresh_pair()
        s1 = am.change(s1, lambda d: d['text'].insert_at(0, 'a'))
        actor = am.get_actor_id(s1)
        assert len(s1['text']) == 1
        assert s1['text'].get(0) == 'a'
        assert str(s1['text']) == 'a'
        assert s1['text'].get_elem_id(0) == f'2@{actor}'

    def test_deletion(self):
        s1, _ = fresh_pair()
        s1 = am.change(s1, lambda d: d['text'].insert_at(0, 'a', 'b', 'c'))
        s1 = am.change(s1, lambda d: d['text'].delete_at(1, 1))
        assert len(s1['text']) == 2
        assert s1['text'].get(0) == 'a'
        assert s1['text'].get(1) == 'c'
        assert str(s1['text']) == 'ac'

    def test_implicit_and_explicit_deletion(self):
        s1, _ = fresh_pair()
        s1 = am.change(s1, lambda d: d['text'].insert_at(0, 'a', 'b', 'c'))
        s1 = am.change(s1, lambda d: d['text'].delete_at(1))
        s1 = am.change(s1, lambda d: d['text'].delete_at(1, 0))
        assert len(s1['text']) == 2
        assert str(s1['text']) == 'ac'

    def test_concurrent_insertion(self):
        s1, s2 = fresh_pair()
        s1 = am.change(s1, lambda d: d['text'].insert_at(0, 'a', 'b', 'c'))
        s2 = am.change(s2, lambda d: d['text'].insert_at(0, 'x', 'y', 'z'))
        s1 = am.merge(s1, s2)
        assert len(s1['text']) == 6
        assert str(s1['text']) in ('abcxyz', 'xyzabc')

    def test_text_and_other_ops_in_same_change(self):
        s1, _ = fresh_pair()

        def edit(d):
            d['foo'] = 'bar'
            d['text'].insert_at(0, 'a')
        s1 = am.change(s1, edit)
        assert s1['foo'] == 'bar'
        assert str(s1['text']) == 'a'

    def test_json_serializes_as_string(self):
        s1, _ = fresh_pair()
        s1 = am.change(s1, lambda d: d['text'].insert_at(0, 'a', '"', 'b'))
        assert json.dumps(s1.to_py()) == '{"text": "a\\"b"}'

    def test_modification_before_assignment(self):
        def edit(d):
            text = Text()
            text.insert_at(0, 'a', 'b', 'c', 'd')
            text.delete_at(2)
            d['text'] = text
        s1 = am.change(am.init(), edit)
        assert str(s1['text']) == 'abd'

    def test_modification_after_assignment(self):
        def edit(d):
            d['text'] = Text()
            d['text'].insert_at(0, 'a', 'b', 'c', 'd')
            d['text'].delete_at(2)
        s1 = am.change(am.init(), edit)
        assert str(s1['text']) == 'abd'

    def test_no_modification_outside_change_callback(self):
        s1, _ = fresh_pair()
        with pytest.raises(TypeError, match='outside of a change block'):
            s1['text'].insert_at(0, 'x')
        with pytest.raises(TypeError, match='outside of a change block'):
            s1['text'].delete_at(0)


class TestInitialValue:
    def test_string_initial_value(self):
        s1 = am.change(am.init(), lambda d: d.update({'text': Text('init')}))
        assert len(s1['text']) == 4
        assert s1['text'].get(0) == 'i'
        assert str(s1['text']) == 'init'

    def test_array_initial_value(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text(['i', 'n', 'i', 't'])}))
        assert str(s1['text']) == 'init'

    def test_text_in_from(self):
        s1 = am.from_({'text': Text('init')})
        assert str(s1['text']) == 'init'

    def test_initial_value_encodes_as_change(self):
        s1 = am.change(am.init(), lambda d: d.update({'text': Text('init')}))
        changes = am.get_all_changes(s1)
        s2, _patch = am.apply_changes(am.init(), changes)
        assert str(s2['text']) == 'init'

    def test_immediate_access_in_callback(self):
        def edit(d):
            d['text'] = Text('init')
            assert len(d['text']) == 4
            assert str(d['text']) == 'init'
        am.change(am.init(), edit)

    def test_pre_assignment_modification(self):
        def edit(d):
            text = Text('init')
            text.delete_at(3)
            text.insert_at(0, 'I', 'n', 'i', 't', 'i', 'a', 'l', ' ')
            text.delete_at(8, 3)
            d['text'] = text
        s1 = am.change(am.init(), edit)
        assert str(s1['text']) == 'Initial '
        s2 = am.load(am.save(s1))
        assert str(s2['text']) == 'Initial '

    def test_post_assignment_modification(self):
        def edit(d):
            d['text'] = Text('init')
            d['text'].delete_at(0)
            d['text'].insert_at(0, 'I')
        s1 = am.change(am.init(), edit)
        assert str(s1['text']) == 'Init'
        s2 = am.load(am.save(s1))
        assert str(s2['text']) == 'Init'


class TestControlCharacters:
    def make(self):
        def edit(d):
            d['text'] = Text()
            d['text'].insert_at(0, 'a')
            d['text'].insert_at(1, {'attribute': 'bold'})
        return am.change(am.init(), edit)

    def test_fetch_non_textual(self):
        s1 = self.make()
        actor = am.get_actor_id(s1)
        assert s1['text'].get(1) == {'attribute': 'bold'}
        assert s1['text'].get_elem_id(1) == f'3@{actor}'

    def test_control_chars_in_length(self):
        s1 = self.make()
        assert len(s1['text']) == 2
        assert s1['text'].get(0) == 'a'

    def test_excluded_from_str(self):
        s1 = self.make()
        assert str(s1['text']) == 'a'

    def test_control_char_update(self):
        s1 = self.make()
        s2 = am.change(s1, lambda d: d['text'][1].update({'attribute': 'italic'}))
        s3 = am.load(am.save(s2))
        assert s1['text'].get(1)['attribute'] == 'bold'
        assert s2['text'].get(1)['attribute'] == 'italic'
        assert s3['text'].get(1)['attribute'] == 'italic'


class TestSpans:
    def test_simple_string_single_span(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text('hello world')}))
        assert s1['text'].to_spans() == ['hello world']

    def test_empty_string_empty_spans(self):
        s1 = am.change(am.init(), lambda d: d.update({'text': Text()}))
        assert s1['text'].to_spans() == []

    def test_split_at_control_character(self):
        def edit(d):
            d['text'] = Text('hello world')
            d['text'].insert_at(5, {'attributes': {'bold': True}})
        s1 = am.change(am.init(), edit)
        assert s1['text'].to_spans() == \
            ['hello', {'attributes': {'bold': True}}, ' world']

    def test_consecutive_control_characters(self):
        def edit(d):
            d['text'] = Text('hello world')
            d['text'].insert_at(5, {'attributes': {'bold': True}})
            d['text'].insert_at(6, {'attributes': {'italic': True}})
        s1 = am.change(am.init(), edit)
        assert s1['text'].to_spans() == \
            ['hello', {'attributes': {'bold': True}},
             {'attributes': {'italic': True}}, ' world']

    def test_control_char_at_text_start(self):
        def edit(d):
            d['text'] = Text('hello')
            d['text'].insert_at(0, {'attributes': {'bold': True}})
        s1 = am.change(am.init(), edit)
        assert s1['text'].to_spans() == [{'attributes': {'bold': True}}, 'hello']


class TestLongEditTrace:
    def test_editing_trace_convergence(self):
        """Simulated multi-actor editing trace with interleaved inserts and
        deletes converges across merge (ref test/text_test.js editing-trace
        style, scaled down)."""
        import random
        rnd = random.Random(42)
        s1 = am.change(am.init('aa01'), lambda d: d.update({'text': Text('seed')}))
        s2 = am.load(am.save(s1), 'bb02')

        def mutate(s, rnd):
            def edit(d):
                t = d['text']
                for _ in range(5):
                    if len(t) > 2 and rnd.random() < 0.4:
                        t.delete_at(rnd.randrange(len(t)))
                    else:
                        t.insert_at(rnd.randrange(len(t) + 1),
                                    rnd.choice('abcdefgh'))
            return am.change(s, edit)

        for _ in range(6):
            s1 = mutate(s1, rnd)
            s2 = mutate(s2, rnd)
        m1 = am.merge(s1, s2)
        m2 = am.merge(s2, m1)
        assert str(m1['text']) == str(m2['text'])
        assert len(m1['text']) > 0


# --- Quill delta interop helpers (ref text_test.js:5-196) ---------------

def _attribute_state_to_attributes(accumulated):
    attributes = {}
    for key, values in accumulated.items():
        if values and values[0] is not None:
            attributes[key] = values[0]
    return attributes


def _is_control_marker(pseudo_char):
    return isinstance(pseudo_char, dict) and 'attributes' in pseudo_char


def _op_from(text, attributes):
    op = {'insert': text}
    if attributes:
        op['attributes'] = attributes
    return op


def _accumulate_attributes(span, accumulated):
    for key, value in span.items():
        if key not in accumulated:
            accumulated[key] = []
        if value is None:
            if not accumulated[key]:
                accumulated[key].insert(0, None)
            else:
                accumulated[key].pop(0)
        else:
            if accumulated[key] and accumulated[key][0] is None:
                accumulated[key].pop(0)
            else:
                accumulated[key].insert(0, value)
    return accumulated


def _plain(value):
    """Deep-convert document views into plain dicts/lists for helpers."""
    if hasattr(value, 'items'):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def automerge_text_to_delta_doc(text):
    ops = []
    control_state = {}
    current_string = ''
    attributes = {}
    for span in text.to_spans():
        span = _plain(span)
        if _is_control_marker(span):
            control_state = _accumulate_attributes(
                span['attributes'], control_state)
        else:
            next_attrs = _attribute_state_to_attributes(control_state)
            if isinstance(span, str) and next_attrs == attributes:
                current_string += span
                continue
            if current_string:
                ops.append(_op_from(current_string, attributes))
            if isinstance(span, str):
                current_string = span
                attributes = next_attrs
            else:
                ops.append(_op_from(span, next_attrs))
                current_string = ''
                attributes = {}
    if current_string:
        ops.append(_op_from(current_string, attributes))
    return ops


def _inverse_attributes(attributes):
    return {key: None for key in attributes}


def _apply_delete_op(text, offset, op):
    length = op['delete']
    while length > 0:
        if _is_control_marker(_plain(text.get(offset))):
            offset += 1
        else:
            text.delete_at(offset, 1)
            length -= 1
    return offset


def _apply_retain_op(text, offset, op):
    length = op['retain']
    if op.get('attributes'):
        text.insert_at(offset, {'attributes': op['attributes']})
        offset += 1
    while length > 0:
        char = _plain(text.get(offset))
        offset += 1
        if not _is_control_marker(char):
            length -= 1
    if op.get('attributes'):
        text.insert_at(offset, {'attributes':
                                _inverse_attributes(op['attributes'])})
        offset += 1
    return offset


def _apply_insert_op(text, offset, op):
    original_offset = offset
    if isinstance(op['insert'], str):
        text.insert_at(offset, *list(op['insert']))
        offset += len(op['insert'])
    else:
        text.insert_at(offset, op['insert'])
        offset += 1
    if op.get('attributes'):
        text.insert_at(original_offset, {'attributes': op['attributes']})
        offset += 1
        text.insert_at(offset, {'attributes':
                                _inverse_attributes(op['attributes'])})
        offset += 1
    return offset


def apply_delta_doc_to_automerge_text(delta, doc):
    offset = 0
    for op in delta:
        if 'retain' in op:
            offset = _apply_retain_op(doc['text'], offset, op)
        elif 'delete' in op:
            offset = _apply_delete_op(doc['text'], offset, op)
        elif 'insert' in op:
            offset = _apply_insert_op(doc['text'], offset, op)


class TestQuillDeltaInterop:
    """ref text_test.js:445-689"""

    def test_convertable_into_quill_delta(self):
        def edit(d):
            d['text'] = Text('Gandalf the Grey')
            d['text'].insert_at(0, {'attributes': {'bold': True}})
            d['text'].insert_at(7 + 1, {'attributes': {'bold': None}})
            d['text'].insert_at(12 + 2, {'attributes': {'color': '#cccccc'}})
        s1 = am.change(am.init(), edit)
        assert automerge_text_to_delta_doc(s1['text']) == [
            {'insert': 'Gandalf', 'attributes': {'bold': True}},
            {'insert': ' the '},
            {'insert': 'Grey', 'attributes': {'color': '#cccccc'}}]

    def test_delta_supports_embeds(self):
        def edit(d):
            d['text'] = Text('')
            d['text'].insert_at(0, {'attributes':
                                    {'link': 'https://quilljs.com'}})
            d['text'].insert_at(1, {
                'image': 'https://quilljs.com/assets/images/icon.png'})
            d['text'].insert_at(2, {'attributes': {'link': None}})
        s1 = am.change(am.init(), edit)
        assert automerge_text_to_delta_doc(s1['text']) == [{
            'insert': {'image': 'https://quilljs.com/assets/images/icon.png'},
            'attributes': {'link': 'https://quilljs.com'}}]

    def test_concurrent_overlapping_spans(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text('Gandalf the Grey')}))
        s2 = am.merge(am.init(), s1)

        def bold_8_16(d):
            d['text'].insert_at(8, {'attributes': {'bold': True}})
            d['text'].insert_at(16 + 1, {'attributes': {'bold': None}})
        s3 = am.change(s1, bold_8_16)

        def bold_0_11(d):
            d['text'].insert_at(0, {'attributes': {'bold': True}})
            d['text'].insert_at(11 + 1, {'attributes': {'bold': None}})
        s4 = am.change(s2, bold_0_11)
        merged = am.merge(s3, s4)
        assert automerge_text_to_delta_doc(merged['text']) == [
            {'insert': 'Gandalf the Grey', 'attributes': {'bold': True}}]

    def test_debolding_spans(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text('Gandalf the Grey')}))
        s2 = am.merge(am.init(), s1)

        def bold_all(d):
            d['text'].insert_at(0, {'attributes': {'bold': True}})
            d['text'].insert_at(16 + 1, {'attributes': {'bold': None}})
        s3 = am.change(s1, bold_all)

        def debold_8_11(d):
            d['text'].insert_at(8, {'attributes': {'bold': None}})
            d['text'].insert_at(11 + 1, {'attributes': {'bold': True}})
        s4 = am.change(s2, debold_8_11)
        merged = am.merge(s3, s4)
        assert automerge_text_to_delta_doc(merged['text']) == [
            {'insert': 'Gandalf ', 'attributes': {'bold': True}},
            {'insert': 'the'},
            {'insert': ' Grey', 'attributes': {'bold': True}}]

    def test_destyling_across_destyled_spans(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text('Gandalf the Grey')}))
        s2 = am.merge(am.init(), s1)

        def bold_all(d):
            d['text'].insert_at(0, {'attributes': {'bold': True}})
            d['text'].insert_at(16 + 1, {'attributes': {'bold': None}})
        s3 = am.change(s1, bold_all)

        def debold_8_11(d):
            d['text'].insert_at(8, {'attributes': {'bold': None}})
            d['text'].insert_at(11 + 1, {'attributes': {'bold': True}})
        s4 = am.change(s2, debold_8_11)
        merged = am.merge(s3, s4)

        def final_edit(d):
            d['text'].insert_at(3 + 1, {'attributes': {'bold': None}})
            d['text'].insert_at(len(d['text']), {'attributes': {'bold': True}})
        final = am.change(merged, final_edit)
        assert automerge_text_to_delta_doc(final['text']) == [
            {'insert': 'Gan', 'attributes': {'bold': True}},
            {'insert': 'dalf the Grey'}]

    def test_apply_an_insert(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text('Hello world')}))
        delta = [{'retain': 6}, {'insert': 'reader'}, {'delete': 5}]
        s2 = am.change(s1,
                       lambda d: apply_delta_doc_to_automerge_text(delta, d))
        assert str(s2['text']) == 'Hello reader'

    def test_apply_insert_with_control_characters(self):
        s1 = am.change(am.init(),
                       lambda d: d.update({'text': Text('Hello world')}))
        delta = [
            {'retain': 6},
            {'insert': 'reader', 'attributes': {'bold': True}},
            {'delete': 5},
            {'insert': '!'}]
        s2 = am.change(s1,
                       lambda d: apply_delta_doc_to_automerge_text(delta, d))
        assert str(s2['text']) == 'Hello reader!'
        assert [_plain(s) for s in s2['text'].to_spans()] == [
            'Hello ',
            {'attributes': {'bold': True}},
            'reader',
            {'attributes': {'bold': None}},
            '!']

    def test_control_characters_in_retain_delete_lengths(self):
        def setup(d):
            d['text'] = Text('Hello world')
            d['text'].insert_at(4, {'attributes': {'color': '#ccc'}})
            d['text'].insert_at(10, {'attributes': {'color': '#f00'}})
        s1 = am.change(am.init(), setup)
        delta = [
            {'retain': 6},
            {'insert': 'reader', 'attributes': {'bold': True}},
            {'delete': 5},
            {'insert': '!'}]
        s2 = am.change(s1,
                       lambda d: apply_delta_doc_to_automerge_text(delta, d))
        assert str(s2['text']) == 'Hello reader!'
        assert [_plain(s) for s in s2['text'].to_spans()] == [
            'Hell',
            {'attributes': {'color': '#ccc'}},
            'o ',
            {'attributes': {'bold': True}},
            'reader',
            {'attributes': {'bold': None}},
            {'attributes': {'color': '#f00'}},
            '!']

    def test_apply_delta_supports_embeds(self):
        s1 = am.change(am.init(), lambda d: d.update({'text': Text('')}))
        delta = [{
            'insert': {'image': 'https://quilljs.com/assets/images/icon.png'},
            'attributes': {'link': 'https://quilljs.com'}}]
        s2 = am.change(s1,
                       lambda d: apply_delta_doc_to_automerge_text(delta, d))
        assert [_plain(s) for s in s2['text'].to_spans()] == [
            {'attributes': {'link': 'https://quilljs.com'}},
            {'image': 'https://quilljs.com/assets/images/icon.png'},
            {'attributes': {'link': None}}]


class TestTextUnicode:
    """ref text_test.js:691-696"""

    def test_unicode_when_creating_text(self):
        s1 = am.from_({'text': Text('🐦')})
        assert s1['text'].get(0) == '🐦'
