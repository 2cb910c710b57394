"""The parser's row format against its named codes: one change of each op
kind goes through `native.ingest_changes(..., with_seq=True)`, and the
row of the case's last op must carry the flag code that
`automerge_tpu_torch.native` names for it (codec.cpp writes the codes,
every reader in the port compares against the names). The same row's
packed id must format, through `native.format_op_id`, as the op's own
`counter@actor`, and the packed-id layout must be the one the fleet's
device state packs."""

import pytest

from automerge_tpu_torch import native
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.fleet import register_kernel, tensor_doc

A = 'ab' * 16

needs_codec = pytest.mark.skipif(not native.available(),
                                 reason='needs the native codec')


def _op(action, obj='_root', key=None, elem=None, insert=False, value=None,
        datatype=None, pred=()):
    op = {'action': action, 'obj': obj, 'pred': list(pred)}
    if elem is None:
        op['key'] = key
    else:
        op['elemId'], op['insert'] = elem, insert
    if value is not None:
        op['value'] = value
    if datatype is not None:
        op['datatype'] = datatype
    return op


_SEQ = f'1@{A}'      # the sequence _in_seq makes (op 1)
_ELEM = f'2@{A}'     # its first element (op 2)


def _in_seq(make, first, *ops):
    """A sequence made at key 's', an element inserted at its head (the
    insert's value and datatype in `first`), then `ops`."""
    return [_op(make, key='s'),
            _op('set', _SEQ, elem='_head', insert=True, **first), *ops]


_MAKES = [('makeText', native.FLAG_MAKE_TEXT, native.FLAG_ELEM_MAKE_TEXT),
          ('makeList', native.FLAG_MAKE_LIST, native.FLAG_ELEM_MAKE_LIST),
          ('makeMap', native.FLAG_MAKE_MAP, native.FLAG_ELEM_MAKE_MAP),
          ('makeTable', native.FLAG_MAKE_TABLE, native.FLAG_ELEM_MAKE_TABLE)]

CASES = {
    'map_set': ([_op('set', key='k', value=7)], native.FLAG_SET),
    'map_del': ([_op('set', key='k', value=7),
                 _op('del', key='k', pred=[f'1@{A}'])], native.FLAG_SET),
    'map_inc': ([_op('set', key='c', value=1, datatype='counter'),
                 _op('inc', key='c', value=2, pred=[f'1@{A}'])],
                native.FLAG_INC),
    'nested_map_set': ([_op('makeMap', key='m'),
                        _op('set', f'1@{A}', key='x', value=3)],
                       native.FLAG_SET),
    'seq_insert': (_in_seq('makeText', {'value': 'a'}),
                   native.FLAG_SEQ_INSERT),
    'seq_set': (_in_seq('makeText', {'value': 'a'},
                        _op('set', _SEQ, elem=_ELEM, value='b',
                            pred=[_ELEM])), native.FLAG_SEQ_SET),
    'seq_del': (_in_seq('makeText', {'value': 'a'},
                        _op('del', _SEQ, elem=_ELEM, pred=[_ELEM])),
                native.FLAG_SEQ_DEL),
    'seq_inc': (_in_seq('makeList', {'value': 1, 'datatype': 'counter'},
                        _op('inc', _SEQ, elem=_ELEM, value=5,
                            pred=[_ELEM])), native.FLAG_SEQ_INC),
}
for _action, _at_key, _as_elem in _MAKES:
    CASES[f'map_{_action}'] = ([_op(_action, key='o')], _at_key)
    CASES[f'elem_{_action}'] = (
        [_op('makeList', key='l'),
         _op(_action, f'1@{A}', elem='_head', insert=True)], _as_elem)


@needs_codec
@pytest.mark.parametrize('name', list(CASES))
def test_each_op_kind_parses_to_its_named_flag(name):
    ops, flag = CASES[name]
    buf = encode_change({'actor': A, 'seq': 1, 'startOp': 1, 'time': 0,
                         'message': '', 'deps': [], 'ops': ops})
    out = native.ingest_changes([buf], None, with_meta=True, with_seq=True)
    assert out is not None, 'the op kind left the parser\'s subset'
    rows, _keys, actors, _meta = out
    assert len(rows['flags']) == len(ops)
    assert int(rows['flags'][-1]) == flag
    assert native.format_op_id(int(rows['packed'][-1]), actors) == \
        f'{len(ops)}@{A}'
    if name == 'map_del':
        assert int(rows['value'][-1]) == -1       # a del is a set of -1
    if flag in native.MAKE_TYPES:
        assert native.MAKE_TYPES[flag] == name.split('_make')[1].lower()


def test_packed_ids_share_the_fleets_actor_bits():
    assert native.ACTOR_BITS == tensor_doc.ACTOR_BITS
    assert native.ACTOR_MASK == tensor_doc.MAX_ACTORS - 1 == \
        register_kernel.ACTOR_MASK
