"""The plain references: hand cases, and agreement with a
`DocFleet(device='cpu')` of the port at tiny sizes of every cell."""

import ast
import os

import numpy as np
import pytest

from portbench.reference.map_lww import lww_state
from portbench.reference.sync_reply import reply
from portbench.reference.text_rga import rga_text
from portbench.wire.sync_wire import BloomFilter, decode_sync_message
from helpers import CELLS, run_tiny

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'reference')


def test_lww_takes_the_greatest_op_id():
    ops = [(3, 0, 'a', 1), (3, 1, 'a', 2), (2, 1, 'b', 5), (4, 0, 'b', 6),
           (1, 0, 'c', 70000)]
    assert lww_state(ops) == {'a': 2, 'b': 6, 'c': 70000}
    assert lww_state(reversed(ops)) == lww_state(ops)
    assert lww_state(ops, np.int16) == {'a': 2, 'b': 6, 'c': 70000 - 65536}


def test_rga_orders_concurrent_inserts_by_op_id():
    ops = [('ins', '1@aa', None, 'a'),
           ('ins', '2@aa', '1@aa', 'b'),
           ('ins', '2@bb', '1@aa', 'c'),      # concurrent with 2@aa
           ('ins', '3@aa', '2@aa', 'd'),
           ('ins', '3@bb', '2@bb', 'e'),
           ('del', '1@aa')]
    # after 1@aa: 2@bb (greater) then its child 3@bb, then 2@aa, 3@aa
    assert rga_text(ops) == 'cebd'
    assert rga_text(ops, show_deleted=True) == 'acebd'


def test_rga_head_inserts():
    ops = [('ins', '1@aa', None, 'x'), ('ins', '2@aa', None, 'y')]
    assert rga_text(ops) == 'yx'


def test_sync_reply_is_the_host_protocols():
    """The reference's reply to a fresh reconnect equals the port's
    per-doc host protocol on the same history."""
    from automerge_tpu_torch import backend as host
    from portbench.gen.map_trace import MapStream
    s = MapStream(np.random.default_rng(5), 1000)
    bufs, _ops = s.chain(20)
    peer_heads = [s.hashes[15]]
    bloom = BloomFilter(s.hashes[:16]).bytes
    from portbench.wire.sync_wire import encode_sync_message
    msg = encode_sync_message({'heads': peer_heads, 'need': [],
                               'have': [{'lastSync': [], 'bloom': bloom}],
                               'changes': []})
    doc = host.apply_changes(host.init(), bufs)[0]
    doc, state, _ = host.receive_sync_message(doc, host.init_sync_state(),
                                              msg)
    _state, want = host.generate_sync_message(doc, state)
    got = reply(s.hashes, s.deps, bufs, s.heads, peer_heads, [], bloom)
    assert got == bytes(want)
    assert len(decode_sync_message(got)['changes']) >= 4
    full = reply(s.hashes, s.deps, bufs, s.heads, peer_heads, [], bloom,
                 use_filter=False)
    assert len(decode_sync_message(full)['changes']) == 20


@pytest.mark.parametrize('cell', CELLS)
def test_reference_agrees_with_a_cpu_fleet(cell):
    result, checks = run_tiny(cell)
    assert result['correct'], checks
    assert all(v == 0 for _n, v, _lim in checks)
    assert result['attempted'] > 0 and result['failed'] == 0


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ''


def test_reference_imports_nothing_of_the_program():
    names = [n for f in sorted(os.listdir(REF_DIR)) if f.endswith('.py')
             for n in _imports(os.path.join(REF_DIR, f))]
    assert names
    bad = [n for n in names if n.split('.', 1)[0] in
           ('automerge_tpu_torch', 'automerge_tpu', 'jax', 'jaxlib')]
    assert not bad
