"""The traffic generators repeat by seed, and the frozen copies make the
same bytes as the program's."""

import numpy as np
import pytest

from portbench.drivers import batch_loop, sync_rounds
from portbench.gen.map_trace import MapStream
from portbench.gen.text_trace import TextTrace
from helpers import SEED, tiny


def _map_bytes(seed):
    s = MapStream(np.random.default_rng(seed), 1000)
    return s.chain(20)[0] + s.branches(20)[0] + s.chain(20)[0]


def test_map_stream_repeats_by_seed():
    assert _map_bytes(SEED) == _map_bytes(SEED)
    assert _map_bytes(SEED) != _map_bytes(SEED + 1)


def test_text_trace_repeats_by_seed():
    a, b = TextTrace(SEED), TextTrace(SEED)
    assert [a.start()] + a.more(700)[0] == [b.start()] + b.more(700)[0]
    c = TextTrace(SEED + 1)
    assert [a.start()] + a.more(100)[0] != [c.start()] + c.more(100)[0]


def test_text_trace_is_the_programs_trace():
    from automerge_tpu_torch.fleet.seq_cases import TextTrace as Program
    a, b = TextTrace(7), Program(7)
    assert [a.start()] + a.more(900)[0] == [b.start()] + b.more(900)


def test_branches_merge_on_the_next_chain():
    s = MapStream(np.random.default_rng(1), 50)
    s.chain(4)
    _bufs, ops = s.branches(6)
    assert len(s.heads) == 2
    assert [o[0] for o in ops] == [5, 6, 7, 5, 6, 7]
    assert [o[1] for o in ops] == [0, 0, 0, 1, 1, 1]
    s.chain(1)
    assert s.deps[-1] == sorted(s.hashes[6:7] + s.hashes[9:10])


@pytest.mark.parametrize('cell', ['map-batch-10k', 'text-batch-1k'])
def test_batch_inputs_repeat_by_seed(cell):
    _b, _c, cfg, traffic = tiny(cell)

    def inputs(seed):
        d = batch_loop.BatchLoop(cfg, traffic, seed, 'cpu', print)
        history = d.groups.make_history()
        batches = [d.groups.make_batch(traffic) for _ in range(2)]
        return history, [[g[0] for g in b] for b in batches], \
            d.doc_group.tolist()
    assert inputs(SEED) == inputs(SEED)
    assert inputs(SEED) != inputs(SEED + 1)


def test_reconnect_messages_repeat_by_seed():
    _b, _c, cfg, traffic = tiny('map-sync-20k')

    def messages(seed):
        d = sync_rounds.SyncRounds(cfg, traffic, seed, 'cpu', print)
        history = d.groups.make_history()
        return history, d.doc_group.tolist(), d.sample.tolist()
    assert messages(SEED) == messages(SEED)
    assert messages(SEED) != messages(SEED + 1)
