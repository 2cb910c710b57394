"""The concurrent Text cell (`text-concurrent-1k`) cut to a tiny size on
the CPU: it comes out correct traced and untraced, its control does
not, its set-up guard stops a program that sends concurrent rounds to
the per-doc exact path, and its readers sum their spans."""

import pytest

from portbench import run
from helpers import SEED

CELL = 'text-concurrent-1k'


def tiny(docs=32):
    """(bench, cell, cfg, traffic) cut to `docs` docs of ~400-op
    histories, short epochs and a small probe."""
    bench, cell, cfg, traffic = run.load_cell(CELL)
    cfg = dict(cfg, docs=docs, history_ops=400)
    traffic = dict(traffic, epoch_batches=3, probe_docs=4,
                   probe_history_ops=48)
    return bench, cell, cfg, traffic


def run_tiny(trace=False, control=False, seconds=0.3):
    bench, cell, cfg, traffic = tiny()
    return run.run_cell(bench, cell, cfg, traffic, SEED, seconds, trace,
                        device='cpu', control=control)


@pytest.mark.parametrize('trace', [False, True])
def test_tiny_cell_is_correct(trace, capsys):
    result, checks = run_tiny(trace=trace)
    assert result['correct'], checks
    assert result['failed'] == 0 and result['attempted'] > 0
    # every batch of the window stayed on the batched path, as causal
    # runs that leave 3 heads a doc
    err = capsys.readouterr().err
    assert 'probe: 4 docs, one round: fallbacks 0, turbo_calls 1' in err
    line = next(ln for ln in err.splitlines()
                if ln.startswith('window counters: '))
    got = dict(kv.rsplit(' ', 1) for kv in
               line[len('window counters: '):].split(', '))
    steps = int(got['turbo_calls'])
    assert steps > 0 and got['fallbacks'] == '0'
    assert got['turbo_drain_docs'] == '0'
    assert int(got['turbo_causal_docs']) == \
        int(got['turbo_multihead_docs']) == 32 * steps
    if trace:
        # the cell's own readers and the text cell's host-side ones (the
        # device trace's readers find nothing on the CPU)
        assert set(result['metrics']) == {
            'causal_gate_ms.conc_ops', 'heads_ms.conc_ops',
            'turbo_host_ms.text_ops', 'dispatch_ms.text_ops',
            'gc_share.text_ops', 'turnover_ms.text_ops',
            'load_values_ms.text_ops'}
        assert all(m['value'] > 0 for name, m in result['metrics'].items()
                   if name != 'gc_share.text_ops')
    else:
        assert set(result['metrics']) == {'setup_s', 'text_ops_per_s'}


def test_control_is_not_correct():
    result, checks = run_tiny(control=True)
    assert not result['correct']
    assert dict((n, v) for n, v, _ in checks)['docs_wrong'] == 32


def test_reference_orders_ties_by_op_id_and_control_by_arrival():
    from portbench.reference.text_rga import rga_text
    from portbench.reference.text_rga_arrival import rga_text_arrival
    a, b, c = 'aa' * 16, 'bb' * 16, 'cc' * 16
    # three actors' first inserts at the head share counter 2
    ops = [('ins', f'2@{a}', None, 'a'), ('ins', f'3@{a}', f'2@{a}', 'A'),
           ('ins', f'2@{b}', None, 'b'), ('ins', f'2@{c}', None, 'c'),
           ('del', f'3@{a}')]
    assert rga_text(ops) == 'cba'
    assert rga_text_arrival(ops) == 'abc'


def test_guard_stops_a_program_whose_rounds_fall_back(monkeypatch):
    from automerge_tpu_torch.fleet import backend
    monkeypatch.setattr(backend, '_apply_changes_turbo',
                        lambda *a, **k: None)
    with pytest.raises(SystemExit, match='per-doc exact path'):
        run_tiny()


# two timed batches: the gate's spans nested in the turbo phases
_SPANS = [('turbo_gate', 0, 5_000_000, 1),
          ('turbo_causal', 1_000_000, 3_000_000, 1),
          ('turbo_drain', 3_000_000, 4_000_000, 1),
          ('turbo_commit', 5_000_000, 9_000_000, 1),
          ('turbo_heads', 6_000_000, 6_500_000, 1),
          ('turbo_causal', 20_000_000, 21_000_000, 1),
          ('turbo_heads', 22_000_000, 22_500_000, 1)]


@pytest.mark.parametrize('name,want', [
    ('causal_gate_ms.conc_ops', (2 + 1 + 1) / 2),
    ('heads_ms.conc_ops', (0.5 + 0.5) / 2)])
def test_readers_sum_their_spans_per_step(name, want):
    ctx = {'steps': 2, 'spans': _SPANS}
    assert run.reader(name)(ctx, name) == pytest.approx(want)
    # no timed step, or none of their spans (the parent's program)
    assert run.reader(name)(dict(ctx, steps=0), name) is None
    assert run.reader(name)({'steps': 2, 'spans': [
        ('turbo_gate', 0, 1_000_000, 1)]}, name) is None


@pytest.mark.parametrize('name', ['causal_gate_ms.conc_ops',
                                  'heads_ms.conc_ops'])
def test_readers_find_nothing_without_a_trace(name):
    ctx = {'steps': 0, 'summary': None, 'step_counts': [], 'spans': [],
           'window_s': 1.0}
    assert run.reader(name)(ctx, name) is None


def test_rounds_follow_the_configuration():
    import numpy as np
    from portbench.kinds.text_rounds import Groups
    from portbench.wire.columnar import decode_change
    _bench, _cell, cfg, traffic = tiny()
    cfg = dict(cfg, groups=2, actors=2, ops_per_change=4, delete_share=0.0,
               continuation=1.0)
    groups = Groups(cfg, np.random.default_rng(SEED))
    groups.make_history()
    for bufs, ops in groups.make_batch(traffic):
        changes = [decode_change(b) for b in bufs]
        assert [c['actor'] for c in changes] == ['aa' * 16, 'bb' * 16]
        assert [len(c['ops']) for c in changes] == [4, 4]
        # no deletes; each actor types on after its own first insert
        assert [op[0] for op in ops] == ['ins'] * 8
        assert [op[2] for op in ops[1:4]] == [op[1] for op in ops[0:3]]
