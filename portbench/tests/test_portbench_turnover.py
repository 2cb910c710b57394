"""The turnover layer's readers (`turnover_ms`, `load_values_ms`): the
summed ms of their spans over the timed batches, and nothing without a
trace or without their spans."""

import pytest

from portbench import run


# a turnover of two timed batches: free, then the load and its phases
_TURNOVER = [('free_docs', 0, 2_000_000, 1),
             ('bulk_load', 2_000_000, 12_000_000, 1),
             ('load_probe', 2_000_000, 3_000_000, 1),
             ('load_seq_values', 3_000_000, 9_000_000, 1),
             ('load_seq_install', 9_000_000, 12_000_000, 1),
             ('dispatch_seq', 12_000_000, 15_000_000, 1),
             ('free_docs', 20_000_000, 21_000_000, 1),
             ('bulk_load', 21_000_000, 26_000_000, 1),
             ('load_seq_values', 22_000_000, 24_000_000, 1)]

_NAMES = ('turnover_ms.text_ops', 'load_values_ms.text_ops')


@pytest.mark.parametrize('name,want', [
    ('turnover_ms.text_ops', (2 + 10 + 1 + 5) / 2),
    ('load_values_ms.text_ops', (6 + 2) / 2)])
def test_turnover_readers_sum_their_spans_per_step(name, want):
    ctx = {'steps': 2, 'spans': _TURNOVER}
    assert run.reader(name)(ctx, name) == pytest.approx(want)
    # no timed step, or no span of theirs: nothing to read
    assert run.reader(name)(dict(ctx, steps=0), name) is None
    assert run.reader(name)({'steps': 2, 'spans': [
        ('dispatch_seq', 0, 1_000_000, 1)]}, name) is None


@pytest.mark.parametrize('name', _NAMES)
def test_turnover_readers_find_nothing_without_a_trace(name):
    ctx = {'steps': 0, 'summary': None, 'step_counts': [], 'spans': [],
           'window_s': 1.0}
    assert run.reader(name)(ctx, name) is None
