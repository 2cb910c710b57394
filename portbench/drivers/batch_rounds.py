"""Closed loop of concurrent rounds at a hub: `batch_loop`'s batches,
turnover and checks, where every batch is one round of the cell's kind
(each actor's change from the doc's frontier, so concurrent changes).

A guard runs before set-up: 8 probe docs (`probe_docs`) of a short
history (`probe_history_ops`) from the seed are loaded into a small fleet
of their own and take one round. If the fleet's `fallbacks` counter
rose, or `turbo_calls` did not, the program sends such rounds to its
per-doc exact path, which cannot set up a hub of this size in a run's
time: the run stops there with a message (exit status 1) instead.

After the window the fleet's path counters over it go to the log:
`fallbacks` must read 0 there.
"""

import time

import numpy as np

from .batch_loop import BatchLoop, _saved_doc


def make(cfg, traffic, seed, device, log):
    return BatchRounds(cfg, traffic, seed, device, log)


class BatchRounds(BatchLoop):

    def setup(self, phases):
        self.probe()
        super().setup(phases)

    def window(self, seconds):
        before = self.fleet.metrics.snapshot()
        out = super().window(seconds)
        got = self.fleet.metrics.delta(before)
        self.log('window counters: ' + ', '.join(
            f'{k} {got.get(k, 0)}' for k in (
                'fallbacks', 'turbo_calls', 'turbo_causal_docs',
                'turbo_drain_docs', 'turbo_multihead_docs')))
        return out

    def probe(self):
        """One round on a few probe docs; SystemExit unless it took the
        batched path."""
        t = time.perf_counter()
        from automerge_tpu_torch.fleet import load_docs
        from automerge_tpu_torch.fleet.backend import (DocFleet,
                                                       apply_changes_docs)
        n = self.traffic['probe_docs']
        cfg = dict(self.cfg, groups=1,
                   history_ops=self.traffic['probe_history_ops'])
        groups = self.groups.__class__(
            cfg, np.random.default_rng(int(self.rng.integers(1 << 62))))
        saved = _saved_doc(groups.make_history()[0])
        fleet = DocFleet(doc_capacity=n,
                         key_capacity=self.cfg['key_capacity'],
                         device=self.device)
        handles = load_docs([saved] * n, fleet)
        batch = groups.make_batch(self.traffic)[0][0]
        before = fleet.metrics.snapshot()
        apply_changes_docs(handles, [batch] * n, mirror=False)
        got = fleet.metrics.delta(before)
        self.log(f'probe: {n} docs, one round: fallbacks {got["fallbacks"]}, '
                 f'turbo_calls {got["turbo_calls"]}, '
                 f'{time.perf_counter() - t:.3f} s')
        if got['fallbacks'] or not got['turbo_calls']:
            raise SystemExit(
                f'portbench: the program sent a concurrent round of {n} '
                f'probe docs to its per-doc exact path (fallbacks '
                f'{got["fallbacks"]}, turbo_calls {got["turbo_calls"]}); '
                f'{self.cfg["docs"]} docs cannot set up in a run\'s time')
