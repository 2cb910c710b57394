"""Root maps of int `set`s (BASELINE config 1, automerge-classic's
test/backend_test.js shape), by two actors."""

import numpy as np

from ..gen.map_trace import MapStream
from ..reference.map_lww import lww_state

# the control stores values one integer width below what the changes
# carry (int32 -> int16)
CONTROL_DTYPE = np.int16


class Groups:
    """`cfg['groups']` document groups, each one stream."""

    unit = 'changes'

    def __init__(self, cfg, rng):
        self.cfg = cfg
        self.streams = [MapStream(np.random.default_rng(rng.integers(1 << 62)),
                                  cfg['keys'])
                        for _ in range(cfg['groups'])]
        self.rng = rng
        self.history = []         # per group: (change bytes, ops)

    def heads(self):
        return [s.heads for s in self.streams]

    def make_history(self):
        self.history = [s.chain(self.cfg['history_changes'])
                        for s in self.streams]
        return [h[0] for h in self.history]

    def make_batch(self, traffic):
        """One batch: per group (change bytes, ops). `concurrent_share`
        of the groups, drawn from the seed, write two concurrent
        branches."""
        n = traffic['changes_per_doc']
        k = round(len(self.streams) * traffic['concurrent_share'])
        conc = set(int(g) for g in self.rng.choice(
            len(self.streams), size=k, replace=False))
        return [s.branches(n) if g in conc else s.chain(n)
                for g, s in enumerate(self.streams)]

    @staticmethod
    def work(batch_group):
        return len(batch_group[1])

    def reference(self, g, batches, control=False):
        ops = list(self.history[g][1])
        for b in batches:
            ops += b[g][1]
        return lww_state(ops, CONTROL_DTYPE if control else None)

    @staticmethod
    def read(handles):
        """The program's answer for every doc: {key: value}, read from the
        card through the bulk read."""
        from automerge_tpu_torch.fleet.backend import materialize_docs
        return materialize_docs(handles)

    @staticmethod
    def step_counts(batch, g):
        """What one doc of group `g` takes in `batch`: set lanes and the
        distinct keys they write."""
        ops = batch[g][1]
        return {'lanes': len(ops), 'cells': len({op[2] for op in ops})}
