"""Automerge.Text documents (BASELINE config 2, automerge-classic's
test/text_test.js shape): 3 actors in turn on one chain."""

from ..gen.text_trace import TextTrace
from ..reference.text_rga import rga_text


class Groups:
    """`cfg['groups']` document groups, each one trace."""

    unit = 'ops'

    def __init__(self, cfg, rng):
        self.cfg = cfg
        self.traces = [TextTrace(int(rng.integers(1 << 62)))
                       for _ in range(cfg['groups'])]
        self.history = []

    def heads(self):
        return [t.heads for t in self.traces]

    def make_history(self):
        out = []
        for t in self.traces:
            first = t.start()
            bufs, ops = t.more(self.cfg['history_ops'] - 1)
            self.history.append(([first] + bufs, ops))
            out.append([first] + bufs)
        return out

    def make_batch(self, traffic):
        return [t.more(traffic['ops_per_doc']) for t in self.traces]

    @staticmethod
    def work(batch_group):
        return len(batch_group[1])

    def reference(self, g, batches, control=False):
        """{'t': text}: the control keeps deleted characters."""
        ops = list(self.history[g][1])
        for b in batches:
            ops += b[g][1]
        return {'t': rga_text(ops, show_deleted=control)}

    @staticmethod
    def read(handles):
        """Every doc's text, read from the card's sequence rows."""
        from automerge_tpu_torch.fleet.backend import materialize_docs
        return materialize_docs(handles)

    @staticmethod
    def step_counts(batch, g):
        """What one doc of group `g` takes in `batch`: inserts and
        deletes."""
        ops = batch[g][1]
        ins = sum(op[0] == 'ins' for op in ops)
        return {'inserts': ins, 'deletes': len(ops) - ins}
