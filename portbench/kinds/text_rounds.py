"""Automerge.Text documents edited by `actors` editors typing at once:
every batch is one round of concurrent changes from the doc's frontier,
one an actor (portbench/gen/text_rounds.py, which reads the
configuration's `actors`, `ops_per_change`, `delete_share` and
`continuation`), so docs hold concurrent RGA history and a frontier of
one head an actor."""

from ..gen.text_rounds import TextRounds
from ..reference.text_rga import rga_text
from ..reference.text_rga_arrival import rga_text_arrival
from . import text


class Groups(text.Groups):
    """`cfg['groups']` document groups, each one round generator."""

    def __init__(self, cfg, rng):
        self.cfg = cfg
        self.traces = [TextRounds(int(rng.integers(1 << 62)),
                                  actors=cfg['actors'],
                                  ops_per_change=cfg['ops_per_change'],
                                  delete_share=cfg['delete_share'],
                                  continuation=cfg['continuation'])
                       for _ in range(cfg['groups'])]
        self.history = []

    def make_batch(self, traffic):
        """One round a batch: every actor's change of the configuration's
        `ops_per_change` ops (the traffic sets no size of its own)."""
        return [t.round() for t in self.traces]

    def reference(self, g, batches, control=False):
        """{'t': text}: the control keeps concurrent inserts at one
        referent in arrival order instead of RGA's op-id order."""
        ops = list(self.history[g][1])
        for b in batches:
            ops += b[g][1]
        return {'t': (rga_text_arrival if control else rga_text)(ops)}
