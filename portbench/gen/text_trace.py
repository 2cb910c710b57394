"""The Text hub's editing trace, from a seed.

A frozen copy of automerge_tpu_torch/fleet/seq_cases.py:410-504
(`TextTrace`, BASELINE config 2: one makeText at `_root.t`, then ops by 3
actors taking turns, 32 ops a change, on one causal chain; an op is a
delete of a random alive character one time in five, else an insert of a
letter after the previous insert half the time and otherwise after a
random alive character, the head while none is alive). Changes: the
copy encodes with the benchmark's frozen codec (portbench/wire) and
keeps, beside the bytes, the logical ops the reference replays:
('ins', (counter, actor index), ref, char) with ref an op id or None for
the head, and ('del', target op id).
"""

import numpy as np

from ..wire.columnar import decode_change_meta, encode_change

TEXT_ACTORS = ('aa' * 16, 'bb' * 16, 'cc' * 16)
OPS_PER_CHANGE = 32


def _change(actor, seq, start, deps, ops):
    return encode_change({'actor': actor, 'seq': seq, 'startOp': start,
                          'time': 0, 'message': '', 'deps': list(deps),
                          'ops': ops})


class TextTrace:
    """`start()` makes the text object; `more(n_ops)` continues the chain
    and returns (change bytes, logical ops)."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.heads, self.seqs, self.turn = [], {a: 0 for a in TEXT_ACTORS}, 0
        self.max_op = 0
        self.alive, self.last = [], None
        self.obj = None
        self.n_ops = 0
        self.hashes = []

    def _emit(self, ops):
        actor = TEXT_ACTORS[self.turn % len(TEXT_ACTORS)]
        self.turn += 1
        self.seqs[actor] += 1
        buf = _change(actor, self.seqs[actor], self.max_op + 1, self.heads,
                      ops)
        start = self.max_op + 1
        self.max_op += len(ops)
        self.heads = [decode_change_meta(buf, True)['hash']]
        self.hashes.append(self.heads[0])
        return buf, actor, start

    def start(self):
        """The change that makes the text object (one op)."""
        buf, actor, start = self._emit([{'action': 'makeText',
                                         'obj': '_root', 'key': 't',
                                         'pred': []}])
        self.obj = f'{start}@{actor}'
        self.n_ops += 1
        return buf

    def more(self, n_ops):
        """The next `n_ops` ops of the trace: (change bytes, ops)."""
        out, logical = [], []
        while n_ops > 0:
            k = min(OPS_PER_CHANGE, n_ops)
            a = self.turn % len(TEXT_ACTORS)
            actor = TEXT_ACTORS[a]
            ops = []
            for i in range(k):
                ctr = self.max_op + 1 + i
                op_id = f'{ctr}@{actor}'
                rng = self.rng
                if self.alive and rng.random() < 0.2:
                    target = self.alive.pop(int(rng.integers(
                        0, len(self.alive))))
                    if target == self.last:
                        self.last = None
                    ops.append({'action': 'del', 'obj': self.obj,
                                'elemId': target, 'insert': False,
                                'pred': [target]})
                    logical.append(('del', target))
                    continue
                if self.last is not None and rng.random() < 0.5:
                    after = self.last
                elif self.alive:
                    after = self.alive[int(rng.integers(0, len(self.alive)))]
                else:
                    after = '_head'
                char = chr(97 + int(rng.integers(0, 26)))
                ops.append({'action': 'set', 'obj': self.obj,
                            'elemId': after, 'insert': True,
                            'value': char, 'pred': []})
                logical.append(('ins', op_id, None if after == '_head'
                                else after, char))
                self.alive.append(op_id)
                self.last = op_id
            buf, _actor, _start = self._emit(ops)
            out.append(buf)
            n_ops -= k
            self.n_ops += k
        return out, logical
