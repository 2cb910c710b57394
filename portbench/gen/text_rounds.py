"""Concurrent typing in one Text document, in rounds, from a seed.

Several editors (the configuration's `actors`; the hub's BASELINE
config 2 has 3) type at once: every round each actor sends one change of
`ops_per_change` ops, all made from the same frontier (the previous
round's tips, or the makeText change before the first round), so each
change merges that frontier and the changes are concurrent. Within a
round:

- the round's cursor is a seeded alive character, or the head while
  none is alive; each actor's first insert goes right after it, so the
  first inserts tie at one referent (RGA orders them by op id);
- after that an actor types after its own previous insert with
  probability `continuation`, otherwise after a random character it has
  seen (alive at the round's start, or its own insert this round);
- an op deletes a random character the actor has seen with probability
  `delete_share`; two actors may delete the same character.

`chain()` makes changes of one actor instead, each on the one before
(the first on the whole frontier): the shape of a merge followed by
sequential typing.

Changes are encoded with the benchmark's frozen codec (portbench/wire);
beside the bytes the generator keeps the logical ops the reference
replays, in buffer order (a causal order): ('ins', op id, ref op id or
None for the head, char) and ('del', target op id).
"""

import numpy as np

from ..wire.columnar import decode_change_meta
from .text_trace import _change

# 'aa' * 16, 'bb' * 16, 'cc' * 16, ...: the first three are TEXT_ACTORS
ACTOR_IDS = tuple(c * 32 for c in 'abcdef123456789')


def actor_ids(n):
    """The first `n` editors' actor ids."""
    if not 0 < n <= len(ACTOR_IDS):
        raise ValueError(f'actors must be 1..{len(ACTOR_IDS)}, not {n}')
    return ACTOR_IDS[:n]


class TextRounds:
    """`start()` makes the text object; `round()` makes one round and
    returns (change bytes, logical ops); `more(n_ops)` adds rounds until
    `n_ops` ops are made; `heads` is the frontier (sorted hashes)."""

    def __init__(self, seed=0, actors=3, ops_per_change=16,
                 delete_share=0.2, continuation=0.9):
        self.rng = np.random.default_rng(seed)
        self.actors = actor_ids(actors)
        self.ops_per_change = ops_per_change
        self.delete_share = delete_share
        self.continuation = continuation
        self.heads = []
        self.seqs = dict.fromkeys(ACTOR_IDS, 0)
        self.max_op = 0
        self.alive = []
        self.obj = None

    def start(self):
        """The change that makes the text object (one op)."""
        actor = self.actors[0]
        self.seqs[actor] += 1
        buf = _change(actor, 1, 1, [], [{'action': 'makeText',
                                         'obj': '_root', 'key': 't',
                                         'pred': []}])
        self.max_op = 1
        self.obj = f'1@{actor}'
        self.heads = [decode_change_meta(buf, True)['hash']]
        return buf

    def _actor_ops(self, actor, start, cursor, dead, n, deletes=True):
        """One actor's change of `n` ops: (ops, logical ops)."""
        rng = self.rng
        seen = list(self.alive)
        ops, logical = [], []
        last = None
        for i in range(n):
            op_id = f'{start + i}@{actor}'
            if deletes and seen and rng.random() < self.delete_share:
                target = seen.pop(int(rng.integers(0, len(seen))))
                if target == last:
                    last = None
                dead.add(target)
                ops.append({'action': 'del', 'obj': self.obj,
                            'elemId': target, 'insert': False,
                            'pred': [target]})
                logical.append(('del', target))
                continue
            if cursor is not None:
                after, cursor = cursor, None
            elif last is not None and rng.random() < self.continuation:
                after = last
            elif seen:
                after = seen[int(rng.integers(0, len(seen)))]
            else:
                after = '_head'
            char = chr(97 + int(rng.integers(0, 26)))
            ops.append({'action': 'set', 'obj': self.obj, 'elemId': after,
                        'insert': True, 'value': char, 'pred': []})
            logical.append(('ins', op_id, None if after == '_head' else after,
                            char))
            seen.append(op_id)
            last = op_id
        return ops, logical

    def _commit(self, actor, start, ops, deps):
        self.seqs[actor] += 1
        buf = _change(actor, self.seqs[actor], start, deps, ops)
        return buf, decode_change_meta(buf, True)['hash']

    def round(self, actors=None, cursor=None, deletes=True, n=None):
        """One round: a change of `n` ops (`ops_per_change` by default)
        of each of `actors` (the configuration's by default), all from
        the same frontier; the first inserts go after `cursor` (the
        seeded alive character by default)."""
        n = n or self.ops_per_change
        start = self.max_op + 1
        if cursor is None:
            cursor = self.alive[int(self.rng.integers(0, len(self.alive)))] \
                if self.alive else '_head'
        bufs, logical, heads, dead, born = [], [], [], set(), []
        for actor in actors or self.actors:
            ops, lg = self._actor_ops(actor, start, cursor, dead, n, deletes)
            buf, head = self._commit(actor, start, ops, self.heads)
            bufs.append(buf)
            logical += lg
            heads.append(head)
            born += [op[1] for op in lg if op[0] == 'ins']
        self.max_op += n
        self.heads = sorted(heads)
        self.alive = [e for e in self.alive + born if e not in dead]
        return bufs, logical

    def chain(self, k=1, actor=None):
        """`k` changes of `actor` (the first editor by default), each on
        the one before, the first on the whole frontier (a merge when it
        has several heads): (change bytes, logical ops)."""
        actor = actor or self.actors[0]
        bufs, logical = [], []
        for _ in range(k):
            dead = set()
            start = self.max_op + 1
            ops, lg = self._actor_ops(actor, start, None, dead,
                                      self.ops_per_change)
            buf, head = self._commit(actor, start, ops, self.heads)
            bufs.append(buf)
            logical += lg
            born = [op[1] for op in lg if op[0] == 'ins']
            self.alive = [e for e in self.alive + born if e not in dead]
            self.max_op += self.ops_per_change
            self.heads = [head]
        return bufs, logical

    def more(self, n_ops):
        """Rounds until `n_ops` ops are made: (change bytes, ops)."""
        out, logical = [], []
        while len(logical) < n_ops:
            bufs, lg = self.round()
            out += bufs
            logical += lg
        return out, logical
