"""Last-writer-wins map registers, as Automerge resolves a root map of
`set`s: every key shows the value of its op with the greatest op id,
ordered by (counter, actor id). An op that a causally later op on the
same key overwrote has a smaller counter than that op (counters are
Lamport clocks), so the greatest op id over all of a key's ops is the
visible winner among the ops no later op overwrote."""

import numpy as np


def lww_state(ops, value_dtype=None):
    """{key: value} after `ops`, an iterable of (counter, actor index,
    key, value) in any order. Actor indexes follow the actors' hex
    order. `value_dtype` stores the values in that numpy integer type
    (the control: a narrower type than the int the changes carry)."""
    best = {}
    for ctr, actor, key, value in ops:
        cur = best.get(key)
        if cur is None or (ctr, actor) > cur[:2]:
            best[key] = (ctr, actor, value)
    if value_dtype is None:
        return {k: v[2] for k, v in best.items()}
    return {k: int(np.array(v[2]).astype(value_dtype))
            for k, v in best.items()}
