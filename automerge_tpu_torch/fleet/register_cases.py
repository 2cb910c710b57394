"""Seeded inputs for holding the register scan (fleet/register_kernel.py)
to its plain version and to the JAX package's, shared by the CPU tests
(tests/test_torch_registers.py), the card tests (tests/test_torch_cuda.py)
and chip_smoke.py.

- `case(name, rng, n_docs, n_keys, n_slots, lanes, d_preds)`: a state
  (`(reg, killed, value, counter, inexact)` numpy arrays) and a
  RegisterOpBatch of numpy columns at one corner of the scan:
  'random' (mixed kinds whose preds name standing ops, earlier ops of
  the batch or nothing), 'dup_preds' (every pred lane repeated),
  'dead_max_inc' (incs whose Lamport-max pred is killed or absent, and
  a live lower pred), 'slots_oob' (actors and pred slots past the slot
  width), 'wrap' (counters next to the int32 limits and large incs),
  'neg_inc' (incs of -1 next to dels), 'self_conflict' (sets that do
  not pred their actor's standing op), 'overflow' (overflow flags,
  on PAD lanes too), 'chain' (set, overwrite, delete and re-set of one
  key inside one batch), 'neg_preds' (pred ids with bit 31 set, which
  the inc's signed max from 0 ignores), 'key_range' (live lanes whose
  key lies outside [0, K]: the port's own rule, so no JAX comparison),
  'one_key' (every op of a doc names one key: the kernel's serial worst
  case, a round per op of a tile) and 'hot_key' (half the lanes name
  one key of their doc). `JAX_CASES` are the cases the JAX step
  defines.
- `both(state, batch, device)`: the case through `register_scan` and
  `register_scan_plain` on copies on `device`; returns the names of the
  arrays that differ, the two lane counts and the largest difference.
- `exact_seam_changes(n_changes, n_keys, seed)`: the exact seam's three
  batches of change bytes for one document (chip_smoke.py gives every
  doc of its fleet the same bytes; the card tests too).
"""

import numpy as np

from ..columnar import decode_change_meta, encode_change
from .register_kernel import register_scan, register_scan_plain
from .registers import (DEL, INC, PAD, SET, RegisterOpBatch,
                        register_state_from_numpy, register_state_to_numpy)

CASES = ('random', 'dup_preds', 'dead_max_inc', 'slots_oob', 'wrap',
         'neg_inc', 'self_conflict', 'overflow', 'chain', 'neg_preds',
         'key_range', 'one_key', 'hot_key')
JAX_CASES = tuple(name for name in CASES if name != 'key_range')
_NAMES = ('reg', 'killed', 'value', 'counter', 'inexact')


def _packed(ctr, actor):
    return ((np.asarray(ctr, np.int64) << 8) | actor).astype(np.int32)


def random_state(rng, n, k, a):
    """A state whose slots hold ops of their own actor (reg[..., s] has
    actor bits s), some killed, with values and counters."""
    shape = (n, k + 1, a)
    reg = np.where(rng.random(shape) < 0.5,
                   _packed(rng.integers(1, 30, shape), np.arange(a) & 255),
                   0).astype(np.int32)
    killed = rng.random(shape) < 0.2
    value = rng.integers(-50, 1000, shape).astype(np.int32)
    counter = np.where(reg != 0, rng.integers(-20, 20, shape),
                       0).astype(np.int32)
    inexact = rng.random(n) < 0.1
    return [reg, killed, value, counter, inexact]


def random_batch(rng, state, lanes, d_preds, kinds=(0.1, 0.5, 0.2, 0.2),
                 actor_hi=None, zero_lanes=0.35):
    """[N, P] ops: keys in [0, K), actors in [0, actor_hi or A), preds
    naming the standing op of a random slot of the same key, a random
    earlier op of the doc, or a random id, each pred lane unused with
    probability `zero_lanes`."""
    reg = state[0]
    n, k1, a = reg.shape
    shape = (n, lanes)
    kind = rng.choice(4, size=shape, p=kinds).astype(np.int32)
    key = rng.integers(0, max(k1 - 1, 1), shape).astype(np.int32)
    hi = actor_hi or a
    packed = _packed(rng.integers(1, 40, shape), rng.integers(0, hi, shape))
    value = rng.integers(-50, 1000, shape).astype(np.int32)
    pshape = (n, lanes, d_preds)
    docs = np.arange(n)[:, None, None]
    standing = reg[docs, key[:, :, None], rng.integers(0, a, pshape)]
    back = np.arange(lanes)[None, :, None] - \
        rng.integers(1, 4, pshape)
    earlier = np.where(back >= 0, packed[docs, np.maximum(back, 0)], 0)
    other = _packed(rng.integers(1, 40, pshape), rng.integers(0, hi, pshape))
    src = rng.integers(0, 3, pshape)
    preds = np.where(src == 0, standing, np.where(src == 1, earlier, other))
    preds = np.where(rng.random(pshape) < zero_lanes, 0,
                     preds).astype(np.int32)
    overflow = np.zeros(shape, dtype=bool)
    return RegisterOpBatch(kind, key, packed, value, preds, overflow)


def case(name, rng, n_docs, n_keys, n_slots, lanes, d_preds):
    """(state arrays, batch) of one named corner; see the module
    docstring."""
    if name not in CASES:
        raise ValueError(f'unknown register case {name!r}')
    a = n_slots
    state = random_state(rng, n_docs, n_keys, a)
    kinds = {'neg_inc': (0.1, 0.3, 0.3, 0.3), 'wrap': (0.1, 0.2, 0.1, 0.6),
             'dead_max_inc': (0.1, 0.2, 0.1, 0.6),
             'self_conflict': (0.05, 0.85, 0.05, 0.05),
             'chain': (0.0, 1.0, 0.0, 0.0)}.get(name, (0.1, 0.5, 0.2, 0.2))
    actor_hi = min(a + 3, 256) if name == 'slots_oob' else None
    batch = random_batch(rng, state, lanes, d_preds, kinds, actor_hi,
                         zero_lanes=0.7 if name == 'self_conflict' else 0.35)
    kind, key, packed, value, preds, overflow = batch.columns()
    if name == 'dup_preds' and d_preds > 1:
        preds[..., 1::2] = preds[..., 0::2][..., :preds[..., 1::2].shape[-1]]
    elif name == 'dead_max_inc' and lanes and d_preds > 1:
        # slot 0 live with a low id, slot a-1 holding a higher id, killed
        # in even docs and empty in odd ones; the first lane incs both
        docs, k0 = np.arange(n_docs), key[:, 0]
        lo, hi = _packed(3, 0), _packed(35, a - 1)
        for arr in state[:4]:
            arr[docs, k0] = 0
        state[0][docs, k0, 0] = lo
        if a > 1:
            state[0][docs, k0, a - 1] = np.where(docs % 2, 0, hi)
            state[1][docs, k0, a - 1] = True
        kind[:, 0] = INC
        preds[:, 0, :] = 0
        preds[:, 0, 0], preds[:, 0, 1] = lo, hi
    elif name == 'wrap':
        big = np.iinfo(np.int32)
        state[3][...] = np.where(state[0] != 0,
                                 rng.choice([big.max - 5, big.min + 5],
                                            state[3].shape), 0)
        value[...] = np.where(kind == INC,
                              rng.choice([big.max, big.min, 7, -7],
                                         kind.shape), value)
    elif name == 'neg_inc':
        value[...] = np.where(kind == INC, -1, value)
    elif name == 'self_conflict':
        preds[...] = np.where(rng.random(preds.shape) < 0.5, 0, preds)
    elif name == 'overflow':
        overflow[...] = rng.random(overflow.shape) < 0.1
    elif name == 'chain' and lanes:
        # per doc on one key: set; overwrite it; delete it; set again by
        # another actor with no pred (a concurrent op: a conflict)
        k0 = key[:, 0].copy()
        steps = [(SET, 1, 0, []), (SET, 2, 0, [0]), (DEL, 3, 0, [1]),
                 (SET, 4, (1 % a), [])]
        for i, (kd, ctr, actor, pred_of) in enumerate(steps[:lanes]):
            kind[:, i] = kd
            key[:, i] = k0
            packed[:, i] = _packed(ctr, actor)
            preds[:, i, :] = 0
            for j, src in enumerate(pred_of[:d_preds]):
                preds[:, i, j] = packed[:, src]
    elif name == 'neg_preds':
        neg = rng.random(preds.shape) < 0.3
        preds[...] = np.where(neg, preds | np.int32(-(1 << 31)), preds)
    elif name == 'one_key':
        key[...] = key[:, :1]
    elif name == 'hot_key':
        key[...] = np.where(rng.random(key.shape) < 0.5, key[:, :1], key)
    elif name == 'key_range':
        bad = (rng.random(key.shape) < 0.2) & (kind != PAD)
        key[...] = np.where(bad, rng.choice([-1, n_keys + 1, 1 << 20],
                                            key.shape), key)
    return state, batch


def both(state, batch, device, plain_device=None):
    """The case through the routed `register_scan` (the kernel on a CUDA
    device) on `device` and through `register_scan_plain` on
    `plain_device` (default: the same device), each on its own copy of
    the state. Returns {'differ': [array names], 'applied': (kernel's,
    plain's), 'max_abs_err': int}."""
    plain_device = plain_device or device
    got = register_state_from_numpy(*state, device=device)
    want = register_state_from_numpy(*state, device=plain_device)
    n_got = int(register_scan(got, batch.to(device)))
    n_want = int(register_scan_plain(want, batch.to(plain_device)))
    differ, err = [], abs(n_got - n_want)
    for name, x, y in zip(_NAMES, register_state_to_numpy(got),
                          register_state_to_numpy(want)):
        d = int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max(
            initial=0))
        if d:
            differ.append(name)
        err = max(err, d)
    return {'differ': differ, 'applied': (n_got, n_want), 'max_abs_err': err}


def to_device(state, batch, device):
    """The case's state and batch as torch objects on `device`."""
    return register_state_from_numpy(*state, device=device), \
        batch.to(device)



CHAIN_ACTORS = ('aa' * 16, 'bb' * 16)
NEW_ACTORS = ('00' * 16, 'cc' * 16)     # '00…' sorts before the chain's


def _change(actor, seq, start, deps, ops):
    return encode_change({'actor': actor, 'seq': seq, 'startOp': start,
                          'time': 0, 'message': '', 'deps': sorted(deps),
                          'ops': ops})


def _op(action, key, pred, value=None, datatype=None):
    op = {'action': action, 'obj': '_root', 'key': key, 'pred': list(pred)}
    if value is not None:
        op['value'] = value
    if datatype is not None:
        op['datatype'] = datatype
    return op


def exact_seam_changes(n_changes, n_keys, seed=0):
    """[chain, second, third]: one document's three batches of change
    bytes for the exact seam.

    - chain: `n_changes` single-set changes by two alternating actors on
      random keys of `n_keys`, each set pred'ing the key's standing op,
      as the frontend writes it;
    - second: two concurrent changes (both on the chain's head) by two
      new actors, one of which sorts before the chain's actors, so the
      batch renumbers every actor lane. One sets a key of the chain and
      the other deletes it, both pred'ing its standing op (the set
      survives: resurrection); each sets 'conf' with no pred (a
      conflict); the first sets the counter 'ctr' to 10;
    - third: one change that increments 'ctr' by 5."""
    rng = np.random.default_rng(seed)
    chain, heads, seqs, standing = [], [], [0, 0], {}
    for c in range(n_changes):
        a = c % 2
        seqs[a] += 1
        key = f'k{int(rng.integers(0, n_keys))}'
        buf = _change(CHAIN_ACTORS[a], seqs[a], c + 1, heads, [_op(
            'set', key, [standing[key]] if key in standing else [],
            int(rng.integers(1, 1 << 20)), 'int')])
        standing[key] = f'{c + 1}@{CHAIN_ACTORS[a]}'
        heads = [decode_change_meta(buf, True)['hash']]
        chain.append(buf)
    start = n_changes + 1
    key = next(iter(standing))
    first, other = NEW_ACTORS
    x = _change(first, 1, start, heads, [
        _op('set', key, [standing[key]], 7, 'int'),
        _op('set', 'conf', [], 1, 'int'),
        _op('set', 'ctr', [], 10, 'counter')])
    y = _change(other, 1, start, heads, [
        _op('del', key, [standing[key]]),
        _op('set', 'conf', [], 2, 'int')])
    both = [decode_change_meta(b, True)['hash'] for b in (x, y)]
    z = _change(other, 2, start + 3, both, [
        _op('inc', 'ctr', [f'{start + 2}@{first}'], 5)])
    return [chain, [x, y], [z]]
