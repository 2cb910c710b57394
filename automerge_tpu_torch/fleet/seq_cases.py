"""Seeded inputs for holding the sequence scan (fleet/seq_kernel.py) to its
plain version and to the JAX package's, shared by the CPU tests
(tests/test_torch_sequence.py), the card tests (tests/test_torch_cuda.py)
and chip_smoke.py.

- `case(name, rng, n_docs, capacity, n_slots, lanes)`: a state (the eight
  SeqState arrays as numpy, built by applying a random warm-up batch to
  empty rows with the plain version, so it keeps the kernel's input
  contract) and a SeqOpBatch of numpy columns [n_docs, lanes] at one
  corner of the scan:
  'random' (mixed kinds whose refs and preds name the row's elements and
  lane ops, earlier ops of the batch, the head or nothing), 'typing'
  (inserts after the previous insert, deletes pred'ing their element),
  'concurrent_head' (head and same-referent inserts that share a counter
  across actors, so the skip walk runs), 'dup_preds' (every pred lane
  repeated), 'dead_max_inc' (incs whose Lamport-max pred is killed or
  absent beside a live lower one), 'lanes_oob' (actors and pred slots past
  the lane width, negative preds), 'wrap' (counter lanes next to the
  envelope and the int32 limits, incs of +/-2^31-1), 'unknown_ref' (refs
  that name no element, ref == 0 on sets, deletes and incs),
  'self_conflict' (sets that do not pred their actor's standing op, some
  reclaiming an inc'd lane), 'flags' (host flags, on PAD lanes too),
  'capacity' (a row one slot below capacity and rows at capacity: the
  cursor clamp), 'cyclic' (a cycle of nodes whose ids exceed every insert:
  the hop backstop), 'kinds' (unknown op kinds); and the corners of the
  kernel's parallel resolution: 'later_ref' (ops naming an id that an
  insert at a later column of the batch brings: a miss), 'dup_ids'
  (inserts whose id an allocated element or an earlier insert already
  holds: the lowest node wins), 'hot_node' (an insert and up to 31 sets,
  deletes and incs of its element inside one 32-column chunk) and
  'serial' (an insert that fails mid-row, then inserts and ops naming
  the shifted slots: the kernel's serial route).
- GLOBAL_CAPACITY: a class whose rows do not fit a CTA's shared memory
  (the kernel's 'global' route).
- `both(state, batch, device, plain_device, route)`: the case through the
  kernel on a CUDA device (along `route`, or the wrapper's own plan) or
  `seq_scan` on the CPU, and through `seq_scan_plain`, each on its own
  copy; returns the names of the arrays that differ, the two applied
  counts, the largest difference, the route and the rows that took the
  serial route.
- `TextTrace(seed)` / `text_changes(n_ops, more, seed)`: the text seam's
  editing trace (BASELINE config 2: one makeText, ~80 % inserts, ~20 % deletes, 3
  actors taking turns on one causal chain, 32 ops per change) as change
  bytes, plus the incremental batches that continue it.
"""

import numpy as np
import torch

from ..columnar import decode_change_meta, encode_change
from . import seq_kernel
from .seq_kernel import (DEL, END, INC, INSERT, PAD, SET, SLOT0,
                         seq_scan, seq_scan_plain)
from .sequence import (SEQ_PRED_LANES, SeqOpBatch, SeqState,
                       seq_state_from_numpy, seq_state_to_numpy)

CASES = ('random', 'typing', 'concurrent_head', 'dup_preds', 'dead_max_inc',
         'lanes_oob', 'wrap', 'unknown_ref', 'self_conflict', 'flags',
         'capacity', 'cyclic', 'kinds', 'later_ref', 'dup_ids', 'hot_node',
         'serial')
GLOBAL_CAPACITY = 65536
NAMES = ('elem_id', 'nxt', 'reg', 'killed', 'val', 'counter', 'n',
         'inexact')
_KINDS = {'random': (0.1, 0.45, 0.15, 0.15, 0.15),
          'typing': (0.0, 0.8, 0.0, 0.2, 0.0),
          'concurrent_head': (0.0, 0.9, 0.05, 0.05, 0.0),
          'dead_max_inc': (0.05, 0.3, 0.1, 0.1, 0.45),
          'wrap': (0.05, 0.3, 0.1, 0.05, 0.5),
          'self_conflict': (0.05, 0.3, 0.5, 0.05, 0.1),
          'capacity': (0.0, 0.9, 0.05, 0.05, 0.0),
          'later_ref': (0.05, 0.5, 0.15, 0.15, 0.15),
          'dup_ids': (0.05, 0.6, 0.1, 0.1, 0.15),
          'serial': (0.0, 0.7, 0.1, 0.1, 0.1)}


def _packed(ctr, actor):
    return int(np.int32(np.int64(ctr) << 8 | actor))


def empty_arrays(n_docs, capacity, n_slots):
    return list(seq_state_to_numpy(SeqState.empty(n_docs, capacity,
                                                  n_slots)))


class _Doc:
    """One row's host view while a batch is generated: its elements in
    allocation order and the ops standing in each element's lanes."""

    def __init__(self, arrays, d):
        elem_id, _nxt, reg, killed = arrays[:4]
        n = int(arrays[6][d])
        self.elems = [int(e) for e in elem_id[d, SLOT0:SLOT0 + n]]
        self.lanes = {}
        for k, e in enumerate(self.elems):
            row = reg[d, SLOT0 + k]
            self.lanes[e] = [int(x) for x in row[(row != 0) &
                                                 ~killed[d, SLOT0 + k]]]
        ids = np.concatenate([elem_id[d].ravel(), reg[d].ravel()])
        self.ctr = int((ids[ids > 0] >> 8).max(initial=1)) + 1
        self.last = None


def random_batch(rng, arrays, lanes, kinds=(0.1, 0.45, 0.15, 0.15, 0.15),
                 actor_hi=None):
    """[N, P] ops against the rows of `arrays`: kinds drawn with the
    probabilities (PAD, INSERT, SET, DEL, INC); inserts after the head,
    the row's previous insert or a random element; sets, deletes and incs
    on a random element, pred'ing up to D of its standing lane ops (or
    its own id); actors in [0, actor_hi or A); each op's counter one past
    the last, or equal to it (a concurrent op) one time in five."""
    n_docs, _nodes, a = arrays[2].shape
    hi = actor_hi or a
    d_lanes = SEQ_PRED_LANES
    kind = np.zeros((n_docs, lanes), np.int32)
    ref = np.zeros((n_docs, lanes), np.int32)
    packed = np.zeros((n_docs, lanes), np.int32)
    value = np.zeros((n_docs, lanes), np.int32)
    preds = np.zeros((n_docs, lanes, d_lanes), np.int32)
    for d in range(n_docs):
        doc = _Doc(arrays, d)
        for i in range(lanes):
            kd = int(rng.choice(5, p=kinds))
            if kd == PAD:
                continue
            if rng.random() >= 0.2:
                doc.ctr += 1
            pk = _packed(doc.ctr, int(rng.integers(0, hi)))
            kind[d, i], packed[d, i] = kd, pk
            if kd == INSERT:
                roll = rng.random()
                if roll < 0.15 or not doc.elems:
                    ref[d, i] = 0
                elif roll < 0.6 and doc.last is not None:
                    ref[d, i] = doc.last
                else:
                    ref[d, i] = doc.elems[int(rng.integers(0,
                                                           len(doc.elems)))]
                value[d, i] = int(rng.integers(32, 127))
                doc.elems.append(pk)
                doc.lanes[pk] = [pk]
                doc.last = pk
                continue
            if not doc.elems:
                kind[d, i] = PAD
                continue
            target = doc.elems[int(rng.integers(0, len(doc.elems)))]
            ref[d, i] = target
            cand = doc.lanes.get(target, []) + [target]
            m = int(rng.integers(0, d_lanes + 1))
            for j in range(m):
                preds[d, i, j] = cand[int(rng.integers(0, len(cand)))]
            if kd == INC:
                value[d, i] = int(rng.integers(-5, 10))
            else:
                value[d, i] = int(rng.integers(32, 127))
                live = [x for x in doc.lanes.get(target, [])
                        if x not in set(preds[d, i].tolist())]
                doc.lanes[target] = live + ([pk] if kd == SET else [])
    return SeqOpBatch(kind, ref, packed, value, preds,
                      np.zeros((n_docs, lanes), bool))


def warm_arrays(rng, n_docs, capacity, n_slots, ops):
    """Empty rows after one random batch of `ops` ops per row (applied
    with the plain version on the CPU), as the eight numpy arrays."""
    arrays = empty_arrays(n_docs, capacity, n_slots)
    if ops:
        batch = random_batch(rng, arrays, ops, (0.0, 0.6, 0.15, 0.1, 0.15))
        st = seq_state_from_numpy(*arrays, device='cpu')
        seq_scan_plain(st, batch.to('cpu'))
        arrays = list(seq_state_to_numpy(st))
    return arrays


def case(name, rng, n_docs, capacity, n_slots, lanes):
    """(state arrays, batch) of one named corner; see the module
    docstring."""
    if name not in CASES:
        raise ValueError(f'unknown sequence case {name!r}')
    a = n_slots
    warm = 0 if name == 'cyclic' else min(capacity // 3, 24)
    arrays = warm_arrays(rng, n_docs, capacity, a, warm)
    if name == 'capacity':
        # row 0 one slot below capacity, the others at it
        fill = random_batch(rng, arrays, capacity, (0.0, 1.0, 0, 0, 0))
        st = seq_state_from_numpy(*arrays, device='cpu')
        seq_scan_plain(st, fill.to('cpu'))
        arrays = list(seq_state_to_numpy(st))
        if arrays[6][0] == capacity:
            last = SLOT0 + capacity - 1
            _unlink(arrays, 0, last)
    if name == 'cyclic':
        # two allocated slots pointing at each other, ids above any insert
        for d in range(n_docs):
            arrays[1][d, 0] = SLOT0
            arrays[1][d, SLOT0] = SLOT0 + 1
            arrays[1][d, SLOT0 + 1] = SLOT0
            arrays[0][d, SLOT0] = 2**30
            arrays[0][d, SLOT0 + 1] = 2**30 + 1
            arrays[6][d] = 2
    if name == 'wrap':
        big = np.iinfo(np.int32)
        live = arrays[2] != 0
        arrays[5][...] = np.where(
            live, rng.choice([big.max - 5, big.min + 6, (1 << 31) - 4,
                              ((1 << 29) - 3) << 2 | 1,
                              -((1 << 29) - 2) << 2 | 3], arrays[5].shape),
            arrays[5]).astype(np.int32)
    kinds = _KINDS.get(name, (0.1, 0.45, 0.15, 0.15, 0.15))
    actor_hi = min(a + 3, 256) if name == 'lanes_oob' else None
    batch = random_batch(rng, arrays, lanes, kinds, actor_hi)
    kind, ref, packed, value, preds, flag = batch.columns()
    live = kind != PAD
    if name == 'dup_preds':
        preds[..., 1::2] = preds[..., 0::2][..., :preds[..., 1::2].shape[-1]]
    elif name == 'dead_max_inc' and lanes:
        # the first op incs an element whose highest pred'd op is killed
        # (or names a lane nobody holds) beside a live lower one
        for d in range(n_docs):
            if arrays[6][d] == 0:
                continue
            e = int(arrays[0][d, SLOT0])
            kind[d, 0], ref[d, 0], value[d, 0] = INC, e, 3
            preds[d, 0] = 0
            preds[d, 0, 0] = e
            preds[d, 0, 1] = _packed((e >> 8) + 1000 + d % 2, a - 1)
    elif name == 'lanes_oob':
        neg = (rng.random(preds.shape) < 0.1) & live[..., None]
        preds[...] = np.where(neg, -1, preds)
    elif name == 'wrap':
        big = np.iinfo(np.int32)
        value[...] = np.where(kind == INC,
                              rng.choice([big.max, big.min, 1 << 28,
                                          -(1 << 28), 7], kind.shape),
                              value)
    elif name == 'unknown_ref':
        miss = (rng.random(kind.shape) < 0.3) & live
        ref[...] = np.where(miss, rng.choice([1 << 20, 12345, -1, 0],
                                             kind.shape), ref)
    elif name == 'self_conflict':
        preds[...] = np.where(rng.random(preds.shape) < 0.6, 0, preds)
    elif name == 'flags':
        flag[...] = rng.random(flag.shape) < 0.1
    elif name == 'cyclic' and lanes:
        kind[:, 0], ref[:, 0] = INSERT, 0
        packed[:, 0] = _packed(1, 0)
    elif name == 'kinds':
        odd = (rng.random(kind.shape) < 0.15)
        kind[...] = np.where(odd, rng.choice([5, 7, -1, -3], kind.shape),
                             kind)
    elif name == 'later_ref':
        _later_refs(rng, kind, ref, packed)
    elif name == 'dup_ids':
        _dup_ids(rng, arrays, kind, ref, packed)
    elif name == 'hot_node':
        _hot_node(rng, arrays, kind, ref, packed, value, preds)
    elif name == 'serial':
        _failing_insert(rng, kind, ref, packed)
    return arrays, batch


def _later_refs(rng, kind, ref, packed):
    """Point a quarter of the live ops at the id an insert at a later
    column brings (sets, deletes and incs only on even rows, whose
    inserts all still resolve; inserts too on odd rows)."""
    for d in range(kind.shape[0]):
        ins = np.flatnonzero(kind[d] == INSERT)
        for i in np.flatnonzero(kind[d] != PAD):
            later = ins[ins > i]
            if not len(later) or rng.random() >= 0.25 or \
                    (d % 2 == 0 and kind[d, i] == INSERT):
                continue
            ref[d, i] = packed[d, int(rng.choice(later))]


def _dup_ids(rng, arrays, kind, ref, packed):
    """Give a fifth of the inserts an id an allocated element or an
    earlier insert of the row already holds; later ops that named the
    insert's own id name the shared one, which resolves to its lowest
    node."""
    elem_id, n = arrays[0], arrays[6]
    for d in range(kind.shape[0]):
        held = [int(e) for e in elem_id[d, SLOT0:SLOT0 + n[d]] if e]
        for i in np.flatnonzero(kind[d] == INSERT):
            earlier = [int(x) for x in packed[d, :i][kind[d, :i] == INSERT]]
            pool = held + earlier
            if pool and rng.random() < 0.2:
                own = packed[d, i]
                packed[d, i] = pool[int(rng.integers(0, len(pool)))]
                later = ref[d, i + 1:]
                later[later == own] = packed[d, i]


def _hot_node(rng, arrays, kind, ref, packed, value, preds):
    """The row's last 32 columns (or all, if fewer): an insert, then
    sets, deletes and incs of its element, each pred'ing ops standing in
    its lanes (or its own id)."""
    n_docs, lanes = kind.shape
    a = arrays[2].shape[2]
    if not lanes:
        return
    c0 = max(0, lanes - 32)
    ctr = int(max(packed.max(initial=0), arrays[0].max(initial=0),
                  arrays[2].max(initial=0)) >> 8) + 2
    for d in range(n_docs):
        elems = [int(e) for e in arrays[0][d, SLOT0:SLOT0 + arrays[6][d]]
                 if e] + [int(x) for x in packed[d, :c0][kind[d, :c0] ==
                                                        INSERT]]
        x = _packed(ctr, int(rng.integers(0, a)))
        kind[d, c0], packed[d, c0] = INSERT, x
        ref[d, c0] = elems[int(rng.integers(0, len(elems)))] \
            if elems and rng.random() < 0.7 else 0
        value[d, c0], preds[d, c0] = 65, 0
        standing, c = [x], ctr
        for i in range(c0 + 1, lanes):
            if rng.random() >= 0.2:
                c += 1
            kd = int(rng.choice([SET, DEL, INC], p=[0.45, 0.2, 0.35]))
            pk = _packed(c, int(rng.integers(0, a)))
            kind[d, i], ref[d, i], packed[d, i] = kd, x, pk
            value[d, i] = int(rng.integers(-3, 9)) if kd == INC else \
                int(rng.integers(32, 127))
            preds[d, i] = 0
            cand = standing + [x]
            for j in range(int(rng.integers(0, preds.shape[2] + 1))):
                preds[d, i, j] = cand[int(rng.integers(0, len(cand)))]
            named = set(preds[d, i].tolist())
            if kd != INC:
                standing = [s for s in standing if s not in named] + \
                    ([pk] if kd == SET else [])


def _failing_insert(rng, kind, ref, packed):
    """An insert a third of the way into each row names an id nobody
    holds, so it fails and every later insert lands one slot lower than
    the parallel resolution assumes; on odd rows a second one fails at a
    random column."""
    n_docs, lanes = kind.shape
    if not lanes:
        return
    for d in range(n_docs):
        cols = [lanes // 3] + ([int(rng.integers(0, lanes))] if d % 2 else [])
        for i in cols:
            kind[d, i] = INSERT
            ref[d, i] = _packed(1 << 22, 1)
            packed[d, i] = _packed((1 << 22) + 1 + i, 0)


def _unlink(arrays, d, node):
    """Drop the last allocated slot `node` of row `d` (splice it out of the
    chain, zero its cells, step the cursor back): the row keeps the input
    contract one slot below capacity."""
    nxt = arrays[1][d]
    prev = int(np.flatnonzero(nxt == node)[0])
    nxt[prev] = nxt[node]
    nxt[node] = END
    arrays[0][d, node] = 0
    for k in (2, 3, 4, 5):
        arrays[k][d, node] = 0
    arrays[6][d] -= 1


def plan_along(route, state, ops):
    """The wrapper's launch plan for `state` and `ops`, with `route`
    ('resident' or 'global') forced where given."""
    r, nodes = state.elem_id.shape
    p, d = ops.preds.shape[1:]
    plan = seq_kernel._launch_plan(r, nodes, state.reg.shape[2], p, d)
    if route is None or route == plan.route:
        return plan
    resident = route == 'resident'
    smem = (seq_kernel.row_bytes(nodes) if resident else 0) + \
        seq_kernel.STAGE_BYTES
    return plan._replace(route=route, smem_bytes=smem,
                         ctas_per_sm=seq_kernel._ctas_per_sm(smem))


def both(state, batch, device, plain_device=None, route=None):
    """The case on `device` (a CUDA device: the kernel, along `route` or
    the wrapper's own plan; the CPU: `seq_scan`) and through
    `seq_scan_plain` on `plain_device` (default: the same device), each
    on its own copy of the state. Returns {'differ': [array names],
    'applied': (kernel's, plain's), 'max_abs_err': int, 'route': the
    kernel's route or None, 'serial_rows': rows on the serial route or
    None}."""
    plain_device = plain_device or device
    got = seq_state_from_numpy(*state, device=device)
    want = seq_state_from_numpy(*state, device=plain_device)
    ops = batch.to(device)
    took, serial = None, None
    if torch.device(device).type == 'cuda':
        plan = plan_along(route, got, ops)
        stats = seq_kernel._launch(got, ops, plan)
        n_got, serial, took = int(stats[0]), int(stats[1]), plan.route
    else:
        n_got = int(seq_scan(got, ops))
    n_want = int(seq_scan_plain(want, batch.to(plain_device)))
    differ, err = [], abs(n_got - n_want)
    for name, x, y in zip(NAMES, seq_state_to_numpy(got),
                          seq_state_to_numpy(want)):
        dd = int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max(
            initial=0))
        if dd:
            differ.append(name)
        err = max(err, dd)
    return {'differ': differ, 'applied': (n_got, n_want), 'max_abs_err': err,
            'route': took, 'serial_rows': serial}


# ---- the text seam's editing trace -----------------------------------------

TEXT_ACTORS = ('aa' * 16, 'bb' * 16, 'cc' * 16)
OPS_PER_CHANGE = 32


def _change(actor, seq, start, deps, ops):
    return encode_change({'actor': actor, 'seq': seq, 'startOp': start,
                          'time': 0, 'message': '', 'deps': list(deps),
                          'ops': ops})


class TextTrace:
    """BASELINE config 2's editing trace, generated from a seed: one
    makeText at `_root.t`, then ops by 3 actors taking turns, one change of
    OPS_PER_CHANGE ops each, on one causal chain. An op is a delete of a
    random alive character (pred'ing it) one time in five, else an insert
    of a letter, after the previous insert half the time and otherwise
    after a random alive character (the head while none is alive).
    `more(n_ops)` continues the same chain."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.heads, self.seqs, self.turn = [], {a: 0 for a in TEXT_ACTORS}, 0
        self.max_op = 0
        self.alive, self.last = [], None
        self.obj = None
        self.n_ops = 0

    def _emit(self, ops):
        actor = TEXT_ACTORS[self.turn % len(TEXT_ACTORS)]
        self.turn += 1
        self.seqs[actor] += 1
        buf = _change(actor, self.seqs[actor], self.max_op + 1, self.heads,
                      ops)
        start = self.max_op + 1
        self.max_op += len(ops)
        self.heads = [decode_change_meta(buf, True)['hash']]
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
        """Change bytes carrying the next `n_ops` ops of the trace."""
        out = []
        while n_ops > 0:
            k = min(OPS_PER_CHANGE, n_ops)
            actor = TEXT_ACTORS[self.turn % len(TEXT_ACTORS)]
            ops = []
            for i in range(k):
                op_id = f'{self.max_op + 1 + i}@{actor}'
                rng = self.rng
                if self.alive and rng.random() < 0.2:
                    target = self.alive.pop(int(rng.integers(
                        0, len(self.alive))))
                    if target == self.last:
                        self.last = None
                    ops.append({'action': 'del', 'obj': self.obj,
                                'elemId': target, 'insert': False,
                                'pred': [target]})
                    continue
                if self.last is not None and rng.random() < 0.5:
                    after = self.last
                elif self.alive:
                    after = self.alive[int(rng.integers(0, len(self.alive)))]
                else:
                    after = '_head'
                ops.append({'action': 'set', 'obj': self.obj,
                            'elemId': after, 'insert': True,
                            'value': chr(97 + int(rng.integers(0, 26))),
                            'pred': []})
                self.alive.append(op_id)
                self.last = op_id
            buf, _actor, _start = self._emit(ops)
            out.append(buf)
            n_ops -= k
            self.n_ops += k
        return out


def text_changes(n_ops, more=(), seed=0):
    """[first, *rest]: the trace's first batch (the makeText change and
    changes carrying n_ops - 1 more ops: n_ops ops in all) and one batch of
    change bytes per entry of `more` (that many ops each), continuing the
    chain."""
    trace = TextTrace(seed)
    first = [trace.start()] + trace.more(n_ops - 1)
    return [first] + [trace.more(k) for k in more]
