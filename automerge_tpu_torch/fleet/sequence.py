"""Batched RGA sequence engine: list/text CRDTs as device tensors.

The torch port of automerge_tpu/fleet/sequence.py. The state of one size
class is a SeqState of torch tensors on one device; the fleet's dispatch
paths update it IN PLACE (the counterpart of the JAX package's donated
buffers). The per-doc scan is `seq_kernel.seq_scan` (a hand-written CUDA
kernel on the card, its plain torch version on the CPU); visibility,
linearize and materialize are torch ops on the state's device. The
entry points are wrapped for the kernel cost ledger under the
reference's kind names (observability/perf.py `instrument_kernel`);
materialize calls the unwrapped visibility and linearize, as the
reference's jitted materialize does.

The reference's description follows.

This is the tensorized equivalent of the reference's list-insertion path
(ref backend/new.js:50-192 seekWithinBlock, :145-163 concurrent-insert skip;
host mirror: automerge_tpu_torch/backend/op_set.py ObjState.insert_rga): a
fleet of N sequence documents (one Text or list object each) lives as
padded [N, S] slot tensors plus a linked-list `nxt` pointer array encoding
RGA order. Slots are allocated in op-arrival order and never move; an
insert splices pointers, so per-op work is a referent lookup + an O(skip)
pointer walk, with NO data movement of the sequence itself — the analogue
of the reference editing a block in place instead of reshuffling the
array.

Ops within one doc apply in causal order (as the reference's per-change op
loop does), while the fleet axis is embarrassingly parallel. Extraction
back to sequence order (`linearize`) is pointer-doubling list ranking:
O(log S) rounds of gathers, fully parallel, replacing the reference's
visibleCount block walk (new.js:225-240).

Packed opIds: (counter << ACTOR_BITS) | actorNum, as in tensor_doc. For the
integer comparisons here to agree with the host engine's Lamport order
(counter, actorId-hex-string) — used both for the RGA concurrent-insert skip
and per-element LWW — actor numbers MUST be assigned in ascending
lexicographic order of the actor hex ids (the reference's columnar format
sorts its actor table the same way, ref backend/columnar.js:133-170).

Per-element overwrite state is an exact multi-value register (the
fleet/registers.py design applied to sequence elements): each element keeps
an actor-slotted visible set — packed opId + payload per actor lane, with a
`killed` bit marking ops that have a successor (ref new.js:1204-1217's
succNum == 0 visibility rule). A SET/DEL kills exactly its preds, never
concurrent ops, so the two shapes where single-winner LWW diverges from the
reference — concurrent set-vs-set (conflict sets) and set-vs-delete
(element resurrection, ref test/new_backend_test.js:1660) — are exact on
device, and counters inside sequences accumulate exactly in per-lane
counter registers with the reference's Lamport-max attribution
(new.js:942-945). The remaining host-only shapes (same-actor overwrites
that don't pred their own op, pred lists past SEQ_PRED_LANES) flag the row
`inexact` and route reads to the host mirror.
"""

import numpy as np
import torch

from ..observability.perf import instrument_kernel
from .seq_kernel import (ACTOR_MASK, DEL, END, HEAD, HEAD_REF, INC, INSERT,
                         PAD, SCRATCH, SET, SLOT0, seq_scan)
from .tensor_doc import pack_op_id

__all__ = ['PAD', 'INSERT', 'SET', 'DEL', 'INC', 'HEAD_REF', 'ACTOR_MASK',
           'HEAD', 'END', 'SCRATCH', 'SLOT0', 'SEQ_PRED_LANES',
           'DEFAULT_ACTOR_SLOTS', 'SeqState', 'SeqOpBatch', 'SeqEncoder',
           'SeqPools', 'grow_seq_state', 'apply_seq_batch',
           'apply_seq_batch_donated', 'element_visibility', 'linearize',
           'materialize', 'visible_text', 'element_conflicts',
           'seq_state_from_numpy', 'seq_state_to_numpy']

# Static pred-lane width: ops with more preds flag their row inexact. A pred
# list wider than the element's current conflict set cannot occur, so lanes
# bound the *representable* conflict width, matching registers.RegisterOpBatch.
SEQ_PRED_LANES = 4

# Default actor-lane width for new states; grows on demand (pow2) with the
# fleet's actor table.
DEFAULT_ACTOR_SLOTS = 4

_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool, torch.int32,
           torch.int32, torch.int32, torch.bool)
_NP_DTYPES = (np.int32, np.int32, np.int32, bool, np.int32, np.int32,
              np.int32, bool)


class SeqState:
    """The eight per-doc sequence tensors of one size class, on one device.

    Element identity / order (node-id indexed, [N, S+3]):
      elem_id  packed elemId per slot (0 = unallocated)
      nxt      linked-list next pointers over node ids

    Per-element multi-value registers ([N, S+3, A], actor-lane indexed by the
    op's packed actor number — at most one live op per actor per element in
    causally well-formed histories, since the frontend always preds its own
    visible op, ref frontend/context.js:576-586):
      reg      packed opId of actor lane a's op on this element (0 = none)
      killed   that op has a successor (overwritten / deleted)
      val      the op's payload (char code / value-table ref)
      counter  accumulated inc deltas for the lane's op, bit-packed as
               (sum << 2) | count-bits, where the count bits are 0, 1,
               or 3 (3 = two or more incs consumed); display value =
               val + (counter >> 2), ref new.js:937-965

    Plus [N] allocation cursors `n` and [N] `inexact` flags (device state
    diverged from reference semantics — self conflicts, pred overflow,
    unknown referents — so reads must come from the host mirror).

    Node-id layout, front-anchored so every per-node array shares one shape
    [N, capacity + 3] and capacity can grow by appending at the tail
    without moving the sentinels: 0 HEAD (its nxt is the first element),
    1 END (masked pointer writes land here; its outgoing pointer is never
    followed), 2 slot-scratch, 3..S+2 real slots in op-arrival order."""

    __slots__ = ('elem_id', 'nxt', 'reg', 'killed', 'val', 'counter', 'n',
                 'inexact')

    def __init__(self, elem_id, nxt, reg, killed, val, counter, n, inexact):
        self.elem_id = elem_id
        self.nxt = nxt
        self.reg = reg
        self.killed = killed
        self.val = val
        self.counter = counter
        self.n = n              # slots allocated per doc
        self.inexact = inexact  # row needs the host mirror for reads

    @property
    def capacity(self):
        return self.elem_id.shape[1] - 3

    @property
    def actor_slots(self):
        return self.reg.shape[2]

    @classmethod
    def empty(cls, n_docs, capacity, actor_slots=DEFAULT_ACTOR_SLOTS,
              device='cpu'):
        nodes = (n_docs, capacity + 3)
        lanes = (n_docs, capacity + 3, actor_slots)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(zeros(nodes, torch.int32),
                   torch.full(nodes, END, dtype=torch.int32, device=device),
                   zeros(lanes, torch.int32), zeros(lanes, torch.bool),
                   zeros(lanes, torch.int32), zeros(lanes, torch.int32),
                   zeros((n_docs,), torch.int32),
                   zeros((n_docs,), torch.bool))

    def tensors(self):
        return (self.elem_id, self.nxt, self.reg, self.killed, self.val,
                self.counter, self.n, self.inexact)

    def nbytes(self):
        return sum(t.nelement() * t.element_size() for t in self.tensors())


def seq_state_from_numpy(elem_id, nxt, reg, killed, val, counter, n, inexact,
                         device):
    """A SeqState on `device` from host arrays — e.g. ``np.asarray`` of the
    JAX engine's state — so two engines can start from the same state."""
    return SeqState(*(torch.from_numpy(np.array(x, dtype=dt, copy=True))
                      .to(device)
                      for x, dt in zip((elem_id, nxt, reg, killed, val,
                                        counter, n, inexact), _NP_DTYPES)))


def seq_state_to_numpy(state):
    """The eight arrays of a SeqState as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in state.tensors())


def grow_seq_state(state, n_rows, capacity, actor_slots=None):
    """Resize to at least (n_rows rows, capacity slots, actor_slots lanes):
    new rows/slots/lanes are zeroed/END-filled; existing node ids and actor
    lanes never move (the sentinels are front-anchored precisely so
    capacity can grow by appending at the tail). Returns `state` unchanged
    if already big enough."""
    old_r, old_nodes = state.elem_id.shape
    old_cap = old_nodes - 3
    old_a = state.reg.shape[2]
    want_a = old_a if actor_slots is None else actor_slots
    if n_rows <= old_r and capacity <= old_cap and want_a <= old_a:
        return state
    r, cap = max(n_rows, old_r), max(capacity, old_cap)
    a = max(want_a, old_a)
    dev = state.elem_id.device

    def pad(arr, fill):
        out = torch.full((r, cap + 3), fill, dtype=arr.dtype, device=dev)
        out[:old_r, :old_nodes] = arr
        return out

    def pad_lane(arr):
        out = torch.zeros((r, cap + 3, a), dtype=arr.dtype, device=dev)
        out[:old_r, :old_nodes, :old_a] = arr
        return out

    def pad_vec(arr):
        out = torch.zeros((r,), dtype=arr.dtype, device=dev)
        out[:old_r] = arr
        return out

    return SeqState(
        pad(state.elem_id, 0), pad(state.nxt, END),
        pad_lane(state.reg), pad_lane(state.killed), pad_lane(state.val),
        pad_lane(state.counter), pad_vec(state.n), pad_vec(state.inexact))


class SeqOpBatch:
    """One batch of sequence ops, parallel columns [N, P].

    - kind   int32: PAD / INSERT / SET / DEL / INC
    - ref    int32: INSERT → packed elemId to insert after (0 = head);
                    SET/DEL/INC → packed elemId of the target element
    - packed int32: the op's own packed opId (INSERT: the new elemId)
    - value  int32: INSERT/SET payload; INC: the delta
    - preds  int32 [N, P, SEQ_PRED_LANES]: packed opIds this op supersedes
      (0 = unused lane, negative = pred naming an actor unknown to the
      fleet). The device kills exactly these lanes in the target element's
      register; concurrent ops survive (multi-value / resurrection
      semantics, ref new.js:1204-1217). An INC's Lamport-max pred is its
      attribution target (new.js:942-945).
    - flag   bool: host-detected inexactness for this row (pred-lane
      overflow, object elements in Text rows): applied unconditionally.

    Host ingest builds the columns as numpy arrays; `to(device)` turns
    them into contiguous torch tensors (int32, `flag` bool)."""

    __slots__ = ('kind', 'ref', 'packed', 'value', 'preds', 'flag')

    def __init__(self, kind, ref, packed, value, preds=None, flag=None):
        self.kind = kind
        self.ref = ref
        self.packed = packed
        self.value = value
        if preds is None:
            preds = np.zeros(tuple(kind.shape) + (SEQ_PRED_LANES,),
                             dtype=np.int32)
        self.preds = preds
        self.flag = np.zeros(tuple(kind.shape), dtype=bool) \
            if flag is None else flag

    def columns(self):
        return (self.kind, self.ref, self.packed, self.value, self.preds,
                self.flag)

    def to(self, device):
        return SeqOpBatch(*(_as_tensor(c, device, dt) for c, dt in
                            zip(self.columns(), (np.int32,) * 5 + (bool,))))


def _as_tensor(col, device, dtype):
    if not isinstance(col, torch.Tensor):
        col = torch.from_numpy(np.ascontiguousarray(col, dtype=dtype))
    return col.to(device).contiguous()


def _apply_seq_batch_donated(state, ops):
    """Apply one SeqOpBatch to `state` in place. Returns (state, applied),
    applied the number of applied ops (a 0-d int32 tensor)."""
    if not isinstance(ops.kind, torch.Tensor):
        ops = ops.to(state.elem_id.device)
    return state, seq_scan(state, ops)


def _apply_seq_batch(state, ops):
    """Apply one SeqOpBatch; the input state is not modified."""
    return _apply_seq_batch_donated(
        SeqState(*(t.clone() for t in state.tensors())), ops)


def _first_argmax(x):
    """Index of the first maximum along the last axis (jnp.argmax's
    tie rule)."""
    top = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == top, idx, x.shape[-1]).min(dim=-1).values


def _element_visibility(state):
    """Per-element visibility and Lamport winner from the registers:
    (vis [N, S+3] bool, winner [N, S+3] int32 packed, value [N, S+3],
    counter [N, S+3] — the winning lane's accumulated inc deltas)."""
    live = (state.reg != 0) & ~state.killed
    vis = live.any(dim=-1)
    w = _first_argmax(torch.where(live, state.reg, -1)).unsqueeze(-1)
    winner = torch.where(live, state.reg, 0).max(dim=-1).values
    value = torch.gather(state.val, -1, w)[..., 0]
    cnt = torch.gather(state.counter, -1, w)[..., 0]
    return vis, winner, value, cnt


def _linearize(state):
    """List-rank every node: returns (pos [N, S+3], length [N]).

    pos is node-indexed (sentinels at 0..2, real slots from SLOT0=3, in
    op-arrival order): pos[d, SLOT0 + k] is the 0-based sequence index of
    doc d's k-th allocated slot; sentinel and unallocated entries are
    garbage — mask with SLOT0 <= node < SLOT0 + n.
    Pointer doubling (Wyllie's list ranking): dist[i] = hops from node i to
    END, accumulated over ceil(log2(nodes)) rounds of jumps. Then
    pos = dist[HEAD] - dist - 1.
    """
    n_docs, nodes = state.nxt.shape
    dev = state.nxt.device
    dist = torch.ones((n_docs, nodes), dtype=torch.int32, device=dev)
    dist[:, END] = 0
    ptr = state.nxt.long()
    ptr[:, END] = END
    for _ in range(int(np.ceil(np.log2(nodes)))):
        dist, ptr = dist + torch.gather(dist, 1, ptr), torch.gather(ptr, 1,
                                                                    ptr)
    return dist[:, HEAD:HEAD + 1] - dist - 1, state.n


def _materialize(state):
    """Return (vals [N, S], cnts [N, S], vis [N, S], length [N]) in
    sequence order.

    vals/cnts/vis are scattered into order positions; entries at index >=
    length are zeros. Visible-only extraction (for text strings / patch
    indexes) is a host-side compress over the vis mask. Values are the
    per-element Lamport winners over the visible register set (conflict
    sets render their winner, like the reference's applyProperties rule,
    frontend/apply_patch.js:57-79); cnts carry the winning lane's
    accumulated counter deltas (display value = val + cnt for counter
    payloads)."""
    n_docs, nodes = state.elem_id.shape
    capacity = nodes - 3
    dev = state.elem_id.device
    pos, n = _linearize(state)
    e_vis, _winner, e_val, e_cnt = _element_visibility(state)
    node_ids = torch.arange(nodes, device=dev)
    alloc = (node_ids >= SLOT0) & (node_ids < SLOT0 + n.long().unsqueeze(1))
    # Scatter into sequence order; masked lanes land on a trailing
    # scratch column that the [:capacity] slice drops
    tgt = torch.where(alloc, pos.long().clamp(0, capacity), capacity)
    outs = []
    for x in (e_val, e_cnt, e_vis):
        out = torch.zeros((n_docs, capacity + 1), dtype=x.dtype, device=dev)
        out.scatter_(1, tgt, torch.where(alloc, x, torch.zeros_like(x)))
        outs.append(out[:, :capacity])
    return outs[0], outs[1], outs[2], n


apply_seq_batch = instrument_kernel('apply_seq_batch', _apply_seq_batch)
apply_seq_batch_donated = instrument_kernel('apply_seq_batch_donated',
                                            _apply_seq_batch_donated)
element_visibility = instrument_kernel('element_visibility',
                                       _element_visibility)
linearize = instrument_kernel('linearize', _linearize)
materialize = instrument_kernel('materialize', _materialize)


def visible_text(state):
    """Host helper: decode each doc's visible values as a Python string
    (values interpreted as Unicode code points)."""
    vals, _cnts, vis, _n = (t.cpu().numpy() for t in materialize(state))
    return [''.join(chr(int(c)) for c in vals[d][vis[d]])
            for d in range(vals.shape[0])]


def element_conflicts(state, row):
    """Host read of one doc's per-element conflict sets: {packed elemId:
    {packed opId: value}} for every element whose visible register holds
    more than one op (the raw-engine view of what
    fleet.backend._FlatEngine._device_patch_diffs serves as patch edits)."""
    reg, killed, val, elem = (t[row].cpu().numpy() for t in
                              (state.reg, state.killed, state.val,
                               state.elem_id))
    live = (reg != 0) & ~killed
    out = {}
    for node in np.flatnonzero(live.sum(axis=-1) > 1):
        lanes = np.flatnonzero(live[node])
        out[int(elem[node])] = {int(reg[node, s]): int(val[node, s])
                                for s in lanes}
    return out


class SeqEncoder:
    """Host-side helper turning 'ctr@actor' string ops into SeqOpBatch
    columns for one fleet. Actor numbers are assigned by ascending hex order
    over a fixed, pre-registered actor set (required for packed-opId
    comparisons to match host Lamport order). SET/DEL ops default their
    pred to the target elemId (the element's insert op) when none is given —
    the common shape for linear edit traces."""

    def __init__(self, actors):
        self.actor_num = {a: i for i, a in enumerate(sorted(actors))}

    def pack(self, op_id):
        if op_id in ('_head', None):
            return HEAD_REF
        ctr_s, _, actor = op_id.partition('@')
        return pack_op_id(int(ctr_s), self.actor_num[actor])

    def batch(self, per_doc_ops, pad_to=None):
        """per_doc_ops: list (per doc) of op dicts
        {kind: 'insert'|'set'|'del'|'inc', ref/target: opId str, id: opId
         str, value: int, pred: [opId str, ...]}. Returns a SeqOpBatch of
        numpy columns [N, P]."""
        n_docs = len(per_doc_ops)
        width = max((len(ops) for ops in per_doc_ops), default=0)
        if pad_to is not None:
            width = max(width, pad_to)
        kind = np.zeros((n_docs, width), dtype=np.int32)
        ref = np.zeros((n_docs, width), dtype=np.int32)
        packed = np.zeros((n_docs, width), dtype=np.int32)
        value = np.zeros((n_docs, width), dtype=np.int32)
        preds = np.zeros((n_docs, width, SEQ_PRED_LANES), dtype=np.int32)
        flag = np.zeros((n_docs, width), dtype=bool)
        kinds = {'insert': INSERT, 'set': SET, 'del': DEL, 'inc': INC}
        for d, ops in enumerate(per_doc_ops):
            for i, op in enumerate(ops):
                kind[d, i] = kinds[op['kind']]
                target = op.get('ref') or op.get('target')
                ref[d, i] = self.pack(target)
                packed[d, i] = self.pack(op['id'])
                value[d, i] = op.get('value', 0)
                pred_ids = op.get('pred')
                if pred_ids is None and op['kind'] in ('set', 'del'):
                    pred_ids = [target]
                pred_ids = pred_ids or []
                if len(pred_ids) > SEQ_PRED_LANES:
                    flag[d, i] = True
                    pred_ids = pred_ids[:SEQ_PRED_LANES]
                for lane, p in enumerate(pred_ids):
                    preds[d, i, lane] = self.pack(p)
                if op.get('flag'):
                    flag[d, i] = True
        return SeqOpBatch(kind, ref, packed, value, preds, flag)


class SeqPools:
    """Size-class pools of sequence rows, on one device.

    A single SeqState is rectangular: one 10k-element document would force
    every row in the fleet to 10k slots × A actor lanes — the long-document
    analogue of padding a whole batch to its longest member. Pools bucket
    rows by pow2 capacity class (class c holds rows of capacity
    `base << c`), so memory follows each document's own length; a row that
    outgrows its class migrates up by a prefix copy (front-anchored
    sentinels make the tail padding inert, see the node layout above).
    The per-flush cost is one apply dispatch per ACTIVE class instead of
    one total — bounded by log2(longest/base).

    Addressing: callers hold (cls, idx) placements; this object owns the
    per-class SeqStates, free lists, and growth/migration. It is
    host-side bookkeeping over indexed torch updates on `device`."""

    def __init__(self, base_capacity=64, device='cpu'):
        self.base = base_capacity
        self.device = torch.device(device)
        self.pools = {}     # cls -> SeqState
        self.free = {}      # cls -> [idx, ...]
        self.used = {}      # cls -> high-water row count
        self.grow_events = 0   # state regrowths (reserve() keeps this at
                               # ~1 per class per dispatch, not per row)

    def cls_for(self, capacity):
        c = 0
        while (self.base << c) < capacity:
            c += 1
        return c

    def cls_for_many(self, capacities):
        """cls_for of every entry of a non-empty int array, in one search
        over the class capacities."""
        top = self.cls_for(int(capacities.max()))
        return np.searchsorted(self.base << np.arange(top + 1), capacities)

    def capacity(self, cls):
        return self.base << cls

    def state(self, cls):
        return self.pools.get(cls)

    def _ensure(self, cls, n_rows, actor_slots):
        pow2 = 1
        while pow2 < n_rows:
            pow2 *= 2
        st = self.pools.get(cls)
        if st is None:
            self.pools[cls] = SeqState.empty(
                pow2, self.capacity(cls), actor_slots=actor_slots,
                device=self.device)
            self.grow_events += 1
        else:
            grown = grow_seq_state(st, pow2, self.capacity(cls),
                                   actor_slots)
            if grown is not st:
                self.grow_events += 1
            self.pools[cls] = grown
        return self.pools[cls]

    def ensure_lanes(self, actor_slots):
        """Grow every pool's actor-lane axis (before a lane permutation)."""
        for cls in list(self.pools):
            grown = grow_seq_state(self.pools[cls], 0, 0, actor_slots)
            if grown is not self.pools[cls]:
                self.grow_events += 1
            self.pools[cls] = grown

    def alloc(self, cls, actor_slots):
        free = self.free.setdefault(cls, [])
        if free:
            # a pool built under a narrower actor table must still widen
            # its lane axis before the recycled row is written
            self._ensure(cls, self.used.get(cls, 1), actor_slots)
            return free.pop()
        idx = self.used.get(cls, 0)
        self.used[cls] = idx + 1
        self._ensure(cls, idx + 1, actor_slots)
        return idx

    def reserve(self, cls, count, actor_slots):
        """Pre-size a pool for `count` upcoming alloc() calls in one
        growth: growing inside each alloc would re-pad the whole pool's
        arrays per pow2 step (~log2(rows) growths of 8 arrays each for a
        batch of fresh rows). Reservation is capacity-only; alloc() still
        does the bookkeeping, it just finds the pool already big enough."""
        fresh = count - len(self.free.get(cls, ()))
        if fresh > 0:
            self._ensure(cls, self.used.get(cls, 0) + fresh, actor_slots)

    def release(self, cls, idx):
        """Zero a row and return it to its class's free list."""
        self.release_rows({cls: [idx]})

    def release_rows(self, by_cls):
        """Zero rows and return them to their free lists; one batched
        indexed update per array of each touched class ({cls: [idx, ...]}),
        in place."""
        for cls, idxs in by_cls.items():
            st = self.pools.get(cls)
            live = [i for i in idxs if st is not None and
                    i < st.elem_id.shape[0]]
            if live:
                i = torch.as_tensor(live, dtype=torch.long,
                                    device=st.elem_id.device)
                for t in st.tensors():
                    t[i] = 0
                st.nxt[i] = END
            self.free.setdefault(cls, []).extend(idxs)

    def copy_row(self, src, dst):
        """Copy row (cls, idx) -> (cls2, idx2); dst class must be >= src
        (prefix copy; END-filled tail stays inert)."""
        self.copy_rows(src[0], [src[1]], dst[0], [dst[1]])

    def copy_rows(self, src_cls, src_idxs, dst_cls, dst_idxs):
        """Batched row copies between two classes (dst capacity >= src);
        one indexed gather/scatter per array, in place."""
        width = max(self.pools[src_cls].reg.shape[2],
                    self.pools[dst_cls].reg.shape[2])
        if self.pools[src_cls].reg.shape[2] != \
                self.pools[dst_cls].reg.shape[2]:
            self.ensure_lanes(width)
        s = self.pools[src_cls]
        d = self.pools[dst_cls]
        nodes = s.elem_id.shape[1]
        dev = s.elem_id.device
        si = torch.as_tensor(src_idxs, dtype=torch.long, device=dev)
        di = torch.as_tensor(dst_idxs, dtype=torch.long, device=dev)
        for dt, st in zip(d.tensors()[:6], s.tensors()[:6]):
            dt[di, :nodes] = st[si]
        d.n[di] = s.n[si]
        d.inexact[di] = s.inexact[si]

    def migrate(self, cls, idx, new_cls, actor_slots):
        """Move a row to a bigger class; returns its new idx."""
        new_idx = self.alloc(new_cls, actor_slots)
        self.copy_row((cls, idx), (new_cls, new_idx))
        self.release(cls, idx)
        return new_idx
