"""Exact multi-value registers on the device: actor-slotted visible sets.

The torch port of automerge_tpu/fleet/registers.py. The scatter-max
engine (fleet/apply.py) materializes LWW winners only; the reference's
per-key state is richer — a *multi-value register* holding every op
with no successor (new.js:1204-1217), which is what conflict sets,
concurrent set-vs-delete resurrection, and per-op counter accumulation
are read from. This engine stores that state exactly, on the device:

    reg     [N, K+1, A] int32  packed opId of actor-slot a's live set op
    killed  [N, K+1, A] bool   that op has a successor (overwritten/deleted)
    value   [N, K+1, A] int32  the op's payload (inline int / table ref)
    counter [N, K+1, A] int32  per-op accumulated inc deltas (new.js:937-965)
    inexact [N]         bool   the doc needs the host engine

In causally well-formed histories each actor's newest set op on a key
supersedes that actor's previous one (the frontend always preds its own
visible op), so the visible set holds at most one op per actor and an
actor-indexed slot axis of width A represents it losslessly. Deletes
kill exactly their preds, and increments accumulate into the target
op's slot, so set-vs-delete resurrection and counter overwrite are
exact here. Histories outside that shape (an actor overwriting its own
key without pred'ing it, more than D preds, an actor or pred beyond the
slot width, an inc with no live target) raise the doc's `inexact` flag
instead of silently diverging; callers route flagged documents to the
host engine.

The ordered scan over each document's ops is
`register_kernel.register_scan` (a hand-written CUDA kernel on the
card, its plain torch version on the CPU). Row zeroing and the visible-set read are
torch ops on the state's device. The entry points are wrapped for the
kernel cost ledger under the reference's kind names
(observability/perf.py `instrument_kernel`).
"""

import numpy as np
import torch

from ..native import FLAG_INC
from ..observability.perf import instrument_kernel
from .register_kernel import ACTOR_MASK, DEL, INC, PAD, SET, register_scan
from .tensor_doc import per_docs_block


class RegisterState:
    """The five register tensors on one device. The fleet's dispatch
    paths update them IN PLACE (the counterpart of the JAX package's
    donated buffers)."""

    __slots__ = ('reg', 'killed', 'value', 'counter', 'inexact')

    def __init__(self, reg, killed, value, counter, inexact):
        self.reg = reg
        self.killed = killed
        self.value = value
        self.counter = counter
        self.inexact = inexact   # [N] bool: doc needs the host engine

    @classmethod
    def empty(cls, n_docs, n_keys, n_actor_slots, device):
        shape = (n_docs, n_keys + 1, n_actor_slots)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(zeros(shape, torch.int32), zeros(shape, torch.bool),
                   zeros(shape, torch.int32), zeros(shape, torch.int32),
                   zeros((n_docs,), torch.bool))

    def tensors(self):
        return (self.reg, self.killed, self.value, self.counter,
                self.inexact)

    def nbytes(self):
        return sum(t.nelement() * t.element_size() for t in self.tensors())


class RegisterOpBatch:
    """Sequenced op columns [N, P] + pred lists [N, P, D].

    kind: 0 pad, 1 set, 2 del, 3 inc. Ops apply in column order per doc.
    preds are packed opIds (0 = unused lane); an op with more than D preds
    must set `overflow` for its lane (flags the doc inexact). Host ingest
    builds the columns as numpy arrays; `to(device)` turns them into
    contiguous torch tensors (int32, `overflow` bool)."""

    __slots__ = ('kind', 'key_id', 'packed', 'value', 'preds', 'overflow')

    def __init__(self, kind, key_id, packed, value, preds, overflow):
        self.kind = kind
        self.key_id = key_id
        self.packed = packed
        self.value = value
        self.preds = preds
        self.overflow = overflow

    def columns(self):
        return (self.kind, self.key_id, self.packed, self.value, self.preds,
                self.overflow)

    def to(self, device):
        return RegisterOpBatch(*(_as_tensor(c, device)
                                 for c in self.columns()))


def _as_tensor(col, device):
    if not isinstance(col, torch.Tensor):
        col = torch.from_numpy(np.ascontiguousarray(col))
    return col.to(device).contiguous()


def _clone(state):
    return RegisterState(*(t.clone() for t in state.tensors()))


def _apply_register_batch_donated(state, ops, blocks=None):
    """Apply one RegisterOpBatch to `state` in place. Returns (state,
    applied) with applied the number of non-PAD op lanes (a 0-d int32
    tensor). With `blocks` (a mesh fleet's docs blocks, [(lo, hi), ...]),
    one scan per block on row views."""
    if blocks is not None:
        return per_docs_block(_apply_register_batch_donated, blocks, state,
                              ops)
    return state, register_scan(state, ops)


def _apply_register_batch(state, ops):
    """Apply one RegisterOpBatch; the input state is not modified."""
    return _apply_register_batch_donated(_clone(state), ops)


def _zero_register_rows_donated(state, idx):
    """Zero the given docs' rows across every register array, in place
    (idempotent under duplicate indices)."""
    idx = torch.as_tensor(idx, dtype=torch.int64).to(state.reg.device)
    for t in state.tensors():
        t[idx] = 0
    return state


def _visible_registers(state):
    """(visible [N, K+1, A] bool, winner_slot [N, K+1] int32,
    winner_packed [N, K+1] int32): the multi-value register contents and
    the Lamport winner per key (packed ids order like lamportCompare
    because actor numbers are hex-sorted). The winner slot is the first
    slot holding the row's maximum, as jnp.argmax picks it, and 0 for a
    row with no visible op."""
    visible = (state.reg != 0) & ~state.killed
    masked = torch.where(visible, state.reg, -1)
    top = masked.max(dim=-1, keepdim=True).values
    slots = torch.arange(masked.shape[-1], dtype=torch.int32,
                         device=masked.device)
    winner_slot = torch.where(masked == top, slots,
                              masked.shape[-1]).min(dim=-1).values
    winner_packed = torch.where(visible, state.reg, 0).max(dim=-1).values
    return visible, winner_slot.to(torch.int32), winner_packed


apply_register_batch = instrument_kernel('apply_register_batch',
                                         _apply_register_batch)
apply_register_batch_donated = instrument_kernel(
    'apply_register_batch_donated', _apply_register_batch_donated)
zero_register_rows_donated = instrument_kernel(
    'zero_register_rows_donated', _zero_register_rows_donated)
visible_registers = instrument_kernel('visible_registers',
                                      _visible_registers)


def register_state_from_numpy(reg, killed, value, counter, inexact,
                              device):
    """A RegisterState on `device` from host arrays — e.g. ``np.asarray``
    of another engine's register state — so two engines can start from
    the same non-empty state."""
    dtypes = (np.int32, bool, np.int32, np.int32, bool)
    return RegisterState(*(torch.from_numpy(
        np.array(a, dtype=dt, copy=True)).to(device)
        for a, dt in zip((reg, killed, value, counter, inexact), dtypes)))


def register_state_to_numpy(state):
    """(reg, killed, value, counter, inexact) of a RegisterState as numpy
    arrays (int32, bool, int32, int32, bool)."""
    return tuple(t.detach().cpu().numpy() for t in state.tensors())


def rows_to_register_batch(doc_ids, flags, key_ids, packed, values,
                           pred_off, pred, n_docs, d_preds=4,
                           force_overflow=None):
    """Lay flat native-ingest op rows (application order, doc-contiguous)
    into a RegisterOpBatch [n_docs, P] of numpy columns. Inputs are the
    arrays the native parser emits with with_meta=True — flags
    (native.FLAG_SET = set/del, FLAG_INC = inc; dels carry value -1),
    pred_off/pred per-row pred lists — already remapped to fleet
    key/actor numbering by the caller.
    Stable layout preserves each document's op order (the scan applies
    columns in order)."""
    doc_ids = np.asarray(doc_ids, dtype=np.int64)
    n_rows = len(doc_ids)
    counts = np.bincount(doc_ids, minlength=n_docs) if n_rows else \
        np.zeros(n_docs, dtype=np.int64)
    width = max(int(counts.max()) if n_rows else 0, 1)
    order = np.argsort(doc_ids, kind='stable')
    doc_sorted = doc_ids[order]
    pos = np.arange(n_rows) - np.searchsorted(doc_sorted, doc_sorted,
                                              side='left')
    kind = np.zeros((n_docs, width), dtype=np.int32)
    key_col = np.zeros((n_docs, width), dtype=np.int32)
    packed_col = np.zeros((n_docs, width), dtype=np.int32)
    value_col = np.zeros((n_docs, width), dtype=np.int32)
    preds_col = np.zeros((n_docs, width, d_preds), dtype=np.int32)
    overflow = np.zeros((n_docs, width), dtype=bool)

    flags = np.asarray(flags)
    values = np.asarray(values)
    kinds_flat = np.where(flags == FLAG_INC, INC,
                          np.where(values == -1, DEL, SET)).astype(np.int32)
    kind[doc_sorted, pos] = kinds_flat[order]
    key_col[doc_sorted, pos] = np.asarray(key_ids)[order]
    packed_col[doc_sorted, pos] = np.asarray(packed)[order]
    # -1 is the DEL sentinel only for set/del rows; an inc delta of -1 is a
    # legitimate negative increment and must pass through untouched
    value_col[doc_sorted, pos] = np.where(
        (values == -1) & (flags != FLAG_INC), 0, values)[order]

    pred_off = np.asarray(pred_off)
    pred = np.asarray(pred)
    pred_counts = np.diff(pred_off)
    oflow_flat = pred_counts > d_preds
    if force_overflow is not None:
        # Caller-detected per-row badness (e.g. a pred naming an actor the
        # fleet has never seen): route the doc to host replay via inexact
        oflow_flat = oflow_flat | np.asarray(force_overflow, dtype=bool)
    overflow[doc_sorted, pos] = oflow_flat[order]
    for d in range(d_preds):
        has = pred_counts > d
        lane = np.zeros(n_rows, dtype=np.int32)
        lane[has] = pred[pred_off[:-1][has] + d]
        preds_col[doc_sorted, pos, d] = lane[order]
    return RegisterOpBatch(kind, key_col, packed_col, value_col, preds_col,
                           overflow)


def materialize_registers(state, keys, value_table=None, n_docs=None):
    """Host-side read: per doc {key: (winner_value, conflict_dict)} where
    conflict_dict maps packed opId -> value for every visible op (empty for
    unanimous keys). Counter accumulators are added to their op's base.
    Only the first `n_docs` docs (all by default) and the interned keys'
    columns leave the device."""
    n_docs = state.reg.shape[0] if n_docs is None else n_docs
    part = RegisterState(*(t[:n_docs, :len(keys)]
                           for t in state.tensors()[:4]), state.inexact)
    visible, winner_slot, _winner_packed = (
        t.cpu().numpy() for t in visible_registers(part))
    reg, value, counter = (t.cpu().numpy()
                           for t in (part.reg, part.value, part.counter))

    def decode(v, c):
        out = value_table[-v - 2] if v <= -2 and value_table is not None else v
        if isinstance(out, TypedValue):
            return out.value + int(c) if out.datatype == 'counter' \
                else out.value
        if isinstance(out, int) and not isinstance(out, bool):
            out += int(c)
        return out

    docs = []
    for n in range(reg.shape[0]):
        doc = {}
        for k in np.flatnonzero(visible[n].any(axis=-1)):
            vis = np.flatnonzero(visible[n, k])
            w = winner_slot[n, k]
            winner_value = decode(int(value[n, k, w]), counter[n, k, w])
            conflicts = {int(reg[n, k, s]): decode(int(value[n, k, s]),
                                                   counter[n, k, s])
                         for s in vis} if len(vis) > 1 else {}
            doc[keys[k]] = (winner_value, conflicts)
        docs.append(doc)
    return docs


def typed_wire_tags():
    """Wire value-type tag -> datatype string for root-map set values that
    must box as TypedValue (uint/counter/timestamp ride int32 value lanes;
    the datatype survives only via the box). The single source of truth for
    every ingest path — native rows, turbo, and the mixed Python decode —
    so device-served patches emit identical datatype leaves regardless of
    which path a change took."""
    from ..columnar import VALUE_TYPE
    return {VALUE_TYPE['LEB128_UINT']: 'uint',
            VALUE_TYPE['COUNTER']: 'counter',
            VALUE_TYPE['TIMESTAMP']: 'timestamp'}


class TypedValue:
    """Boxed register value carrying its wire datatype (uint / timestamp /
    counter / float64 …) so device-served patches reproduce the host patch
    grammar exactly (datatype survives the int32 value lanes)."""

    __slots__ = ('value', 'datatype')

    def __init__(self, value, datatype):
        self.value = value
        self.datatype = datatype

    def __repr__(self):
        return f'TypedValue({self.value!r}, {self.datatype!r})'

    def __eq__(self, other):
        return isinstance(other, TypedValue) and \
            other.value == self.value and other.datatype == self.datatype

    def __hash__(self):
        return hash(('TypedValue', self.value, self.datatype))


def _patch_leaf(raw, counter_fold, value_table):
    """One visible register lane -> host-grammar patch value leaf."""
    boxed = value_table[-raw - 2] if raw <= -2 and value_table is not None \
        else raw
    if isinstance(boxed, TypedValue):
        value = boxed.value
        if boxed.datatype == 'counter':
            value += int(counter_fold)
        return {'type': 'value', 'value': value, 'datatype': boxed.datatype}
    if isinstance(boxed, bool) or boxed is None or isinstance(boxed, str):
        return {'type': 'value', 'value': boxed}
    if isinstance(boxed, float):
        return {'type': 'value', 'value': boxed, 'datatype': 'float64'}
    if isinstance(boxed, int):
        return {'type': 'value', 'value': boxed, 'datatype': 'int'}
    return None    # links / unsupported payloads: caller uses the mirror
