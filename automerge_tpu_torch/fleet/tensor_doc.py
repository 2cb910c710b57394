"""Padded device-tensor representation of a document fleet (torch).

A fleet of N map documents with a key universe of size K (dictionary-encoded
per fleet on the host) is:

- `winners`   [N, K+1] int32 — packed opId (counter << ACTOR_BITS | actorNum)
  of the LWW winner per key; 0 = key absent. Column K is a scratch slot that
  padded scatter lanes write into.
- `values`    [N, K+1] int32 — value-table index of the winner's value.
- `counters`  [N, K+1] int32 — accumulated increment total per key (counter
  CRDT semantics: inc ops add instead of overwriting; ref new.js:937-965).

Ops arrive as an OpBatch of parallel columns [N, P] (P = padded ops per doc),
mirroring the reference's columnar storage (ref backend/columnar.js:56-70)
so host decode feeds the device directly.

The packed-opId trick: Automerge op visibility means the LWW winner of a key
is simply the op with the greatest (counter, actorNum) among all set ops for
that key — an overwritten op always has a successor with a greater opId — so
per-key conflict resolution vectorizes to a scatter-max of packed opIds.
Deletion is a set with value TOMBSTONE (correct for causally-ordered deletes;
concurrent set-vs-delete resurrection routes through the host engine).
"""

import numpy as np
import torch

ACTOR_BITS = 8               # up to 256 distinct actors per fleet
MAX_ACTORS = 1 << ACTOR_BITS
# Packed counters occupy 23 bits (~8.4M) — a WINDOW, not a history cap: the
# LWW grid rebases each slot's window as counters grow (DocFleet.ctr_base /
# _rebase_slot), so history length is unbounded; only a slot's live-winner
# counter spread is window-bounded (beyond that, reads use the host mirror)
CTR_LIMIT = 1 << (31 - ACTOR_BITS)
TOMBSTONE = -1               # value-table index marking a deleted key


def resolve_device(device):
    """The torch device of the port's entry points: CUDA unless the
    caller asks otherwise. Without a device on a machine with no CUDA it
    raises: nothing carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available; pass '
                               'device="cpu" to run on the CPU')
        return torch.device('cuda')
    return torch.device(device)


def pack_op_id(counter, actor_num):
    """Pack (counter, actorNum) into one int32 preserving Lamport order."""
    if isinstance(counter, (int, np.integer)):
        if counter >= CTR_LIMIT:
            raise ValueError(f'op counter {counter} exceeds packing limit {CTR_LIMIT}')
        if actor_num >= MAX_ACTORS:
            raise ValueError(f'actor index {actor_num} exceeds {MAX_ACTORS}')
    return (counter << ACTOR_BITS) | actor_num


def unpack_op_id(packed):
    return packed >> ACTOR_BITS, packed & (MAX_ACTORS - 1)


class FleetState:
    """The fleet's three int32 grids, torch tensors on one device.

    The fleet's dispatch paths update them IN PLACE (the counterpart of
    the JAX package's donated buffers); external callers of the
    non-donating entry points get fresh tensors."""

    __slots__ = ('winners', 'values', 'counters')

    def __init__(self, winners, values, counters):
        self.winners = winners
        self.values = values
        self.counters = counters

    @classmethod
    def empty(cls, n_docs, n_keys, device):
        shape = (n_docs, n_keys + 1)
        return cls(*(torch.zeros(shape, dtype=torch.int32, device=device)
                     for _ in range(3)))

    def tensors(self):
        return (self.winners, self.values, self.counters)

    def nbytes(self):
        return sum(t.nelement() * t.element_size() for t in self.tensors())


class OpBatch:
    """One batch of ops for the whole fleet, as parallel columns [N, P].

    - key_id  int32: dictionary-encoded key (scratch column K for padding)
    - packed  int32: packed opId of the op
    - value   int32: value-table index (set ops) or increment delta (inc ops)
    - is_set  bool:  set/makeX/del op (participates in LWW)
    - is_inc  bool:  increment op (accumulates into counters)
    - valid   bool:  padding mask

    Host ingest builds the columns as numpy arrays; `to(device)` turns
    them into torch tensors at the dispatch boundary.
    """

    __slots__ = ('key_id', 'packed', 'value', 'is_set', 'is_inc', 'valid')

    def __init__(self, key_id, packed, value, is_set, is_inc, valid):
        self.key_id = key_id
        self.packed = packed
        self.value = value
        self.is_set = is_set
        self.is_inc = is_inc
        self.valid = valid

    def columns(self):
        return (self.key_id, self.packed, self.value, self.is_set,
                self.is_inc, self.valid)

    def to(self, device):
        """The batch as contiguous torch tensors on `device` (int32 id
        columns, bool masks)."""
        return OpBatch(*(_as_tensor(c, device) for c in self.columns()))


def _as_tensor(col, device):
    if not isinstance(col, torch.Tensor):
        col = torch.from_numpy(np.ascontiguousarray(col))
    return col.to(device).contiguous()


def docs_rows(obj, lo, hi):
    """Rows [lo, hi) of a state or op batch (FleetState, OpBatch,
    RegisterState, RegisterOpBatch, ...: every tensor's leading axis is
    the docs axis), as views of its tensors."""
    parts = obj.tensors() if hasattr(obj, 'tensors') else obj.columns()
    return type(obj)(*(t[lo:hi] for t in parts))


def per_docs_block(run, blocks, state, ops, *lanes):
    """run(state, ops, *lanes) -> (state, stats) once per docs block
    [lo, hi) of `blocks` on row views of its arguments (the runs update
    `state` in place); returns (state, the stats summed). A mesh fleet's
    dispatch: one kernel launch per block of the mesh's docs axis."""
    total = None
    for lo, hi in blocks:
        _, stats = run(docs_rows(state, lo, hi), docs_rows(ops, lo, hi),
                       *(lane[lo:hi] for lane in lanes))
        total = stats if total is None else total + stats
    return state, total


def state_from_numpy(winners, values, counters, device):
    """A FleetState on `device` from three [N, K+1] int32 host arrays —
    e.g. ``np.asarray`` of another fleet engine's grids — so two engines
    can start from the same non-empty grid."""
    return FleetState(*(torch.from_numpy(
        np.array(a, dtype=np.int32, copy=True)).to(device)
        for a in (winners, values, counters)))


def state_to_numpy(state):
    """(winners, values, counters) of a FleetState as int32 numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in state.tensors())
