"""Batched change application: the whole fleet's merge in one dispatch.

The torch counterpart of automerge_tpu/fleet/apply.py. All documents'
ops land as padded [N, P] columns and per-key LWW resolution is one
merge over the [N, K+1] key grids (merge_kernel.lww_merge: the
hand-written CUDA kernel on the card, its plain torch version on the
CPU). The entry points keep the reference's names and contracts:

- `apply_op_batch(state, ops)` returns a NEW state (the input is left
  intact); the `_donated` forms update the input state's tensors IN
  PLACE and return it — the fleet's own dispatch paths use those, as
  the reference donates its buffers;
- `noinc`: set-only batches on a counter-free grid leave the counter
  grid untouched (the caller's soundness gate, DocFleet._counters_touched);
- `fresh`: the zero state is created inside the dispatch (the kernel
  fuses the zero-fill with the merge);
- `kills`: pred-scoped deletes. The pre-pass (clear a standing winner
  iff it holds the pred'd packed id; mask every same-batch set lane a
  kill names, by per-doc sorted membership) is torch ops, as it is XLA
  code in the reference; the merge after it is the kernel;
- `zero_doc_rows_donated` zeroes the listed doc rows of all three grids;
- `fleet_merge(state, batches)` runs `apply_op_batch` over a sequence of
  OpBatches and sums their counts (a Python int).

Every other entry point returns (state, stats) with stats the number of
valid op lanes (a 0-d int32 tensor).

Each entry point is wrapped for the kernel cost ledger under the
reference's kind name (observability/perf.py `instrument_kernel`); the
entry points that build on another call its unwrapped body, so one call
counts one dispatch, as one jitted call does in the reference.
"""

import torch

from ..observability.perf import instrument_kernel
from .merge_kernel import lww_merge
from .tensor_doc import FleetState


def _clone(state):
    return FleetState(*(t.clone() for t in state.tensors()))


def _empty(n_docs, n_keys, device):
    # the fresh kernel writes every cell of every row, so no zero-fill
    shape = (n_docs, n_keys + 1)
    return FleetState(*(torch.empty(shape, dtype=torch.int32, device=device)
                        for _ in range(3)))


def _apply_op_batch_donated(state, ops):
    """Apply one OpBatch to the fleet in place. Returns (state, stats)."""
    return state, lww_merge(state, ops)


def _apply_op_batch(state, ops):
    """Apply one OpBatch; the input state is not modified."""
    return _apply_op_batch_donated(_clone(state), ops)


def _apply_op_batch_noinc_donated(state, ops):
    """Set-only batches (no inc lanes — the caller checks host-side) on a
    counter-free grid: the counter grid passes through untouched. Only
    byte-identical to the general merge while the counter grid is
    all-zero (see automerge_tpu/fleet/apply.py for the gate)."""
    return state, lww_merge(state, ops, noinc=True)


def _apply_op_batch_noinc_fresh(ops, n_docs, n_keys):
    state = _empty(n_docs, n_keys, ops.key_id.device)
    return state, lww_merge(state, ops, noinc=True, fresh=True)


def _apply_op_batch_fresh(ops, n_docs, n_keys):
    """First dispatch of a FRESH fleet: the zero state is created inside
    the merge (one pass over the grid instead of a memset + a merge)."""
    state = _empty(n_docs, n_keys, ops.key_id.device)
    return state, lww_merge(state, ops, fresh=True)


def _kill_lane_mask(ops, kill_packed):
    """Same-batch kills: True for every set lane whose packed id some
    kill lane of its doc names (per-doc sorted membership, O(N x (P+Q)))."""
    if kill_packed.shape[1] == 0:
        return torch.zeros_like(ops.is_set)
    int32_max = torch.iinfo(torch.int32).max
    kill_sorted, _ = torch.sort(
        torch.where(kill_packed > 0, kill_packed, int32_max), dim=1)
    pos = torch.searchsorted(kill_sorted, ops.packed)
    pos = pos.clamp_(0, kill_sorted.shape[1] - 1)
    return (torch.gather(kill_sorted, 1, pos) == ops.packed) & \
        (ops.packed > 0)


def mask_killed_sets(ops, kill_packed):
    return type(ops)(ops.key_id, ops.packed, ops.value,
                     ops.is_set & ~_kill_lane_mask(ops, kill_packed),
                     ops.is_inc, ops.valid)


def clear_killed(state, kill_key, kill_packed):
    """Clear (in place) every cell whose standing winner holds exactly
    the packed id a kill lane names."""
    if kill_key.shape[1] == 0:
        return
    k1 = state.winners.shape[1]
    scratch = k1 - 1
    kvalid = kill_packed > 0
    kkey = torch.where(kvalid, kill_key, scratch).long()
    standing = torch.gather(state.winners, 1, kkey)
    hit = kvalid & (standing == kill_packed)
    killed = torch.zeros(state.winners.shape, dtype=torch.int32,
                         device=state.winners.device)
    killed.scatter_reduce_(1, torch.where(hit, kkey, scratch),
                           hit.to(torch.int32), 'amax')
    killed = killed.bool()
    for t in state.tensors():
        t.masked_fill_(killed, 0)


def _apply_op_batch_kills_donated(state, ops, kill_key, kill_packed):
    """One OpBatch plus delete kill lanes [N, Q] (pred-scoped deletes,
    ref new.js:1204-1217), in place."""
    kill_key, kill_packed = _lanes(kill_key, state), _lanes(kill_packed, state)
    clear_killed(state, kill_key, kill_packed)
    return state, lww_merge(state, mask_killed_sets(ops, kill_packed))


def _apply_op_batch_kills(state, ops, kill_key, kill_packed):
    return _apply_op_batch_kills_donated(_clone(state), ops, kill_key,
                                         kill_packed)


def _apply_op_batch_kills_fresh(ops, kill_key, kill_packed, n_docs,
                                n_keys):
    """Kills-aware fresh dispatch: kills against an all-zero grid cannot
    hit, but the lane masking of same-batch sets still runs."""
    state = _empty(n_docs, n_keys, ops.key_id.device)
    kill_packed = _lanes(kill_packed, state)
    return state, lww_merge(state, mask_killed_sets(ops, kill_packed),
                            fresh=True)


def _lanes(kill, state):
    return torch.as_tensor(kill).to(device=state.winners.device,
                                    dtype=torch.int32)


def _zero_doc_rows_donated(state, idx):
    """Zero the given docs' rows across every grid, in place (duplicate
    indices are fine: zeroing is idempotent)."""
    idx = torch.as_tensor(idx).to(device=state.winners.device,
                                  dtype=torch.long)
    for t in state.tensors():
        t.index_fill_(0, idx, 0)
    return state


apply_op_batch = instrument_kernel('apply_op_batch', _apply_op_batch)
apply_op_batch_donated = instrument_kernel('apply_op_batch_donated',
                                           _apply_op_batch_donated)
apply_op_batch_noinc_donated = instrument_kernel(
    'apply_op_batch_noinc_donated', _apply_op_batch_noinc_donated)
apply_op_batch_noinc_fresh = instrument_kernel(
    'apply_op_batch_noinc_fresh', _apply_op_batch_noinc_fresh)
apply_op_batch_fresh = instrument_kernel('apply_op_batch_fresh',
                                         _apply_op_batch_fresh)
apply_op_batch_kills = instrument_kernel('apply_op_batch_kills',
                                         _apply_op_batch_kills)
apply_op_batch_kills_donated = instrument_kernel(
    'apply_op_batch_kills_donated', _apply_op_batch_kills_donated)
apply_op_batch_kills_fresh = instrument_kernel(
    'apply_op_batch_kills_fresh', _apply_op_batch_kills_fresh)
zero_doc_rows_donated = instrument_kernel('zero_doc_rows_donated',
                                          _zero_doc_rows_donated)


def fleet_merge(state, op_batches):
    """Apply a sequence of OpBatches (e.g. one per change round)."""
    total = 0
    for ops in op_batches:
        state, stats = apply_op_batch(state, ops)
        total += int(stats)
    return state, total
