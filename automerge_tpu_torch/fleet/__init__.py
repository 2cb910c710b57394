"""The fleet engine on torch: batched CRDT computation over document
fleets, with the LWW merge as a hand-written CUDA kernel.

This slice of the port carries the LWW grid and the turbo apply seam
(`backend.apply_changes_docs`); sequences, exact-device registers, the
sync plane, storage and multi-device sharding are later slices
(ROADMAP.md Queue 1).
"""

from .tensor_doc import (FleetState, OpBatch, TOMBSTONE, pack_op_id,
                         state_from_numpy, state_to_numpy, unpack_op_id)
from .apply import apply_op_batch

__all__ = [
    'FleetState', 'OpBatch', 'TOMBSTONE', 'pack_op_id', 'unpack_op_id',
    'state_from_numpy', 'state_to_numpy',
    'apply_op_batch',
]
