"""The fleet engine on torch: batched CRDT computation over document
fleets, with the LWW merge, the multi-value register scan, the RGA
sequence scan and the sync plane's Bloom and hash-index kernels as
hand-written CUDA kernels.

The port carries the LWW grid, the exact-device register engine
(`DocFleet(exact_device=True)`, over `registers`), the Text/list
sequence engine (`sequence`, in both device modes), the turbo apply seam
(`backend.apply_changes_docs`), the batched sync
plane (`sync_driver`, over `bloom` and `hashindex`, with the mixed
live/parked rounds), the bulk loader (`load_docs`: saved documents
straight to device state), durability (`durability.DurableFleet`:
journal, checkpoints, crash recovery) and the storage tier
(`storage.StorageEngine` over `segment`'s arenas, `tiering`'s cost
model and controller), and the multi-device path: `sharding`'s
`FleetMesh`, sharded values and steps (one kernel launch per block),
`DocFleet(mesh=...)` (one launch per docs block of a dispatch) and
`exchange`'s cross-shard sync transport (a transpose on one device,
`torch.distributed.all_to_all_single` across processes).
"""

from .tensor_doc import (FleetState, OpBatch, TOMBSTONE, pack_op_id,
                         state_from_numpy, state_to_numpy, unpack_op_id)
from .apply import apply_op_batch, fleet_merge
from .registers import (RegisterOpBatch, RegisterState, apply_register_batch,
                        register_state_from_numpy, register_state_to_numpy)
from .sequence import (SeqEncoder, SeqOpBatch, SeqState, apply_seq_batch,
                       linearize, materialize, visible_text)
from .bloom import build_bloom_filters, probe_bloom_filters, bloom_filter_bytes
from .sync_driver import (generate_sync_messages_docs,
                          receive_sync_messages_docs)
from .loader import load_docs
from .hashindex import (HashIndex, FleetFrontierIndex, frontier_compare,
                        hashes_to_rows)

__all__ = [
    'load_docs',
    'HashIndex', 'FleetFrontierIndex', 'frontier_compare', 'hashes_to_rows',
    'FleetState', 'OpBatch', 'TOMBSTONE', 'pack_op_id', 'unpack_op_id',
    'state_from_numpy', 'state_to_numpy',
    'apply_op_batch', 'fleet_merge',
    'RegisterState', 'RegisterOpBatch', 'apply_register_batch',
    'register_state_from_numpy', 'register_state_to_numpy',
    'SeqState', 'SeqOpBatch', 'SeqEncoder', 'apply_seq_batch', 'linearize',
    'materialize',
    'visible_text',
    'build_bloom_filters', 'probe_bloom_filters', 'bloom_filter_bytes',
    'generate_sync_messages_docs', 'receive_sync_messages_docs',
]
