"""automerge_tpu_torch: the PyTorch + CUDA port of automerge_tpu, a
CRDT framework with the capabilities of classic Automerge.

Public API (ref src/automerge.js): conflict-free replicated JSON documents —
maps, lists, text, tables, counters — edited concurrently by many actors and
merged deterministically, with a columnar binary change/document format and a
Bloom-filter peer sync protocol. The pluggable backend (`set_default_backend`)
is the seam where the batched fleet engine (automerge_tpu_torch.fleet) slots
in.

The default backend is the host OpSet (`automerge_tpu_torch.backend`), as
in the reference package. The card comes in through
`set_default_backend(automerge_tpu_torch.fleet.backend)` or
`set_default_backend(FleetBackend(DocFleet(...)))`: every `change`,
`merge`, `load` and sync then goes through the fleet's pending flush, whose
merge, register and sequence dispatches are the hand-written CUDA kernels.
`DocFleet()` with no device is on CUDA and raises without a card; pass
`DocFleet(device='cpu')` to run the fleet on the CPU.

The package also carries the query engine (`automerge_tpu_torch.query`:
time-travel reads and patch subscriptions), durability and the storage tier
(`automerge_tpu_torch.fleet`). The later items of ROADMAP.md Queue 1 are
still to come.
"""

from . import backend as _default_backend
from . import errors
from . import frontend as Frontend
from .columnar import encode_change, decode_change
from .errors import (
    AutomergeError, MalformedChange, MalformedDocument, MalformedSyncMessage,
    InvalidChange, DanglingPred, DuplicateOpId, SyncOverflow, DocError,
)
from .common import uuid, set_uuid_factory
from .frontend import (
    Text, Table, Counter, Observable, Int, Uint, Float64,
    get_object_id, get_object_by_id, get_actor_id, set_actor_id,
    get_conflicts, get_last_local_change,
)
from .frontend.views import MapView, ListView

_backend = _default_backend  # mutable: overridden with set_default_backend()


def Backend():
    return _backend


def init(options=None):
    """Create a new, empty document (ref src/automerge.js:14-23)."""
    if isinstance(options, str):
        options = {'actorId': options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f'Unsupported options for init(): {options}')
    merged = {'backend': _backend}
    merged.update(options)
    return Frontend.init(merged)


def from_(initial_state, options=None):
    """Create a document initialized with `initial_state`
    (ref src/automerge.js:28-31). Non-mapping initial states follow the
    reference's JS object-spread semantics: sequences and strings become
    index-keyed maps, scalars contribute nothing (ref test/test.js:39-55)."""
    initial_state = Frontend.normalize_initial_state(initial_state)
    return change(init(options), {'message': 'Initialization'},
                  lambda doc: doc.update(initial_state))


def change(doc, options=None, callback=None):
    """Mutate `doc` via a callback receiving a mutable proxy; returns the new
    document (ref src/automerge.js:33-36)."""
    new_doc, _req = Frontend.change(doc, options, callback)
    return new_doc


def empty_change(doc, options=None):
    new_doc, _req = Frontend.empty_change(doc, options)
    return new_doc


def _normalize_options(options):
    if isinstance(options, str):
        return {'actorId': options}
    return options or {}


def clone(doc, options=None):
    options = _normalize_options(options)
    state = _backend.clone(Frontend.get_backend_state(doc, 'clone'))
    return _apply_patch(init(options), _backend.get_patch(state), state, [],
                        options)


def free(doc):
    _backend.free(Frontend.get_backend_state(doc, 'free'))


def load(data, options=None):
    options = _normalize_options(options)
    state = _backend.load(data)
    return _apply_patch(init(options), _backend.get_patch(state), state, [data],
                        options)


def save(doc):
    return _backend.save(Frontend.get_backend_state(doc, 'save'))


def merge(local_doc, remote_doc):
    """Merge changes from `remote_doc` into `local_doc`
    (ref src/automerge.js:61-67)."""
    local_state = Frontend.get_backend_state(local_doc, 'merge')
    remote_state = Frontend.get_backend_state(remote_doc, 'merge', 'second')
    changes = _backend.get_changes_added(local_state, remote_state)
    new_doc, _patch = apply_changes(local_doc, changes)
    return new_doc


def get_changes(old_doc, new_doc):
    old_state = Frontend.get_backend_state(old_doc, 'getChanges')
    new_state = Frontend.get_backend_state(new_doc, 'getChanges', 'second')
    return _backend.get_changes(new_state, _backend.get_heads(old_state))


def get_all_changes(doc):
    return _backend.get_all_changes(Frontend.get_backend_state(doc, 'getAllChanges'))


def _apply_patch(doc, patch, backend_state, changes, options):
    new_doc = Frontend.apply_patch(doc, patch, backend_state)
    patch_callback = options.get('patchCallback') or \
        doc._options.get('patchCallback')
    if patch_callback:
        patch_callback(patch, doc, new_doc, False, changes)
    return new_doc


def apply_changes(doc, changes, options=None):
    old_state = Frontend.get_backend_state(doc, 'applyChanges')
    new_state, patch = _backend.apply_changes(old_state, changes)
    return [_apply_patch(doc, patch, new_state, changes, options or {}), patch]


def equals(val1, val2):
    """Deep structural equality ignoring metadata (ref src/automerge.js:94-103)."""
    if isinstance(val1, (MapView, dict)) and isinstance(val2, (MapView, dict)):
        keys1, keys2 = sorted(val1.keys()), sorted(val2.keys())
        if keys1 != keys2:
            return False
        return all(equals(val1[k], val2[k]) for k in keys1)
    if isinstance(val1, (ListView, list, tuple)) and \
            isinstance(val2, (ListView, list, tuple)):
        if len(val1) != len(val2):
            return False
        return all(equals(a, b) for a, b in zip(val1, val2))
    return val1 == val2


class _HistoryEntry:
    def __init__(self, history, index, actor):
        self._history = history
        self._index = index
        self._actor = actor

    @property
    def change(self):
        return decode_change(self._history[self._index])

    @property
    def snapshot(self):
        state = _backend.load_changes(_backend.init(),
                                      self._history[:self._index + 1])
        return Frontend.apply_patch(init(self._actor), _backend.get_patch(state),
                                    state)


def get_history(doc):
    """List of {change, snapshot} with lazy snapshot reconstruction
    (ref src/automerge.js:105-118)."""
    actor = Frontend.get_actor_id(doc)
    history = get_all_changes(doc)
    return [_HistoryEntry(history, i, actor) for i in range(len(history))]


def generate_sync_message(doc, sync_state):
    state = Frontend.get_backend_state(doc, 'generateSyncMessage')
    return _backend.generate_sync_message(state, sync_state)


def receive_sync_message(doc, old_sync_state, message):
    old_backend_state = Frontend.get_backend_state(doc, 'receiveSyncMessage')
    backend_state, sync_state, patch = _backend.receive_sync_message(
        old_backend_state, old_sync_state, message)
    if not patch:
        return [doc, sync_state, patch]
    changes = None
    if doc._options.get('patchCallback'):
        changes = _backend.decode_sync_message(message)['changes']
    return [_apply_patch(doc, patch, backend_state, changes, {}), sync_state, patch]


def init_sync_state():
    return _backend.init_sync_state()


def set_default_backend(new_backend):
    """Swap in a different backend implementation — the plug-in point for the
    fleet backend (ref src/automerge.js:147-149)."""
    global _backend
    _backend = new_backend
