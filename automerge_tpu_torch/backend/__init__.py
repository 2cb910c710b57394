"""Backend API: the exact contract a replacement backend must satisfy
(ref backend/index.js:1-8, backend/backend.js).

A backend handle is a dict {'state': OpSet, 'heads': [...]} with
freeze-on-use semantics: every mutating call freezes the old handle and
returns a new one; using a stale handle raises (ref backend/util.js:1-10).
"""

from ..columnar import encode_change
from .op_set import OpSet


def _backend_state(backend):
    if backend.get('frozen'):
        raise ValueError(
            'Attempting to use an outdated Automerge document that has already been updated. '
            'Please use the latest document state, or call Automerge.clone() if you really '
            'need to use this old document state.')
    return backend['state']


def init():
    return {'state': OpSet(), 'heads': []}


def clone(backend):
    return {'state': _backend_state(backend).clone(), 'heads': backend['heads']}


def free(backend):
    backend['state'] = None
    backend['frozen'] = True


def apply_changes(backend, changes):
    state = _backend_state(backend)
    patch = state.apply_changes(changes)
    backend['frozen'] = True
    return [{'state': state, 'heads': state.heads}, patch]


def _hash_by_actor(state, actor_id, index):
    hashes = state.hashes_by_actor.get(actor_id)
    if hashes and index < len(hashes):
        return hashes[index]
    raise ValueError(f'Unknown change: actorId = {actor_id}, seq = {index + 1}')


def apply_local_change(backend, change):
    """Apply a change request from the local frontend
    (ref backend/backend.js:54-91)."""
    state = _backend_state(backend)
    clock_seq = state.clock.get(change['actor'])
    if clock_seq is not None and change['seq'] <= clock_seq:
        raise ValueError('Change request has already been applied')

    # The backend injects the local actor's previous change hash into deps,
    # because a frontend racing ahead of an async backend doesn't know the
    # hash of its own last change (rationale: backend/backend.js:59-72)
    if change['seq'] > 1:
        last_hash = _hash_by_actor(state, change['actor'], change['seq'] - 2)
        deps = {last_hash: True}
        for h in change.get('deps', []):
            deps[h] = True
        change = dict(change, deps=sorted(deps.keys()))

    binary_change = encode_change(change)
    patch = state.apply_changes([binary_change], is_local=True)
    backend['frozen'] = True

    # Omit the local actor's own last change hash from the patch's deps
    last_hash = _hash_by_actor(state, change['actor'], change['seq'] - 1)
    patch['deps'] = [head for head in patch['deps'] if head != last_hash]
    return [{'state': state, 'heads': state.heads}, patch, binary_change]


def save(backend):
    return _backend_state(backend).save()


def load(data):
    state = OpSet(data)
    return {'state': state, 'heads': state.heads}


def load_changes(backend, changes):
    state = _backend_state(backend)
    state.apply_changes(changes)
    backend['frozen'] = True
    return {'state': state, 'heads': state.heads}


def get_patch(backend):
    return _backend_state(backend).get_patch()


def get_heads(backend):
    return backend['heads']


def get_all_changes(backend):
    return get_changes(backend, [])


def get_changes(backend, have_deps):
    if not isinstance(have_deps, (list, tuple)):
        raise TypeError('Pass an array of hashes to Backend.getChanges()')
    return _backend_state(backend).get_changes(list(have_deps))


def get_change_hashes(backend, have_deps):
    """Hashes of get_changes(backend, have_deps) without decoding the
    change buffers (the fleet sync driver's Bloom feed)."""
    if not isinstance(have_deps, (list, tuple)):
        raise TypeError('Pass an array of hashes to Backend.getChanges()')
    return _backend_state(backend).get_change_hashes(list(have_deps))


def get_changes_added(backend1, backend2):
    return _backend_state(backend2).get_changes_added(_backend_state(backend1))


def get_change_by_hash(backend, hash):
    return _backend_state(backend).get_change_by_hash(hash)


def get_missing_deps(backend, heads=()):
    return _backend_state(backend).get_missing_deps(heads)


# Sync protocol re-exports (ref backend/index.js:5-7); imported last to avoid
# a circular import, since sync.py uses the backend API above
from .sync import (  # noqa: E402
    generate_sync_message, receive_sync_message, encode_sync_message,
    decode_sync_message, init_sync_state, encode_sync_state, decode_sync_state,
    BloomFilter,
)
