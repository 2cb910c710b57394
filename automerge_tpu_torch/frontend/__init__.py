"""Frontend: immutable document tree + mutation API (ref frontend/index.js).

Documents are RootView objects (read-only mappings) carrying hidden state:
`_options`, `_cache` (objectId -> immutable view), and `_state`
({seq, maxOp, requests, clock, deps, backendState, lastLocalChange}).
"""

import re
import time as _time

from ..common import uuid
from .apply_patch import interpret_patch, clone_root_object
from .proxies import root_object_proxy
from .context import Context
from .text import Text
from .table import Table
from .values import Counter, Int, Uint, Float64
from .observable import Observable
from .views import MapView, RootView, ListView, get_object_id

__all__ = [
    'init', 'from_', 'change', 'empty_change', 'apply_patch',
    'get_object_id', 'get_object_by_id', 'get_actor_id', 'set_actor_id',
    'get_conflicts', 'get_last_local_change', 'get_backend_state',
    'get_element_ids', 'Text', 'Table', 'Counter', 'Observable',
    'Float64', 'Int', 'Uint',
]


def _check_actor_id(actor_id):
    if not isinstance(actor_id, str):
        raise TypeError(f'Unsupported type of actorId: {type(actor_id)}')
    if not re.fullmatch(r'[0-9a-f]+', actor_id):
        raise ValueError('actorId must consist only of lowercase hex digits')
    if len(actor_id) % 2 != 0:
        raise ValueError('actorId must consist of an even number of digits')


def _update_root_object(doc, updated, state):
    """Swap updated objects into a fresh cache (ref frontend/index.js:34-68)."""
    new_doc = updated.get('_root')
    if new_doc is None:
        new_doc = clone_root_object(doc._cache['_root'])
        updated['_root'] = new_doc
    new_doc._options = doc._options
    new_doc._cache = updated
    new_doc._state = state
    for object_id, view in doc._cache.items():
        if object_id not in updated:
            updated[object_id] = view
    return new_doc


def _count_ops(ops):
    count = 0
    for op in ops:
        if op['action'] == 'set' and 'values' in op:
            count += len(op['values'])
        elif op['action'] == 'del' and op.get('multiOp'):
            count += op['multiOp']
        else:
            count += 1
    return count


def _make_change(doc, context, options):
    """(ref frontend/index.js:78-118)"""
    actor = get_actor_id(doc)
    if not actor:
        raise ValueError('Actor ID must be initialized with set_actor_id() '
                         'before making a change')
    state = dict(doc._state)
    state['seq'] += 1
    options = options or {}
    change = {
        'actor': actor,
        'seq': state['seq'],
        'startOp': state['maxOp'] + 1,
        'deps': state['deps'],
        'time': options['time'] if isinstance(options.get('time'), (int, float))
        else int(round(_time.time())),
        'message': options.get('message') if isinstance(options.get('message'), str)
        else '',
        'ops': context.ops if context else [],
    }

    backend = doc._options.get('backend')
    if backend:
        # Immediate mode: round-trip through the attached backend. The patch is
        # effectively applied twice (context echo + backend round-trip,
        # rationale: frontend/index.js:101-105)
        new_backend_state, patch, binary_change = backend.apply_local_change(
            state['backendState'], change)
        state['backendState'] = new_backend_state
        state['lastLocalChange'] = binary_change
        new_doc = _apply_patch_to_doc(doc, patch, state, True)
        patch_callback = options.get('patchCallback') or \
            doc._options.get('patchCallback')
        if patch_callback:
            patch_callback(patch, doc, new_doc, True, [binary_change])
        return [new_doc, change]
    else:
        # Async mode: queue the request for a separate backend
        queued = {'actor': actor, 'seq': change['seq'], 'before': doc}
        state['requests'] = state['requests'] + [queued]
        state['maxOp'] = state['maxOp'] + _count_ops(change['ops'])
        state['deps'] = []
        return [_update_root_object(doc, context.updated if context else {}, state),
                change]


def _apply_patch_to_doc(doc, patch, state, from_backend):
    """(ref frontend/index.js:146-162)"""
    actor = get_actor_id(doc)
    updated = {}
    interpret_patch(patch['diffs'], doc, updated)
    if from_backend:
        if 'clock' not in patch:
            raise ValueError('patch is missing clock field')
        if patch['clock'].get(actor, 0) > state['seq']:
            state['seq'] = patch['clock'][actor]
        state['clock'] = patch['clock']
        state['deps'] = patch['deps']
        state['maxOp'] = max(state['maxOp'], patch['maxOp'])
    return _update_root_object(doc, updated, state)


def init(options=None):
    """Create an empty document (ref frontend/index.js:166-202)."""
    if isinstance(options, str):
        options = {'actorId': options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f'Unsupported value for init() options: {options}')

    if not options.get('deferActorId'):
        if options.get('actorId') is None:
            options['actorId'] = uuid()
        _check_actor_id(options['actorId'])

    if options.get('observable'):
        patch_callback = options.get('patchCallback')
        observable = options['observable']

        def combined(patch, before, after, local, changes):
            if patch_callback:
                patch_callback(patch, before, after, local, changes)
            observable.patch_callback(patch, before, after, local, changes)
        options['patchCallback'] = combined

    root = RootView()
    cache = {'_root': root}
    state = {'seq': 0, 'maxOp': 0, 'requests': [], 'clock': {}, 'deps': []}
    if options.get('backend'):
        state['backendState'] = options['backend'].init()
        state['lastLocalChange'] = None
    root._options = options
    root._cache = cache
    root._state = state
    return root


def normalize_initial_state(initial_state):
    """Coerce a `from_` initial state to a mapping, per the reference's JS
    object-spread semantics (ref test/test.js:39-55): sequences and strings
    become index-keyed maps, scalars contribute nothing, and anything else
    non-mapping is rejected rather than silently dropped."""
    import datetime as _datetime
    from .values import Counter, Int, Uint, Float64
    if isinstance(initial_state, (list, tuple, str)):
        return {str(i): v for i, v in enumerate(initial_state)}
    if initial_state is None or isinstance(
            initial_state, (int, float, bool, _datetime.datetime,
                            Counter, Int, Uint, Float64)):
        return {}    # scalars have no enumerable properties to spread
    if not hasattr(initial_state, 'items'):
        raise TypeError('Unsupported initial state: '
                        f'{type(initial_state).__name__}')
    return initial_state


def from_(initial_state, options=None):
    return change(init(options), 'Initialization',
                  lambda doc: doc.update(
                      normalize_initial_state(initial_state)))[0]


def change(doc, options=None, callback=None):
    """Mutate the document via `callback`; returns [new_doc, change_request]
    (ref frontend/index.js:224-254)."""
    from .proxies import MapProxy
    if isinstance(doc, MapProxy):
        raise TypeError('Calls to change cannot be nested')
    if get_object_id(doc) != '_root':
        raise TypeError('The first argument to change must be the document root')
    if callable(options) and callback is None:
        options, callback = None, options
    if isinstance(options, str):
        options = {'message': options}
    if options is not None and not isinstance(options, dict):
        raise TypeError('Unsupported type of options')

    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError('Actor ID must be initialized with set_actor_id() '
                         'before making a change')
    context = Context(doc, actor_id)
    callback(root_object_proxy(context))

    if not context.updated:
        return [doc, None]
    return _make_change(doc, context, options)


def empty_change(doc, options=None):
    if get_object_id(doc) != '_root':
        raise TypeError('The first argument to empty_change must be the document root')
    if isinstance(options, str):
        options = {'message': options}
    if options is not None and not isinstance(options, dict):
        raise TypeError('Unsupported type of options')
    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError('Actor ID must be initialized with set_actor_id() '
                         'before making a change')
    return _make_change(doc, Context(doc, actor_id), options)


def apply_patch(doc, patch, backend_state=None):
    """Apply a backend patch, reconciling the async-mode request queue
    (ref frontend/index.js:288-327)."""
    if get_object_id(doc) != '_root':
        raise TypeError('The first argument to apply_patch must be the document root')
    state = dict(doc._state)

    if doc._options.get('backend'):
        if backend_state is None:
            raise ValueError('apply_patch must be called with the updated backend state')
        state['backendState'] = backend_state
        return _apply_patch_to_doc(doc, patch, state, True)

    if state['requests']:
        base_doc = state['requests'][0]['before']
        if patch.get('actor') == get_actor_id(doc):
            if state['requests'][0]['seq'] != patch.get('seq'):
                raise ValueError(
                    f"Mismatched sequence number: patch {patch.get('seq')} does not "
                    f"match next request {state['requests'][0]['seq']}")
            state['requests'] = state['requests'][1:]
        else:
            state['requests'] = list(state['requests'])
    else:
        base_doc = doc
        state['requests'] = []

    new_doc = _apply_patch_to_doc(base_doc, patch, state, True)
    if not state['requests']:
        return new_doc
    state['requests'] = list(state['requests'])
    state['requests'][0] = dict(state['requests'][0], before=new_doc)
    return _update_root_object(doc, {}, state)


def get_object_by_id(doc, object_id):
    return doc._cache.get(object_id)


def get_actor_id(doc):
    return doc._state.get('actorId') or doc._options.get('actorId')


def set_actor_id(doc, actor_id):
    _check_actor_id(actor_id)
    state = dict(doc._state, actorId=actor_id)
    return _update_root_object(doc, {}, state)


def get_conflicts(object, key):
    """Expose multi-value register conflicts (ref frontend/index.js:374-379)."""
    if isinstance(object, MapView):
        conflicts = object._conflicts.get(key)
    elif isinstance(object, ListView):
        conflicts = object._conflicts[key] if key < len(object._conflicts) else None
    else:
        return None
    if conflicts and len(conflicts) > 1:
        return conflicts
    return None


def get_last_local_change(doc):
    return doc._state.get('lastLocalChange')


def get_backend_state(doc, caller_name=None, arg_pos='first'):
    if get_object_id(doc) != '_root':
        extra = '. Note: applyChanges returns a [doc, patch] pair.' \
            if isinstance(doc, (list, tuple)) else ''
        if caller_name:
            raise TypeError(f'The {arg_pos} argument to {caller_name} must be the '
                            f'document root{extra}')
        raise TypeError(f'Argument is not an Automerge document root{extra}')
    return doc._state['backendState']


def get_element_ids(list_):
    if isinstance(list_, Text):
        return [elem['elemId'] for elem in list_.elems]
    return list(list_._elem_ids)
