"""Seeded inputs for holding the CUDA merge against its plain version.

`chip_smoke.py` (phase 2) and `tests/test_torch_cuda.py` both draw their
batches from here, so the card checks and the card tests cover the same
cases: random op columns, the corner columns that stress a warp's key
groups, and `launch_along`, which sends one batch down a chosen route of
the kernel whatever route its P would pick.
"""

import numpy as np
import torch

from . import merge_kernel
from .merge_kernel import lww_merge_plain
from .tensor_doc import ACTOR_BITS, FleetState, OpBatch


def random_cols(rng, n_docs, n_keys, lanes, ctr0=1, inc=True):
    """[N, P] OpBatch columns as numpy arrays: keys in [0, n_keys),
    packed ids rising from `ctr0` along a doc's lanes, ~70 % sets (all
    sets without `inc`), ~90 % valid, values including negatives."""
    shape = (n_docs, lanes)
    key_id = rng.integers(0, n_keys, shape, dtype=np.int32)
    actor = rng.integers(0, 4, shape, dtype=np.int32)
    ctrs = ctr0 + np.broadcast_to(np.arange(lanes, dtype=np.int32), shape)
    packed = (ctrs.astype(np.int32) << ACTOR_BITS) | actor
    value = rng.integers(-50, 1000, shape, dtype=np.int32)
    is_set = rng.random(shape) < 0.7 if inc else np.ones(shape, bool)
    valid = rng.random(shape) < 0.9
    return [key_id, packed, value, is_set, ~is_set, valid]


def seeded(rng, n_docs, n_keys, device):
    """A grid that already holds winners, values and counters."""
    state = FleetState.empty(n_docs, n_keys, device)
    lww_merge_plain(state, OpBatch(*random_cols(rng, n_docs, n_keys, 6))
                    .to(device))
    return state


def clone(state):
    return FleetState(*(t.clone() for t in state.tensors()))


CORNERS = ('collision', 'duplicates', 'negative')


def corner_cols(case, rng, base, n_keys, lanes):
    """Columns that stress a doc's key groups, for the grid `base`:
    'collision' puts every lane on a few keys (key K included, and every
    lane of the first four docs on key 1); 'duplicates' re-delivers a
    third of the lanes inside the batch and, in lane 0, each doc's
    standing winner of one key; 'negative' gives every lane a negative
    value (negative incs beside newer sets)."""
    n_docs = base.winners.shape[0]
    if case == 'collision':
        cols = random_cols(rng, n_docs, n_keys + 1, lanes, ctr0=9)
        cols[0][:4] = 1
    elif case == 'duplicates':
        cols = random_cols(rng, n_docs, n_keys, lanes, ctr0=30)
        src = rng.integers(1, lanes // 2, lanes // 3)
        dst = lanes - 1 - rng.permutation(lanes // 2)[:lanes // 3]
        for c in cols:
            c[:, dst] = c[:, src]
        rows = np.arange(n_docs)
        key = rng.integers(0, n_keys, n_docs)
        w, v = (t.cpu().numpy()[rows, key] for t in (base.winners,
                                                      base.values))
        for c, x in zip(cols, (key, w, v, True, False, True)):
            c[:, 0] = x
    elif case == 'negative':
        cols = random_cols(rng, n_docs, n_keys, lanes, ctr0=50)
        cols[2] = -rng.integers(1, 1000, cols[2].shape, dtype=np.int32)
    else:
        raise ValueError(f'unknown corner case {case!r}')
    return cols


def launch_along(route, state, ops, noinc=False, stats=None):
    """One launch of the kernel along `route` ('warp', 'cta' or 'fresh')
    whatever the batch's P: the cta route also takes P <= 32, and 'fresh'
    starts the grids from zero. Adds the valid-lane count to `stats` (a
    new int32 tensor when None) and returns it."""
    n, k1 = state.winners.shape
    p = ops.key_id.shape[1]
    plan = merge_kernel._launch_plan(n, max(p, 33) if route == 'cta' else p,
                                     k1, route == 'fresh')
    if plan.route != route:
        raise ValueError(f'route {route!r} does not take P = {p}')
    if stats is None:
        stats = torch.zeros(1, dtype=torch.int32,
                            device=state.winners.device)
    merge_kernel._launch(state, ops, plan, noinc, stats)
    return stats
