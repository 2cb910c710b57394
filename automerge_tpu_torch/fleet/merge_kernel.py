"""The fleet LWW merge: a hand-written CUDA kernel and its plain version.

`lww_merge(state, ops, noinc=False, fresh=False)` merges one OpBatch into
the fleet's [N, K+1] int32 grids IN PLACE and returns the number of
valid lanes as an int32 tensor. It is the port of the TPU kernel
automerge_tpu/fleet/pallas_merge.py (`_pallas_apply_op_batch_impl`), and
computes the same function as automerge_tpu/fleet/apply.py's scatter
form:

- winners  = max(old winner, packed ids of the valid set lanes);
- values   = value of the lane whose packed id is the new winner;
- counters = sum of the valid inc deltas, plus the old counter only
  where the winner did not change (skipped entirely with noinc);
- fresh: the grids start from zero (fused into the kernel).

A valid lane whose key lies outside [0, K] is dropped.

Routing is by the tensors' device: CUDA tensors launch the kernel in
csrc/lww_merge.cu (built with nvcc for sm_90a on first use into the
package's git-ignored build directory, bound through ctypes: see
cuda_build.py); CPU tensors run `lww_merge_plain`, the same function in
torch ops. There is no fallback between the two: a build or launch
failure raises.
`LAUNCHES['lww_merge']` counts kernel launches (plain runs do not count).

One launch per call, along the route `_launch_plan` picks from the
shapes (csrc/lww_merge.cu says what bounds each route and why):

- 'warp': in place with P <= 32 lanes per doc (every batch of a
  long-lived fleet at the seam's widths): one warp per doc, the lanes
  grouped by key inside the warp, one writer per cell;
- 'cta': in place with P > 32: one CTA per doc in four barrier-separated
  phases, with an [N, P] old-winner scratch array;
- 'fresh': a fresh fleet's first batch, any P: each CTA builds D whole
  rows (or one key chunk of a row too wide for the shared-memory
  budget) in shared memory and writes every cell once with 16-byte
  streaming stores.
"""

import collections
import ctypes

import torch

from . import cuda_build
from ..observability.metrics import Counters

WARP_DOCS = 8            # docs (one warp each) per CTA of the warp route
CTA_THREADS = 128        # threads of the cta route's CTA (one doc)
FRESH_THREADS = 256
# Dynamic shared memory of one fresh CTA. Smaller tiles measured faster
# on an H100 (more CTAs per SM overlap one CTA's lane loads with
# another's stores); this one holds two 1,025-key rows of each grid.
FRESH_SMEM_BUDGET = 36 * 1024
_ROUTES = {'warp': 0, 'cta': 1, 'fresh': 2}

# Counters: shard pumps launch from threads
LAUNCHES = Counters({'lww_merge': 0})

Plan = collections.namedtuple('Plan', (
    'route',          # 'warp', 'cta' or 'fresh'
    'grid',           # CTAs in the launch
    'threads',        # threads per CTA (the warp route: 32 per doc)
    'docs_per_cta',   # docs a CTA owns (D)
    'key_chunk',      # keys of a row a fresh CTA owns (K+1 = whole rows)
    'smem_cells'))    # int32 cells of shared memory per grid (fresh; the
                      # CTA's dynamic shared memory is 3 x smem_cells x 4 B)

_set_up = set()          # devices where lww_merge_setup has run


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch_plan(n, p, k1, fresh):
    """The launch of an [n, k1] merge of P = p lanes per doc: route, CTA
    count and size, and for 'fresh' the tile of cells a CTA builds in
    shared memory (D whole rows, or one key chunk of one row)."""
    if fresh:
        # one grid's cells per CTA, less the 3 cells of alignment slack
        room = FRESH_SMEM_BUDGET // (3 * 4) // 4 * 4 - 4
        if k1 <= room:
            docs, chunk = max(1, min(n, room // k1)), k1
        else:
            docs, chunk = 1, room
        cells = (docs * chunk + 3 + 3) // 4 * 4
        grid = -(-n // docs) * -(-k1 // chunk)
        return Plan('fresh', grid, FRESH_THREADS, docs, chunk, cells)
    if p <= 32:
        return Plan('warp', -(-n // WARP_DOCS), 32 * WARP_DOCS, WARP_DOCS,
                    k1, 0)
    return Plan('cta', n, CTA_THREADS, 1, k1, 0)


def _fresh_tile(plan, n, k1, block):
    """The cells CTA `block` of a fresh launch owns: docs [d0, d1) x keys
    [c0, c1), as lww_merge_fresh computes them from blockIdx. One flat
    range of a grid, since d1 - d0 == 1 or [c0, c1) is the whole row."""
    chunks = -(-k1 // plan.key_chunk)
    d0 = (block // chunks) * plan.docs_per_cta
    c0 = (block % chunks) * plan.key_chunk
    return (d0, min(d0 + plan.docs_per_cta, n), c0,
            min(c0 + plan.key_chunk, k1))


def _declare(lib):
    fn = lib.lww_merge_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 3 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int] + \
        [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lww_merge_setup.argtypes = [ctypes.c_int]
    lib.lww_merge_setup.restype = ctypes.c_int


def build():
    """Compile csrc/lww_merge.cu (once per source content) and load it.
    Returns the ctypes library."""
    return cuda_build.load('lww_merge', _declare)


def _check(ops, state):
    n, k1 = state.winners.shape
    dev = state.winners.device
    for name, t in (('winners', state.winners), ('values', state.values),
                    ('counters', state.counters)):
        if t.dtype != torch.int32 or t.shape != (n, k1) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous int32 [{n}, '
                             f'{k1}] tensor on {dev}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    p = ops.key_id.shape[1] if ops.key_id.dim() == 2 else -1
    for name, want in (('key_id', torch.int32), ('packed', torch.int32),
                       ('value', torch.int32), ('is_set', torch.bool),
                       ('is_inc', torch.bool), ('valid', torch.bool)):
        t = getattr(ops, name)
        if t.dtype != want or t.shape != (n, p) or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f'ops.{name}: expected a contiguous {want} '
                             f'[{n}, P] tensor on {dev}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')


def lww_merge(state, ops, noinc=False, fresh=False):
    """Merge `ops` into `state` in place (see the module docstring);
    returns the valid-lane count as a 0-d int32 tensor."""
    _check(ops, state)
    dev = state.winners.device
    if dev.type == 'cpu':
        return lww_merge_plain(state, ops, noinc=noinc, fresh=fresh)
    if dev.type != 'cuda':
        raise ValueError(f'lww_merge: unsupported device {dev}')
    n, k1 = state.winners.shape
    plan = _launch_plan(n, ops.key_id.shape[1], k1, fresh)
    stats = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch(state, ops, plan, noinc, stats)
    return stats[0]


def _launch(state, ops, plan, noinc, stats):
    """One launch of the kernel along `plan` on CUDA tensors that passed
    `_check`; adds the valid-lane count to the int32 tensor `stats`."""
    n, k1 = state.winners.shape
    p = ops.key_id.shape[1]
    if plan.route == 'warp' and p > 32:
        raise ValueError(f'lww_merge: plan {plan} does not fit P = {p}')
    if state.winners.device.type != 'cuda':
        raise ValueError('lww_merge: the kernel takes CUDA tensors only')
    lib = build()
    dev = state.winners.device
    old_w = None
    if plan.route == 'cta' and not noinc:
        old_w = torch.empty((n, p), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        if plan.route == 'fresh' and index not in _set_up:
            err = lib.lww_merge_setup(FRESH_SMEM_BUDGET)
            if err != 0:
                raise RuntimeError(f'lww_merge: setting the fresh route\'s '
                                   f'shared memory failed: CUDA error {err}')
            _set_up.add(index)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lww_merge_launch(
            ops.key_id.data_ptr(), ops.packed.data_ptr(),
            ops.value.data_ptr(), ops.is_set.data_ptr(),
            ops.is_inc.data_ptr(), ops.valid.data_ptr(),
            state.winners.data_ptr(), state.values.data_ptr(),
            state.counters.data_ptr(),
            old_w.data_ptr() if old_w is not None else None,
            stats.data_ptr(), n, p, k1, int(bool(noinc)),
            _ROUTES[plan.route], plan.grid, plan.threads,
            plan.docs_per_cta, plan.key_chunk, plan.smem_cells, stream)
    if err != 0:
        raise RuntimeError(f'lww_merge kernel launch failed ({plan.route} '
                           f'route): CUDA error {err}')
    if n > 0:
        LAUNCHES.inc('lww_merge')


def lww_merge_plain(state, ops, noinc=False, fresh=False):
    """The same merge in torch ops (scatter-max / scatter / where /
    scatter-add, following automerge_tpu/fleet/apply.py). In place."""
    winners, values, counters = state.tensors()
    if fresh:
        for t in (winners, values, counters):
            t.zero_()
    k1 = winners.shape[1]
    scratch = k1 - 1
    key = ops.key_id.long()
    in_range = (key >= 0) & (key < k1)
    set_mask = ops.is_set & ops.valid & in_range
    set_key = torch.where(set_mask, key, scratch)
    old = None if noinc else winners.clone()
    winners.scatter_reduce_(1, set_key,
                            torch.where(set_mask, ops.packed, 0), 'amax')
    won = set_mask & (ops.packed == winners.gather(1, set_key))
    win_key = torch.where(won, key, scratch)
    values.scatter_(1, win_key, torch.where(won, ops.value, 0))
    if not noinc:
        counters.masked_fill_(winners != old, 0)
        inc_mask = ops.is_inc & ops.valid & in_range
        counters.scatter_add_(1, torch.where(inc_mask, key, scratch),
                              torch.where(inc_mask, ops.value, 0))
    return ops.valid.sum(dtype=torch.int32)
