"""The multi-value register scan: a hand-written CUDA kernel and its plain
version.

`register_scan(state, ops)` applies one RegisterOpBatch to a
RegisterState IN PLACE and returns the number of non-PAD op lanes as a
0-d int32 tensor. It is the port of automerge_tpu/fleet/registers.py's
ordered scan (`_apply_register_batch_impl` :207 over `_apply_step`
:106): each document's ops apply in column order, since a successor
can land in the same batch as the op it kills, and documents are
independent. Per op (registers.py says why each rule holds):

- every non-zero pred lane whose actor slot s = pred & 255 is < A and
  holds exactly that packed id is killed, unless the op is an inc; a
  non-zero pred with s >= A flags the doc inexact;
- an inc adds its delta (wrapping int32) to the slot of its Lamport-max
  non-zero pred (signed max, from 0) iff that slot holds it live, and
  kills every other live pred'd slot; an inc with no live pred hit
  flags the doc;
- a set takes its own actor slot (packed & 255): packed id, value,
  killed = 0, counter = 0; a live different op standing there that the
  set did not pred flags the doc (a self-conflict);
- an op whose actor slot is >= A, and any lane whose `overflow` is set
  (PAD lanes included), flags the doc.

A live lane's key must lie in [0, K]; the fleet never makes another.
The JAX step would read a clamped row for such a lane and drop its
writes; here it flags the doc inexact and changes nothing else.

Ops of one doc touch only the row of the key they name and the doc's
`inexact` flag, so ops on different keys commute. The kernel uses that:
a doc's ops go in tiles of up to 32 columns, in order, and in a tile the
ops of distinct keys apply at once, in rounds (csrc/registers.cu says
how). `register_scan_rounds_plain` applies the same schedule in torch
ops; the CPU tests hold it to the JAX scan.

Routing is by the tensors' device: CUDA tensors launch the kernel in
csrc/registers.cu (built with nvcc for sm_90a on first use, see
cuda_build.py); CPU tensors run `register_scan_plain`, the same function
in torch ops (it also runs on CUDA tensors when called by name, as
chip_smoke.py does to hold the kernel to it). There is no fallback
between the two: a build or launch failure raises.
`LAUNCHES['register_scan']` counts kernel launches and nothing else.
"""

import ctypes
import threading

import torch

from . import cuda_build
from ..observability.metrics import Counters
from .tensor_doc import MAX_ACTORS

PAD, SET, DEL, INC = 0, 1, 2, 3       # op kinds of a RegisterOpBatch
ACTOR_MASK = MAX_ACTORS - 1           # a packed id's actor bits

# Counters: shard pumps launch from threads
LAUNCHES = Counters({'register_scan': 0})


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib):
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.register_scan_launch.argtypes = [ptr] * 13 + [i64] * 5 + [ptr]
    lib.register_scan_launch.restype = ctypes.c_int


def build():
    """Compile csrc/registers.cu (once per source content) and load it."""
    return cuda_build.load('registers', _declare)


def _check(state, ops):
    dev = state.reg.device
    n, k1, a = state.reg.shape
    p = ops.kind.shape[1] if ops.kind.dim() == 2 else -1
    d = ops.preds.shape[2] if ops.preds.dim() == 3 else -1
    want = [('reg', state.reg, torch.int32, (n, k1, a)),
            ('killed', state.killed, torch.bool, (n, k1, a)),
            ('value', state.value, torch.int32, (n, k1, a)),
            ('counter', state.counter, torch.int32, (n, k1, a)),
            ('inexact', state.inexact, torch.bool, (n,)),
            ('ops.kind', ops.kind, torch.int32, (n, p)),
            ('ops.key_id', ops.key_id, torch.int32, (n, p)),
            ('ops.packed', ops.packed, torch.int32, (n, p)),
            ('ops.value', ops.value, torch.int32, (n, p)),
            ('ops.preds', ops.preds, torch.int32, (n, p, d)),
            ('ops.overflow', ops.overflow, torch.bool, (n, p))]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous {dtype} '
                             f'{list(shape)} tensor on {dev}, got {t.dtype} '
                             f'{list(t.shape)} on {t.device}')
    if a > ACTOR_MASK + 1:
        raise ValueError(f'register_scan: {a} actor slots exceed '
                         f'{ACTOR_MASK + 1}')
    return dev, n, k1, a, p, d


def _segment_shift(p):
    """log2 of the lanes the kernel gives one doc: 32 when P > 16, else
    the power of two >= P (32 >> shift docs share a warp)."""
    shift = 5
    while shift > 0 and (1 << (shift - 1)) >= p:
        shift -= 1
    return shift


_ARRIVALS = {}      # (device, stream) -> the kernel's uint64 arrival word
_ARRIVALS_LOCK = threading.Lock()   # shard pumps launch from threads


def _arrivals(dev, stream):
    """The zeroed uint64 word the kernel's CTAs count their arrival and
    lanes into; the last CTA resets it, so it is zeroed once per device
    and stream, not once per launch."""
    key = (dev, stream)
    word = _ARRIVALS.get(key)
    if word is None:
        with _ARRIVALS_LOCK:
            word = _ARRIVALS.get(key)
            if word is None:
                word = _ARRIVALS[key] = torch.zeros(1, dtype=torch.int64,
                                                    device=dev)
    return word


def register_scan(state, ops):
    """Apply `ops` to `state` in place (see the module docstring); returns
    the non-PAD lane count as a 0-d int32 tensor."""
    dev, n, k1, a, p, d = _check(state, ops)
    if dev.type == 'cpu':
        return register_scan_plain(state, ops)
    if dev.type != 'cuda':
        raise ValueError(f'register_scan: unsupported device {dev}')
    if n * p >= 1 << 31:
        raise ValueError(f'register_scan: {n} x {p} op lanes exceed the '
                         f'int32 count')
    if not n * p:
        return torch.zeros((), dtype=torch.int32, device=dev)
    lib = build()
    applied = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.register_scan_launch(
            state.reg.data_ptr(), state.killed.data_ptr(),
            state.value.data_ptr(), state.counter.data_ptr(),
            state.inexact.data_ptr(), ops.kind.data_ptr(),
            ops.key_id.data_ptr(), ops.packed.data_ptr(),
            ops.value.data_ptr(), ops.preds.data_ptr(),
            ops.overflow.data_ptr(), applied.data_ptr(),
            _arrivals(dev, stream).data_ptr(), n, p, d, k1, a, stream)
    if err != 0:
        raise RuntimeError(f'register_scan kernel launch failed: CUDA '
                           f'error {err}')
    LAUNCHES.inc('register_scan')
    return applied[0]


def register_scan_plain(state, ops):
    """register_scan in torch ops: the [N]-wide step of registers.py's
    `_apply_step` in a Python loop over the P op columns and the D pred
    lanes. In place; returns the non-PAD lane count (0-d int32)."""
    reg, killed, value, counter, inexact = state.tensors()
    n, k1, a_n = reg.shape
    dev = reg.device
    docs = torch.arange(n, device=dev)
    flag = inexact.clone()
    applied = torch.zeros((), dtype=torch.int32, device=dev)

    def slot(p):
        s = (p & ACTOR_MASK).long()
        return s < a_n, s.clamp(max=a_n - 1)

    for i in range(ops.kind.shape[1]):
        kind, packed, val = ops.kind[:, i], ops.packed[:, i], ops.value[:, i]
        key = ops.key_id[:, i].long()
        preds = [ops.preds[:, i, d] for d in range(ops.preds.shape[2])]
        live = kind != PAD
        key_ok = (key >= 0) & (key < k1)
        on = live & key_ok
        k = torch.where(on, key, k1 - 1)
        reg_row, killed_row, value_row, counter_row = (
            t[docs, k] for t in (reg, killed, value, counter))

        # pred kills (not by incs), lane by lane
        kills = kind != INC
        slot_oob = torch.zeros(n, dtype=torch.bool, device=dev)
        for p in preds:
            inb, s = slot(p)
            slot_oob |= on & (p != 0) & ~inb
            hit = on & (p != 0) & inb & (reg_row[docs, s] == p)
            killed_row[docs, s] = killed_row[docs, s] | (hit & kills)

        # inc: the Lamport-max pred's slot takes the delta iff it is live
        is_inc = on & (kind == INC)
        max_pred = torch.zeros(n, dtype=torch.int32, device=dev)
        any_live_hit = torch.zeros(n, dtype=torch.bool, device=dev)
        for p in preds:
            inb, s = slot(p)
            nz = is_inc & (p != 0)
            max_pred = torch.where(nz, torch.maximum(max_pred, p), max_pred)
            any_live_hit |= nz & inb & (reg_row[docs, s] == p) & \
                ~killed_row[docs, s]
        inb, s_max = slot(max_pred)
        max_live = is_inc & (max_pred != 0) & inb & \
            (reg_row[docs, s_max] == max_pred) & ~killed_row[docs, s_max]
        counter_row[docs, s_max] = counter_row[docs, s_max] + \
            torch.where(max_live, val, 0)
        for p in preds:
            inb, s = slot(p)
            lose = is_inc & (p != 0) & inb & (reg_row[docs, s] == p) & \
                ~killed_row[docs, s] & (p != max_pred)
            killed_row[docs, s] = killed_row[docs, s] | lose
        inc_hit = any_live_hit | max_live

        # set: occupy the op's own actor slot
        in_a, a = slot(packed)
        is_set = on & (kind == SET)
        own_prev = reg_row[docs, a]
        own_pred = torch.zeros(n, dtype=torch.bool, device=dev)
        for p in preds:
            own_pred |= p == own_prev
        self_conflict = is_set & in_a & (own_prev != 0) & \
            ~killed_row[docs, a] & ~own_pred & (own_prev != packed)
        bad_inc = is_inc & ~inc_hit
        actor_oob = on & ~in_a
        flag |= self_conflict | ops.overflow[:, i] | bad_inc | slot_oob | \
            actor_oob | (live & ~key_ok)

        w = is_set & in_a
        dw, aw = docs[w], a[w]
        reg_row[dw, aw] = packed[w]
        killed_row[dw, aw] = False
        value_row[dw, aw] = val[w]
        counter_row[dw, aw] = 0
        for t, row in ((reg, reg_row), (killed, killed_row),
                       (value, value_row), (counter, counter_row)):
            t[docs, k] = row
        applied += live.sum(dtype=torch.int32)
    inexact.copy_(flag)
    return applied


def _slot(p, a_n):
    s = (p & ACTOR_MASK).long()
    return s < a_n, s.clamp(max=a_n - 1)


def _apply_rows(rows, kind, packed, val, preds):
    """The rule of one op on each of M rows: `rows` are the [M, A] reg,
    killed, value and counter rows (changed in place), the op columns are
    [M] and `preds` a list of D [M] columns; every op's key lies in the
    grid, and a PAD op changes nothing. Returns the [M] flags the ops
    raise (self-conflicts, incs without a live pred hit, pred or actor
    slots >= A), which the caller masks to its live ops."""
    reg_row, killed_row, value_row, counter_row = rows
    m, a_n = reg_row.shape
    idx = torch.arange(m, device=reg_row.device)
    no = torch.zeros(m, dtype=torch.bool, device=reg_row.device)

    # pred kills (not by incs), lane by lane
    kills = (kind != INC) & (kind != PAD)
    slot_oob = no.clone()
    for p in preds:
        inb, s = _slot(p, a_n)
        slot_oob |= (p != 0) & ~inb
        hit = (p != 0) & inb & (reg_row[idx, s] == p)
        killed_row[idx, s] = killed_row[idx, s] | (hit & kills)

    # inc: the Lamport-max pred's slot takes the delta iff it is live
    is_inc = kind == INC
    max_pred = torch.zeros(m, dtype=torch.int32, device=reg_row.device)
    any_live_hit = no.clone()
    for p in preds:
        inb, s = _slot(p, a_n)
        nz = is_inc & (p != 0)
        max_pred = torch.where(nz, torch.maximum(max_pred, p), max_pred)
        any_live_hit |= nz & inb & (reg_row[idx, s] == p) & \
            ~killed_row[idx, s]
    inb, s_max = _slot(max_pred, a_n)
    max_live = is_inc & (max_pred != 0) & inb & \
        (reg_row[idx, s_max] == max_pred) & ~killed_row[idx, s_max]
    counter_row[idx, s_max] = counter_row[idx, s_max] + \
        torch.where(max_live, val, 0)
    for p in preds:
        inb, s = _slot(p, a_n)
        lose = is_inc & (p != 0) & inb & (reg_row[idx, s] == p) & \
            ~killed_row[idx, s] & (p != max_pred)
        killed_row[idx, s] = killed_row[idx, s] | lose
    inc_hit = any_live_hit | max_live

    # set: occupy the op's own actor slot
    in_a, a = _slot(packed, a_n)
    is_set = kind == SET
    own_prev = reg_row[idx, a]
    own_pred = no.clone()
    for p in preds:
        own_pred |= p == own_prev
    self_conflict = is_set & in_a & (own_prev != 0) & \
        ~killed_row[idx, a] & ~own_pred & (own_prev != packed)
    w = is_set & in_a
    iw, aw = idx[w], a[w]
    reg_row[iw, aw] = packed[w]
    killed_row[iw, aw] = False
    value_row[iw, aw] = val[w]
    counter_row[iw, aw] = 0
    return self_conflict | (is_inc & ~inc_hit) | slot_oob | ~in_a


def _lane_flags(ops, k1):
    """[N, P]: the lanes that flag their doc whatever the state: any
    `overflow` (PAD lanes too) and live lanes whose key lies outside
    [0, K]. Also returns the live lanes and the lanes that apply."""
    live = ops.kind != PAD
    key_ok = (ops.key_id >= 0) & (ops.key_id < k1)
    return ops.overflow | (live & ~key_ok), live, live & key_ok


def tile_ranks(key, ok):
    """[N, W]: each lane's round in its tile, the number of earlier lanes
    of the tile that apply (`ok`) on the same key."""
    w = key.shape[1]
    before = torch.ones(w, w, dtype=torch.bool, device=key.device).tril(-1)
    same = (key.unsqueeze(2) == key.unsqueeze(1)) & ok.unsqueeze(1)
    return (same & before).sum(dim=2)


def register_scan_rounds_plain(state, ops):
    """register_scan in torch ops, by the kernel's schedule: each doc's
    ops in tiles of 2^`_segment_shift(P)` columns, in order; in a tile,
    the lanes that apply (live, key in the grid) in rounds, round r
    holding the lanes with r earlier lanes of the same key in the tile.
    A round's ops touch distinct (doc, key) rows, so each round is one
    `_apply_rows` over all of its ops, of every doc at once. In place;
    returns the non-PAD lane count (0-d int32). It equals
    `register_scan_plain` because ops on different keys of a doc
    commute."""
    reg, killed, value, counter, inexact = state.tensors()
    n, k1, _a = reg.shape
    p = ops.kind.shape[1]
    lane_flag, live, on = _lane_flags(ops, k1)
    flag = inexact | lane_flag.any(dim=1)
    w = 1 << _segment_shift(p)
    for t in range(0, p, w):
        cols = slice(t, min(t + w, p))
        ok = on[:, cols]
        rank = tile_ranks(ops.key_id[:, cols], ok)
        for r in range(int(rank[ok].max()) + 1 if ok.any() else 0):
            doc, col = torch.nonzero(ok & (rank == r), as_tuple=True)
            col = col + t
            k = ops.key_id[doc, col].long()
            rows = [x[doc, k] for x in (reg, killed, value, counter)]
            raised = _apply_rows(rows, ops.kind[doc, col],
                                 ops.packed[doc, col], ops.value[doc, col],
                                 [ops.preds[doc, col, d]
                                  for d in range(ops.preds.shape[2])])
            flag[doc[raised]] = True
            for x, row in zip((reg, killed, value, counter), rows):
                x[doc, k] = row
    inexact.copy_(flag)
    return live.sum(dtype=torch.int32)
