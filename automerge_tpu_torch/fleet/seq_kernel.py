"""The RGA sequence scan: a hand-written CUDA kernel and its plain version.

`seq_scan(state, ops)` applies one SeqOpBatch to a SeqState IN PLACE and
returns the number of applied ops as a 0-d int32 tensor. It is the port
of automerge_tpu/fleet/sequence.py's per-doc scan
(`_apply_seq_batch_impl` :436 over `_apply_one_doc` :240): each
document's ops apply in column order (an insert's referent can be an
element inserted earlier in the same batch) and documents are
independent. Per op (sequence.py says why each rule holds):

- the referent is the first node whose elem_id equals `ref`; a miss
  never resolves to node 0, and `ref == 0` means the head for an insert
  and is rejected for a set, delete or inc;
- an INSERT after a found referent (or the head), below capacity, skips
  the following nodes whose elem_id is greater than its own id (at most
  `capacity + 3` hops: a cyclic chain stops there), splices a fresh slot
  `SLOT0 + n` in after the last skipped node and takes its own actor lane
  of that slot;
- a SET or DEL kills each pred lane (lane by lane) whose actor slot holds
  exactly that id; a SET then takes its own actor lane;
- an INC adds its delta to the lane of its Lamport-max pred iff that lane
  holds it live, in the counter lane's `(sum << 2) | count-bits` packing
  (int32 wrap), and kills every other live pred'd lane;
- the doc's `inexact` flag rises for the host flag, a dropped op, a pred
  or actor past the lane width (or negative), a self-conflict, an inc
  with no live target, a sum leaving +/-2^29 and a reclaimed inc'd lane.

Routing is by the tensors' device: CUDA tensors launch the kernel in
csrc/sequence.cu (built with nvcc for sm_90a on first use, see
cuda_build.py); CPU tensors run `seq_scan_plain`, the same function in
torch ops (it also runs on CUDA tensors when called by name, as
chip_smoke.py does to hold the kernel to it). There is no fallback
between the two: a build or launch failure raises.
`LAUNCHES['seq_scan']` counts kernel launches and nothing else;
`ROUTE_LAUNCHES` counts them by route.

The kernel (csrc/sequence.cu says why) gives each row one CTA and splits
its work: phase A resolves every op's node in parallel (the rule is
`resolve_plain`), phase B walks the splice chain over the row held in
shared memory, phase C applies the register updates beside it. Rows where
the parallel resolution is not exact (an insert over capacity or with an
unresolved referent) take a serial route inside the same launch.
`_launch_plan` picks the launch: 'resident' where a row's elem_id and nxt
fit a CTA's shared memory, 'global' (the walk in device memory) above.

The kernel's input contract is the state the engine itself keeps: every
`nxt` entry lies in [0, nodes), and elem_id is 0 outside the allocated
slots [SLOT0, SLOT0 + n). `check_rows` tests it; seq_cases.py builds
only such states.
"""

import ctypes
from collections import namedtuple

import torch

from . import cuda_build
from ..observability.metrics import Counters
from .tensor_doc import MAX_ACTORS

PAD, INSERT, SET, DEL, INC = 0, 1, 2, 3, 4      # op kinds of a SeqOpBatch
HEAD, END, SCRATCH, SLOT0 = 0, 1, 2, 3          # node-id layout
HEAD_REF = 0
ACTOR_MASK = MAX_ACTORS - 1
INT32_MAX = 2**31 - 1

# Counters: shard pumps launch from threads
LAUNCHES = Counters({'seq_scan': 0})
ROUTE_LAUNCHES = Counters({'resident': 0, 'global': 0})

# The launch geometry, mirrored from csrc/sequence.cu.
THREADS = 256                 # one CTA of 8 warps per row
MAX_PREDS = 8                 # pred lanes the kernel stages
AHEAD = 128                   # columns phase B loads ahead
MAX_RESIDENT_NODES = 65536    # the resident route holds nxt as uint16
STAGE_BYTES = (2 * (AHEAD + 2) + 32 * (3 + MAX_PREDS)) * 4   # phases B, C
SMEM_LIMIT = 232_448          # shared memory a CTA may use on sm_90
SMEM_BUDGET = SMEM_LIMIT - 1_024     # dynamic; the rest covers the static
SM_SHARED = 233_472           # shared memory of one SM (228 KB)
CTA_RESERVED = 1_024          # the system's share of it per CTA
MAX_CTAS_PER_SM = 2048 // THREADS
_ROUTES = {'resident': 0, 'global': 1}

Plan = namedtuple('Plan', (
    'route',          # 'resident' or 'global'
    'grid',           # CTAs: one per row
    'threads',        # threads per CTA
    'rows_per_cta',   # rows a CTA owns (1)
    'smem_bytes',     # dynamic shared memory per CTA
    'ctas_per_sm',    # CTAs an SM holds at once, by shared memory
    'table_slots'))   # entries of a row's lookup table (in shared memory
                      # on the resident route, else in device scratch)

_set_up = set()       # devices where seq_scan_setup has run


def reset_launches():
    for table in (LAUNCHES, ROUTE_LAUNCHES):
        for name in table:
            table[name] = 0


def _declare(lib):
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.seq_scan_launch.argtypes = [ptr] * 17 + [i64] * 6 + \
        [ctypes.c_int, i64, ptr]
    lib.seq_scan_launch.restype = ctypes.c_int
    lib.seq_scan_setup.argtypes = [ctypes.c_int]
    lib.seq_scan_setup.restype = ctypes.c_int


def build():
    """Compile csrc/sequence.cu (once per source content) and load it."""
    return cuda_build.load('sequence', _declare)


def table_slots(capacity):
    """Entries of the lookup table of a row of `capacity` slots (it
    holds at most that many nodes): load factor <= 0.8."""
    return (capacity * 5 // 4 + 7) // 8 * 8 + 8


def _round16(n):
    return -(-n // 16) * 16


def row_bytes(nodes):
    """Shared bytes of one resident row: elem_id (int32), then a region
    that holds the lookup table (uint16 nodes) during phase A and nxt
    (uint16) after it."""
    return _round16(nodes * 4) + \
        _round16(2 * max(nodes, table_slots(nodes - 3)))


def _ctas_per_sm(smem):
    return min(MAX_CTAS_PER_SM, SM_SHARED // (smem + CTA_RESERVED))


def _launch_plan(rows, nodes, a, p, d):
    """The launch of a [rows, nodes, a] class with a [rows, p, d] batch:
    one CTA of THREADS per row; 'resident' (the row's elem_id, its lookup
    table and then its nxt in shared memory) where they fit SMEM_BUDGET
    beside the staging, else 'global' (all three in device memory). Which
    rows take the serial route is decided per row inside the kernel."""
    if not 1 <= a <= ACTOR_MASK + 1 or not 0 <= d <= MAX_PREDS:
        raise ValueError(f'seq_scan: {a} actor lanes and {d} pred lanes are '
                         f'outside [1, {ACTOR_MASK + 1}] x [0, {MAX_PREDS}]')
    resident = nodes <= MAX_RESIDENT_NODES and \
        row_bytes(nodes) + STAGE_BYTES <= SMEM_BUDGET
    smem = (row_bytes(nodes) if resident else 0) + STAGE_BYTES
    return Plan('resident' if resident else 'global', rows, THREADS, 1,
                smem, _ctas_per_sm(smem), table_slots(nodes - 3))


def _check(state, ops):
    dev = state.elem_id.device
    r, nodes = state.elem_id.shape
    a = state.reg.shape[2] if state.reg.dim() == 3 else -1
    p = ops.kind.shape[1] if ops.kind.dim() == 2 else -1
    d = ops.preds.shape[2] if ops.preds.dim() == 3 else -1
    want = [('elem_id', state.elem_id, torch.int32, (r, nodes)),
            ('nxt', state.nxt, torch.int32, (r, nodes)),
            ('reg', state.reg, torch.int32, (r, nodes, a)),
            ('killed', state.killed, torch.bool, (r, nodes, a)),
            ('val', state.val, torch.int32, (r, nodes, a)),
            ('counter', state.counter, torch.int32, (r, nodes, a)),
            ('n', state.n, torch.int32, (r,)),
            ('inexact', state.inexact, torch.bool, (r,)),
            ('ops.kind', ops.kind, torch.int32, (r, p)),
            ('ops.ref', ops.ref, torch.int32, (r, p)),
            ('ops.packed', ops.packed, torch.int32, (r, p)),
            ('ops.value', ops.value, torch.int32, (r, p)),
            ('ops.preds', ops.preds, torch.int32, (r, p, d)),
            ('ops.flag', ops.flag, torch.bool, (r, p))]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous {dtype} '
                             f'{list(shape)} tensor on {dev}, got {t.dtype} '
                             f'{list(t.shape)} on {t.device}')
    if nodes < SLOT0 + 1 or not 1 <= a <= ACTOR_MASK + 1:
        raise ValueError(f'seq_scan: {nodes} nodes and {a} actor lanes are '
                         f'outside [4, ...) x [1, {ACTOR_MASK + 1}]')
    return dev, r, nodes, a, p, d


def seq_scan(state, ops):
    """Apply `ops` to `state` in place (see the module docstring); returns
    the applied-op count as a 0-d int32 tensor."""
    dev, r, nodes, a, p, d = _check(state, ops)
    if dev.type == 'cpu':
        return seq_scan_plain(state, ops)
    if dev.type != 'cuda':
        raise ValueError(f'seq_scan: unsupported device {dev}')
    return _launch(state, ops, _launch_plan(r, nodes, a, p, d))[0]


def _launch(state, ops, plan):
    """One launch of the kernel along `plan` (a route may be forced, as
    the card tests do); returns its stats, an int32 CUDA tensor [applied
    ops, rows that took the serial route]."""
    dev, r, nodes, a, p, d = _check(state, ops)
    if dev.type != 'cuda':
        raise ValueError('seq_scan: the kernel takes CUDA tensors only')
    lib = build()
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    live = r if r * p else 0
    aux = torch.empty((live, p), dtype=torch.int32, device=dev)
    table = torch.empty((0 if plan.route == 'resident' else live,
                         plan.table_slots), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        if index not in _set_up:
            err = lib.seq_scan_setup(SMEM_BUDGET)
            if err != 0:
                raise RuntimeError(f'seq_scan: setting the resident route\'s '
                                   f'shared memory failed: CUDA error {err}')
            _set_up.add(index)
        err = lib.seq_scan_launch(
            state.elem_id.data_ptr(), state.nxt.data_ptr(),
            state.reg.data_ptr(), state.killed.data_ptr(),
            state.val.data_ptr(), state.counter.data_ptr(),
            state.n.data_ptr(), state.inexact.data_ptr(),
            ops.kind.data_ptr(), ops.ref.data_ptr(), ops.packed.data_ptr(),
            ops.value.data_ptr(), ops.preds.data_ptr(), ops.flag.data_ptr(),
            stats.data_ptr(), aux.data_ptr(), table.data_ptr(), r, nodes, a,
            p, d, plan.table_slots, _ROUTES[plan.route], plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'seq_scan kernel launch failed ({plan.route} '
                           f'route): CUDA error {err}')
    if live:
        LAUNCHES.inc('seq_scan')
        ROUTE_LAUNCHES.inc(plan.route)
    return stats


def check_rows(state):
    """The kernel's input contract per row ([R] bool): every nxt entry in
    [0, nodes) and elem_id zero outside [SLOT0, SLOT0 + n)."""
    r, nodes = state.elem_id.shape
    node = torch.arange(nodes, device=state.elem_id.device)
    alloc = (node >= SLOT0) & (node < SLOT0 + state.n.long().unsqueeze(1))
    ok_nxt = ((state.nxt >= 0) & (state.nxt < nodes)).all(dim=1)
    ok_elem = ((state.elem_id == 0) | alloc).all(dim=1)
    ok_n = (state.n >= 0) & (state.n <= nodes - 3)
    return ok_nxt & ok_elem & ok_n


Resolved = namedtuple('Resolved', ('node', 'slot', 'exact', 'n'))


def resolve_plain(state, ops):
    """Phase A's rule in torch ops (the kernel's parallel resolution, for
    the tests; [R, P, nodes] and [R, P, P] compares, small inputs only).
    Assuming every insert of a row applies, insert k of the row (in
    column order) lands at `slot` SLOT0 + n0 + k, and the `node` of a
    known op at column i is the lowest node in [SLOT0, SLOT0 + n0)
    holding its ref, else the slot of the earliest insert at a column
    before i with that packed id, else -1 (a miss); ref == 0 is HEAD for
    an insert and -1 otherwise. `exact` [R] holds where the assumption
    does (n0 + inserts <= capacity and every insert resolves): there the
    scan ends with `n` [R] = n0 + inserts, each op's ref at its node and
    each insert's id at its slot. Unknown kinds resolve to -1."""
    kind, ref, packed = ops.kind, ops.ref, ops.packed
    r, nodes = state.elem_id.shape
    p = kind.shape[1]
    dev = kind.device
    is_ins = kind == INSERT
    known = (kind >= INSERT) & (kind <= INC)
    n0 = state.n.long()
    before = torch.cumsum(is_ins.long(), 1) - is_ins.long()
    slot = torch.where(is_ins, SLOT0 + n0.unsqueeze(1) + before, -1)
    node_ids = torch.arange(nodes, device=dev)
    alloc = (node_ids >= SLOT0) & (node_ids < SLOT0 + n0.unsqueeze(1))
    hit = (state.elem_id.unsqueeze(1) == ref.unsqueeze(2)) & \
        alloc.unsqueeze(1)
    held = torch.where(hit, node_ids, nodes).min(dim=2).values \
        if nodes else torch.full_like(ref, nodes, dtype=torch.long)
    col = torch.arange(p, device=dev)
    earlier = col.view(1, 1, p) < col.view(1, p, 1)       # column j < i
    ins_hit = (packed.unsqueeze(1) == ref.unsqueeze(2)) & \
        is_ins.unsqueeze(1) & earlier
    first = torch.where(ins_hit, col, p).min(dim=2).values \
        if p else torch.zeros_like(ref, dtype=torch.long)
    inserted = torch.where(first < p,
                           slot.gather(1, first.clamp(max=max(p - 1, 0))),
                           -1)
    node = torch.where(held < nodes, held, inserted)
    node = torch.where(ref == HEAD_REF,
                       torch.where(is_ins, HEAD, -1), node)
    node = torch.where(known, node, -1)
    inserts = is_ins.sum(dim=1)
    exact = (n0 + inserts <= nodes - 3) & ~(is_ins & (node < 0)).any(dim=1)
    return Resolved(node, slot, exact, n0 + inserts)


def seq_scan_plain(state, ops):
    """seq_scan in torch ops: `_apply_one_doc`'s step for every doc at once
    ([R]-wide), in a Python loop over the P op columns and the D pred
    lanes, including its masked writes to the SCRATCH and END nodes. In
    place; returns the applied-op count (0-d int32)."""
    elem_id, nxt, reg, killed, val, counter = (
        state.elem_id, state.nxt, state.reg, state.killed, state.val,
        state.counter)
    r, nodes = elem_id.shape
    capacity = nodes - 3
    a_n = reg.shape[2]
    dev = elem_id.device
    docs = torch.arange(r, device=dev)
    n = state.n.clone()
    inexact = state.inexact.clone()
    applied_total = torch.zeros((), dtype=torch.int32, device=dev)
    i32 = torch.int32
    scratch = torch.full((r,), SCRATCH, dtype=torch.long, device=dev)
    end = torch.full((r,), END, dtype=torch.long, device=dev)
    node_ids = torch.arange(nodes, device=dev)

    def lane(p):
        s = (p & ACTOR_MASK).long()
        return (s < a_n) & (p > 0), s.clamp(max=a_n - 1)

    for i in range(ops.kind.shape[1]):
        kind, ref = ops.kind[:, i], ops.ref[:, i]
        packed, value = ops.packed[:, i], ops.value[:, i]
        preds = [ops.preds[:, i, d] for d in range(ops.preds.shape[2])]
        flag = ops.flag[:, i]
        is_ins = kind == INSERT
        is_upd = (kind == SET) | (kind == DEL)
        is_inc = kind == INC

        # referent: the first node whose elem_id equals ref
        hits = elem_id == ref.unsqueeze(1)
        found = hits.any(dim=1)
        match = torch.where(hits, node_ids, nodes).min(dim=1).values
        match = torch.where(found, match, 0)

        # INSERT: skip the following nodes with a greater elem_id
        r0 = torch.where(ref == HEAD_REF, HEAD, match)
        my_key = torch.where(is_ins, packed, INT32_MAX)
        cur = r0
        j = nxt[docs, r0].long()
        h = torch.zeros(r, dtype=torch.long, device=dev)
        walk = (elem_id[docs, j] > my_key) & (h < capacity + 3)
        while bool(walk.any()):
            cur = torch.where(walk, j, cur)
            j = torch.where(walk, nxt[docs, j].long(), j)
            h = h + walk.long()
            walk = (elem_id[docs, j] > my_key) & (h < capacity + 3)

        can_ins = is_ins & (n < capacity) & ((ref == HEAD_REF) | found)
        slot = SLOT0 + torch.clamp(n.long(), max=capacity - 1)
        ins_slot = torch.where(can_ins, slot, scratch)
        ins_ptr_from = torch.where(can_ins, cur, end)
        ins_ptr_new = torch.where(can_ins, slot, end)
        nxt[docs, ins_ptr_new] = torch.where(
            can_ins, j.to(i32), nxt[docs, ins_ptr_new])
        nxt[docs, ins_ptr_from] = torch.where(
            can_ins, slot.to(i32), nxt[docs, ins_ptr_from])
        elem_id[docs, ins_slot] = torch.where(can_ins, packed,
                                              elem_id[docs, ins_slot])
        n = n + can_ins.to(i32)

        # own actor lane of the inserted slot
        a = (packed & ACTOR_MASK).long()
        a_ok = a < a_n
        a_c = a.clamp(max=a_n - 1)
        w_ins = can_ins & a_ok
        tgt_ins = torch.where(w_ins, slot, scratch)
        reg[docs, tgt_ins, a_c] = torch.where(w_ins, packed,
                                              reg[docs, tgt_ins, a_c])
        killed[docs, tgt_ins, a_c] = torch.where(
            w_ins, False, killed[docs, tgt_ins, a_c])
        val[docs, tgt_ins, a_c] = torch.where(w_ins, value,
                                              val[docs, tgt_ins, a_c])
        counter[docs, tgt_ins, a_c] = torch.where(
            w_ins, 0, counter[docs, tgt_ins, a_c])

        # SET / DEL / INC on the target element's register row
        upd_ok = is_upd & found & (ref != HEAD_REF)
        inc_ok = is_inc & found & (ref != HEAD_REF)
        tgt = torch.where(upd_ok | inc_ok, match, scratch)
        reg_row = reg[docs, tgt]
        killed_row = killed[docs, tgt]
        val_row = val[docs, tgt]
        counter_row = counter[docs, tgt]

        lane_oob = torch.zeros(r, dtype=torch.bool, device=dev)
        for p in preds:
            s_ok, s_c = lane(p)
            lane_oob |= (upd_ok | inc_ok) & (p != 0) & ~s_ok
            hit = upd_ok & s_ok & (reg_row[docs, s_c] == p)
            killed_row[docs, s_c] = killed_row[docs, s_c] | hit

        max_pred = torch.zeros(r, dtype=i32, device=dev)
        any_live_hit = torch.zeros(r, dtype=torch.bool, device=dev)
        for p in preds:
            s_ok, s_c = lane(p)
            max_pred = torch.where(is_inc & (p > 0),
                                   torch.maximum(max_pred, p), max_pred)
            any_live_hit |= inc_ok & s_ok & (reg_row[docs, s_c] == p) & \
                ~killed_row[docs, s_c]
        s_max = (max_pred & ACTOR_MASK).long()
        s_max_ok = (s_max < a_n) & (max_pred != 0)
        s_max_c = s_max.clamp(max=a_n - 1)
        max_live = inc_ok & s_max_ok & (reg_row[docs, s_max_c] == max_pred) \
            & ~killed_row[docs, s_max_c]
        old_cnt = counter_row[docs, s_max_c]
        new_sum = (old_cnt >> 2) + value
        bad_sum = max_live & (torch.abs(new_sum) >= (1 << 29))
        stepped = (old_cnt & ~3) + (value << 2)
        stepped = stepped | torch.where((old_cnt & 3) == 0, 1, 3).to(i32)
        counter_row[docs, s_max_c] = torch.where(max_live, stepped, old_cnt)
        for p in preds:
            s_ok, s_c = lane(p)
            lose = inc_ok & s_ok & (reg_row[docs, s_c] == p) & \
                ~killed_row[docs, s_c] & (p != max_pred)
            killed_row[docs, s_c] = killed_row[docs, s_c] | lose
        bad_inc = inc_ok & ~any_live_hit & ~max_live

        is_set_live = upd_ok & (kind == SET)
        own_prev = reg_row[docs, a_c]
        own_pred = torch.zeros(r, dtype=torch.bool, device=dev)
        for p in preds:
            own_pred |= p == own_prev
        self_conflict = is_set_live & a_ok & (own_prev != 0) & \
            ~killed_row[docs, a_c] & ~own_pred & (own_prev != packed)
        set_actor_oob = is_set_live & ~a_ok
        w_set = is_set_live & a_ok
        reclaim_incd = w_set & ((counter_row[docs, a_c] & 3) != 0)
        reg_row[docs, a_c] = torch.where(w_set, packed, reg_row[docs, a_c])
        killed_row[docs, a_c] = torch.where(w_set, False,
                                            killed_row[docs, a_c])
        val_row[docs, a_c] = torch.where(w_set, value, val_row[docs, a_c])
        counter_row[docs, a_c] = torch.where(w_set, 0,
                                             counter_row[docs, a_c])
        reg[docs, tgt] = reg_row
        killed[docs, tgt] = killed_row
        val[docs, tgt] = val_row
        counter[docs, tgt] = counter_row

        applied = torch.where(is_ins, can_ins,
                              torch.where(is_inc, inc_ok, upd_ok))
        ins_actor_oob = can_ins & ~a_ok
        inexact = inexact | flag | self_conflict | lane_oob | \
            set_actor_oob | ins_actor_oob | bad_inc | bad_sum | \
            reclaim_incd | ((kind > PAD) & ~applied)
        applied_total += applied.sum(dtype=i32)
    state.n.copy_(n)
    state.inexact.copy_(inexact)
    return applied_total
