"""Fleet sharding across a mesh of device positions (torch).

The torch port of automerge_tpu/fleet/sharding.py. Documents are
independent, so the fleet's batch axis splits data-parallel over a
'docs' axis of positions; the per-document key grid can split over a
second 'keys' axis when the key universe is large. Where the reference
lets XLA place the blocks and insert the collectives, the port does it
by hand:

- `FleetMesh` is the counterpart of `jax.sharding.Mesh`: named axes
  over an array of positions, each with a torch device and the process
  rank that owns it. Positions may repeat a device: 4 positions on
  `cuda:0` (or on the CPU) are 4 logical shards, and run the same code
  as 4 cards; only the device objects differ.
- `ShardedTensor` is the counterpart of a jax.Array under a
  NamedSharding: a global tensor held as per-position blocks, which
  `gather()` (and ``np.asarray``) reassemble. On one device the blocks
  are views of one tensor where their layout allows.
- The steps launch one kernel per block on the block's device: the
  hand-written LWW merge (`sharded_apply`, one launch per (docs, keys)
  block) and RGA scan (`sharded_seq_apply`, one per docs block). A few
  long documents whose slot axis stripes over every position
  (`sharded_long_seq_apply` / `_materialize`) gather their stripes,
  run one scan (or the list ranking) and stripe the result again: on
  one device the stripes are views, so the gather moves nothing.

The key grid under key sharding: the reference's padded lanes write a
global scratch column (the grid's last). Here every key block that does
not end the grid carries a scratch column of its own, dropped by
`gather()`, and a lane only takes part in the block that holds its key,
so each op counts once in the stats (a lane whose key lies in no block
counts in the first block, whose kernel drops it).

Each step is wrapped for the kernel cost ledger under the reference's
kind name; `LAUNCHES` counts the steps that launched their kernels on
the card. The module docstring of the reference follows.

The parallelism story for a CRDT fleet (SURVEY.md §2.12): documents are
independent, so the fleet batch axis shards data-parallel across chips; the
per-document key grid can shard across a second mesh axis when the key
universe is large. XLA inserts the collectives (scatter updates crossing the
key axis become all-to-alls; fleet-wide stats are psums riding ICI).
"""

import numpy as np
import torch

from ..observability.metrics import Counters
from ..observability.perf import instrument_kernel
from . import apply, sequence
from .tensor_doc import FleetState, OpBatch

# Counters: shard pumps launch from threads
LAUNCHES = Counters({'sharded_apply': 0, 'sharded_seq_apply': 0,
                     'sharded_long_seq_apply': 0,
                     'sharded_long_seq_materialize': 0})


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def process_rank(group=None):
    """This process's rank in `group` (0 without a process group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


class FleetMesh:
    """Named axes over an array of positions: the port's counterpart of
    `jax.sharding.Mesh`.

    - `devices`: an object array of torch devices with one axis per
      name (a position's device; positions may share one);
    - `axis_names`, and `shape`, a dict {axis name: size} as in JAX, so
      ``mesh.shape.get('docs', 1)`` reads the same;
    - `ranks`: the process rank that owns each position (all this
      process's by default);
    - `group`: the process group the mesh was laid out over, or None for
      a single-controller mesh. The exchange's collectives run over it.
    """

    def __init__(self, devices, axis_names, ranks=None, group=None):
        flat = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if flat.ndim != len(axis_names):
            raise ValueError(f'FleetMesh: {flat.ndim}-d devices for axes '
                             f'{axis_names}')
        self.devices = np.empty(flat.shape, dtype=object)
        for idx in np.ndindex(flat.shape):
            self.devices[idx] = torch.device(flat[idx])
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, flat.shape))
        self.group = group
        self.ranks = np.full(flat.shape, process_rank(group)) \
            if ranks is None else np.asarray(ranks).reshape(flat.shape)

    @property
    def size(self):
        return int(self.devices.size)

    def device_of(self, pos):
        return self.devices.reshape(-1)[pos]

    def coords(self, pos):
        """{axis name: index} of flat position `pos`."""
        return dict(zip(self.axis_names,
                        np.unravel_index(pos, self.devices.shape)))

    def local_positions(self):
        """The flat positions this process owns, in order."""
        me = process_rank(self.group)
        return [int(p) for p in np.flatnonzero(self.ranks.reshape(-1) == me)]

    def local_devices(self):
        """The distinct devices of this process's positions, in order."""
        out = []
        for p in self.local_positions():
            if self.device_of(p) not in out:
                out.append(self.device_of(p))
        return out

    def __repr__(self):
        devs = ','.join(str(d) for d in self.devices.reshape(-1))
        return f'FleetMesh({self.shape}, [{devs}])'


def fleet_mesh(devices=None, keys_axis=1):
    """Build a (docs, keys) mesh over the devices. With none given, every
    visible CUDA device (it raises where there is none). Under an
    initialised process group every rank passes its own devices (the
    same number on each) and the mesh lays them out rank-major, as
    JAX's global device order puts process 0 first."""
    import torch.distributed as dist
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available; pass devices=[...] '
                               'to build a mesh on the CPU')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    ranks, group = None, None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, [str(d) for d in devices])
        if len({len(p) for p in per_rank}) != 1:
            raise ValueError(f'fleet_mesh: ranks bring unequal numbers of '
                             f'positions: {[len(p) for p in per_rank]}')
        devices = [torch.device(d) for p in per_rank for d in p]
        ranks = [r for r, p in enumerate(per_rank) for _ in p]
    n = len(devices)
    if keys_axis > 1 and n % keys_axis == 0:
        shape = (n // keys_axis, keys_axis)
    else:
        shape = (n, 1)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return FleetMesh(grid.reshape(shape), ('docs', 'keys'),
                     ranks=None if ranks is None
                     else np.reshape(ranks, shape), group=group)


def _as_torch(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class ShardedTensor:
    """A global tensor held as per-position blocks of a `FleetMesh`.

    `spec` names, per dimension, None (not split) or the mesh axis (a
    name, or a tuple of names taken row-major) whose positions split it
    into contiguous ranges of ceil(size / parts). Positions that share a
    block coordinate hold replicas. With `scratch`, a 2-d grid's key
    blocks that do not end the grid carry one trailing scratch column,
    which `gather()` drops. `base`, where set, is one tensor on the
    single device of every block, and the blocks are views of it.
    Positions of other processes hold None."""

    __slots__ = ('mesh', 'spec', 'shape', 'dtype', 'blocks', 'scratch',
                 'base')

    def __init__(self, mesh, spec, shape, dtype, blocks, scratch=False,
                 base=None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = list(blocks)
        self.scratch = scratch
        self.base = base

    def _parts(self, names):
        names = (names,) if isinstance(names, str) else names
        return names, int(np.prod([self.mesh.shape[a] for a in names]))

    def block_key(self, pos):
        """The block coordinate of position `pos`: per split dim, its
        block index."""
        coords = self.mesh.coords(pos)
        key = []
        for names in self.spec:
            if names is None:
                key.append(0)
                continue
            names, _ = self._parts(names)
            idx = 0
            for a in names:
                idx = idx * self.mesh.shape[a] + int(coords[a])
            key.append(idx)
        return tuple(key)

    def ranges(self, pos):
        """Per dim, the [lo, hi) of the global tensor position `pos`
        holds."""
        out = []
        for dim, (names, idx) in enumerate(zip(self.spec,
                                               self.block_key(pos))):
            size = self.shape[dim]
            if names is None:
                out.append((0, size))
                continue
            chunk = -(-size // self._parts(names)[1])
            out.append((min(idx * chunk, size),
                        min((idx + 1) * chunk, size)))
        return out

    def padded(self, pos):
        """Does position `pos`'s block carry a trailing scratch column?"""
        return self.scratch and self.ranges(pos)[1][1] < self.shape[1]

    @classmethod
    def put(cls, x, mesh, spec, scratch=False):
        """Place `x` (a torch tensor or numpy array) on the mesh by
        `spec`: the counterpart of ``jax.device_put(x, NamedSharding(mesh,
        P(*spec)))``. The blocks are copies of `x`."""
        x = _as_torch(x)
        spec = tuple(spec) + (None,) * (x.dim() - len(spec))
        out = cls(mesh, spec, x.shape, x.dtype, [None] * mesh.size, scratch)
        local = mesh.local_positions()
        devs = mesh.local_devices()
        if len(devs) == 1:
            base = torch.empty(x.shape, dtype=x.dtype, device=devs[0])
            base.copy_(x)
            out.base = base
            for p in local:
                out.blocks[p] = out._block_of(base, p)
            if not all(_is_view_of(out.blocks[p], base) for p in local):
                out.base = None
            return out
        made = {}
        for p in local:
            dev = mesh.device_of(p)
            key = (out.block_key(p), dev)
            if key not in made:
                made[key] = out._block_of(x, p, dev)
            out.blocks[p] = made[key]
        return out

    def _block_of(self, x, pos, device=None):
        """Position `pos`'s block cut from the global tensor `x` (a view
        where it can be one and needs no scratch column)."""
        view = x[tuple(slice(lo, hi) for lo, hi in self.ranges(pos))]
        if device is not None:
            view = view.to(device)
        if self.padded(pos):
            block = torch.zeros((view.shape[0], view.shape[1] + 1),
                                dtype=view.dtype, device=view.device)
            block[:, :-1] = view
            return block
        return view if view.is_contiguous() else view.contiguous()

    def with_blocks(self, blocks):
        """A ShardedTensor of the same layout over new blocks (which own
        their memory)."""
        return ShardedTensor(self.mesh, self.spec, self.shape, self.dtype,
                             blocks, self.scratch)

    def gather(self, device=None):
        """The global tensor, on `device` (by default the device of this
        process's first position). Every position must be local."""
        if self.base is not None and (device is None or _names(
                torch.device(device), self.base.device)):
            return self.base
        if device is None:
            device = self.mesh.device_of(self.mesh.local_positions()[0])
        device = torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for p, block in enumerate(self.blocks):
            if block is None:
                raise ValueError('ShardedTensor.gather: position '
                                 f'{p} belongs to another process')
            key = self.block_key(p)
            if key in seen:
                continue
            seen.add(key)
            if self.padded(p):
                block = block[:, :-1]
            out[tuple(slice(lo, hi) for lo, hi in self.ranges(p))] = \
                block.to(device)
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.gather().detach().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self):
        return (f'ShardedTensor({list(self.shape)}, {self.dtype}, '
                f'spec={self.spec})')


def _names(device, actual):
    """Does `device` (which may leave out its index) name the device
    `actual` a tensor is on?"""
    return device.type == actual.type and device.index in (None,
                                                           actual.index)


def _is_view_of(block, base):
    """Does `block` share `base`'s storage?"""
    return block.untyped_storage().data_ptr() == \
        base.untyped_storage().data_ptr()


def _global_sum(mesh, parts):
    """The sum of this process's per-block counts (0-d tensors), as a
    0-d int32 tensor on the first block's device, all-reduced over the
    mesh's process group where it has one (the reference's psum)."""
    total = None
    for part in parts:
        total = part.to(torch.int32) if total is None \
            else total + part.to(device=total.device, dtype=torch.int32)
    if total is None:
        total = torch.zeros((), dtype=torch.int32)
    if mesh.group is not None:
        import torch.distributed as dist
        wire = _wire_device(mesh)
        reduced = total.reshape(1).to(wire)
        dist.all_reduce(reduced, group=mesh.group)
        total = reduced[0].to(total.device)
    return total


def _wire_device(mesh):
    """Where the collectives' tensors live: the card of this process's
    first position under NCCL, else the CPU (gloo)."""
    import torch.distributed as dist
    if dist.get_backend(mesh.group) == 'nccl':
        return mesh.device_of(mesh.local_positions()[0])
    return torch.device('cpu')


def _card(tensors):
    return any(t is not None and t.device.type == 'cuda' for t in tensors)


def fleet_sharding(mesh):
    """The specs of FleetState ([docs, keys] grids) and OpBatch ([docs,
    ops] columns, replicated over the keys axis)."""
    return ('docs', 'keys'), ('docs', None)


def shard_fleet(state, mesh):
    state_spec, _ = fleet_sharding(mesh)
    return FleetState(*(ShardedTensor.put(x, mesh, state_spec, scratch=True)
                        for x in state.tensors()))


def shard_ops(ops, mesh):
    _, ops_spec = fleet_sharding(mesh)
    return OpBatch(*(ShardedTensor.put(x, mesh, ops_spec)
                     for x in ops.columns()))


def seq_sharding(mesh):
    """Specs for SeqState / SeqOpBatch, data-parallel over the docs axis
    only — the per-doc slot axis stays local (the RGA pointer walk is a
    per-document scan). Arrays pick their spec by rank: [docs] vectors,
    [docs, slots] node arrays, [docs, slots, lanes] register/pred-lane
    arrays."""
    return {1: ('docs',), 2: ('docs', None), 3: ('docs', None, None)}


def _place(obj, mesh, by_ndim):
    """`obj` (a state or op batch) with every tensor placed on the mesh
    by its rank's spec."""
    parts = obj.tensors() if hasattr(obj, 'tensors') else obj.columns()
    placed = []
    for x in parts:
        x = _as_torch(x)
        placed.append(ShardedTensor.put(x, mesh, by_ndim[x.dim()]))
    return type(obj)(*placed)


def shard_seq(state, mesh):
    return _place(state, mesh, seq_sharding(mesh))


def shard_seq_ops(ops, mesh):
    return _place(ops, mesh, seq_sharding(mesh))


def _per_block(mesh, lead, run):
    """Call run(pos) -> tuple of result blocks once per distinct block
    coordinate of `lead` (a ShardedTensor) among this process's
    positions; replicas on another device get a copy. Returns {pos:
    result blocks}."""
    done, out = {}, {}
    for p in mesh.local_positions():
        key = lead.block_key(p)
        dev = mesh.device_of(p)
        if key not in done:
            done[key] = run(p)
        res = done[key]
        if res[0].device != dev:
            res = tuple(t.to(dev) for t in res)
        out[p] = res
    return out


def _sharded_apply(mesh, state, ops):
    """apply_op_batch over grids split P('docs', 'keys') and ops split
    P('docs', None): one merge per block on the block's device, each
    block's valid lanes masked to its key range; the stats a global
    sum. The input state is left intact."""
    k1 = state.winners.shape[1]
    stats = {}

    def run(p):
        lo, hi = state.winners.ranges(p)[1]
        block = FleetState(*(t.blocks[p].clone() for t in state.tensors()))
        cols = [c.blocks[p] for c in ops.columns()]
        if (lo, hi) != (0, k1):
            key, valid = cols[0], cols[5]
            inside = (key >= lo) & (key < hi)
            if lo == 0:
                inside |= (key < 0) | (key >= k1)
            cols[0], cols[5] = key - lo, valid & inside
        _, stats[p] = apply._apply_op_batch_donated(block, OpBatch(*cols))
        return block.tensors()

    blocks = _per_block(mesh, state.winners, run)
    if _card([b[0] for b in blocks.values()]):
        LAUNCHES.inc('sharded_apply')
    new = FleetState(*(t.with_blocks([blocks[p][i] if p in blocks else None
                                      for p in range(mesh.size)])
                       for i, t in enumerate(state.tensors())))
    return new, _global_sum(mesh, stats.values())


def _sharded_seq_apply(mesh, state, ops):
    """The sequence apply, data-parallel over docs: one scan per docs
    block on the block's device. The input state is left intact."""
    stats = {}

    def run(p):
        block = sequence.SeqState(*(t.blocks[p].clone()
                                    for t in state.tensors()))
        batch = sequence.SeqOpBatch(*(c.blocks[p] for c in ops.columns()))
        _, stats[p] = sequence._apply_seq_batch_donated(block, batch)
        return block.tensors()

    blocks = _per_block(mesh, state.elem_id, run)
    if _card([b[0] for b in blocks.values()]):
        LAUNCHES.inc('sharded_seq_apply')
    new = sequence.SeqState(*(
        t.with_blocks([blocks[p][i] if p in blocks else None
                       for p in range(mesh.size)])
        for i, t in enumerate(state.tensors())))
    return new, _global_sum(mesh, stats.values())


def long_seq_sharding(mesh):
    """Specs for the LONG-document regime: a handful of very long
    sequences whose slot axis stripes over every position of the mesh
    (the CRDT analogue of sequence/context parallelism, SURVEY.md
    §2.12/§5 — the document is too long for one chip's memory/bandwidth,
    so its element slots, pointers, and values stripe over the whole
    mesh). [D] vectors are replicated."""
    every_axis = mesh.axis_names
    return {1: (), 2: (None, every_axis), 3: (None, every_axis, None)}


def shard_long_seq(state, mesh):
    """Stripe a long-document SeqState's node axis over the whole mesh,
    tail-padding to a position-count multiple first (safe because
    sentinels are front-anchored and padded tail slots read as
    unallocated: elem_id 0, nxt END, killed False)."""
    from .sequence import END, SeqState
    by_ndim = long_seq_sharding(mesh)
    size = state.elem_id.shape[1]
    pad = (-size) % mesh.size

    def padded(x, fill):
        x = _as_torch(x)
        if pad == 0:
            return x
        shape = (x.shape[0], size + pad) + tuple(x.shape[2:])
        out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        out[:, :size] = x
        return out

    return SeqState(*(
        ShardedTensor.put(arr, mesh, by_ndim[arr.dim()]) for arr in (
            padded(state.elem_id, 0), padded(state.nxt, END),
            padded(state.reg, 0), padded(state.killed, False),
            padded(state.val, 0), padded(state.counter, 0),
            _as_torch(state.n), _as_torch(state.inexact))))


def _restripe(mesh, x, spec):
    """A whole tensor striped again by `spec` (views on one device)."""
    return ShardedTensor.put(x, mesh, spec) if len(mesh.local_devices()) \
        > 1 else _views(mesh, x, spec)


def _views(mesh, x, spec):
    """`x` as a ShardedTensor whose blocks are views of it (one device)."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    out = ShardedTensor(mesh, spec, x.shape, x.dtype, [None] * mesh.size,
                        base=x)
    for p in mesh.local_positions():
        out.blocks[p] = out._block_of(x, p)
    return out


def _sharded_long_seq_apply(mesh, state, ops):
    """The sequence apply for slot-striped long documents: gather the
    stripes (no copy on one device), one scan over the whole rows, then
    stripe again. The input state is left intact."""
    by_ndim = long_seq_sharding(mesh)
    whole = sequence.SeqState(*(t.gather().clone() for t in state.tensors()))
    dev = whole.elem_id.device
    batch = sequence.SeqOpBatch(*(
        c.gather() if isinstance(c, ShardedTensor) else c
        for c in ops.columns())).to(dev)
    _, applied = sequence._apply_seq_batch_donated(whole, batch)
    if dev.type == 'cuda':
        LAUNCHES.inc('sharded_long_seq_apply')
    return sequence.SeqState(*(_restripe(mesh, t, by_ndim[t.dim()])
                               for t in whole.tensors())), applied


def _sharded_long_seq_materialize(mesh, state):
    """Sequence-order extraction for slot-striped long documents:
    pointer-doubling list ranking (Wyllie's algorithm, ceil(log2 S)
    rounds of gathers) over the gathered stripes, the outputs striped
    again over the slot axis."""
    whole = sequence.SeqState(*(t.gather() for t in state.tensors()))
    vals, cnts, vis, n = sequence._materialize(whole)
    if vals.device.type == 'cuda':
        LAUNCHES.inc('sharded_long_seq_materialize')
    slots = long_seq_sharding(mesh)[2]
    return (_restripe(mesh, vals, slots), _restripe(mesh, cnts, slots),
            _restripe(mesh, vis, slots), n)


_sharded_apply_k = instrument_kernel('sharded_apply', _sharded_apply)
_sharded_seq_apply_k = instrument_kernel('sharded_seq_apply',
                                         _sharded_seq_apply)
_sharded_long_seq_apply_k = instrument_kernel('sharded_long_seq_apply',
                                              _sharded_long_seq_apply)
_sharded_long_seq_materialize_k = instrument_kernel(
    'sharded_long_seq_materialize', _sharded_long_seq_materialize)


def sharded_apply(mesh):
    """The fleet step over a (docs, keys) mesh: data-parallel over docs,
    the key grid split over the second axis, the stats a global sum.
    Returns step(state, ops) -> (new_state, stats)."""
    def step(state, ops):
        return _sharded_apply_k(mesh, state, ops)
    step.kernel_kind = 'sharded_apply'
    return step


def sharded_seq_apply(mesh):
    """The sequence-fleet step, data-parallel over docs."""
    def step(state, ops):
        return _sharded_seq_apply_k(mesh, state, ops)
    step.kernel_kind = 'sharded_seq_apply'
    return step


def sharded_long_seq_apply(mesh):
    """Op application for slot-striped long documents. Causality keeps
    the op stream itself sequential — the win is that the document's
    state never has to fit one device."""
    def step(state, ops):
        return _sharded_long_seq_apply_k(mesh, state, ops)
    step.kernel_kind = 'sharded_long_seq_apply'
    return step


def sharded_long_seq_materialize(mesh):
    """Sequence-order extraction for slot-striped long documents."""
    def run(state):
        return _sharded_long_seq_materialize_k(mesh, state)
    run.kernel_kind = 'sharded_long_seq_materialize'
    return run
