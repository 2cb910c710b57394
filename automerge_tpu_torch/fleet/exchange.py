"""Cross-shard change exchange: sync-protocol payload routing (torch).

The torch port of automerge_tpu/fleet/exchange.py. `pack_outboxes`,
`unpack_inbox`, `sync_round_sharded`, `_pairwise_callbacks`,
`drive_pairwise_sync` and `drive_pairwise_sync_multihost` are copies;
the device calls change:

- `exchange_changes` on a single-controller mesh (fleet/sharding.py
  `FleetMesh` with no process group) delivers inbox[j, i] = outbox[i, j]:
  one transpose where the positions share a device, peer copies where
  they do not. On a mesh laid out over a process group it is one
  `torch.distributed.all_to_all_single` of this process's outbox rows
  (and one of their lengths), over gloo on the CPU or NCCL on the card.
- `local_shard_ids` reads the process rank from torch.distributed (0
  without a process group).
- `_sync_round_multihost`'s agreement round is one `all_gather` of an
  int64 [2] tensor (local without a process group); the payload rows it
  packs are this process's own, and so are the inbox rows it reads.

`exchange_changes` is wrapped for the kernel cost ledger under the
reference's kind, `exchange_all_to_all`; `LAUNCHES` counts the
exchanges whose payload moved on the card. The reference's description
follows.

The reference's sync protocol is transport-agnostic byte messages
(backend/sync.js; SURVEY.md §2.11) — the application moves them. When the
document fleet itself is sharded across devices/hosts, peer reconciliation
between shards becomes a bulk payload movement problem, and the idiomatic
TPU transport is an XLA collective riding ICI rather than a host-side mesh
of sockets: every shard contributes, for every other shard, the concatenated
change buffers (or sync messages) destined there, and one `all_to_all`
delivers every shard its inbox in a single collective (SURVEY.md §5
"per-peer change exchange becomes an all-to-all of change buffers").

Payloads are ragged bytes; they ride as a padded uint8 tensor
[n_shards_out, max_len] per shard with a length vector. The collective
moves bytes only — hashing/causal gating stays host-side per shard, exactly
like the reference's split between transport and protocol.
"""

import time

import numpy as np
import torch

from ..errors import SyncOverflow
from ..observability import register_health_source
from ..observability.metrics import Counters
from ..observability import hist as _hist
from ..observability import recorder as _flight
from ..observability.perf import instrument_kernel
from ..observability.spans import span as _span
from .sharding import ShardedTensor, _views, _wire_device, process_rank

# Counters: the exchanges whose payload moved on the card
LAUNCHES = Counters({'exchange_all_to_all': 0})

# Fault-containment roll-up: extra sub-rounds paid to move over-limit sync
# payloads through the fixed-width wire (sync_round_multihost chunking).
_sync_stats = Counters({'sync_retries': 0})
register_health_source('sync_retries', lambda: _sync_stats['sync_retries'])


def pack_outboxes(per_dest_payloads, max_len=None):
    """per_dest_payloads: list over destination shards of bytes objects
    (b'' for none). Returns (data uint8 [n_dest, max_len], lens int32)."""
    n = len(per_dest_payloads)
    max_len = max_len if max_len is not None else \
        max((len(p) for p in per_dest_payloads), default=0)
    max_len = max(max_len, 1)
    data = np.zeros((n, max_len), dtype=np.uint8)
    lens = np.zeros((n,), dtype=np.int32)
    for d, payload in enumerate(per_dest_payloads):
        buf = np.frombuffer(bytes(payload), dtype=np.uint8)
        data[d, :len(buf)] = buf
        lens[d] = len(buf)
    return data, lens


def unpack_inbox(data, lens):
    """Inverse of pack_outboxes after the exchange: list over source shards
    of bytes."""
    data = np.asarray(data)
    lens = np.asarray(lens)
    return [data[s, :int(lens[s])].tobytes() for s in range(data.shape[0])]


def _exchange_changes(mesh, axis, all_outboxes, all_lens):
    """One round of shard-to-shard payload delivery.

    all_outboxes: [n_shards, n_shards, L] uint8, where row i column j holds
    shard i's payload for shard j. Returns (inboxes [n_shards, n_shards,
    L], in_lens) where row j column i is the payload shard j received
    from shard i, as ShardedTensors over `axis` (``np.asarray`` gathers
    them) — one transpose (or peer copies) plus the matching length
    exchange. On a mesh laid out over a process group, all_outboxes /
    all_lens are this process's rows only (its positions along `axis`,
    in order) and so are the returned inbox rows, [k, n, L] / [k, n]
    tensors: one all_to_all_single each."""
    if mesh.group is not None:
        return _all_to_all(mesh, all_outboxes, all_lens)
    out = (_transpose(mesh, axis, all_outboxes),
           _transpose(mesh, axis, all_lens))
    if out[0].blocks[mesh.local_positions()[0]].device.type == 'cuda':
        LAUNCHES.inc('exchange_all_to_all')
    return out


def _transpose(mesh, axis, x):
    """x [n, n, ...] placed by rows over `axis` and delivered: row j of
    the result holds column j of every row."""
    src = ShardedTensor.put(torch.as_tensor(x), mesh, (axis,))
    if src.base is not None:
        # one device: one transpose, the rows views of it
        return _views(mesh, src.base.transpose(0, 1).contiguous(), (axis,))
    # across devices: row j gathers column j of every source row from
    # its device (peer copies)
    blocks, rows = [None] * mesh.size, {}
    for p in mesh.local_positions():
        j, dev = src.ranges(p)[0][0], mesh.device_of(p)
        if (j, dev) not in rows:
            rows[(j, dev)] = torch.stack([
                src.blocks[q][0, j].to(dev)
                for q in _row_owners(src, mesh)])[None]
        blocks[p] = rows[(j, dev)]
    return src.with_blocks(blocks)


def _row_owners(sharded, mesh):
    """One local position holding each row of `sharded`, in row order."""
    owners = {}
    for p in mesh.local_positions():
        owners.setdefault(sharded.ranges(p)[0][0], p)
    return [owners[r] for r in sorted(owners)]


def _all_to_all(mesh, rows, lens):
    """Multi-controller exchange: this process's k outbox rows [k, n, L]
    (and lengths [k, n]) for its k positions, n = ranks x k. The rows are
    permuted by destination rank so each rank's share is one equal split
    of one all_to_all_single; the inbox rows come back [k, n, L]."""
    import torch.distributed as dist
    wire = _wire_device(mesh)
    ranks = dist.get_world_size(mesh.group)
    rows = torch.as_tensor(rows).to(wire)
    lens = torch.as_tensor(lens).to(wire)
    k, n = lens.shape
    if n != ranks * k:
        raise ValueError(f'exchange: {k} local rows of {n} shards over '
                         f'{ranks} ranks')
    out = []
    for t in (rows, lens):
        tail = tuple(t.shape[2:])
        send = t.reshape((k, ranks, k) + tail).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
        # recv[s, a, b] = rank s's source a -> my destination b
        out.append(recv.permute((2, 0, 1) + tuple(range(3, t.dim() + 1)))
                   .reshape((k, n) + tail))
    if wire.type == 'cuda':
        LAUNCHES.inc('exchange_all_to_all')
    return out[0], out[1]


exchange_changes = instrument_kernel('exchange_all_to_all',
                                     _exchange_changes)


def sync_round_sharded(mesh, axis, backends, sync_states, generate, receive):
    """Drive one full sync round between every ordered pair of shards, with
    message transport on the device mesh: each shard generates its per-peer
    sync messages host-side (`generate(src, dst) -> bytes | None`), the
    payload matrix rides ONE all_to_all, and `receive(dst, src, payload)`
    applies what arrived. Returns the number of non-empty payloads moved."""
    n = mesh.shape[axis]
    row_fn = getattr(generate, 'row', None)
    rows, row_lens = [], []
    for src in range(n):
        if row_fn is not None:
            # one batched generate per shard (single Bloom build +
            # frontier-index membership dispatch) instead of one per
            # ordered pair — byte-identical messages either way
            payloads = [m or b'' for m in row_fn(src, range(n))]
        else:
            payloads = [(generate(src, dst) or b'') if dst != src
                        else b'' for dst in range(n)]
        data, lens = pack_outboxes(payloads)
        rows.append(data)
        row_lens.append(lens)
    width = max(r.shape[1] for r in rows)
    outboxes = np.zeros((n, n, width), dtype=np.uint8)
    lens = np.zeros((n, n), dtype=np.int32)
    for src in range(n):
        outboxes[src, :, :rows[src].shape[1]] = rows[src]
        lens[src] = row_lens[src]

    inboxes, in_lens = exchange_changes(mesh, axis, outboxes, lens)
    inboxes = np.asarray(inboxes)
    in_lens = np.asarray(in_lens)

    items = []
    for dst in range(n):
        for src in range(n):
            length = int(in_lens[dst, src])
            if length:
                items.append((dst, src,
                              inboxes[dst, src, :length].tobytes()))
    all_fn = getattr(receive, 'all', None)
    if all_fn is not None:
        # fused receive waves (see _pairwise_callbacks.receive_all):
        # O(max inbox depth) driver calls per round instead of O(pairs)
        all_fn(items)
    else:
        for dst, src, payload in items:
            receive(dst, src, payload)
    return len(items)


def _pairwise_callbacks(docs, sync_states, backend_module, device=None):
    """(generate, receive) closures over a docs container (list indexed by
    shard, or dict keyed by global shard id) and per-ordered-pair sync
    states — THE sync-state handshake, shared by the single-controller
    and multi-controller drivers so it cannot drift between them.

    ``generate.row(src, dsts)`` produces ALL of src's outgoing messages
    for one round through the batched fleet driver when the backend
    module is the fleet (ONE Bloom build + ONE frontier-index membership
    dispatch per shard instead of one of each per ordered pair — the
    per-peer scan the round used to pay); byte-identical to the per-pair
    calls (the driver's differential tests pin it), and host backend
    modules simply take the per-pair path. `device` places the batched
    generate's Bloom dispatches (the drivers pass the mesh's device)."""

    def generate(src, dst):
        state, msg = backend_module.generate_sync_message(
            docs[src], sync_states[(src, dst)])
        sync_states[(src, dst)] = state
        return msg

    # batch through the fleet driver ONLY when the module's generate IS
    # the canonical protocol (host Backend and fleet.backend both
    # re-export it; a third-party backend module keeps per-pair calls)
    from ..backend.sync import generate_sync_message as _canonical
    if getattr(backend_module, 'generate_sync_message', None) \
            is _canonical:
        from .sync_driver import generate_sync_messages_docs as \
            batched_gen
    else:
        batched_gen = None

    def generate_row(src, dsts):
        if batched_gen is None:
            return [generate(src, dst) if dst != src else None
                    for dst in dsts]
        peers = [dst for dst in dsts if dst != src]
        new_states, msgs = batched_gen(
            [docs[src]] * len(peers),
            [sync_states[(src, dst)] for dst in peers], device=device)
        for dst, state in zip(peers, new_states):
            sync_states[(src, dst)] = state
        by_dst = dict(zip(peers, msgs))
        return [by_dst.get(dst) for dst in dsts]

    generate.row = generate_row

    def receive(dst, src, payload):
        doc, state, _patch = backend_module.receive_sync_message(
            docs[dst], sync_states[(dst, src)], payload)
        docs[dst] = doc
        sync_states[(dst, src)] = state

    from ..backend.sync import receive_sync_message as _canonical_recv
    if getattr(backend_module, 'receive_sync_message', None) \
            is _canonical_recv:
        from .sync_driver import receive_sync_messages_docs as \
            batched_recv
    else:
        batched_recv = None

    def receive_all(items):
        """Apply a whole round's inbound (dst, src, payload) triples in
        fused WAVES: wave k carries each destination's k-th message, so
        every wave is one batched receive over DISTINCT dst docs — the
        per-(dst, src) stream order the sharedHeads algebra depends on
        is preserved, wire behavior byte-identical to the per-pair
        loop, and a round costs O(max inbox depth) fused driver calls
        instead of O(pairs)."""
        if batched_recv is None:
            for dst, src, payload in items:
                receive(dst, src, payload)
            return
        queues = {}
        for dst, src, payload in items:
            queues.setdefault(dst, []).append((src, payload))
        while queues:
            wave = [(dst, q.pop(0)) for dst, q in queues.items()]
            new_docs, new_states, _patches = batched_recv(
                [docs[dst] for dst, _ in wave],
                [sync_states[(dst, src)] for dst, (src, _p) in wave],
                [payload for _dst, (_src, payload) in wave])
            for (dst, (src, _p)), doc, state in zip(wave, new_docs,
                                                    new_states):
                docs[dst] = doc
                sync_states[(dst, src)] = state
            queues = {d: q for d, q in queues.items() if q}

    receive.all = receive_all

    return generate, receive


def drive_pairwise_sync(mesh, axis, docs, backend_module, max_rounds=None):
    """Converge every ordered pair of shard documents with the mesh as the
    wire: per-pair sync states on host, one all_to_all per round, until a
    round moves nothing (the sync_test.js driver loop, shard-to-shard).
    `backend_module` supplies init_sync_state / generate_sync_message /
    receive_sync_message (host backend or fleet backend — both satisfy the
    Backend contract). Mutates `docs` in place; returns the round count."""
    n = mesh.shape[axis]
    sync_states = {(i, j): backend_module.init_sync_state()
                   for i in range(n) for j in range(n) if i != j}
    generate, receive = _pairwise_callbacks(docs, sync_states,
                                            backend_module,
                                            _sync_device(mesh))
    rounds = 0
    for _ in range(max_rounds if max_rounds is not None else 2 * n):
        rounds += 1
        if sync_round_sharded(mesh, axis, docs, sync_states,
                              generate, receive) == 0:
            break
    return rounds


def local_shard_ids(mesh, axis):
    """Global positions along `axis` owned by THIS process — the shards
    whose documents a multi-controller host holds. Mesh axes other than
    `axis` must be absent or size 1 for the pairwise sync drivers."""
    devs = np.asarray(mesh.devices).reshape(-1)
    if len(devs) != mesh.shape[axis]:
        raise ValueError(
            f'pairwise sync needs a 1-axis mesh: {len(devs)} devices but '
            f'axis {axis!r} spans {mesh.shape[axis]}')
    me = process_rank(mesh.group)
    return [int(i) for i, r in enumerate(mesh.ranks.reshape(-1))
            if r == me]


def sync_round_multihost(mesh, axis, generate, receive, max_msg=1 << 16,
                         max_chunks=64):
    """One pairwise sync round over a MULTI-PROCESS mesh (true multi-host:
    each controller holds only its local shards' documents, the payload
    matrix rides the same all_to_all — ICI within a host, DCN across
    hosts, exactly where the reference hands messages to NCCL/MPI-style
    transports). `generate(src, dst) -> bytes | None` and
    `receive(dst, src, payload)` are called ONLY for src/dst shards local
    to this process. Payloads are padded to `max_msg` bytes (a fixed
    global width keeps every controller's data shapes identical without a
    per-round width negotiation).

    Graceful degradation: a payload larger than `max_msg` no longer kills
    the round — the round splits into ceil(global_max / max_msg)
    fixed-width SUB-ROUNDS, sub-round t carrying every payload's bytes
    [t*max_msg, (t+1)*max_msg); receivers reassemble and deliver each
    payload once complete. Every controller derives the same sub-round
    count from the agreement allgather's global max, so the collectives
    stay SPMD-lock-step with no extra negotiation, and a normal-size
    round still pays exactly one all_to_all. The extra sub-rounds land in
    the 'sync_retries' health counter. Only a payload beyond
    max_msg * max_chunks raises — a typed `SyncOverflow` carrying
    (global_max, max_msg, max_chunks, locally-determinable offending
    pairs), raised identically on every controller (the condition is a
    function of allgathered values alone), so no peer is left blocking
    inside the collective. Returns the round's GLOBAL non-empty payload
    count — identical on every controller, so callers can branch on it
    without desyncing; an all-empty round returns 0 without paying the
    padded all_to_all."""
    round_start = time.perf_counter() if _hist.on() else None
    with _span('sync_round', max_msg=max_msg):
        result = _sync_round_multihost(mesh, axis, generate, receive,
                                       max_msg, max_chunks)
    if round_start is not None:
        _hist.record_value('sync_round_s', time.perf_counter() - round_start,
                           scale=1e9, unit='s')
    return result


def _sync_round_multihost(mesh, axis, generate, receive, max_msg,
                          max_chunks):
    n = mesh.shape[axis]
    mine = local_shard_ids(mesh, axis)
    row_fn = getattr(generate, 'row', None)
    per_src = []
    biggest = sent = 0
    for src in mine:
        if row_fn is not None:
            payloads = [m or b'' for m in row_fn(src, range(n))]
        else:
            payloads = [generate(src, dst) or b'' if dst != src else b''
                        for dst in range(n)]
        biggest = max(biggest, max(map(len, payloads)))
        sent += sum(1 for p in payloads if p)
        per_src.append(payloads)
    # SPMD-safe agreement round: every controller sees the global max
    # payload size (identical overflow/chunking decisions everywhere,
    # never deadlocking peers inside the collective) and the global sent
    # count (an all-empty round returns 0 everywhere WITHOUT paying the
    # padded all_to_all — the lock-step convergence signal).
    agg = _allgather(mesh, np.array([biggest, sent], dtype=np.int64))
    global_max, global_sent = int(agg[:, 0].max()), int(agg[:, 1].sum())
    hard_limit = max_msg * max_chunks
    if global_max > hard_limit:
        pairs = [(src, dst)
                 for src, payloads in zip(mine, per_src)
                 for dst, p in enumerate(payloads) if len(p) > hard_limit]
        # forensic dump before the (SPMD-identical) raise: the overflow
        # aborts the round on every controller, so record what this one
        # saw — sizes, limits, and its locally-observed offending pairs
        _flight.record_event('sync_overflow', global_max=global_max,
                             max_msg=max_msg, max_chunks=max_chunks,
                             pairs=pairs[:16])
        _flight.dump_flight_record('sync_overflow', detail={
            'global_max': global_max, 'max_msg': max_msg,
            'max_chunks': max_chunks, 'hard_limit': hard_limit,
            'local_pairs': pairs[:64]})
        raise SyncOverflow(
            f'sync message {global_max}B exceeds max_msg={max_msg} x '
            f'max_chunks={max_chunks}', global_max=global_max,
            max_msg=max_msg, max_chunks=max_chunks, pairs=pairs)
    if global_sent == 0:
        return 0
    n_sub = -(-global_max // max_msg) if global_max else 1
    if n_sub > 1:
        _sync_stats.inc('sync_retries', n_sub - 1)
    inbox_acc = {}        # (dst, src) -> bytearray of reassembled fragments
    for t in range(n_sub):
        lo = t * max_msg
        rows = np.zeros((len(mine), n, max_msg), dtype=np.uint8)
        lens = np.zeros((len(mine), n), dtype=np.int32)
        for r, payloads in enumerate(per_src):
            rows[r], lens[r] = pack_outboxes(
                [p[lo:lo + max_msg] for p in payloads], max_len=max_msg)
        inboxes, in_lens = exchange_changes(mesh, axis, rows, lens)
        inboxes, in_lens = _local_rows(mesh, mine, inboxes, in_lens)
        for r, dst in enumerate(mine):
            for src, fragment in enumerate(unpack_inbox(inboxes[r],
                                                        in_lens[r])):
                if fragment:
                    inbox_acc.setdefault((dst, src),
                                         bytearray()).extend(fragment)
    items = [(dst, src, bytes(payload))
             for (dst, src), payload in inbox_acc.items()]
    all_fn = getattr(receive, 'all', None)
    if all_fn is not None:
        all_fn(items)
    else:
        for dst, src, payload in items:
            receive(dst, src, payload)
    # the GLOBAL count, identical on every controller: callers may branch
    # on it (the driver's lock-step break) — a process-local count here
    # would desync the round loops and deadlock the next collective
    return global_sent


def _sync_device(mesh):
    """The device of a round's batched Bloom dispatches: this process's
    first mesh position's (the transport's device)."""
    return mesh.device_of(mesh.local_positions()[0])


def _allgather(mesh, local):
    """Every process's int64 [2] `local`, stacked [ranks, 2] (local alone
    on a mesh without a process group)."""
    if mesh.group is None:
        return local.reshape(1, -1)
    import torch.distributed as dist
    wire = _wire_device(mesh)
    mine = torch.from_numpy(local).to(wire)
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.stack(parts).cpu().numpy()


def _local_rows(mesh, mine, inboxes, in_lens):
    """This process's inbox rows (in the order of `mine`) as numpy
    arrays: the whole matrix's rows on a single-controller mesh, the
    exchange's own rows on a process group's."""
    if isinstance(inboxes, ShardedTensor):
        return np.asarray(inboxes)[mine], np.asarray(in_lens)[mine]
    return inboxes.cpu().numpy(), in_lens.cpu().numpy()


def drive_pairwise_sync_multihost(mesh, axis, local_docs, backend_module,
                                  max_rounds=None, max_msg=1 << 16,
                                  max_chunks=64):
    """drive_pairwise_sync for a multi-controller mesh: `local_docs` maps
    THIS process's global shard id -> backend doc. Every controller runs
    the same round loop, and each round's agreement allgather carries the
    global sent count, so all controllers break in lock-step as soon as a
    round generates nothing anywhere (an empty round costs only the tiny
    allgather, never the padded all_to_all). Mutates local_docs; returns
    the round count."""
    n = mesh.shape[axis]
    states = {(i, j): backend_module.init_sync_state()
              for i in local_docs for j in range(n) if i != j}
    generate, receive = _pairwise_callbacks(local_docs, states,
                                            backend_module,
                                            _sync_device(mesh))
    rounds = 0
    for _ in range(max_rounds if max_rounds is not None else 2 * n):
        rounds += 1
        if sync_round_multihost(mesh, axis, generate, receive,
                                max_msg=max_msg,
                                max_chunks=max_chunks) == 0:
            break
    return rounds
