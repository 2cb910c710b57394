"""Differential tests of the cross-shard sync transport
(fleet/exchange.py): the six tests of tests/test_exchange.py, each run
through the JAX package (8-device virtual CPU mesh) and the port (a
FleetMesh of CPU positions) and compared — inboxes, round counts, heads,
reads, save() bytes, the sync_retries increment and SyncOverflow's
fields — plus the multi-controller path (all_gather + all_to_all_single)
over a world-size-1 gloo group in this process."""

import os
import socket

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import automerge_tpu.native as jax_native
from automerge_tpu import backend as JBackend
from automerge_tpu.columnar import encode_change
from automerge_tpu.errors import SyncOverflow as JSyncOverflow
from automerge_tpu.fleet import backend as jax_fleet_backend
from automerge_tpu.fleet import exchange as jex
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch import backend as TBackend
from automerge_tpu_torch.errors import SyncOverflow as TSyncOverflow
from automerge_tpu_torch.fleet import backend as torch_fleet_backend
from automerge_tpu_torch.fleet import exchange as tex
from automerge_tpu_torch.fleet import sharding as tsh

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

N_SHARDS = 4


def _change(i):
    return encode_change({
        'actor': f'{i:02x}' * 16, 'seq': 1, 'startOp': 1, 'time': 0,
        'deps': [], 'ops': [{'action': 'set', 'obj': '_root',
                             'key': f'k{i}', 'value': i,
                             'datatype': 'int', 'pred': []}]})


def seed_backend(backend, i):
    """One host backend holding shard i's private change (key ki=i)."""
    b = backend.init()
    b, _ = backend.apply_changes(b, [_change(i)])
    return b


def _meshes(devices=('cpu',)):
    """The reference's 4-shard mesh and the port's; positions alternating
    over two device objects that both name the CPU take the port's peer
    copies, the code path of a mesh over several cards."""
    return (Mesh(np.array(jax.devices()[:N_SHARDS]), ('peers',)),
            tsh.FleetMesh([devices[i % len(devices)]
                           for i in range(N_SHARDS)], ('peers',)))


PKGS = (('ref', jex, JBackend), ('port', tex, TBackend))


@pytest.mark.parametrize('devices', [('cpu',), ('cpu', 'cpu:0')],
                         ids=['one-device', 'two-devices'])
def test_all_to_all_transpose(devices):
    """Shard i's payload-for-j arrives as shard j's payload-from-i, in
    both packages, byte for byte."""
    payload = lambda i, j: bytes(f'msg {i}->{j}', 'ascii') * (i + j + 1)
    got = []
    for mesh, ex in zip(_meshes(devices), (jex, tex)):
        rows, row_lens = [], []
        for i in range(N_SHARDS):
            data, lens = ex.pack_outboxes(
                [payload(i, j) for j in range(N_SHARDS)], max_len=128)
            rows.append(data)
            row_lens.append(lens)
        inboxes, in_lens = ex.exchange_changes(mesh, 'peers', np.stack(rows),
                                               np.stack(row_lens))
        inboxes, in_lens = np.asarray(inboxes), np.asarray(in_lens)
        for j in range(N_SHARDS):
            assert ex.unpack_inbox(inboxes[j], in_lens[j]) == \
                [payload(i, j) for i in range(N_SHARDS)]
        got.append((inboxes, in_lens))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][1], got[0][1])
    assert got[1][0].dtype == np.uint8 and got[1][1].dtype == np.int32


def test_sharded_sync_convergence():
    """One host backend per shard; the mesh-transported rounds converge
    every shard to every change, in the same number of rounds and to the
    same heads in both packages."""
    out = []
    for mesh, (_name, ex, backend) in zip(_meshes(), PKGS):
        backends = [seed_backend(backend, i) for i in range(N_SHARDS)]
        rounds = ex.drive_pairwise_sync(mesh, 'peers', backends, backend)
        heads = [tuple(backend.get_heads(b)) for b in backends]
        assert len(set(heads)) == 1 and len(heads[0]) == N_SHARDS
        out.append((rounds, heads, [bytes(backend.save(b))
                                    for b in backends]))
    assert out[1] == out[0]


def test_sharded_fleet_backend_sync_convergence():
    """The backend seam on a mesh fleet: one FleetBackend per shard over
    ONE 4-position mesh fleet, the changes applied through the turbo
    seam, then sync rounds whose transport is the exchange. Rounds,
    heads, reads and save() bytes equal the JAX mesh fleet's."""
    if not (torch_native.available() and jax_native.available()):
        pytest.skip('a native codec is unavailable')
    meshes = (Mesh(np.array(jax.devices()[:N_SHARDS]).reshape(N_SHARDS, 1),
                   ('docs', 'keys')),
              tsh.fleet_mesh(['cpu'] * N_SHARDS))
    out = []
    for mesh, fb, ex in zip(meshes, (jax_fleet_backend, torch_fleet_backend),
                            (jex, tex)):
        fleet = fb.DocFleet(doc_capacity=N_SHARDS, key_capacity=4,
                            mesh=mesh)
        backends = fb.init_docs(N_SHARDS, fleet)
        per_doc = [[encode_change({
            'actor': f'{i:02x}' * 16, 'seq': 1, 'startOp': 1, 'time': 0,
            'message': '', 'deps': [], 'ops': [{
                'action': 'set', 'obj': '_root', 'key': f'k{i}', 'value': i,
                'datatype': 'int', 'pred': []}]})]
            for i in range(N_SHARDS)]
        backends, _ = fb.apply_changes_docs(backends, per_doc, mirror=False)
        assert fleet.metrics.turbo_calls == 1
        peers = Mesh(np.array(jax.devices()[:N_SHARDS]), ('peers',)) \
            if ex is jex else tsh.FleetMesh(['cpu'] * N_SHARDS, ('peers',))
        rounds = ex.drive_pairwise_sync(peers, 'peers', backends, fb)
        heads = [tuple(fb.get_heads(b)) for b in backends]
        assert len(set(heads)) == 1 and len(heads[0]) == N_SHARDS
        assert all(b['state'].is_fleet for b in backends)
        assert fleet.metrics.promotions == 0
        mats = fb.materialize_docs(backends)
        assert all(m == {f'k{i}': i for i in range(N_SHARDS)} for m in mats)
        out.append((rounds, heads, mats,
                    [bytes(fb.save(b)) for b in backends]))
    assert out[1] == out[0]


def test_multihost_driver_single_controller():
    """drive_pairwise_sync_multihost on a single-controller mesh: the
    agreement round, the lock-step break (well before the 2n bound) and
    the heads equal the reference's."""
    out = []
    for mesh, (_name, ex, backend) in zip(_meshes(), PKGS):
        local_docs = {i: seed_backend(backend, i) for i in range(N_SHARDS)}
        rounds = ex.drive_pairwise_sync_multihost(mesh, 'peers', local_docs,
                                                  backend)
        assert rounds < 2 * N_SHARDS
        heads = [tuple(backend.get_heads(local_docs[i]))
                 for i in range(N_SHARDS)]
        assert len(set(heads)) == 1 and len(heads[0]) == N_SHARDS
        out.append((rounds, heads))
    assert out[1] == out[0]


def _oversize(src, dst):
    # different sizes per pair, some multi-chunk, some sub-chunk
    return bytes([src * 16 + dst]) * (40 + 97 * src + 311 * dst)


def test_multihost_round_oversize_chunks_and_reassembles():
    """A payload over max_msg splits across fixed-width sub-rounds and
    reassembles byte-exact; both packages deliver the same payloads in
    the same order and add the same sync_retries."""
    out = []
    for mesh, (_name, ex, _backend) in zip(_meshes(), PKGS):
        got = []
        before = ex._sync_stats['sync_retries']
        sent = ex.sync_round_multihost(
            mesh, 'peers', _oversize,
            lambda dst, src, p: got.append((dst, src, p)), max_msg=128)
        assert sent == N_SHARDS * (N_SHARDS - 1)
        assert {(d, s): p for d, s, p in got} == {
            (d, s): _oversize(s, d) for d in range(N_SHARDS)
            for s in range(N_SHARDS) if s != d}
        out.append((sent, got, ex._sync_stats['sync_retries'] - before))
    assert out[1] == out[0]
    assert out[1][2] > 0


def test_multihost_round_hard_overflow_raises_typed():
    """Beyond max_msg * max_chunks the round fails in the agreement
    phase with a typed SyncOverflow whose fields equal the reference's."""
    raised = []
    for mesh, (_name, ex, _backend), cls in zip(_meshes(), PKGS,
                                                (JSyncOverflow,
                                                 TSyncOverflow)):
        with pytest.raises(cls, match='exceeds max_msg') as ei:
            ex.sync_round_multihost(mesh, 'peers', lambda s, d: b'x' * 300,
                                    lambda *a: None, max_msg=128,
                                    max_chunks=2)
        assert isinstance(ei.value, ValueError)
        raised.append((str(ei.value), ei.value.global_max,
                       ei.value.max_msg, ei.value.max_chunks,
                       ei.value.pairs))
    assert raised[1] == raised[0]
    assert raised[1][1] == 300 and (0, 1) in raised[1][4]


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_world_size_one_group_drives_the_collectives():
    """Under an initialised gloo group of one rank the port's mesh is a
    multi-controller mesh: each round's agreement is an all_gather and
    each sub-round one all_to_all_single of the local rows. The chunked
    rounds converge to the reference's heads in the reference's number of
    rounds, with the same sync_retries increment."""
    import torch.distributed as dist
    jmesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ('peers',))
    ref_docs = {i: seed_backend(JBackend, i) for i in range(N_SHARDS)}
    before = jex._sync_stats['sync_retries']
    ref_rounds = jex.drive_pairwise_sync_multihost(
        jmesh, 'peers', ref_docs, JBackend, max_msg=64)
    ref_retries = jex._sync_stats['sync_retries'] - before
    calls = []
    real = dist.all_to_all_single

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:'
                            f'{_free_port()}', world_size=1, rank=0,
                            timeout=__import__('datetime').timedelta(
                                seconds=60))
    try:
        mesh = tsh.fleet_mesh(['cpu'] * N_SHARDS)
        assert mesh.group is not None and list(mesh.ranks.ravel()) == \
            [0] * N_SHARDS
        assert tex.local_shard_ids(mesh, 'docs') == list(range(N_SHARDS))
        docs = {i: seed_backend(TBackend, i) for i in range(N_SHARDS)}
        before = tex._sync_stats['sync_retries']
        dist.all_to_all_single = spy
        try:
            rounds = tex.drive_pairwise_sync_multihost(
                mesh, 'docs', docs, TBackend, max_msg=64)
        finally:
            dist.all_to_all_single = real
        retries = tex._sync_stats['sync_retries'] - before
    finally:
        dist.destroy_process_group()
    assert (rounds, retries) == (ref_rounds, ref_retries) and retries > 0
    assert calls and all(tuple(c)[:3] == (1, N_SHARDS, N_SHARDS)
                         for c in calls)
    assert [tuple(TBackend.get_heads(docs[i])) for i in range(N_SHARDS)] == \
        [tuple(JBackend.get_heads(ref_docs[i])) for i in range(N_SHARDS)]
