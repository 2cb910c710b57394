"""True multi-controller sync in the port: two OS processes over a gloo
process group, each owning 2 of the mesh's 4 positions and their
fleet-resident documents, converge through fleet/exchange.py
`drive_pairwise_sync_multihost` (one all_gather and all_to_all_single a
round), as tests/test_multihost.py holds the reference. Reads and heads
must be equal on both ranks and equal to the single-controller port's.

Rank 0 is the test's own process (its group is destroyed at the end);
rank 1 is this file's ``__main__``:
``python tests/test_torch_multihost.py <rank> <world> <port>``."""

import datetime
import json
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import automerge_tpu_torch as A                          # noqa: E402
from automerge_tpu_torch import frontend as F            # noqa: E402
from automerge_tpu_torch.fleet import backend as fleet_backend  # noqa: E402
from automerge_tpu_torch.fleet.backend import (          # noqa: E402
    DocFleet, FleetBackend)
from automerge_tpu_torch.fleet.exchange import (         # noqa: E402
    drive_pairwise_sync_multihost, local_shard_ids)
from automerge_tpu_torch.fleet.sharding import (         # noqa: E402
    FleetMesh, fleet_mesh)

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

N_SHARDS = 4


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _shard_docs(shards):
    """Each shard's fleet-resident document with its own key, built
    through the port's Automerge.* API on a CPU FleetBackend."""
    fb = FleetBackend(DocFleet(doc_capacity=8, key_capacity=32,
                               device='cpu'))
    docs, prev = {}, A.Backend()
    A.set_default_backend(fb)
    try:
        for s in shards:
            doc = A.change(A.init(f'{s:02x}' * 16), {'time': 0},
                           lambda r, s=s: r.update({f'k{s}': s}))
            docs[s] = F.get_backend_state(doc, 'multihost')
    finally:
        A.set_default_backend(prev)
    return docs


def _worker(rank, world, port):
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = fleet_mesh(['cpu'] * (N_SHARDS // world))
        mine = local_shard_ids(mesh, 'docs')
        local_docs = _shard_docs(mine)
        rounds = drive_pairwise_sync_multihost(mesh, 'docs', local_docs,
                                               fleet_backend)
        reads = fleet_backend.materialize_docs([local_docs[s]
                                                for s in mine])
        heads = [fleet_backend.get_heads(local_docs[s]) for s in mine]
    finally:
        dist.destroy_process_group()
    return {'process': rank, 'shards': mine, 'rounds': rounds,
            'reads': reads, 'heads': heads}


def test_two_process_pairwise_sync_converges():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '1', '2', str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env)
    try:
        results = {0: _worker(0, 2, port)}
        out, _ = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, f'worker 1 failed:\n{out}'
    for line in out.splitlines():
        if line.startswith('RESULT '):
            r = json.loads(line[len('RESULT '):])
            results[r['process']] = r
    assert set(results) == {0, 1}, results
    # the same shards under one controller
    docs = _shard_docs(range(N_SHARDS))
    single_rounds = drive_pairwise_sync_multihost(
        FleetMesh(['cpu'] * N_SHARDS, ('docs',)), 'docs', docs,
        fleet_backend)
    assert results[0]['shards'] == [0, 1] and results[1]['shards'] == [2, 3]
    want = {f'k{s}': s for s in range(N_SHARDS)}
    single_heads = [fleet_backend.get_heads(docs[s])
                    for s in range(N_SHARDS)]
    assert fleet_backend.materialize_docs(
        [docs[s] for s in range(N_SHARDS)]) == [want] * N_SHARDS
    for r in results.values():
        assert r['rounds'] == single_rounds
        assert r['reads'] == [want, want]
        assert r['heads'] == [single_heads[s] for s in r['shards']]


if __name__ == '__main__':
    print('RESULT ' + json.dumps(_worker(int(sys.argv[1]),
                                         int(sys.argv[2]), sys.argv[3])),
          flush=True)
