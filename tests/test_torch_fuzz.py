"""Lockstep differential of the public API: the reference's fuzz generator
(tests/test_fuzz.py `random_mutation`) drives automerge_tpu and
automerge_tpu_torch with the same seeds, actors and times, on the host
backend and on each package's fleet backend (on the CPU). Everything is
compared exactly: every change's bytes, every patch, every sync message,
every typed error, `get_all_changes` and `save()` of every replica."""

import contextlib
import os
import random
import subprocess
import sys

import pytest
import torch

import automerge_tpu as ref
import automerge_tpu_torch as port
from automerge_tpu.fleet import backend as ref_fleet
from automerge_tpu_torch.fleet import backend as port_fleet

import tests.test_fuzz as ref_fuzz

torch.set_num_threads(1)   # small tensors: the intra-op pool costs more

ACTORS = ['aa01', 'bb02', 'cc03']


@contextlib.contextmanager
def _on(pkg, backend):
    """Install `backend` as `pkg`'s default and point the generator's
    proxy checks at `pkg`; both are restored after."""
    generator_pkg = ref_fuzz.am
    ref_fuzz.am = pkg
    pkg.set_default_backend(backend)
    try:
        yield
    finally:
        pkg.set_default_backend(pkg.backend)
        ref_fuzz.am = generator_pkg


def _error(fn):
    try:
        fn()
    except Exception as exc:   # the typed error is what is compared
        return type(exc).__name__, str(exc)
    return None


def _sync(pkg, log, d1, d2):
    s1, s2 = pkg.init_sync_state(), pkg.init_sync_state()
    for _ in range(10):
        s1, m1 = pkg.generate_sync_message(d1, s1)
        log.append(('msg', None if m1 is None else bytes(m1)))
        if m1 is not None:
            d2, s2, patch = pkg.receive_sync_message(d2, s2, m1)
            log.append(('sync-patch', patch))
        s2, m2 = pkg.generate_sync_message(d2, s2)
        log.append(('msg', None if m2 is None else bytes(m2)))
        if m2 is not None:
            d1, s1, patch = pkg.receive_sync_message(d1, s1, m2)
            log.append(('sync-patch', patch))
        if m1 is None and m2 is None:
            break
    return d1, d2


def _run(pkg, backend, seed, fleet=None):
    log = []
    with _on(pkg, backend):
        rnd = random.Random(seed)
        docs = {a: pkg.init(a) for a in ACTORS}
        for _round in range(12):
            actor = rnd.choice(ACTORS)
            new_doc, req = pkg.Frontend.change(
                docs[actor], {'time': 0},
                ref_fuzz.random_mutation(rnd, docs[actor]))
            if req is not None:
                docs[actor] = new_doc
                log.append(('change', bytes(
                    pkg.Frontend.get_last_local_change(new_doc))))
            if rnd.random() < 0.6:
                src, dst = rnd.sample(ACTORS, 2)
                docs[dst], patch = pkg.apply_changes(
                    docs[dst], pkg.get_all_changes(docs[src]))
                log.append(('patch', patch))
        docs['aa01'], docs['bb02'] = _sync(pkg, log, docs['aa01'],
                                           docs['bb02'])
        change = bytearray(pkg.get_all_changes(docs['aa01'])[-1])
        change[-1] ^= 0x01
        log.append(('error', _error(
            lambda: pkg.apply_changes(docs['cc03'], [bytes(change)]))))
        log.append(('error', _error(
            lambda: pkg.load(b'\x85\x6f\x4a\x83garbage'))))
        log.append(('error', _error(
            lambda: pkg.receive_sync_message(
                docs['cc03'], pkg.init_sync_state(), b'\x42\x00\x07'))))
        for a in ACTORS:
            log.append((a, [bytes(c) for c in pkg.get_all_changes(docs[a])],
                        bytes(pkg.save(docs[a])), docs[a].to_py()))
        if fleet is not None:
            # the fleet's own read: flushes the pending batch through
            # the device merge and reads the grids back
            log.append(('device', fleet.materialize_docs(
                [pkg.Frontend.get_backend_state(docs[a]) for a in ACTORS])))
    return log


def _lockstep(seed, ref_backend, port_backend, fleets=(None, None)):
    ref_log = _run(ref, ref_backend, seed, fleets[0])
    port_log = _run(port, port_backend, seed, fleets[1])
    assert len(port_log) == len(ref_log)
    for got, want in zip(port_log, ref_log):
        assert got == want
    assert [e for e in ref_log if e[0] == 'error' and e[1] is None] == []
    return ref_log


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_lockstep_host_backend(seed):
    log = _lockstep(seed, ref.backend, port.backend)
    assert any(e[0] == 'msg' and e[1] is not None for e in log)


# one seed each on the fleets: every new batch shape costs the
# reference's fleet a JAX compile
@pytest.mark.parametrize('seed', [1])
def test_lockstep_fleet_backend_lww(seed):
    _lockstep(seed,
              ref_fleet.FleetBackend(ref_fleet.DocFleet(
                  doc_capacity=4, key_capacity=4)),
              port_fleet.FleetBackend(port_fleet.DocFleet(
                  doc_capacity=4, key_capacity=4, device='cpu')),
              (ref_fleet, port_fleet))


@pytest.mark.parametrize('seed', [1])
def test_lockstep_fleet_backend_exact(seed):
    _lockstep(seed,
              ref_fleet.FleetBackend(ref_fleet.DocFleet(
                  doc_capacity=4, key_capacity=4, exact_device=True)),
              port_fleet.FleetBackend(port_fleet.DocFleet(
                  doc_capacity=4, key_capacity=4, exact_device=True,
                  device='cpu')),
              (ref_fleet, port_fleet))


def test_public_surface_matches_reference():
    """Every public name of a freshly imported automerge_tpu is one of the
    port's too (in a fresh process: in this one, other tests load the
    reference's later subpackages, which are later slices of the port),
    and the fleet exports fleet_merge as the reference's does."""
    code = ('import automerge_tpu as ref, automerge_tpu_torch as port\n'
            'print([n for n in dir(ref) if not n.startswith("_") '
            'and not hasattr(port, n)])\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'
    import automerge_tpu.fleet as ref_fleet_pkg
    import automerge_tpu_torch.fleet as port_fleet_pkg
    assert 'fleet_merge' in ref_fleet_pkg.__all__
    assert 'fleet_merge' in port_fleet_pkg.__all__
