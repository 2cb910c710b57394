"""Differential tests of the storage engine (fleet/storage.py): park and
revive, compute-on-compressed causal reads, the needs-sync gate, ingest,
vacuum, memory accounting, revive through a durable fleet, and the
dead-fraction auto-vacuum. Each scenario runs the same inputs through
the JAX package's StorageEngine and the torch port's (over a
DocFleet(device='cpu')), and the two runs must agree exactly: chunks,
heads, clocks, maxOp, change counts, needs_sync answers, memory_stats,
health-counter deltas, and every revived doc's save().

The shapes are those of the reference's tests/test_storage.py
TestStorageEngine and TestAutoVacuum (not its slow million-doc test,
whose size chip_smoke.py's storage path runs on the card)."""

import types

import pytest
import torch

import automerge_tpu.native as jax_native
from automerge_tpu.columnar import encode_change
from automerge_tpu.fleet import backend as jb
from automerge_tpu.fleet import durability as jd
from automerge_tpu.fleet import storage as js
from automerge_tpu.fleet import tiering as jt
from automerge_tpu.observability import health_counts as jax_health
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch.errors import MalformedDocument
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import durability as td
from automerge_tpu_torch.fleet import storage as ts
from automerge_tpu_torch.fleet import tiering as tt
from automerge_tpu_torch.observability import health_counts as torch_health

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (torch_native.available() and jax_native.available()),
    reason='a native codec is unavailable')


def _package(fb, S, D, health, kw):
    return types.SimpleNamespace(
        fb=fb, S=S, D=D, health=health,
        fleet=lambda: fb.DocFleet(**kw),
        durable=lambda path: D.DurableFleet(path, **kw),
        recover=lambda path: D.DurableFleet.recover(path, **kw))


def _registry(*modules):
    """The health counters that these modules register (their `_stats`
    families)."""
    return frozenset(k for m in modules for k in m._stats)


REF = _package(jb, js, jd, jax_health, {})
PORT = _package(tb, ts, td, torch_health, {'device': 'cpu'})
# the counters compared: those the storage and tiering modules of each
# package register
REF.counters = _registry(js, jt)
PORT.counters = _registry(ts, tt)


def _change(actor, seq, start_op, deps, key, val):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}]})


def _workload(P, fleet, n, rounds=2):
    handles = P.fb.init_docs(n, fleet)
    for r in range(rounds):
        per_doc = [[_change(f'{d:04x}' * 4, r + 1, r + 1,
                            P.fb.get_heads(handles[d]),
                            f'k{r}', d * 10 + r)]
                   for d in range(n)]
        handles, _ = P.fb.apply_changes_docs(handles, per_doc,
                                             mirror=False)
    return handles


def _saves(handles):
    return [bytes(h['state'].save()) for h in handles]


def _reads(eng, ids):
    """Every compute-on-compressed read of each parked id."""
    return [(eng.heads(i), eng.clock(i), eng.max_op(i), eng.n_changes(i),
             bytes(eng.chunk(i))) for i in ids]


def _both(scenario):
    """Run `scenario(P)` for both packages; results and health-counter
    deltas must agree. Returns the reference's result."""
    out = {}
    for name, P in (('ref', REF), ('port', PORT)):
        before = P.health()
        result = scenario(P)
        after = P.health()
        delta = {k: after[k] - before.get(k, 0) for k in P.counters}
        out[name] = (result, delta)
    assert out['port'][0] == out['ref'][0]
    assert out['port'][1] == out['ref'][1]
    return out['ref'][0]


class TestStorageEngine:
    def test_park_revive_byte_identical(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 6)
            saves = _saves(handles)
            ids = eng.park(handles)
            reads = _reads(eng, ids)
            frozen = all(h.get('frozen') for h in handles)
            back = eng.revive(ids)
            return saves, ids, reads, frozen, _saves(back), len(eng.main)
        saves, ids, _r, frozen, back, left = _both(run)
        assert frozen and back == saves and left == 0 and None not in ids

    def test_park_frees_device_slots(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 5)
            slots = {h['state']._impl.slot for h in handles}
            eng.park(handles)
            return slots <= set(fleet.free_slots), sorted(fleet.free_slots)
        assert _both(run)[0]

    def test_causal_reads_match_live_state(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 4, rounds=3)
            live = [(sorted(h['state'].heads), dict(h['state'].clock),
                     h['state'].max_op) for h in handles]
            ids = eng.park(handles)
            return live, _reads(eng, ids)
        live, reads = _both(run)
        assert [r[:3] for r in reads] == live
        assert all(r[3] == 3 for r in reads)

    def test_needs_sync_gate(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 2)
            heads = [list(h['state'].heads) for h in handles]
            ids = eng.park(handles)
            return [eng.needs_sync(ids[0], heads[0]),
                    eng.needs_sync(ids[0], heads[1]),
                    eng.needs_sync(ids[0], []),
                    eng.main.contains_head(ids[0], heads[0][0]),
                    eng.main.contains_head(ids[0], 'ee' * 32),
                    eng.main.covers_heads(ids[0], heads[0]),
                    eng.covers_heads(ids[1], heads[0] + heads[1])]
        assert _both(run) == [False, True, True, True, False, True, False]

    def test_park_skips_queued_and_frozen(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 3)
            dangling = _change('ee' * 16, 2, 5, ['dd' * 32], 'q', 1)
            handles[0]['state'].apply_changes([dangling])
            handles[1]['frozen'] = True
            ids = eng.park(handles)
            return ids, bool(handles[0].get('frozen'))
        ids, frozen = _both(run)
        assert ids[0] is None and ids[1] is None and ids[2] is not None
        assert not frozen

    def test_ingest_chunks_compute_on_compressed(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            saves = _saves(_workload(P, fleet, 4))
            ids = eng.ingest_chunks(saves)
            reads = _reads(eng, ids)
            back = eng.revive(ids[:2])
            return saves, ids, reads, _saves(back)
        saves, _ids, reads, back = _both(run)
        assert back == saves[:2] and [r[4] for r in reads] == saves

    def test_chunks_cross_packages(self):
        """Chunks parked by one package ingest and revive in the
        other."""
        fleets = {'ref': REF.fleet(), 'port': PORT.fleet()}
        saves = {name: _saves(_workload(P, fleets[name], 3))
                 for name, P in (('ref', REF), ('port', PORT))}
        assert saves['ref'] == saves['port']
        for src, P in (('port', REF), ('ref', PORT)):
            eng = P.S.StorageEngine(P.fleet())
            ids = eng.ingest_chunks(saves[src])
            assert _saves(eng.revive(ids)) == saves[src]

    def test_ingest_rejects_hostile_chunk_typed(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            chunk = bytearray(_saves(_workload(P, fleet, 1))[0])
            chunk[5] ^= 0x10
            try:
                eng.ingest_chunks([bytes(chunk)])
            except Exception as exc:    # noqa: BLE001 - compared by name
                return type(exc).__name__, len(eng.main)
            return None
        assert _both(run) == ('MalformedDocument', 0)
        assert ts.MalformedDocument is MalformedDocument

    def test_vacuum_reclaims_discards(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            ids = eng.park(_workload(P, fleet, 8))
            for r in ids[:4]:
                eng.main.discard(r)
            dead = eng.main.dead_fraction
            keep = ids[4:]
            want = _reads(eng, keep)
            remap = eng.main.vacuum()
            got = _reads(eng, [remap[old] for old in keep])
            return dead, sorted(remap), want == got, eng.main.dead_fraction
        dead, remapped, same, after = _both(run)
        assert dead == pytest.approx(0.5) and same and after == 0.0
        assert len(remapped) == 4

    def test_memory_stats_match(self):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            eng.park(_workload(P, fleet, 256))
            return eng.memory_stats()
        stats = _both(run)
        assert stats['n_docs'] == 256 and stats['overhead_per_doc'] < 1024

    def test_revive_through_durable_fleet_journals_baseline(self, tmp_path):
        def run(P):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 3)
            saves = _saves(handles)
            ids = eng.park(handles)
            path = str(tmp_path / f'dur-{id(P)}')
            mgr = P.durable(path)
            eng2 = P.S.StorageEngine(mgr.fleet)
            eng2.adopt_main(eng)
            back = eng2.revive(ids, durable=mgr)
            mgr.close()
            mgr2, rec, report = P.recover(path)
            recovered = sorted(bytes(P.fb.save(h)) for h in rec.values())
            mgr2.close()
            return saves, _saves(back), recovered, report.ok
        saves, back, recovered, ok = _both(run)
        assert back == saves and recovered == sorted(saves) and ok


class TestAutoVacuum:
    @staticmethod
    def _engine(P, n, threshold=0.5):
        fleet = P.fleet()
        eng = P.S.StorageEngine(fleet, vacuum_dead_fraction=threshold)
        saves = _saves(_workload(P, fleet, n))
        return eng, eng.ingest_chunks(saves), saves

    def test_discard_churn_triggers_vacuum(self):
        def run(P):
            eng, ids, saves = self._engine(P, 12)
            eng.discard(ids[:7])
            return eng.vacuums, eng.main.dead_fraction, \
                [bytes(eng.chunk(i)) == s for i, s in zip(ids[7:],
                                                           saves[7:])]
        vacuums, dead, same = _both(run)
        assert vacuums == 1 and dead == 0.0 and all(same)

    def test_below_threshold_no_vacuum(self):
        def run(P):
            eng, ids, _ = self._engine(P, 12)
            eng.discard(ids[:3])
            return eng.vacuums, eng.main.dead_fraction
        vacuums, dead = _both(run)
        assert vacuums == 0 and dead > 0

    def test_policy_disabled(self):
        def run(P):
            eng, ids, _ = self._engine(P, 12, threshold=None)
            eng.discard(ids[:10])
            return eng.vacuums, eng.main.dead_fraction
        vacuums, dead = _both(run)
        assert vacuums == 0 and dead > 0.8

    def test_revive_churn_triggers_and_reads_survive(self):
        def run(P):
            eng, ids, saves = self._engine(P, 16)
            live = [(sorted(eng.heads(i)), eng.max_op(i)) for i in ids]
            back = eng.revive(ids[:12])
            after = [(eng.heads(i), eng.max_op(i)) for i in ids[12:]]
            with pytest.raises(KeyError):
                eng.heads(ids[0])
            return _saves(back) == saves[:12], eng.vacuums, \
                after == live[12:]
        same, vacuums, reads = _both(run)
        assert same and vacuums >= 1 and reads

    def test_small_stores_never_churn(self):
        def run(P):
            eng, ids, _ = self._engine(P, 4)
            eng.discard(ids[:3])
            return eng.vacuums
        assert _both(run) == 0

    def test_adopt_main_moves_ownership(self):
        def run(P):
            eng, ids, saves = self._engine(P, 16)
            other = P.S.StorageEngine(P.fleet())
            other.adopt_main(eng)
            moved = (len(eng.main), len(eng._row_of))
            other.discard(ids[:12])
            with pytest.raises(KeyError):
                eng.heads(ids[15])
            return moved, other.vacuums, \
                [bytes(other.chunk(i)) for i in ids[12:]] == saves[12:]
        moved, vacuums, same = _both(run)
        assert moved == (0, 0) and vacuums >= 1 and same

    def test_adopt_main_requires_empty_adopter(self):
        def run(P):
            eng, ids, _ = self._engine(P, 8)
            other = P.S.StorageEngine(P.fleet())
            other.ingest_chunks([bytes(eng.chunk(ids[0]))])
            with pytest.raises(ValueError):
                other.adopt_main(eng)
            return len(eng.main)
        assert _both(run) == 8


def test_storage_engine_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.StorageEngine()
    eng = ts.StorageEngine(device='cpu', path=str(tmp_path / 'arena'))
    assert eng.fleet.device == torch.device('cpu')
    eng.main.sync()
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.StorageEngine.open(str(tmp_path / 'arena'))
    assert ts.StorageEngine.open(str(tmp_path / 'arena'),
                                 device='cpu').fleet.device.type == 'cpu'
