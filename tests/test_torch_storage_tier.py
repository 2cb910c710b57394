"""Differential tests of the disk tier (fleet/segment.py under
fleet/storage.py) and cost-based tiering (fleet/tiering.py): each
scenario runs the same inputs through the JAX package and the torch port
(DocFleet(device='cpu')), and the two runs must agree exactly: chunks,
heads, clocks, ids, memory_stats, health-counter deltas, and the arena
directories file for file (names and bytes). An arena written by one
package opens in the other.

The shapes are those of the reference's tests/test_storage_tier.py
TestDiskArena (with the kill-mid-vacuum subprocess, here in the port's
form), TestPrefixShortCircuit, TestCostModel, TestClockDemote,
TestTieringController (not its service-pump test: the service is a
later slice of the port) and TestMixedBatchRouting."""

import os
import subprocess
import sys
import types

import pytest
import torch

import automerge_tpu.native as jax_native
from automerge_tpu import backend as jax_host
from automerge_tpu.backend import sync as jax_sync
from automerge_tpu.columnar import decode_change_meta, encode_change
from automerge_tpu.fleet import backend as jb
from automerge_tpu.fleet import hashindex as jax_hi
from automerge_tpu.fleet import segment as jseg
from automerge_tpu.fleet import storage as js
from automerge_tpu.fleet import sync_driver as jax_driver
from automerge_tpu.fleet import tiering as jt
from automerge_tpu.fleet.tensor_doc import CTR_LIMIT
from automerge_tpu.observability import health_counts as jax_health
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch import backend as torch_host
from automerge_tpu_torch.backend import sync as torch_sync
from automerge_tpu_torch.columnar import DocChunkView
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import hashindex as torch_hi
from automerge_tpu_torch.fleet import segment as tseg
from automerge_tpu_torch.fleet import storage as ts
from automerge_tpu_torch.fleet import sync_driver as torch_driver
from automerge_tpu_torch.fleet import tiering as tt
from automerge_tpu_torch.observability import health_counts as torch_health

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (torch_native.available() and jax_native.available()),
    reason='a native codec is unavailable')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _package(fb, S, G, T, host, sync, hi, driver, native, health, kw):
    return types.SimpleNamespace(
        fb=fb, S=S, G=G, T=T, host=host, sync=sync, hi=hi, driver=driver,
        native=native, health=health, fleet=lambda: fb.DocFleet(**kw),
        open=lambda path, **k: S.StorageEngine.open(path, **k, **kw))


def _registry(*modules):
    """The health counters that these modules register (their `_stats`
    families)."""
    return frozenset(k for m in modules for k in m._stats)


REF = _package(jb, js, jseg, jt, jax_host, jax_sync, jax_hi, jax_driver,
               jax_native, jax_health, {})
PORT = _package(tb, ts, tseg, tt, torch_host, torch_sync, torch_hi,
                torch_driver, torch_native, torch_health, {'device': 'cpu'})
# the counters compared: those the storage, tiering and sync_driver
# modules of each package register (segment.py registers none)
REF.counters = _registry(js, jt, jax_driver)
PORT.counters = _registry(ts, tt, torch_driver)


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


def _tree(path):
    """{relative file name: bytes} of a directory."""
    out = {}
    for root, _dirs, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, 'rb') as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _both(scenario, tmp_path=None):
    """Run `scenario(P, root)` for both packages, each with its own arena
    root; results, health-counter deltas and (with tmp_path) the arena
    directories must agree. Returns the reference's result."""
    out = {}
    for name, P in (('ref', REF), ('port', PORT)):
        root = str(tmp_path / name / 'arena') if tmp_path else None
        before = P.health()
        result = scenario(P, root)
        after = P.health()
        delta = {k: after[k] - before.get(k, 0) for k in P.counters}
        files = _tree(os.path.dirname(root)) if root else None
        out[name] = (result, delta, files)
    assert out['port'][0] == out['ref'][0]
    assert out['port'][2] == out['ref'][2]
    assert out['port'][1] == out['ref'][1]
    return out['ref'][0]


class TestDiskArena:
    def test_park_discard_vacuum_revive_park_cycles(self, tmp_path):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root)
            handles = _workload(P, fleet, 12)
            saves = _saves(handles)
            ids = eng.park(handles)
            log = []
            for _cycle in range(3):
                eng.discard(ids[:4])
                eng.vacuum_now()
                log.append([bytes(eng.chunk(i)) == s
                            for i, s in zip(ids[4:], saves[4:])])
                back = eng.revive(ids[4:])
                log.append((_saves(back) == saves[4:], len(eng.main)))
                new_ids = eng.park(back)
                ids = eng.ingest_chunks(saves[:4]) + new_ids
                log.append(list(ids))
            eng.main.sync()
            return log, eng.vacuums
        log, _vacuums = _both(run, tmp_path)
        assert all(all(x) for x in log[0::3])
        assert all(x == (True, 0) for x in log[1::3])

    def test_chunk_reads_are_zero_copy_views(self, tmp_path):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root)
            handles = _workload(P, fleet, 3)
            saves = _saves(handles)
            ids = eng.park(handles)
            view = eng.chunk(ids[0])
            got = P.native.extract_changes([view])
            eng.main.sync()
            return (isinstance(view, memoryview), bytes(view) == saves[0],
                    sorted(DocChunkView(view).heads) == eng.heads(ids[0]),
                    got == P.native.extract_changes([saves[0]]),
                    got[0] is not None)
        assert all(_both(run, tmp_path))

    def test_held_view_survives_segment_swap(self, tmp_path):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root,
                                    vacuum_dead_fraction=None)
            saves = _saves(_workload(P, fleet, 10))
            ids = eng.ingest_chunks(saves)
            held = eng.chunk(ids[7])
            eng.discard(ids[:5])
            eng.vacuum_now()
            out = (bytes(held) == saves[7],
                   bytes(eng.chunk(ids[7])) == saves[7])
            del held
            eng.vacuum_now()
            eng.main.sync()
            return out
        assert _both(run, tmp_path) == (True, True)

    def test_segment_rollover_and_reopen(self, tmp_path):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root, segment_bytes=1 << 10)
            saves = _saves(_workload(P, fleet, 16))
            ids = eng.ingest_chunks(saves)
            segments = len(eng.main._arena.segments)
            eng.main.sync()
            eng2 = P.open(root, segment_bytes=1 << 10)
            return segments, sorted(eng2._row_of) == sorted(ids), \
                [(bytes(eng2.chunk(i)) == s, eng2.heads(i) == eng.heads(i),
                  eng2.clock(i) == eng.clock(i)) for i, s in zip(ids, saves)]
        segments, same_ids, reads = _both(run, tmp_path)
        assert segments > 1 and same_ids
        assert all(all(r) for r in reads)

    def _crash_mid_vacuum(self, tmp_path, point):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root,
                                    vacuum_dead_fraction=None)
            saves = _saves(_workload(P, fleet, 10))
            ids = eng.ingest_chunks(saves)
            eng.discard(ids[:4])
            eng.main.sync()
            eng.main._arena.fault_point = point
            with pytest.raises(RuntimeError, match='injected arena fault'):
                eng.vacuum_now()
            eng2 = P.open(root)
            return sorted(eng2._row_of), \
                [(bytes(eng2.chunk(i)) == saves[i], eng2.needs_sync(i, []))
                 for i in ids[4:]]
        ids, reads = _both(run, tmp_path)
        assert ids == list(range(4, 10))
        assert all(r == (True, True) for r in reads)

    def test_crash_mid_vacuum_pre_commit(self, tmp_path):
        self._crash_mid_vacuum(tmp_path, 'pre_commit')

    def test_crash_mid_vacuum_post_manifest(self, tmp_path):
        self._crash_mid_vacuum(tmp_path, 'post_manifest')

    def test_kill_mid_vacuum_recovers(self, tmp_path):
        """Hard kill (os._exit inside the swap window) of a process that
        runs only the port on the CPU; both packages reopen the arena
        byte-identically."""
        root = str(tmp_path / 'arena')
        script = f'''
import sys; sys.path.insert(0, {ROOT!r})
import pathlib
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.fleet import backend as fb
from automerge_tpu_torch.fleet.storage import StorageEngine

def change(actor, seq, deps, key, val):
    return encode_change({{
        'actor': actor, 'seq': seq, 'startOp': seq, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}}]}})

fleet = fb.DocFleet(device='cpu')
eng = StorageEngine(fleet, path={root!r}, vacuum_dead_fraction=None)
handles = fb.init_docs(8, fleet)
for r in range(2):
    handles, _ = fb.apply_changes_docs(handles, [
        [change(f'{{d:04x}}' * 4, r + 1, fb.get_heads(handles[d]),
                f'k{{r}}', d * 10 + r)] for d in range(8)], mirror=False)
saves = [bytes(h['state'].save()) for h in handles]
pathlib.Path({root!r} + '.expect').write_bytes(b''.join(saves[4:]))
ids = eng.park(handles)
eng.discard(ids[:4])
eng.main.sync()
eng.main._arena.fault_point = 'exit:post_manifest'
eng.vacuum_now()           # never returns
'''
        proc = subprocess.run([sys.executable, '-c', script],
                              capture_output=True, timeout=300)
        assert proc.returncode == 71, proc.stderr.decode()[-2000:]
        with open(root + '.expect', 'rb') as f:
            want = f.read()
        for P in (PORT, REF):
            eng2 = P.open(root)
            assert len(eng2._row_of) == 4
            assert b''.join(bytes(eng2.chunk(i))
                            for i in sorted(eng2._row_of)) == want

    def test_torn_append_tail_dropped(self, tmp_path):
        def run(P, root):
            arena = P.G.SegmentArena(root)
            for i in range(6):
                arena.append(i, b'payload-%d' % i * 20)
            arena.sync()
            seg_path = arena.segments[-1].path
            size = os.path.getsize(seg_path)
            arena.close()
            with open(seg_path, 'r+b') as f:
                f.truncate(size - 5)
            arena2, records = P.G.SegmentArena.open(root)
            views = [bytes(arena2.view(*records[i])) for i in range(5)]
            seg, off, ln = arena2.append(99, b'fresh')
            out = (sorted(records), views, bytes(arena2.view(seg, off, ln)))
            arena2.sync()
            arena2.close()
            return out
        records, views, fresh = _both(run, tmp_path)
        assert records == list(range(5)) and fresh == b'fresh'
        assert views == [b'payload-%d' % i * 20 for i in range(5)]

    def test_repark_preserves_ids_on_disk(self, tmp_path):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root)
            handles = _workload(P, fleet, 4)
            saves = _saves(handles)
            ids = eng.park(handles)
            eng.repark(eng.revive(ids), ids)
            eng.main.sync()
            eng2 = P.open(root)
            return sorted(eng._row_of) == sorted(ids), \
                sorted(eng2._row_of) == sorted(ids), \
                [bytes(eng2.chunk(i)) == s for i, s in zip(ids, saves)]
        same, reopened, chunks = _both(run, tmp_path)
        assert same and reopened and all(chunks)

    def test_resident_vs_disk_split(self, tmp_path):
        def run(P, root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, path=root)
            eng.park(_workload(P, fleet, 32))
            eng.main.sync()
            return eng.memory_stats()
        stats = _both(run, tmp_path)
        assert stats['n_docs'] == 32
        assert stats['disk_bytes'] >= stats['chunk_bytes'] > 0
        assert stats['resident_per_doc'] < 512, stats

    @pytest.mark.parametrize('writer', ['ref', 'port'])
    def test_arena_opens_in_the_other_package(self, tmp_path, writer):
        W, R = (REF, PORT) if writer == 'ref' else (PORT, REF)
        root = str(tmp_path / 'arena')
        fleet = W.fleet()
        eng = W.S.StorageEngine(fleet, path=root, vacuum_dead_fraction=None)
        saves = _saves(_workload(W, fleet, 10))
        ids = eng.ingest_chunks(saves)
        eng.discard(ids[:3])
        eng.vacuum_now()
        eng.main.sync()
        other = R.open(root)
        assert sorted(other._row_of) == ids[3:]
        for i in ids[3:]:
            assert bytes(other.chunk(i)) == saves[i]
            assert other.heads(i) == eng.heads(i)
            assert other.clock(i) == eng.clock(i)
        back = other.revive(ids[3:5])
        assert _saves(back) == saves[3:5]


class TestPrefixShortCircuit:
    @staticmethod
    def _threshold(monkeypatch, threshold):
        for P in (REF, PORT):
            monkeypatch.setattr(P.S.MainStore, 'PREFIX_MIN_ROWS', threshold)

    def test_probe_correct_above_threshold(self, monkeypatch):
        self._threshold(monkeypatch, 8)

        def run(P, _root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 12)
            heads = [list(h['state'].heads) for h in handles]
            ids = eng.park(handles)
            out = [eng.main._head_prefixes is None,
                   eng.contains_head(ids[0], 'ee' * 32),
                   eng.main._head_prefixes is not None]
            for k, i in enumerate(ids):
                out.append((eng.contains_head(i, heads[k][0]),
                            eng.contains_head(i, heads[(k + 1) % 12][0])))
            return out
        out = _both(run)
        assert out[:3] == [True, False, True]
        assert all(hit and not miss for hit, miss in out[3:])

    def test_prefixes_survive_churn_and_vacuum(self, monkeypatch):
        self._threshold(monkeypatch, 8)

        def run(P, _root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet, vacuum_dead_fraction=None)
            handles = _workload(P, fleet, 16)
            heads = [list(h['state'].heads) for h in handles]
            ids = eng.park(handles)
            out = [eng.contains_head(ids[-1], 'aa' * 32)]
            eng.discard(ids[:8])
            out += [eng.contains_head(i, hs[0])
                    for i, hs in zip(ids[8:], heads[8:])]
            eng.vacuum_now()
            out.append(eng.main._head_prefixes is None)
            out += [eng.contains_head(i, hs[0])
                    for i, hs in zip(ids[8:], heads[8:])]
            out.append(eng.contains_head(ids[8], 'bb' * 32))
            return out
        out = _both(run)
        assert out[0] is False and out[-1] is False and all(out[1:-1])

    def test_additions_maintain_built_set(self, monkeypatch):
        self._threshold(monkeypatch, 4)

        def run(P, _root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            ids = eng.park(_workload(P, fleet, 6))
            out = [eng.contains_head(ids[0], 'cc' * 32)]
            more = _workload(P, fleet, 3)
            heads = [list(h['state'].heads) for h in more]
            more_ids = eng.park(more)
            out += [eng.contains_head(i, hs[0])
                    for i, hs in zip(more_ids, heads)]
            return out
        assert _both(run) == [False, True, True, True]


class _FakeDurable:
    def __init__(self):
        self.debt = {'bytes': 0, 'records': 0}
        self.compactions = 0

    def replay_debt(self):
        return dict(self.debt)

    def maybe_compact(self, force=False):
        self.compactions += 1
        self.debt = {'bytes': 0, 'records': 0}
        return True


class TestCostModel:
    @staticmethod
    def _churned_engine(P, n=16, discard=12):
        fleet = P.fleet()
        eng = P.S.StorageEngine(fleet, vacuum_dead_fraction=None)
        ids = eng.ingest_chunks(_saves(_workload(P, fleet, n)))
        eng.discard(ids[:discard])
        return eng

    def test_vacuum_fires_when_garbage_dominates(self):
        def run(P, _root):
            model = P.T.CostModel(min_garbage_bytes=1)
            eng = self._churned_engine(P)
            out = [eng.main.garbage_bytes > eng.main.chunk_bytes,
                   model.vacuum_due(eng.main, stage=0)]
            eng.cost_model = model
            out += [eng._maybe_vacuum(), eng.vacuums,
                    model.vacuum_due(eng.main, stage=0)]
            return out
        assert _both(run) == [True, True, True, 1, False]

    def test_vacuum_defers_under_brownout_stage2(self):
        def run(P, _root):
            model = P.T.CostModel(min_garbage_bytes=1,
                                  stage_write_penalty=1000.0)
            eng = self._churned_engine(P)
            return model.vacuum_due(eng.main, stage=0), \
                model.vacuum_due(eng.main, stage=2)
        assert _both(run) == (True, False)

    def test_vacuum_still_fires_under_pressure_when_debt_overwhelms(self):
        def run(P, _root):
            model = P.T.CostModel(min_garbage_bytes=1,
                                  stage_write_penalty=0.5)
            return model.vacuum_due(
                self._churned_engine(P, n=16, discard=15).main, stage=2)
        assert _both(run) is True

    def test_compact_decision_weighs_replay_debt(self):
        def run(P, _root):
            model = P.T.CostModel(min_replay_bytes=1024)
            dur = _FakeDurable()
            dur.debt = {'bytes': 512, 'records': 4}
            out = [model.compact_due(dur, stage=0)]
            dur.debt = {'bytes': 1 << 20, 'records': 5000}
            out.append(model.compact_due(dur, stage=0))
            model2 = P.T.CostModel(min_replay_bytes=1024,
                                   stage_write_penalty=50.0,
                                   replay_record_cost=0.0)
            out.append(model2.compact_due(dur, stage=2))
            dur.debt = {'bytes': 1 << 20, 'records': 10_000_000}
            model3 = P.T.CostModel(min_replay_bytes=1024,
                                   stage_write_penalty=50.0)
            out.append(model3.compact_due(dur, stage=2))
            return out
        assert _both(run) == [False, True, False, True]


class TestClockDemote:
    def test_demotes_cold_docs_under_pressure(self):
        def run(P, _root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            handles = _workload(P, fleet, 12)
            resident = {'docs': 12}
            policy = P.T.ClockDemote(eng, budget_bytes=4,
                                     source=lambda: resident['docs'],
                                     batch=4)
            policy.register(handles)
            hot = handles[:3]
            parked_total = []
            for _tick in range(8):
                policy.touch(hot)
                parked = policy.tick()
                parked_total.extend(parked)
                resident['docs'] = 12 - len(parked_total)
                if resident['docs'] <= 4:
                    break
            return parked_total, len(eng.main), \
                [bool(h.get('frozen')) for h in hot]
        parked, stored, hot_frozen = _both(run)
        assert len(parked) >= 8 and stored == len(parked)
        assert not any(hot_frozen)

    def test_no_pressure_no_demotion(self):
        def run(P, _root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            policy = P.T.ClockDemote(eng, budget_bytes=100,
                                     source=lambda: 1)
            policy.register(_workload(P, fleet, 4))
            return policy.tick(), len(eng.main)
        assert _both(run) == ([], 0)


class TestTieringController:
    def test_controller_replaces_threshold_and_drives_all_planes(self):
        def run(P, _root):
            fleet = P.fleet()
            eng = P.S.StorageEngine(fleet)
            dur = _FakeDurable()
            dur.debt = {'bytes': 4 << 20, 'records': 10_000}
            ctrl = P.T.TieringController(
                engine=eng, durable=dur,
                model=P.T.CostModel(min_garbage_bytes=1,
                                    min_replay_bytes=1024))
            out = [eng.vacuum_dead_fraction is None,
                   eng.cost_model is ctrl.model]
            ids = eng.ingest_chunks(_saves(_workload(P, fleet, 16)))
            eng.discard(ids[:12])
            tick = ctrl.tick(stage=0)
            return out, tick['compacted'], dur.compactions, eng.vacuums
        owned, compacted, compactions, vacuums = _both(run)
        assert owned == [True, True] and compacted and compactions == 1
        assert vacuums >= 1


def _mixed_batch(P, fleet, n=4):
    handles = _workload(P, fleet, n, rounds=2)
    big = encode_change({
        'actor': 'dd' * 16, 'seq': 1, 'startOp': CTR_LIMIT + 10,
        'time': 0, 'message': '', 'deps': list(handles[0]['heads']),
        'ops': [{'action': 'makeText', 'obj': '_root', 'key': 'deep',
                 'pred': []}]})
    handles, _ = P.fb.apply_changes_docs(
        handles, [[big]] + [[] for _ in handles[1:]], mirror=False)
    return handles


class TestMixedBatchRouting:
    def test_generate_byte_identical_with_straggler(self):
        def run(P, _root):
            fleet = P.fleet()
            handles = _mixed_batch(P, fleet)
            fleet.frontier_index()
            states = [P.host.init_sync_state() for _ in handles]
            for h, s in zip(handles, states):
                s['theirHeads'] = list(h['heads'])
                s['theirHave'] = [{'lastSync': list(h['heads']),
                                   'bloom': b''}]
                s['theirNeed'] = []
            new_states, messages = P.driver.generate_sync_messages_docs(
                handles, [dict(s) for s in states])
            prev = P.hi.set_frontier_enabled(False)
            try:
                classic_states, classic_msgs = \
                    P.driver.generate_sync_messages_docs(
                        handles, [dict(s) for s in states])
            finally:
                P.hi.set_frontier_enabled(prev)
            msgs = [None if m is None else bytes(m) for m in messages]
            return ([h['state'].is_fleet for h in handles], msgs,
                    msgs == [None if m is None else bytes(m)
                             for m in classic_msgs],
                    new_states == classic_states)
        fleet_flags, _msgs, same_msgs, same_states = _both(run)
        assert fleet_flags == [False, True, True, True]
        assert same_msgs and same_states

    def test_receive_mixed_batch_advances_all_docs(self):
        def run(P, _root):
            fleet = P.fleet()
            handles = _mixed_batch(P, fleet)
            fleet.frontier_index()
            bufs = [_change('ee' * 16, 1, 60 + i, list(h['heads']), 'new',
                            i) for i, h in enumerate(handles)]
            msgs = [P.sync.encode_sync_message({
                        'heads': [decode_change_meta(b, True)['hash']],
                        'need': [], 'have': [], 'changes': [b]})
                    for b in bufs]
            states = [P.host.init_sync_state() for _ in handles]
            new_handles, new_states, _p, errors = \
                P.driver.receive_sync_messages_docs(
                    handles, states, msgs, on_error='quarantine')
            return errors, [s['sharedHeads'] for s in new_states], \
                _saves(new_handles)
        errors, shared, _s = _both(run)
        assert errors == [None] * 4 and all(len(s) == 1 for s in shared)
