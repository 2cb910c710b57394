"""Differential tests of durability (fleet/durability.py): the journal's
frames and parsers, group commit, checkpoints and recovery, clone, free
and queue records, compaction chains, rot and torn tails. Each scenario
runs the same inputs through the JAX package's DurableFleet and the
torch port's (device='cpu') in two directories, and the two runs must
agree exactly: every file of the directory (names and bytes), the
RecoveryReport's fields, every recovered save(), and the durability
counters' deltas. Directories written by one package are also recovered
by the other.

The shapes are those of the reference's tests/test_durability.py (every
unmarked test; its crash-matrix dose is tests/test_torch_crash.py)."""

import glob
import os
import random
import shutil
import types

import pytest
import torch

import automerge_tpu as A
import automerge_tpu.native as jax_native
from automerge_tpu import backend as jax_host
from automerge_tpu.columnar import decode_change_meta, encode_change
from automerge_tpu.fleet import backend as jb
from automerge_tpu.fleet import durability as jd
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch import backend as torch_host
from automerge_tpu_torch import errors as torch_errors
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import durability as td

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (torch_native.available() and jax_native.available()),
    reason='a native codec is unavailable (the turbo seam and the '
    'reference comparison need both)')


def _package(fb, D, host, kw):
    return types.SimpleNamespace(
        fb=fb, D=D, host=host,
        fleet=lambda **k: fb.DocFleet(**k, **kw),
        durable=lambda path, **k: D.DurableFleet(path, **k, **kw),
        recover=lambda path, **k: D.DurableFleet.recover(path, **k, **kw))


REF = _package(jb, jd, jax_host, {})
PORT = _package(tb, td, torch_host, {'device': 'cpu'})


def _change(actor, seq, deps, value, start=1, key='k'):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': value, 'datatype': 'int', 'pred': []}]})


def _grow(P, mgr, handles, round_no, n=None):
    """One linear change per doc; returns new handles."""
    n = n if n is not None else len(handles)
    per_doc = []
    for i, h in enumerate(handles[:n]):
        per_doc.append([_change(f'{i:02x}' * 16, round_no,
                                P.fb.get_heads(h), round_no * 100 + i,
                                start=round_no)])
    per_doc += [[] for _ in handles[n:]]
    out, _patches, errors = mgr.apply_changes(handles, per_doc)
    assert not any(errors)
    return out


def _saves(P, handles):
    if isinstance(handles, dict):
        return {did: bytes(P.fb.save(h)) for did, h in handles.items()}
    return [bytes(P.fb.save(h)) for h in handles]


def _report(report):
    """Every RecoveryReport field, errors by stage and type name."""
    out = {k: getattr(report, k) for k in report.__slots__
           if k != 'quarantined'}
    out['quarantined'] = {did: (e.stage, type(e.error).__name__)
                          for did, e in report.quarantined.items()}
    out['ok'] = report.ok
    return out


def _tree(path):
    """{relative file name: bytes} of a directory."""
    out = {}
    for root, _dirs, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, 'rb') as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _both(tmp_path, scenario):
    """Run `scenario(P, path)` for the reference and the port; the
    results, the durability counters' deltas and the directories must be
    equal. Returns the reference's result and its directory."""
    runs = {}
    for name, P in (('ref', REF), ('port', PORT)):
        path = str(tmp_path / name)
        before = P.D.durability_stats()
        result = scenario(P, path)
        after = P.D.durability_stats()
        delta = {k: after[k] - before[k] for k in after}
        runs[name] = (result, delta, _tree(path) if os.path.isdir(path)
                      else None)
    want, got = runs['ref'], runs['port']
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert sorted(got[2] or {}) == sorted(want[2] or {})
    assert got[2] == want[2]
    return want[0], str(tmp_path / 'ref')


def _recover_both(path, tmp_path, **kw):
    """Recover copies of one directory with each package: saves and
    reports must agree, and so must the directories recovery leaves."""
    out = {}
    for name, P in (('ref', REF), ('port', PORT)):
        dst = str(tmp_path / f'recover-{name}')
        shutil.copytree(path, dst)
        mgr, rec, report = P.recover(dst, **kw)
        out[name] = (_saves(P, rec), _report(report))
        mgr.close()
        out[name] += (_tree(dst),)
    assert out['port'] == out['ref']
    return out['ref']


# ---------------------------------------------------------------------------
# framing and parsers: the same bytes parse alike, torn and rotted ones too
# ---------------------------------------------------------------------------


def _plain(x):
    """x with every exception inside it replaced by (type name, text),
    so results of the two packages compare."""
    if isinstance(x, BaseException):
        return type(x).__name__, str(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _parse(fn, blob):
    try:
        return _plain(fn(blob))
    except Exception as exc:    # noqa: BLE001 - compared by type name
        return type(exc).__name__


def _parse_journal(D, blob, strict=False):
    return _parse(lambda b: D.parse_journal_bytes(b, strict=strict), blob)


def test_frame_bytes_and_journal_parse_match():
    rng = random.Random(0)
    frames = [(jd.KIND_CHANGE, rng.randrange(1 << 31),
               bytes(rng.randrange(256) for _ in range(rng.randrange(200))))
              for _ in range(20)]
    blob = b''.join(jd.encode_frame(k, d, p) for k, d, p in frames)
    assert b''.join(td.encode_frame(k, d, p) for k, d, p in frames) == blob
    got = _parse_journal(td, blob)
    assert got == _parse_journal(jd, blob)
    assert got[0] == frames and got[1]['valid_end'] == len(blob)


def test_torn_tail_parse_matches():
    blob = b''.join(jd.encode_frame(jd.KIND_CHANGE, i, b'x' * 40)
                    for i in range(4))
    for cut in (len(blob) - 11, len(blob) - 1, 5, 0):
        torn = blob[:cut]
        assert _parse_journal(td, torn) == _parse_journal(jd, torn)
        assert _parse_journal(td, torn, strict=True) == \
            _parse_journal(jd, torn, strict=True)
    assert _parse_journal(td, blob[:-11], strict=True) == 'TornTail'


def test_rotted_stream_parse_matches():
    blob = b''.join(jd.encode_frame(jd.KIND_CHANGE, i, bytes([i]) * 30)
                    for i in range(5))
    frame_len = len(jd.encode_frame(jd.KIND_CHANGE, 0, b'\0' * 30))
    rng = random.Random(1)
    spots = [2 * frame_len + 20, 2 * frame_len + 3, 0, len(blob) - 2] + \
        [rng.randrange(len(blob)) for _ in range(12)]
    for at in spots:
        rot = bytearray(blob)
        rot[at] ^= 1 << (at % 8)
        rot = bytes(rot)
        assert _parse_journal(td, rot) == _parse_journal(jd, rot)
        assert _parse_journal(td, rot, strict=True) == \
            _parse_journal(jd, rot, strict=True)


def test_snapshot_and_manifest_parse_match():
    body = jd.encode_frame(jd.KIND_DOC, 0, b'doc0') + \
        jd.encode_frame(jd.KIND_QUEUED, 0, b'q0') + \
        jd.encode_frame(jd.KIND_END, 0, jd._U32.pack(2))
    manifest = jd.MANIFEST_MAGIC + jd.encode_frame(
        jd.KIND_END, 0, b'{"chain": [], "journal": "journal-00000000.log", '
        b'"journal_offset": 0, "next_doc_id": 3, "seq": 0, '
        b'"snapshot": null}')
    cases = [jd.SNAP_MAGIC + body, b'NOPE' + body,
             jd.SNAP_MAGIC + jd.encode_frame(jd.KIND_DOC, 0, b'doc0'),
             jd.SNAP_MAGIC + body[:-3], b'']
    rng = random.Random(2)
    for _ in range(8):
        rot = bytearray(jd.SNAP_MAGIC + body)
        rot[rng.randrange(len(rot))] ^= 1 << rng.randrange(8)
        cases.append(bytes(rot))
    for blob in cases:
        assert _parse(td.parse_snapshot_bytes, blob) == \
            _parse(jd.parse_snapshot_bytes, blob)
    for blob in (manifest, b'garbage', manifest[:-2],
                 manifest[:8] + b'\xff' + manifest[9:]):
        assert _parse(td.parse_manifest_bytes, blob) == \
            _parse(jd.parse_manifest_bytes, blob)
    assert _parse(td.parse_manifest_bytes, b'garbage') == 'MalformedSnapshot'
    assert td.MalformedSnapshot is torch_errors.MalformedSnapshot


# ---------------------------------------------------------------------------
# journal group commit / accounting
# ---------------------------------------------------------------------------


def test_group_commit_fsync_batching_matches(tmp_path):
    def run(P, path):
        os.makedirs(path)
        j = P.D.ChangeJournal(os.path.join(path, 'j.log'),
                              fsync_bytes=1 << 20)
        j.append(0, b'a' * 100)
        out = [(j.buffered_bytes, j.written_bytes)]
        j.commit()
        out.append((j.buffered_bytes, j.pending_fsync_bytes))
        j.sync()
        out.append(j.pending_fsync_bytes)
        j.close()
        return out
    result, _ = _both(tmp_path, run)
    assert result[1][0] == 0 and result[1][1] > 0 and result[2] == 0


def test_memory_stats_journal_accounting_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path, fsync_bytes=1 << 20)
        handles = mgr.init_docs(2)
        _grow(P, mgr, handles, 1)
        out = [mgr.fleet.memory_stats()['journal']]
        mgr.journal.sync()
        out.append(mgr.fleet.memory_stats()['journal'])
        mgr.close()
        return out
    result, _ = _both(tmp_path, run)
    assert result[0]['records'] >= 2 and result[0]['pending_fsync_bytes']
    assert result[1]['pending_fsync_bytes'] == 0


# ---------------------------------------------------------------------------
# checkpoint + recovery
# ---------------------------------------------------------------------------


def test_checkpoint_recover_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = mgr.init_docs(3)
        handles = _grow(P, mgr, handles, 1)
        mgr.checkpoint()
        handles = _grow(P, mgr, handles, 2)
        pre = _saves(P, handles)
        mgr.close()
        mgr2, rec, report = P.recover(path)
        assert _saves(P, [rec[i] for i in range(3)]) == pre
        h3 = _grow(P, mgr2, [rec[i] for i in range(3)], 3)
        mgr2.close()
        return pre, _report(report), _saves(P, h3)
    (_pre, report, _after), _ = _both(tmp_path, run)
    assert report['snapshot_docs'] == 3 and report['replayed_records'] == 3
    assert report['ok']


def test_recover_refuses_fresh_dir_reuse_matches(tmp_path):
    def run(P, path):
        P.durable(path).close()
        with pytest.raises(ValueError):
            P.durable(path)
        return sorted(os.listdir(path))
    _both(tmp_path, run)


def test_sync_seam_journals_received_changes_matches(tmp_path):
    """Changes arriving through the sync protocol journal with no
    explicit call; the peer is made with the reference's frontend and
    enters each package's host backend as the same saved bytes."""
    peer = A.change(A.init('aa' * 16), {'time': 0},
                    lambda d: d.update({'x': 1, 'y': 'hello'}))
    peer_bytes = bytes(A.save(peer))

    def run(P, path):
        peer_backend = P.host.load(peer_bytes)
        mgr = P.durable(path)
        handle = mgr.init_docs(1)[0]
        s1, s2 = P.host.init_sync_state(), P.host.init_sync_state()
        msgs = []
        for _ in range(8):
            s2, msg = P.host.generate_sync_message(peer_backend, s2)
            if msg is not None:
                handle, s1, _ = P.fb.receive_sync_message(handle, s1, msg)
            s1, msg2 = P.fb.generate_sync_message(handle, s1)
            if msg2 is not None:
                peer_backend, s2, _ = P.host.receive_sync_message(
                    peer_backend, s2, msg2)
            msgs.append((msg, msg2))
            if msg is None and msg2 is None:
                break
        pre = bytes(P.fb.save(handle))
        mgr.close()
        mgr2, rec, report = P.recover(path)
        assert bytes(P.fb.save(rec[0])) == pre
        mgr2.close()
        return msgs, pre, _report(report)
    (_msgs, _pre, report), _ = _both(tmp_path, run)
    assert report['replayed_records'] >= 1


def _queued_pair():
    actor = 'aa' * 16
    c1 = _change(actor, 1, [], 1, start=1)
    h1 = decode_change_meta(c1, True)['hash']
    return c1, _change(actor, 2, [h1], 2, start=2)


def test_queued_changes_survive_checkpoint_matches(tmp_path):
    c1, c2 = _queued_pair()

    def run(P, path):
        mgr = P.durable(path)
        handle = mgr.init_docs(1)[0]
        out, _p, errs = mgr.apply_changes([handle], [[c2]])
        assert not any(errs) and out[0]['state'].queue
        mgr.checkpoint()
        mgr.close()
        mgr2, rec, report = P.recover(path)
        queued = len(rec[0]['state'].queue)
        out, _p, errs = mgr2.apply_changes([rec[0]], [[c1]])
        assert not any(errs)
        mgr2.close()
        return queued, _report(report), P.fb.get_heads(out[0])
    (queued, _report_, heads), _ = _both(tmp_path, run)
    assert queued == 1 and len(heads) == 1


def test_checkpoint_preserves_successor_journal_matches(tmp_path):
    class _Die(Exception):
        pass

    def run(P, path):
        mgr = P.durable(path)
        _grow(P, mgr, mgr.init_docs(1), 1)
        stale = os.path.join(path, 'journal-00000001.log')
        blob = P.D.encode_frame(P.D.KIND_INIT, 7, b'')
        with open(stale, 'wb') as f:
            f.write(blob)
        orig = P.D.DurableFleet._fault
        P.D.DurableFleet._fault = lambda self, point: (_ for _ in ()).throw(
            _Die()) if point == 'snapshot-temp-written' else None
        try:
            with pytest.raises(_Die):
                mgr.checkpoint()
        finally:
            P.D.DurableFleet._fault = orig
        kept = open(stale, 'rb').read() == blob
        mgr.checkpoint()
        mgr.close()
        return kept, open(stale, 'rb').read() == blob
    assert _both(tmp_path, run)[0] == (True, False)


def test_clone_queue_survives_crash_matches(tmp_path):
    c1, c2 = _queued_pair()

    def run(P, path):
        mgr = P.durable(path)
        handle = mgr.init_docs(1)[0]
        out, _p, errs = mgr.apply_changes([handle], [[c2]])
        clone = P.fb.clone(out[0])
        clone_id = clone['state']._dur_id
        mgr.close()
        mgr2, rec, report = P.recover(path)
        queued = len(rec[clone_id]['state'].queue)
        out, _p, errs = mgr2.apply_changes([rec[clone_id]], [[c1]])
        assert not any(errs)
        mgr2.close()
        return clone_id, queued, _report(report), _saves(P, out)
    (_cid, queued, _r, _s), _ = _both(tmp_path, run)
    assert queued == 1


def test_clone_is_journaled_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(1), 1)
        clone = P.fb.clone(handles[0])
        pre = bytes(P.fb.save(clone))
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return pre, _saves(P, rec), _report(report)
    pre, saves, _r = _both(tmp_path, run)[0]
    assert len(saves) == 2 and pre in saves.values()


# ---------------------------------------------------------------------------
# freed / never-used slots, rebuild, id fencing
# ---------------------------------------------------------------------------


def test_freed_and_never_used_slots_roundtrip_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = mgr.init_docs(4)
        handles = _grow(P, mgr, handles, 1, n=3)
        freed_slot = handles[1]['state']._impl.slot
        P.fb.free_docs([handles[1]])
        reused = mgr.init_docs(1)[0]
        assert reused['state']._impl.slot == freed_slot
        reused = _grow(P, mgr, [reused], 1)[0]
        mgr.checkpoint()
        pre = {0: bytes(P.fb.save(handles[0])),
               2: bytes(P.fb.save(handles[2])), 4: bytes(P.fb.save(reused))}
        mgr.close()
        mgr2, rec, report = P.recover(path)
        saves = _saves(P, rec)
        grown = _grow(P, mgr2, [rec[3]], 1)
        mgr2.close()
        return pre, saves, _report(report), _saves(P, grown)
    pre, saves, _r, _g = _both(tmp_path, run)[0]
    assert sorted(saves) == [0, 2, 3, 4]
    assert all(saves[did] == want for did, want in pre.items())


def test_free_docs_batch_writes_one_commit_matches(tmp_path):
    """free_docs records every FREE with commit=False and group-commits
    once per batch: the journal frames and the commit counter agree."""
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(6), 1)
        before = P.D.durability_stats()['journal_commits']
        P.fb.free_docs(handles[1:5])
        commits = P.D.durability_stats()['journal_commits'] - before
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return commits, sorted(rec), _report(report)
    commits, ids, report = _both(tmp_path, run)[0]
    assert commits == 1 and ids == [0, 5]
    assert report['freed_docs'] == [1, 2, 3, 4]


def test_rebuild_docs_keeps_durability_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(2), 1)
        old_fleet = mgr.fleet
        fresh = P.fleet(doc_capacity=4, key_capacity=64)
        rebuilt = P.fb.rebuild_docs(handles, fresh)
        mgr.adopt_fleet(fresh)
        assert old_fleet.journal is None and fresh.journal is mgr.journal
        ids = [h['state']._dur_id for h in rebuilt]
        rebuilt = _grow(P, mgr, rebuilt, 2)
        mgr.checkpoint()
        pre = _saves(P, rebuilt)
        mgr.close()
        mgr2, rec, report = P.recover(path)
        assert _saves(P, [rec[i] for i in range(2)]) == pre
        mgr2.close()
        return ids, pre, _report(report)
    assert _both(tmp_path, run)[0][0] == [0, 1]


def test_rebuild_docs_moves_the_journal_across_matches(tmp_path):
    """With one source journal and an unjournaled target, rebuild_docs
    itself moves the journal to the new fleet (no adopt_fleet): the
    source is detached, later changes journal through the target, and
    the rebuilt documents recover."""
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(3), 1)
        src = mgr.fleet
        fresh = P.fleet(doc_capacity=4, key_capacity=64)
        rebuilt = P.fb.rebuild_docs(handles, fresh)
        moved = (src.journal is None, fresh.journal is mgr.journal,
                 all(h.get('frozen') for h in handles))
        ids = [h['state']._dur_id for h in rebuilt]
        per_doc = [[_change(f'{i:02x}' * 16, 2, P.fb.get_heads(h), 7 + i,
                            start=2)] for i, h in enumerate(rebuilt)]
        rebuilt, _p = P.fb.apply_changes_docs(rebuilt, per_doc,
                                              mirror=False)
        pre = _saves(P, rebuilt)
        mgr.journal.sync()
        mgr.close()
        mgr2, rec, report = P.recover(path)
        assert _saves(P, [rec[i] for i in range(3)]) == pre
        mgr2.close()
        return moved, ids, pre, _report(report)
    moved, ids, _pre, report = _both(tmp_path, run)[0]
    assert moved == (True, True, True) and ids == [0, 1, 2]
    assert report['replayed_records'] == 6


def test_rebuild_docs_from_two_journals_detaches_both_matches(tmp_path):
    """Two source journals: both sources detach and the target stays
    unjournaled (the caller re-homes the managers)."""
    def run(P, path):
        mgrs = [P.durable(os.path.join(path, f'd{k}')) for k in range(2)]
        handles = [_grow(P, m, m.init_docs(1), 1)[0] for m in mgrs]
        fresh = P.fleet(doc_capacity=4, key_capacity=64)
        rebuilt = P.fb.rebuild_docs(handles, fresh)
        out = ([m.fleet.journal is None for m in mgrs],
               fresh.journal is None,
               [h['state']._dur_id for h in rebuilt], _saves(P, rebuilt))
        for m in mgrs:
            m.close()
        return out
    detached, unjournaled, ids, _s = _both(tmp_path, run)[0]
    assert detached == [True, True] and unjournaled and ids == [0, 0]


def test_recovery_never_recycles_freed_doc_ids_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(3), 1)
        P.fb.free_docs([handles[2]])
        mgr.close()
        mgr2, rec, report = P.recover(path)
        fresh = mgr2.init_docs(1)[0]
        mgr2.close()
        return fresh['state']._dur_id, sorted(rec), _report(report)
    assert _both(tmp_path, run)[0][0] >= 3


def test_free_before_any_checkpoint_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(2), 1)
        P.fb.free_docs([handles[0]])
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return _saves(P, rec), _report(report)
    saves, report = _both(tmp_path, run)[0]
    assert sorted(saves) == [1] and report['freed_docs'] == [0]


# ---------------------------------------------------------------------------
# containment: rot quarantines one doc, torn tails truncate
# ---------------------------------------------------------------------------


def _journal_path(path):
    names = sorted(glob.glob(os.path.join(path, 'journal-*.log')))
    assert names
    return names[-1]


def _rot_doc_change(path, doc, nth):
    """Flip one payload bit in doc `doc`'s `nth` CHANGE frame."""
    jp = _journal_path(path)
    data = bytearray(open(jp, 'rb').read())
    off, target, seen = 0, None, {}
    while off < len(data):
        kind, did, _p, end, status = jd._frame_at(bytes(data), off)
        assert status == 'ok'
        if kind == jd.KIND_CHANGE:
            seen[did] = seen.get(did, 0) + 1
            if did == doc and seen[did] == nth:
                target = off
        off = end
    data[target + 20] ^= 0x08
    open(jp, 'wb').write(bytes(data))


def test_rotted_record_quarantines_exactly_one_doc_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(3), 1)
        handles = _grow(P, mgr, handles, 2)
        pre = _saves(P, handles)
        mgr.close()
        _rot_doc_change(path, 1, 2)
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return pre, _saves(P, rec), _report(report)
    pre, saves, report = _both(tmp_path, run)[0]
    assert sorted(report['quarantined']) == [1]
    assert saves[0] == pre[0] and saves[2] == pre[2] and saves[1] != pre[1]


def test_torn_tail_counter_and_truncation_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        _grow(P, mgr, mgr.init_docs(2), 1)
        mgr.close()
        jp = _journal_path(path)
        data = open(jp, 'rb').read()
        open(jp, 'wb').write(data[:-5])
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return _saves(P, rec), _report(report), \
            [P.fb.get_heads(rec[i]) for i in range(2)]
    _saves_, report, heads = _both(tmp_path, run)[0]
    assert report['torn_tail_bytes'] > 0
    assert len(heads[0]) == 1 and heads[1] == []


def test_newest_snapshot_rot_falls_back_a_generation_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(2), 1)
        mgr.checkpoint()
        handles = _grow(P, mgr, handles, 2)
        mgr.checkpoint()
        handles = _grow(P, mgr, handles, 3)
        pre = _saves(P, handles)
        mgr.close()
        snaps = sorted(glob.glob(os.path.join(path, 'snapshot-*.snap')))
        blob = bytearray(open(snaps[-1], 'rb').read())
        blob[0] ^= 0xFF
        open(snaps[-1], 'wb').write(bytes(blob))
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return len(snaps), pre, _saves(P, [rec[i] for i in range(2)]), \
            _report(report)
    n_snaps, pre, saves, report = _both(tmp_path, run)[0]
    assert n_snaps == 2 and report['used_fallback_manifest']
    assert saves == pre


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def test_cost_triggered_compaction_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path, compact_bytes=400)
        handles = mgr.init_docs(2)
        for r in range(1, 5):
            handles = _grow(P, mgr, handles, r)
        debt = mgr.replay_debt()
        pre = _saves(P, handles)
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return debt, pre, _saves(P, [rec[i] for i in range(2)]), \
            _report(report)
    debt, pre, saves, _r = _both(tmp_path, run)[0]
    assert debt['bytes'] < 600 and saves == pre


def test_incremental_compaction_work_tracks_churn_matches(tmp_path):
    n, k = 40, 3

    def run(P, path):
        mgr = P.durable(path, compact_bytes=1 << 40,
                        compact_records=1 << 40)
        handles = _grow(P, mgr, mgr.init_docs(n), 1)
        mgr.checkpoint()
        per_doc = [[] for _ in range(n)]
        for i in range(k):
            per_doc[i] = [_change(f'{i:02x}' * 16, 2,
                                  P.fb.get_heads(handles[i]), 999 + i,
                                  start=2)]
        handles, _p, errs = mgr.apply_changes(handles, per_doc)
        assert not any(errs)
        compacted = mgr.maybe_compact(force=True)
        chain = list(mgr.chain)
        idle = (mgr.compact(), mgr.maybe_compact(force=True))
        pre = _saves(P, handles)
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return compacted, chain, idle, pre, \
            _saves(P, [rec[i] for i in range(n)]), _report(report)
    compacted, chain, idle, pre, saves, report = _both(tmp_path, run)[0]
    assert compacted and len(chain) == 2 and idle == (False, False)
    assert saves == pre and report['ok']


def _segment_chain(exact_device, mirror):
    def run(P, path):
        mgr = P.durable(path, exact_device=exact_device)
        handles = _grow(P, mgr, mgr.init_docs(6), 1)
        mgr.checkpoint()
        seqs = [1] * len(handles)
        for r in (2, 3, 4):
            per_doc = [[] for _ in handles]
            for i in range(r - 2, r + 1):
                seqs[i] += 1
                per_doc[i] = [_change(f'{i:02x}' * 16, seqs[i],
                                      P.fb.get_heads(handles[i]), r * 10 + i,
                                      start=seqs[i])]
            handles, _p, errs = mgr.apply_changes(handles, per_doc,
                                                  mirror=mirror)
            assert not any(errs)
            assert mgr.maybe_compact(force=True)
        P.fb.free_docs([handles[5]])
        assert mgr.maybe_compact(force=True)
        chain = list(mgr.chain)
        pre = {i: bytes(P.fb.save(handles[i])) for i in range(5)}
        mgr.close()
        mgr2, rec, report = P.recover(path, exact_device=exact_device,
                                      mirror=mirror)
        mgr2.close()
        return chain, pre, _saves(P, rec), _report(report)
    return run


def test_segment_chain_recovery_matches_lww(tmp_path):
    chain, pre, saves, report = _both(tmp_path, _segment_chain(False,
                                                               False))[0]
    assert len(chain) >= 4 and saves == pre and report['ok']


def test_segment_chain_recovery_matches_lww_mirror(tmp_path):
    chain, pre, saves, report = _both(tmp_path, _segment_chain(False,
                                                               True))[0]
    assert len(chain) >= 4 and saves == pre and report['ok']


def test_segment_chain_recovery_matches_exact(tmp_path):
    chain, pre, saves, report = _both(tmp_path, _segment_chain(True,
                                                               False))[0]
    assert len(chain) >= 4 and saves == pre and report['ok']


def test_first_compaction_without_checkpoint_cuts_a_base_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(3), 1)
        chains = [list(mgr.chain), mgr.maybe_compact(force=True),
                  list(mgr.chain)]
        handles = _grow(P, mgr, handles, 2)
        chains += [mgr.maybe_compact(force=True), list(mgr.chain)]
        pre = _saves(P, handles)
        mgr.close()
        mpath = os.path.join(path, 'MANIFEST')
        data = bytearray(open(mpath, 'rb').read())
        data[8] ^= 0xff
        open(mpath, 'wb').write(bytes(data))
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return chains, pre, _saves(P, [rec[i] for i in range(3)]), \
            _report(report)
    chains, pre, saves, report = _both(tmp_path, run)[0]
    assert len(chains[2]) == 1 and len(chains[4]) == 2
    assert report['used_fallback_manifest'] and saves == pre


def test_chain_escalates_to_full_checkpoint_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path, max_chain=3)
        handles = mgr.init_docs(2)
        lengths = []
        for r in range(1, 8):
            handles = _grow(P, mgr, handles, r)
            mgr.maybe_compact(force=True)
            lengths.append(len(mgr.chain))
        pre = _saves(P, handles)
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return lengths, pre, _saves(P, [rec[i] for i in range(2)]), \
            _report(report)
    lengths, pre, saves, report = _both(tmp_path, run)[0]
    assert max(lengths) <= 3 and saves == pre and report['ok']


def test_recovery_rejournals_instead_of_resnapshotting_matches(tmp_path):
    def run(P, path):
        mgr = P.durable(path)
        handles = _grow(P, mgr, mgr.init_docs(8), 1)
        mgr.checkpoint()
        handles = _grow(P, mgr, handles, 2)
        pre = _saves(P, handles)
        mgr.close()
        snaps = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(path, 'snapshot-*.snap')))
        reports = []
        for _ in range(2):
            mgr2, rec, report = P.recover(path)
            assert _saves(P, [rec[i] for i in range(8)]) == pre
            reports.append(_report(report))
            mgr2.close()
        after = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(path, 'snapshot-*.snap')))
        return snaps == after, reports
    same, reports = _both(tmp_path, run)[0]
    assert same and reports[0]['replayed_records'] == 8


# ---------------------------------------------------------------------------
# the seam's journal hooks, byte for byte
# ---------------------------------------------------------------------------


def _seam_changes(n_docs, rounds, seed):
    """Per round, per doc: one change (a linear chain per doc) or none."""
    rng = random.Random(seed)
    seqs, heads, out = [0] * n_docs, [[] for _ in range(n_docs)], []
    for r in range(rounds):
        batch = []
        for i in range(n_docs):
            if rng.random() >= 0.8:
                batch.append([])
                continue
            seqs[i] += 1
            buf = _change(f'{i:02x}' * 16, seqs[i], heads[i],
                          rng.randrange(99), start=seqs[i], key=f'k{r}')
            heads[i] = [decode_change_meta(buf, True)['hash']]
            batch.append([buf])
        out.append(batch)
    return out


def test_turbo_seam_journal_matches_plain_and_split_batches(tmp_path):
    """The turbo seam's record_seam writes the reference's bytes, for
    batches applied in one call and for one applied through sequential
    calls over the thirds of each doc's changes (empty thirds skipped),
    over batches big enough for the columnar batch frame and small
    enough for per-record frames."""
    batches = _seam_changes(24, 3, seed=5)

    def run(P, path):
        mgr = P.durable(path)
        handles = mgr.init_docs(24)
        for k, per_doc in enumerate(batches):
            steps = [-(-len(c) // 3) if k == 1 else len(c) for c in per_doc]
            for s in range(3 if k == 1 else 1):
                split = [c[s * n:(s + 1) * n] for c, n in zip(per_doc, steps)]
                if any(split):
                    handles, _p = P.fb.apply_changes_docs(handles, split,
                                                          mirror=False)
        few = [[] for _ in handles]
        few[0] = [_change('ee' * 16, 1, P.fb.get_heads(handles[0]), 5,
                          start=9, key='z')]
        handles, _p = P.fb.apply_changes_docs(handles, few, mirror=False)
        mgr.journal.sync()
        records, info = P.D.parse_journal_bytes(
            open(_journal_path(path), 'rb').read())
        pre = _saves(P, handles)
        mgr.close()
        mgr2, rec, report = P.recover(path)
        mgr2.close()
        return records, info, pre, _saves(P, [rec[i] for i in range(24)]), \
            _report(report)
    records, _info, pre, saves, _r = _both(tmp_path, run)[0]
    assert saves == pre
    changes = [p for k, _d, p in records if k == jd.KIND_CHANGE]
    assert len(changes) == sum(len(d) for b in batches for d in b) + 1


# ---------------------------------------------------------------------------
# across packages: a directory written by one recovers in the other
# ---------------------------------------------------------------------------


def _write_dir(P, path, exact=False):
    """A directory with a checkpoint, a compacted segment, a queued
    change, a clone, a freed doc and a journal suffix; the manager is
    returned unclosed (the crash)."""
    _c1, c2 = _queued_pair()
    mgr = P.durable(path, exact_device=exact)
    handles = _grow(P, mgr, mgr.init_docs(5), 1)
    mgr.checkpoint()
    handles = _grow(P, mgr, handles, 2, n=4)
    _out, _p, errs = mgr.apply_changes(handles[4:], [[c2]])
    assert not any(errs)
    P.fb.clone(handles[0])
    P.fb.free_docs([handles[3]])
    assert mgr.maybe_compact(force=True)
    _grow(P, mgr, handles[:3], 3)
    mgr.journal.sync()
    return mgr


@pytest.mark.parametrize('writer', ['ref', 'port'])
def test_directory_recovers_across_packages(tmp_path, writer):
    P = REF if writer == 'ref' else PORT
    path = str(tmp_path / 'written')
    _write_dir(P, path)
    saves, report, _tree_ = _recover_both(path, tmp_path)
    assert report['ok'] and sorted(saves) == [0, 1, 2, 4, 5]


def test_directories_written_by_each_package_are_equal(tmp_path):
    def run(P, path):
        _write_dir(P, path, exact=True)
        return None
    _, path = _both(tmp_path, run)
    saves, report, _t = _recover_both(path, tmp_path, exact_device=True)
    assert report['ok'] and len(saves) == 5


def test_rotted_directory_recovers_alike_in_both_packages(tmp_path):
    path = str(tmp_path / 'written')
    _write_dir(PORT, path)
    _rot_doc_change(path, 1, 1)
    jp = _journal_path(path)
    data = open(jp, 'rb').read()
    open(jp, 'wb').write(data[:-3])
    _saves_, report, _t = _recover_both(path, tmp_path)
    assert report['torn_tail_bytes'] > 0
    assert sorted(report['quarantined']) == [1]


def test_durable_fleet_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        td.DurableFleet(str(tmp_path / 'dur'))
    mgr = td.DurableFleet(str(tmp_path / 'cpu'), device='cpu')
    assert mgr.fleet.device == torch.device('cpu')
    mgr.close()
    with pytest.raises(RuntimeError, match='CUDA'):
        td.DurableFleet.recover(str(tmp_path / 'cpu'))
    mgr, _rec, _report = td.DurableFleet.recover(str(tmp_path / 'cpu'),
                                                 device='cpu')
    mgr.close()
