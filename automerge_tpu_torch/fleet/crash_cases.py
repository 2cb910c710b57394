"""Crash-injection cases for the port's durability layer
(fleet/durability.py): the torch port's copy of tools/crashtest.py's
harness (`build_run`, `journal_record_spans`, `expected_saves`,
`_recover_and_compare`, `run_crashtest`), with one difference: a
`device=` keyword that places every DocFleet a run builds (CUDA unless
the caller names another). It lives in the package, as sync_cases.py
and seq_cases.py do, so the CPU tests and chip_smoke.py share it.

Run a seeded dose with
`run_crashtest(n_seeds=1, n_points=2, modes=['lww'], device='cpu')`;
an empty `failures` list is green. The reference's description of the
matrix follows.

Runs a scripted journaled workload (N docs, R rounds, a checkpoint in the
middle), then injects faults into a COPY of the durability directory and
recovers it, proving the recovery contract for every injected crash
point:

- **kill matrix** — truncate the journal at seeded random byte offsets
  (the on-disk effect of a process killed mid-write: the suffix was
  simply never written, possibly splitting the final frame);
- **torn final frame** — cut mid-way through the journal's last frame;
- **bit-rot matrix** — flip one seeded bit inside a journal CHANGE frame
  (header, payload, or CRC bytes) and inside a snapshot DOC frame;
- **checkpoint-crash matrix** — die at each labeled step of the
  checkpoint protocol (temp snapshot written, snapshot renamed, journal
  rotated, manifest flipped) via the ``DurableFleet._fault`` hook.

For every fault the recovered fleet must satisfy the byte-identical
expectation: each unaffected doc's ``save()`` equals the pre-crash
checkpoint + replayed-suffix state, and the (at most one) victim doc
lands exactly on its longest surviving change prefix — with torn tails
truncated and rotted records reported typed (report + health counters),
never as an untyped escape or a fleet-wide failure.

The expectation model is independent of the recovery code path: it
parses the PRE-fault journal for frame boundaries, computes the
surviving record set implied by the fault (complete frames below a
truncation offset; everything except the damaged frame and the victim's
subsequent records for rot), and replays that set through a fresh CLEAN
fleet.

Modes cover the replay matrix: the LWW-grid fleet through the turbo path
(``lww``), the same grid through the host-exact mirror path
(``lww-mirror``), and the exact-device register engine (``exact``).
"""

import os
import random
import shutil
import sys
import tempfile

from ..columnar import encode_change
from ..errors import AutomergeError
from . import backend as fleet_backend
from . import durability as D
from .backend import DocFleet
from .durability import DurableFleet

MODES = {
    'lww': dict(exact_device=False, mirror=False),
    'lww-mirror': dict(exact_device=False, mirror=True),
    'exact': dict(exact_device=True, mirror=False),
}


class _SimulatedCrash(Exception):
    pass


class _CrashingFleet(DurableFleet):
    """DurableFleet that dies at a chosen checkpoint-protocol step."""

    crash_at = None

    def _fault(self, point):
        if point == self.crash_at:
            raise _SimulatedCrash(point)


# ---------------------------------------------------------------------------
# scripted workload
# ---------------------------------------------------------------------------


class _DocScript:
    """Deterministic single-actor linear change chain for one doc."""

    def __init__(self, idx):
        self.actor = f'{idx:02x}' * 16
        self.seq = 0
        self.start_op = 1

    def make(self, heads, rng):
        self.seq += 1
        n_ops = 1 + (rng.random() < 0.3)
        ops = [{'action': 'set', 'obj': '_root',
                'key': f'k{rng.randrange(8)}',
                'value': rng.randrange(1000), 'datatype': 'int',
                'pred': []} for _ in range(n_ops)]
        buf = encode_change({
            'actor': self.actor, 'seq': self.seq, 'startOp': self.start_op,
            'time': 0, 'message': '', 'deps': list(heads), 'ops': ops})
        self.start_op += n_ops
        return buf


def build_run(path, n_docs=5, rounds=6, checkpoint_at=2, seed=0,
              exact_device=False, mirror=False, free_doc=None,
              compact_every=None, device=None):
    """Run the scripted workload into a fresh durability dir. Returns
    (pre_crash_saves {doc_id: save bytes}, freed doc ids).
    `compact_every=k` forces an INCREMENTAL per-doc compaction every k
    rounds (a chain of segments over the base snapshot) — the recovery
    under test must stitch per-doc generations back together."""
    mgr = DurableFleet(path, exact_device=exact_device, device=device)
    handles = mgr.init_docs(n_docs)
    scripts = [_DocScript(i) for i in range(n_docs)]
    rng = random.Random(seed)
    freed = []
    for r in range(rounds):
        per_doc = []
        for d in range(n_docs):
            if handles[d].get('frozen') or (r > 0 and rng.random() < 0.15):
                per_doc.append([])
                continue
            per_doc.append([scripts[d].make(
                fleet_backend.get_heads(handles[d]), rng)])
        out = mgr.apply_changes(handles, per_doc, mirror=mirror)
        handles, _patches, errors = out
        assert not any(errors), f'clean workload rejected: {errors}'
        if r == checkpoint_at:
            mgr.checkpoint()
        if free_doc is not None and r == rounds - 2 and \
                not handles[free_doc].get('frozen'):
            fleet_backend.free_docs([handles[free_doc]])
            freed.append(free_doc)
        if compact_every and r != checkpoint_at and \
                (r + 1) % compact_every == 0:
            mgr.maybe_compact(force=True)
    saves = {d: bytes(fleet_backend.save(handles[d]))
             for d in range(n_docs) if not handles[d].get('frozen')}
    mgr.close()
    return saves, freed


# ---------------------------------------------------------------------------
# expectation model (independent of the recovery code path)
# ---------------------------------------------------------------------------


def journal_record_spans(path):
    """Per-RECORD layout of the manifest's journal in a CLEAN
    (pre-fault) dir. Returns (jpath, data, spans, frame_bounds): spans
    aligns index-for-index with read_state()['journal_records'] and
    carries each record's payload byte span plus `req_end` — the offset
    that must be fully on disk for the record to survive a truncation
    (frame end for per-record frames; the record's own payload end for
    columnar batch frames, whose tables and per-record CRCs precede the
    payloads). frame_bounds lists outer frame (start, end) pairs."""
    st = D.read_state(path)
    jpath = os.path.join(path, st['manifest']['journal'])
    data = open(jpath, 'rb').read()
    spans = []
    frame_bounds = []
    off = int(st['manifest'].get('journal_offset') or 0)
    while off < len(data):
        kind, doc_id, payload, end, status = D._frame_at(data, off)
        assert status == 'ok', f'clean journal has a bad frame: {status}'
        if kind == D.KIND_BATCH:
            dids, _rcrcs, starts, ends, expected_end = D._batch_spans(
                data, off, doc_id, len(data))
            for i in range(doc_id):
                spans.append({'kind': D.KIND_CHANGE, 'did': int(dids[i]),
                              'pay': (int(starts[i]), int(ends[i])),
                              'req_end': int(ends[i]), 'batch': True})
            frame_bounds.append((off, expected_end))
            off = expected_end
        else:
            spans.append({'kind': kind, 'did': doc_id,
                          'pay': (end - 4 - len(payload), end - 4),
                          'req_end': end, 'batch': False})
            frame_bounds.append((off, end))
            off = end
    return jpath, data, spans, frame_bounds


def expected_saves(path, surviving_filter, quarantine_snapshot_doc=None,
                   device=None):
    """Per-doc save() bytes a correct recovery must produce, computed by
    replaying the surviving record set through a fresh clean fleet.
    `surviving_filter(i, frame)` says whether the i-th journal frame
    survives the fault; `quarantine_snapshot_doc` marks one snapshot doc
    whose baseline was rotted away (it restarts empty)."""
    st = D.read_state(path)
    baseline = dict(st['docs'])
    queued = {d: list(v) for d, v in st['queued'].items()}
    if quarantine_snapshot_doc is not None:
        baseline.pop(quarantine_snapshot_doc, None)
        queued.pop(quarantine_snapshot_doc, None)
    per = {d: [] for d in baseline}
    exists = set(baseline)
    broken = set()
    freed_in_journal = set()
    for i, (kind, did, payload) in enumerate(st['journal_records']):
        if not surviving_filter(i, (kind, did, payload)):
            # the victim loses this record AND every later one of its
            # own (recovery either skips them by policy or the causal
            # gate holds them back — same save() either way)
            if did is not None:
                broken.add(did)
            continue
        if kind == D.KIND_INIT:
            exists.add(did)
            per.setdefault(did, [])
        elif kind == D.KIND_CHANGE:
            if did in broken:
                continue
            exists.add(did)
            per.setdefault(did, []).append(bytes(payload))
        elif kind == D.KIND_FREE:
            exists.discard(did)
            per.pop(did, None)
            broken.discard(did)
            freed_in_journal.add(did)
    if quarantine_snapshot_doc is not None and \
            quarantine_snapshot_doc not in freed_in_journal:
        # its journal suffix cannot apply without the baseline — the doc
        # restarts empty (unless a surviving FREE record deleted it)
        exists.add(quarantine_snapshot_doc)
        per[quarantine_snapshot_doc] = []
    fleet = DocFleet(doc_capacity=8, key_capacity=64, device=device)
    handles = {}
    ids = sorted(exists)
    for did in ids:
        if baseline.get(did):
            handles[did] = fleet_backend.load(bytes(baseline[did]), fleet)
        else:
            handles[did] = fleet_backend.init(fleet)
    work_ids = [d for d in ids if queued.get(d) or per.get(d)]
    if work_ids:
        out, _p, errs = fleet_backend.apply_changes_docs(
            [handles[d] for d in work_ids],
            [list(queued.get(d, [])) + list(per.get(d, []))
             for d in work_ids],
            mirror=False, on_error='quarantine')
        assert not any(errs), f'expectation replay rejected: {errs}'
        for did, handle in zip(work_ids, out):
            handles[did] = handle
    return {did: bytes(fleet_backend.save(handles[did])) for did in ids}


# ---------------------------------------------------------------------------
# fault injection + verification
# ---------------------------------------------------------------------------


def _recover_and_compare(case, faulted_dir, expect, mode, failures,
                         expect_torn=False, expect_rot=False,
                         expect_damage=False, expect_quarantined=(),
                         allow_differ=(), device=None):
    h0 = D.durability_stats()
    try:
        mgr, handles, report = DurableFleet.recover(
            faulted_dir, device=device,
            **{'exact_device': MODES[mode]['exact_device'],
               'mirror': MODES[mode]['mirror']})
    except AutomergeError as exc:
        failures.append(f'{case}: typed recovery failure (should have '
                        f'contained): {type(exc).__name__}: {exc}')
        return None
    except Exception as exc:        # noqa: BLE001 - the harness net
        failures.append(f'{case}: UNTYPED escape: '
                        f'{type(exc).__name__}: {exc}')
        return None
    try:
        got = {did: bytes(fleet_backend.save(h))
               for did, h in handles.items()}
        if sorted(got) != sorted(expect):
            failures.append(f'{case}: doc set {sorted(got)} != expected '
                            f'{sorted(expect)} (report {report})')
            return report
        for did in sorted(expect):
            if did in allow_differ:
                # the fault took this doc's newest persisted copy; it
                # recovers to an OLDER generation (segment-chain rot) —
                # equality is asserted for everyone else
                continue
            if got[did] != expect[did]:
                failures.append(
                    f'{case}: doc {did} save bytes diverge from the '
                    f'checkpoint+suffix expectation (report {report})')
        h1 = D.durability_stats()
        if expect_torn and h1['journal_truncations'] <= \
                h0['journal_truncations']:
            failures.append(f'{case}: torn tail not counted')
        if expect_rot and h1['rotted_records'] <= h0['rotted_records']:
            failures.append(f'{case}: rotted record not counted')
        if expect_damage and not (report.rotted_records or
                                  report.torn_tail_bytes):
            failures.append(f'{case}: damage not reported at all')
        for did in expect_quarantined:
            if did not in report.quarantined:
                failures.append(f'{case}: doc {did} expected in '
                                f'quarantine, report {report}')
        if len(report.quarantined) > 1:
            failures.append(f'{case}: blast radius {len(report.quarantined)}'
                            f' docs > 1 (report {report})')
        return report
    finally:
        mgr.close()


def run_crashtest(n_seeds=None, n_points=None, modes=None, verbose=False,
                  device=None):
    """Returns {'cases', 'failures': [...]}; empty failures = green.
    `device` places every DocFleet the run builds (CUDA unless named)."""
    n_seeds = n_seeds if n_seeds is not None else \
        int(os.environ.get('CRASH_SEEDS', '2'))
    n_points = n_points if n_points is not None else \
        int(os.environ.get('CRASH_POINTS', '4'))
    modes = modes or list(os.environ.get('CRASH_MODES',
                                         'lww,lww-mirror,exact').split(','))
    failures = []
    cases = 0
    root = tempfile.mkdtemp(prefix='crashtest-')
    try:
        for mode in modes:
            cfg = MODES[mode]
            for seed in range(n_seeds):
                base = os.path.join(root, f'{mode}-{seed}')
                # 12 docs/round crosses the columnar-batch threshold
                # (_BATCH_MIN); skip-rounds drop below it, so both frame
                # formats land in one journal
                build_run(base, n_docs=12, seed=seed,
                          free_doc=4 if seed % 2 else None,
                          exact_device=cfg['exact_device'],
                          mirror=cfg['mirror'], device=device)
                jpath, jdata, spans, frame_bounds = \
                    journal_record_spans(base)
                jname = os.path.basename(jpath)
                rng = random.Random(1000 + seed)

                def faulted(tag, mutate):
                    """Copy the dir, apply `mutate(journal bytes) ->
                    bytes` to the journal, return the copy's path."""
                    dst = os.path.join(root, f'{mode}-{seed}-{tag}')
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    shutil.copytree(base, dst)
                    with open(os.path.join(dst, jname), 'wb') as f:
                        f.write(mutate(jdata))
                    return dst

                # ---- kill at random offset (journal truncation)
                offsets = [rng.randrange(len(jdata) + 1)
                           for _ in range(n_points)]
                # always include the torn-final-frame case explicitly
                if frame_bounds:
                    s, e = frame_bounds[-1]
                    offsets.append(rng.randrange(s + 1, e))
                for j, cut in enumerate(offsets):
                    cases += 1
                    tag = f'kill@{cut}'
                    dst = faulted(f'kill{j}', lambda d, c=cut: d[:c])
                    expect = expected_saves(
                        base, lambda i, fr, c=cut: spans[i]['req_end'] <= c,
                        device=device)
                    torn = any(s < cut < e for s, e in frame_bounds)
                    _recover_and_compare(f'{mode}/{seed}/{tag}', dst,
                                         expect, mode, failures,
                                         expect_torn=torn,
                                         device=device)

                # ---- bit rot inside CHANGE record payloads (journal)
                change_recs = [(i, sp) for i, sp in enumerate(spans)
                               if sp['kind'] == D.KIND_CHANGE]
                for j in range(min(n_points, len(change_recs))):
                    cases += 1
                    ri, sp = change_recs[rng.randrange(len(change_recs))]
                    bit_at = rng.randrange(sp['pay'][0], sp['pay'][1])
                    bit = 1 << rng.randrange(8)

                    def rot(data, at=bit_at, b=bit):
                        out = bytearray(data)
                        out[at] ^= b
                        return bytes(out)

                    dst = faulted(f'rot{j}', rot)
                    expect = expected_saves(
                        base, lambda i, fr, ri=ri: i != ri, device=device)
                    # payload flips in batch frames are ALWAYS attributed
                    # through the table crcs; in a per-record frame that
                    # is also the journal's final frame, a flip may read
                    # as a torn tail instead — either way damage must be
                    # reported
                    is_last_plain = not sp['batch'] and \
                        ri == len(spans) - 1
                    _recover_and_compare(
                        f'{mode}/{seed}/rot@{bit_at}', dst, expect, mode,
                        failures, expect_rot=not is_last_plain,
                        expect_damage=is_last_plain, device=device)

                # ---- bit rot inside a snapshot DOC frame
                st = D.read_state(base)
                snap_name = st['manifest'].get('snapshot')
                if snap_name and st['docs']:
                    cases += 1
                    sdata = open(os.path.join(base, snap_name), 'rb').read()
                    # find a DOC frame to hit (skip magic prefix)
                    off = len(D.SNAP_MAGIC)
                    doc_frames = []
                    while off < len(sdata):
                        kind, did, _p, end, status = D._frame_at(sdata, off)
                        assert status == 'ok'
                        if kind == D.KIND_DOC:
                            doc_frames.append((off, end, did))
                        off = end
                    s, e, victim = doc_frames[
                        rng.randrange(len(doc_frames))]
                    # flip inside the payload region so the damage is
                    # attributable (structural magic/END rot is covered
                    # by the generation-fallback tests)
                    at = rng.randrange(s + 15, e - 4)
                    rotted = bytearray(sdata)
                    rotted[at] ^= 1 << rng.randrange(8)
                    dst = os.path.join(root, f'{mode}-{seed}-snaprot')
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    shutil.copytree(base, dst)
                    with open(os.path.join(dst, snap_name), 'wb') as f:
                        f.write(bytes(rotted))
                    expect = expected_saves(
                        base, lambda i, fr: True,
                        quarantine_snapshot_doc=victim, device=device)
                    _recover_and_compare(
                        f'{mode}/{seed}/snaprot@{at}', dst, expect, mode,
                        failures, expect_quarantined=(victim,),
                        device=device)

                # ---- checkpoint-protocol crash points
                for point in ('snapshot-temp-written', 'snapshot-renamed',
                              'journal-rotated', 'manifest-flipped'):
                    cases += 1
                    dst = os.path.join(root, f'{mode}-{seed}-ckpt-{point}')
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    pre, _freed = build_run(
                        dst, seed=seed, exact_device=cfg['exact_device'],
                        mirror=cfg['mirror'], checkpoint_at=rng.randrange(
                            1, 5), device=device)
                    mgr2, rec, _rep = DurableFleet.recover(
                        dst, exact_device=cfg['exact_device'],
                        mirror=cfg['mirror'], device=device)
                    mgr2.__class__ = _CrashingFleet
                    mgr2.crash_at = point
                    try:
                        mgr2.checkpoint()
                        failures.append(f'{mode}/{seed}/ckpt-{point}: '
                                        f'fault hook never fired')
                    except _SimulatedCrash:
                        pass
                    # abandon mgr2 (simulated death) and recover the dir:
                    # every step must preserve the full pre-crash state
                    expect = {did: bytes(fleet_backend.save(h))
                              for did, h in rec.items()}
                    _recover_and_compare(f'{mode}/{seed}/ckpt-{point}',
                                         dst, expect, mode, failures,
                                         device=device)

                # ---- incremental per-doc compaction (segment chain):
                # recovery stitches per-doc generations — base snapshot,
                # K segments (incl. a freed doc's tombstone), live
                # journal — back to byte-identical state, and survives
                # journal truncation + compaction-protocol crashes
                seg_base = os.path.join(root, f'{mode}-{seed}-seg')
                pre, _freed = build_run(
                    seg_base, n_docs=12, rounds=8, seed=seed,
                    free_doc=3 if seed % 2 else None,
                    exact_device=cfg['exact_device'], mirror=cfg['mirror'],
                    compact_every=2, device=device)
                st_seg = D.read_state(seg_base)
                assert len(st_seg['manifest'].get('chain') or []) > 1, \
                    'segment workload produced no chain'
                cases += 1
                _recover_and_compare(
                    f'{mode}/{seed}/segments-clean', seg_base,
                    expected_saves(seg_base, lambda i, fr: True,
                                   device=device), mode,
                    failures, device=device)
                # truncation of the LIVE journal over a chain
                jpath2, jdata2, spans2, fb2 = journal_record_spans(seg_base)
                if len(jdata2):
                    cases += 1
                    cut = rng.randrange(len(jdata2) + 1)
                    dst = os.path.join(root, f'{mode}-{seed}-seg-kill')
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    shutil.copytree(seg_base, dst)
                    with open(os.path.join(dst,
                                           os.path.basename(jpath2)),
                              'wb') as f:
                        f.write(jdata2[:cut])
                    expect = expected_saves(
                        seg_base,
                        lambda i, fr, c=cut: spans2[i]['req_end'] <= c,
                        device=device)
                    torn = any(s < cut < e for s, e in fb2)
                    _recover_and_compare(f'{mode}/{seed}/seg-kill@{cut}',
                                         dst, expect, mode, failures,
                                         expect_torn=torn,
                                         device=device)
                # rot inside the NEWEST segment's DOC frame: the victim
                # falls back to an older generation (stitched), everyone
                # else stays byte-identical, damage reports typed
                chain = st_seg['manifest']['chain']
                sdata = open(os.path.join(seg_base, chain[-1]),
                             'rb').read()
                off = len(D.SNAP_MAGIC)
                doc_frames = []
                while off < len(sdata):
                    kind, did, _p, end, status = D._frame_at(sdata, off)
                    assert status == 'ok'
                    if kind == D.KIND_DOC:
                        doc_frames.append((off, end, did))
                    off = end
                if doc_frames:
                    cases += 1
                    s, e, victim = doc_frames[
                        rng.randrange(len(doc_frames))]
                    at = rng.randrange(s + 15, e - 4)
                    rotted = bytearray(sdata)
                    rotted[at] ^= 1 << rng.randrange(8)
                    dst = os.path.join(root, f'{mode}-{seed}-seg-rot')
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    shutil.copytree(seg_base, dst)
                    with open(os.path.join(dst, chain[-1]), 'wb') as f:
                        f.write(bytes(rotted))
                    expect = expected_saves(seg_base, lambda i, fr: True,
                                            device=device)
                    _recover_and_compare(
                        f'{mode}/{seed}/seg-rot@{at}', dst, expect, mode,
                        failures, expect_quarantined=(victim,),
                        allow_differ=(victim,), device=device)
                # compaction-protocol crash points (same _fault hooks as
                # the full checkpoint)
                for point in ('snapshot-temp-written', 'snapshot-renamed',
                              'journal-rotated', 'manifest-flipped'):
                    cases += 1
                    dst = os.path.join(root,
                                       f'{mode}-{seed}-seg-{point}')
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    build_run(dst, n_docs=8, rounds=6, seed=seed,
                              exact_device=cfg['exact_device'],
                              mirror=cfg['mirror'], compact_every=3,
                              device=device)
                    mgr2, rec, _rep = DurableFleet.recover(
                        dst, exact_device=cfg['exact_device'],
                        mirror=cfg['mirror'], device=device)
                    expect = {did: bytes(fleet_backend.save(h))
                              for did, h in rec.items()}
                    # dirty one doc so compact() has churn to persist
                    did0 = sorted(rec)[0]
                    sc = _DocScript(99)
                    sc.actor = f'{seed:02x}ee' * 8
                    buf = sc.make(
                        fleet_backend.get_heads(rec[did0]), rng)
                    out_h, _p, errs = mgr2.apply_changes(
                        [rec[did0]], [[buf]])
                    assert not any(errs)
                    expect[did0] = bytes(fleet_backend.save(out_h[0]))
                    mgr2.__class__ = _CrashingFleet
                    mgr2.crash_at = point
                    try:
                        mgr2.compact()
                        failures.append(f'{mode}/{seed}/seg-{point}: '
                                        f'fault hook never fired')
                    except _SimulatedCrash:
                        pass
                    _recover_and_compare(f'{mode}/{seed}/seg-{point}',
                                         dst, expect, mode, failures,
                                         device=device)

                if verbose:
                    print(f'# crashtest {mode} seed {seed}: '
                          f'{cases} cases so far, '
                          f'{len(failures)} failures', file=sys.stderr)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {'cases': cases, 'failures': failures}

