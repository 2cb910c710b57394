"""The crash-injection matrix on the torch port (fleet/crash_cases.py,
the port's copy of tools/crashtest.py's harness): a seeded smoke dose of
kill offsets, the torn final frame, journal and snapshot rot, the
checkpoint- and compaction-protocol crash points and the segment-chain
legs, on the turbo path with device='cpu'; and one faulted directory
recovered by both packages with equal saves and reports."""

import os
import random
import shutil

import pytest
import torch

import automerge_tpu.native as jax_native
from automerge_tpu.fleet import backend as jb
from automerge_tpu.fleet import durability as jd
import automerge_tpu_torch.native as torch_native
from automerge_tpu_torch.fleet import backend as tb
from automerge_tpu_torch.fleet import crash_cases
from automerge_tpu_torch.fleet import durability as td

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (torch_native.available() and jax_native.available()),
    reason='a native codec is unavailable')


def test_crashtest_smoke_on_the_port():
    stats = crash_cases.run_crashtest(n_seeds=1, n_points=2, modes=['lww'],
                                      device='cpu')
    assert stats['failures'] == [], stats['failures'][:5]
    assert stats['cases'] >= 8


def test_crashtest_smoke_on_the_port_exact():
    stats = crash_cases.run_crashtest(n_seeds=1, n_points=1,
                                      modes=['exact'], device='cpu')
    assert stats['failures'] == [], stats['failures'][:5]
    assert stats['cases'] >= 8


def _recover(D, fb, path, **kw):
    mgr, rec, report = D.DurableFleet.recover(path, **kw)
    try:
        saves = {did: bytes(fb.save(h)) for did, h in rec.items()}
        return saves, (report.snapshot_docs, report.replayed_records,
                       report.torn_tail_bytes, report.rotted_records,
                       sorted(report.quarantined), report.freed_docs,
                       report.used_fallback_manifest)
    finally:
        mgr.close()


def test_faulted_directory_recovers_alike_in_both_packages(tmp_path):
    """A directory the port wrote (the harness's 12-doc workload, a
    freed doc, both journal frame formats), cut mid-frame and with one
    rotted CHANGE payload: both packages recover it to the same saves
    and report, equal to the harness's independent expectation."""
    base = str(tmp_path / 'base')
    crash_cases.build_run(base, n_docs=12, seed=1, free_doc=4,
                          device='cpu')
    _jpath, data, spans, frame_bounds = crash_cases.journal_record_spans(
        base)
    rng = random.Random(7)
    changes = [i for i, sp in enumerate(spans)
               if sp['kind'] == td.KIND_CHANGE and sp['batch']]
    victim = changes[rng.randrange(len(changes))]
    at = rng.randrange(*spans[victim]['pay'])
    s, e = frame_bounds[-1]
    cut = rng.randrange(s + 1, e)
    faulted = bytearray(data[:cut])
    faulted[at] ^= 0x10
    expect = crash_cases.expected_saves(
        base, lambda i, fr: i != victim and spans[i]['req_end'] <= cut,
        device='cpu')
    jname = os.path.basename(_jpath)
    results = []
    for name, D, fb, kw in (('ref', jd, jb, {}),
                            ('port', td, tb, {'device': 'cpu'})):
        dst = str(tmp_path / name)
        shutil.copytree(base, dst)
        with open(os.path.join(dst, jname), 'wb') as f:
            f.write(bytes(faulted))
        results.append(_recover(D, fb, dst, **kw))
    assert results[1] == results[0]
    saves, report = results[0]
    assert saves == expect
    assert report[2] > 0 and report[3] == 1
    assert report[4] == [spans[victim]['did']]
