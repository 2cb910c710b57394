#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build: the native codec (g++) and the CUDA LWW merge kernel (nvcc,
   sm_90a) are compiled from this checkout's sources, both at once;
2. kernel vs plain: seeded batches go through the CUDA kernel and its
   plain torch version on the card — general, noinc, fresh, kills
   pre-pass + merge, duplicate delivery with counter keep/reset over 3
   rounds, more than 1024 lanes in one doc, and the full seam shape —
   and must agree exactly (int32 equality on the real key columns);
3. main path: the fleet backend seam at full size (10,000 docs x 1,000
   keys x 20 changes per doc, one set op per change, two actors on one
   shared chain): DocFleet(device='cuda') -> init_docs ->
   apply_changes_docs(mirror=False) -> materialize_docs, checked against
   the last writer per key, the host OpSet engine and a save() round
   trip, with one merge dispatch per batch and the kernel's launch
   count read around the run;
4. numbers: seam changes/s (median of 5 warm reps), the kernel's time
   from CUDA events beside its plain version's and its bound, the grid
   bytes, and the card's name and power limit.

The last stdout line is {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository beside it, the script exits non-zero
and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
INT_OPS_PER_S = 67e12         # non-tensor float32 peak, an upper bound
                              # on the card's int32 issue rate
ROOT = os.path.dirname(os.path.abspath(__file__))

N_DOCS, N_KEYS, N_CHANGES = 10_000, 1_000, 20
DEVICE = 'cuda'
SEAM_DOCS, SEAM_COLS = 16_384, 1_025


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


# ---- phase 1 ---------------------------------------------------------------

def build_all():
    from automerge_tpu_torch import native
    from automerge_tpu_torch.fleet import merge_kernel
    times, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            ok = fn()
            if ok is False:
                raise RuntimeError(f'{name} did not build')
        except Exception as exc:
            errors.append(f'{name}: {exc}')
        times[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=a) for a in (
        ('native_codec', native.available),
        ('lww_merge', lambda: merge_kernel.build() is not None))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail('build: ' + '; '.join(errors))
    for name, sec in sorted(times.items()):
        log(f'build {name}: {sec:.2f} s')


# ---- phase 2 ---------------------------------------------------------------

def random_cols(rng, n_docs, n_keys, lanes, ctr0=1, inc=True):
    import numpy as np
    shape = (n_docs, lanes)
    key_id = rng.integers(0, n_keys, shape, dtype=np.int32)
    actor = rng.integers(0, 4, shape, dtype=np.int32)
    ctrs = ctr0 + np.broadcast_to(np.arange(lanes, dtype=np.int32), shape)
    packed = (ctrs.astype(np.int32) << 8) | actor
    value = rng.integers(-50, 1000, shape, dtype=np.int32)
    is_set = rng.random(shape) < 0.7 if inc else np.ones(shape, bool)
    valid = rng.random(shape) < 0.9
    return [key_id, packed, value, is_set, ~is_set, valid]


def kernel_vs_plain():
    import numpy as np
    import torch
    from automerge_tpu_torch.fleet import apply
    from automerge_tpu_torch.fleet.merge_kernel import (lww_merge,
                                                        lww_merge_plain)
    from automerge_tpu_torch.fleet.tensor_doc import (FleetState, OpBatch,
                                                      state_to_numpy)
    dev = torch.device(DEVICE)
    max_err = 0

    def seeded(rng, n, k):
        st = FleetState.empty(n, k, dev)
        lww_merge_plain(st, OpBatch(*random_cols(rng, n, k, 6)).to(dev))
        return st

    def clone(st):
        return FleetState(*(t.clone() for t in st.tensors()))

    def compare(name, ref, got, n_keys):
        nonlocal max_err
        torch.cuda.synchronize()
        for grid, a, b in zip(('winners', 'values', 'counters'),
                              state_to_numpy(ref), state_to_numpy(got)):
            diff = int(np.abs(a[:, :n_keys].astype(np.int64) -
                              b[:, :n_keys].astype(np.int64)).max())
            max_err = max(max_err, diff)
            if diff:
                fail(f'kernel != plain: {name} {grid} (max abs err {diff})')
        log(f'kernel == plain: {name}')

    rng = np.random.default_rng(0)
    n, k = 300, 257
    base = seeded(rng, n, k)
    for name, noinc, fresh in (('general', False, False),
                               ('noinc', True, False),
                               ('fresh', False, True),
                               ('noinc+fresh', True, True)):
        cols = random_cols(rng, n, k, 40, ctr0=7, inc=not noinc)
        ops = OpBatch(*cols).to(dev)
        ref, got = clone(base), clone(base)
        s_ref = lww_merge_plain(ref, ops, noinc=noinc, fresh=fresh)
        s_got = lww_merge(got, ops, noinc=noinc, fresh=fresh)
        if int(s_ref) != int(s_got):
            fail(f'stats differ on {name}')
        compare(name, ref, got, k)

    # kills pre-pass + merge
    cols = random_cols(rng, n, k, 40, ctr0=7)
    w = base.winners.cpu().numpy()
    kk = np.zeros((n, 8), np.int32)
    kp = np.zeros((n, 8), np.int32)
    for d in range(n):
        sets = np.flatnonzero(cols[3][d] & cols[5][d])
        live = np.flatnonzero(w[d, :k])
        for j in range(8):
            if j % 3 == 0 and len(sets):
                lane = sets[rng.integers(0, len(sets))]
                kk[d, j], kp[d, j] = cols[0][d, lane], cols[1][d, lane]
            elif j % 3 == 1 and len(live):
                key = live[rng.integers(0, len(live))]
                kk[d, j], kp[d, j] = key, w[d, key]
    ops = OpBatch(*cols).to(dev)
    kk_t, kp_t = (torch.from_numpy(a).to(dev) for a in (kk, kp))
    ref = clone(base)
    apply.clear_killed(ref, kk_t, kp_t)
    lww_merge_plain(ref, apply.mask_killed_sets(ops, kp_t))
    got, _ = apply.apply_op_batch_kills(base, ops, kk_t, kp_t)
    compare('kills pre-pass + merge', ref, got, k)

    # duplicate delivery and counter keep/reset across 3 rounds
    ref, got = clone(base), clone(base)
    for r in range(3):
        cols = random_cols(rng, n, k, 64, ctr0=7 + 64 * r)
        src = rng.integers(0, 32, 16)
        dst = 63 - rng.permutation(16)
        for c in cols:
            c[:, dst] = c[:, src]
        if r == 1:      # re-deliver round 0's standing winners too
            cols[1][:, :8] = prev[1][:, :8]
            cols[2][:, :8] = prev[2][:, :8]
            cols[0][:, :8] = prev[0][:, :8]
        prev = cols
        ops = OpBatch(*cols).to(dev)
        lww_merge_plain(ref, ops)
        lww_merge(got, ops)
    compare('duplicate delivery + counter keep/reset x3', ref, got, k)

    # more lanes in one doc than threads in a block
    n2, k2 = 64, 129
    base2 = seeded(rng, n2, k2)
    ops = OpBatch(*random_cols(rng, n2, k2, 3000, ctr0=7)).to(dev)
    ref, got = clone(base2), clone(base2)
    lww_merge_plain(ref, ops)
    lww_merge(got, ops)
    compare('P = 3000 lanes per doc', ref, got, k2)

    # the full seam shape
    rng2 = np.random.default_rng(1)
    seam = seeded(rng2, SEAM_DOCS, SEAM_COLS - 1)
    ops = OpBatch(*random_cols(rng2, SEAM_DOCS, SEAM_COLS - 1, N_CHANGES,
                               ctr0=7)).to(dev)
    ref, got = clone(seam), clone(seam)
    lww_merge_plain(ref, ops)
    lww_merge(got, ops)
    compare(f'seam shape {SEAM_DOCS} x {SEAM_COLS}', ref, got,
            SEAM_COLS - 1)
    return max_err


# ---- phase 3 ---------------------------------------------------------------

def seam_workload(seed=0):
    """bench.py bench_backend_pipeline's workload: one shared chain of
    N_CHANGES single-set changes by two alternating actors."""
    import numpy as np
    from automerge_tpu_torch.columnar import decode_change_meta, encode_change
    rng = np.random.default_rng(seed)
    actors = ['aa' * 16, 'bb' * 16]
    changes, heads, seqs, last = [], [], [0, 0], {}
    for c in range(N_CHANGES):
        a = c % 2
        seqs[a] += 1
        key = f'k{int(rng.integers(0, N_KEYS))}'
        value = int(rng.integers(1, 1 << 20))
        buf = encode_change({
            'actor': actors[a], 'seq': seqs[a], 'startOp': c + 1,
            'time': 0, 'message': '', 'deps': heads,
            'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                     'value': value, 'datatype': 'int', 'pred': []}]})
        heads = [decode_change_meta(buf, True)['hash']]
        changes.append(buf)
        last[key] = value          # ops arrive in Lamport order
    return changes, heads, last


def run_seam(per_doc, split=None):
    """One seam run on a fresh fleet; `split` (a dict) receives the
    seconds of fleet + init_docs and of the apply up to its sync."""
    import torch
    from automerge_tpu_torch.fleet.backend import (DocFleet,
                                                   apply_changes_docs,
                                                   init_docs)
    t0 = time.perf_counter()
    fleet = DocFleet(doc_capacity=N_DOCS, key_capacity=N_KEYS + 1,
                     device=DEVICE)
    handles = init_docs(N_DOCS, fleet)
    t1 = time.perf_counter()
    d0 = fleet.metrics.dispatches
    handles, _ = apply_changes_docs(handles, per_doc, mirror=False)
    torch.cuda.synchronize()
    if split is not None:
        split['init_s'] = t1 - t0
        split['apply_s'] = time.perf_counter() - t1
    return fleet, handles, fleet.metrics.dispatches - d0


def main_path():
    import torch
    from automerge_tpu_torch.backend.op_set import OpSet
    from automerge_tpu_torch.columnar import decode_document
    from automerge_tpu_torch.fleet import merge_kernel
    from automerge_tpu_torch.fleet.backend import _leaf_value, materialize_docs
    changes, heads, last = seam_workload()
    per_doc = [list(changes) for _ in range(N_DOCS)]

    merge_kernel.reset_launches()
    fleet, handles, dispatches = run_seam(per_doc)
    launches = dict(merge_kernel.LAUNCHES)
    if dispatches != 1:
        fail(f'{dispatches} merge dispatches for one batch (want 1)')
    if launches['lww_merge'] < 1:
        fail('the main path never launched lww_merge')
    docs = materialize_docs(handles)
    if len(docs) != N_DOCS or any(doc != last for doc in docs):
        bad = next(i for i, doc in enumerate(docs) if doc != last)
        fail(f'doc {bad} != last writer per key: {docs[bad]} vs {last}')
    for d in (0, 1, N_DOCS // 2, N_DOCS - 1):
        host = OpSet()
        host.apply_changes(list(changes))
        want = _leaf_value(host.get_patch()['diffs'])
        if docs[d] != want:
            fail(f'doc {d} disagrees with the host OpSet engine')
        saved = bytes(handles[d]['state'].save())
        if [ch['hash'] for ch in decode_document(saved)][-1] != heads[0] \
                or len(decode_document(saved)) != N_CHANGES:
            fail(f'doc {d} save() does not round-trip')
    w = fleet.state.winners
    if w.device.type != DEVICE or w.dtype != torch.int32:
        fail(f'grid is {w.dtype} on {w.device}')
    log(f'main path: {N_DOCS} docs x {N_KEYS} keys x {N_CHANGES} changes, '
        f'{dispatches} dispatch, lww_merge launches {launches["lww_merge"]}'
        f', grid {tuple(w.shape)} x3 int32 = {fleet.state.nbytes()} B, '
        f'all {N_DOCS} docs == last writer, 4 sampled == host OpSet, '
        f'save() round-trips')

    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_seam(per_doc)
        rates.append(N_DOCS * N_CHANGES / (time.perf_counter() - t0))
    log(f'seam changes/s (median of 5 warm reps): '
        f'{statistics.median(rates):.1f}  reps {[round(r) for r in rates]}')
    return launches, fleet.state.nbytes(), tuple(w.shape), per_doc


def breakdown(per_doc):
    """One more seam run with the host-phase spans on and torch.profiler
    tracing CPU + CUDA: seconds per seam phase, and the device's busy
    time (sum of CUDA kernel + copy time) against the run's wall time.
    The traced run is slower than an untraced one; read the shares."""
    import torch
    from automerge_tpu_torch import observability
    from automerge_tpu_torch.observability import spans
    observability.enable(span_capacity=1 << 16)
    spans.clear()
    split = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_seam(per_doc, split)
        wall = time.perf_counter() - t0
    observability.disable()
    phases = {}
    for rec in spans.iter_spans():
        phases[rec['name']] = phases.get(rec['name'], 0) + rec['dur_ns']
    order = ('turbo_setup', 'turbo_parse', 'turbo_gate', 'turbo_commit',
             'turbo_stage', 'turbo_dispatch', 'dispatch_grid')
    log(f'breakdown (traced run, wall {wall * 1e3:.1f} ms): init_docs '
        f'{split["init_s"] * 1e3:.1f} ms, apply {split["apply_s"] * 1e3:.1f}'
        f' ms; ' + ', '.join(f'{name} {phases.get(name, 0) / 1e6:.1f} ms'
                             for name in order))
    busy_us = 0.0
    top = []
    for evt in prof.key_averages():
        # device-side rows only (kernels, copies): host ops such as
        # aten::copy_ also report their children's device time
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(evt, 'self_cuda_time_total', 0)
        if dev_us:
            busy_us += dev_us
            top.append((dev_us, evt.key, evt.count))
    top.sort(reverse=True)
    log(f'device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.1f} ms wall '
        f'(idle share {1 - busy_us / 1e6 / wall:.4f}); top: ' +
        '; '.join(f'{key} x{cnt} {us / 1e3:.3f} ms'
                  for us, key, cnt in top[:6]))


# ---- phase 4 ---------------------------------------------------------------

def time_ms(fn, reps=50):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_numbers(grid_shape):
    """The merge at the main path's shapes: the fresh-fleet set-only
    variant the seam's first batch takes (noinc + fresh), and the
    general in-place variant a later batch takes."""
    import numpy as np
    import torch
    from automerge_tpu_torch.fleet.merge_kernel import (lww_merge,
                                                        lww_merge_plain)
    from automerge_tpu_torch.fleet.tensor_doc import FleetState, OpBatch
    dev = torch.device(DEVICE)
    n, k1 = grid_shape
    rng = np.random.default_rng(2)
    out = {}
    lane_bytes = 3 * 4 + 3 * 1        # key/packed/value int32 + 3 bools
    for variant, noinc, fresh in (('noinc_fresh', True, True),
                                  ('general', False, False)):
        cols = random_cols(rng, n, N_KEYS, N_CHANGES, inc=not noinc)
        cols[5][:] = True
        if noinc:
            cols[4][:] = False
        ops = OpBatch(*cols).to(dev)
        st = FleetState.empty(n, k1 - 1, dev)
        lww_merge_plain(st, OpBatch(*random_cols(rng, n, N_KEYS, 6)).to(dev))
        ms = time_ms(lambda: lww_merge(st, ops, noinc=noinc, fresh=fresh))
        plain_ms = time_ms(
            lambda: lww_merge_plain(st, ops, noinc=noinc, fresh=fresh),
            reps=10)
        touched = len(np.unique(np.arange(n)[:, None] * k1 + cols[0]))
        grids = 2 if noinc else 3
        if fresh:
            state_bytes = n * k1 * 3 * 4      # every cell written once
        else:
            state_bytes = touched * grids * 2 * 4   # read + write
        n_bytes = n * N_CHANGES * lane_bytes + state_bytes
        n_ops = n * N_CHANGES * 8
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / INT_OPS_PER_S * 1e3
        out[variant] = {
            'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'bytes': n_bytes}
        log(f'lww_merge {variant} at {n} x {k1}, {N_CHANGES} lanes: '
            f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
            f'{max(bytes_ms, ops_ms):.4f} ms ({n_bytes} B)')
    return out


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this smoke test runs only on a GPU')
    if not os.path.isdir(os.path.join(ROOT, 'automerge_tpu_torch')):
        fail('automerge_tpu_torch/ not found beside chip_smoke.py')
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    build_all()
    max_err = kernel_vs_plain()
    launches, grid_bytes, grid_shape, per_doc = main_path()
    nums = kernel_numbers(grid_shape)
    breakdown(per_doc)
    log(f'grid bytes: {grid_bytes}')
    log(f'wall: {time.perf_counter() - t_start:.1f} s')
    log(card_line())
    main_nums = nums['noinc_fresh']
    print(json.dumps({'kernels': [{
        'name': 'lww_merge', 'route': 'cuda',
        'source': 'automerge_tpu_torch/fleet/csrc/lww_merge.cu',
        'replaces': 'automerge_tpu/fleet/pallas_merge.py:198',
        'launches': launches['lww_merge'],
        'max_abs_err': max_err,
        'ms': main_nums['ms'], 'plain_ms': main_nums['plain_ms'],
        'bound_ms': main_nums['bound_ms'],
        'bound_by': main_nums['bound_by'],
        'library_ms': None}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
