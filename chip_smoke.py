#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build: the native codec (g++) and the CUDA LWW merge kernel (nvcc,
   sm_90a) are compiled from this checkout's sources, both at once;
2. kernel vs plain: seeded batches go through the CUDA kernel and its
   plain torch version on the card and must agree exactly (int32
   equality on the real key columns, and the valid-lane count): every
   variant (general, noinc, fresh, noinc+fresh) at P = 0, 1, 20, 31,
   32, 33 and 40 lanes, on both sides of the warp / cta route split; the
   cta route forced at P = 20 and 32; full key collision, duplicate
   packed ids with a re-delivered standing winner, and negative incs on
   the warp, cta and fresh routes; fresh rows wider than a shared-memory
   tile (key chunks); kills pre-pass + merge on both in-place routes;
   duplicate delivery with counter keep/reset over 3 rounds; P = 3000;
   and the full seam shape;
3. main path: the fleet backend seam at full size (10,000 docs x 1,000
   keys x 20 changes per doc, one set op per change, two actors on one
   shared chain): DocFleet(device='cuda') -> init_docs ->
   apply_changes_docs(mirror=False) -> materialize_docs, checked against
   the last writer per key, the host OpSet engine and a save() round
   trip, with one merge dispatch per batch and the kernel's launch
   count read around the run;
4. numbers: seam changes/s (median of 5 warm reps); the kernel's device
   time from CUDA events, with the host's launches queued behind a sleep
   kernel, with L2 warm and flushed: noinc+fresh (fresh route) beside
   the zero_() floor of the same bytes, and general (warp route, on
   batches whose packed ids rise, so every launch moves winners) beside
   the CTA-per-doc schedule (the cta route at P = 20), an empty grid
   (P = 0) and a batch that touches no cell; the public wrapper timed
   both ways (queued, and issued call by call from the host); each
   beside its plain version and its bound; the grid bytes, and the
   card's name and power limit.

    python3 chip_smoke.py --baseline DIR

also builds the merge kernel of another checkout (e.g. the parent
commit, unpacked with `git archive`) and times its wrapper in phase 4
beside this one's, by the same methods.

The last stdout line is {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository beside it, the script exits non-zero
and prints no result.
"""

import argparse
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

def build_all(baseline=None):
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

    jobs = [('native_codec', native.available),
            ('lww_merge', lambda: merge_kernel.build() is not None)]
    if baseline is not None:
        jobs.append(('baseline lww_merge',
                     lambda: baseline.build() is not None))
    threads = [threading.Thread(target=run, args=a) for a in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail('build: ' + '; '.join(errors))
    for name, sec in sorted(times.items()):
        log(f'build {name}: {sec:.2f} s')


# ---- phase 2 ---------------------------------------------------------------

def kernel_vs_plain():
    import numpy as np
    import torch
    from automerge_tpu_torch.fleet import apply, merge_kernel
    from automerge_tpu_torch.fleet.merge_cases import (CORNERS, clone,
                                                       corner_cols,
                                                       launch_along,
                                                       random_cols)
    from automerge_tpu_torch.fleet.merge_cases import seeded as seeded_on
    from automerge_tpu_torch.fleet.merge_kernel import (lww_merge,
                                                        lww_merge_plain)
    from automerge_tpu_torch.fleet.tensor_doc import (FleetState, OpBatch,
                                                      state_to_numpy)
    dev = torch.device(DEVICE)
    max_err = 0

    def seeded(rng, n, k):
        return seeded_on(rng, n, k, dev)

    def compare(name, ref, got, n_keys, s_ref=None, s_got=None):
        nonlocal max_err
        torch.cuda.synchronize()
        if s_ref is not None and int(s_ref) != int(s_got):
            fail(f'stats differ on {name}: {int(s_got)} vs {int(s_ref)}')
        for grid, a, b in zip(('winners', 'values', 'counters'),
                              state_to_numpy(ref), state_to_numpy(got)):
            diff = int(np.abs(a[:, :n_keys].astype(np.int64) -
                              b[:, :n_keys].astype(np.int64)).max(
                                  initial=0))
            max_err = max(max_err, diff)
            if diff:
                fail(f'kernel != plain: {name} {grid} (max abs err {diff})')
        log(f'kernel == plain: {name}')

    rng = np.random.default_rng(0)
    n, k = 300, 257
    base = seeded(rng, n, k)
    variants = (('general', False, False), ('noinc', True, False),
                ('fresh', False, True), ('noinc+fresh', True, True))
    for lanes in (0, 1, 20, 31, 32, 33, 40):
        for name, noinc, fresh in variants:
            cols = random_cols(rng, n, k, lanes, ctr0=7, inc=not noinc)
            ops = OpBatch(*cols).to(dev)
            route = merge_kernel._launch_plan(n, lanes, k + 1, fresh).route
            ref, got = clone(base), clone(base)
            s_ref = lww_merge_plain(ref, ops, noinc=noinc, fresh=fresh)
            s_got = lww_merge(got, ops, noinc=noinc, fresh=fresh)
            compare(f'{name} P = {lanes} ({route} route)', ref, got, k,
                    s_ref, s_got)
    for lanes in (20, 32):          # the cta route at warp widths
        for name, noinc, _ in variants[:2]:
            ops = OpBatch(*random_cols(rng, n, k, lanes, ctr0=7,
                                       inc=not noinc)).to(dev)
            ref, got = clone(base), clone(base)
            s_ref = lww_merge_plain(ref, ops, noinc=noinc)
            s_got = launch_along('cta', got, ops, noinc)
            compare(f'{name} P = {lanes} (cta route)', ref, got, k, s_ref,
                    s_got[0])
    for case in CORNERS:
        kc = 3 if case == 'collision' else 40
        cbase = seeded(rng, 96, kc)
        ops = OpBatch(*corner_cols(case, rng, cbase, kc, 32)).to(dev)
        for route in ('warp', 'cta', 'fresh'):
            ref, got = clone(cbase), clone(cbase)
            s_ref = lww_merge_plain(ref, ops, fresh=route == 'fresh')
            s_got = launch_along(route, got, ops)
            compare(f'{case} P = 32 ({route} route)', ref, got, kc, s_ref,
                    s_got[0])

    # fresh rows wider than a shared-memory tile: key-chunked
    n3, k3, p3 = 37, 20_000, 48
    plan = merge_kernel._launch_plan(n3, p3, k3 + 1, True)
    cols = random_cols(rng, n3, k3 + 1, p3)
    edges = np.arange(plan.key_chunk, k3 + 1, plan.key_chunk)
    near = np.concatenate([edges - 1, edges, [0, k3 - 1, k3]])
    cols[0][:, :len(near)] = near
    ops = OpBatch(*cols).to(dev)
    ref = FleetState.empty(n3, k3, dev)
    got = FleetState(*(torch.full_like(t, 7) for t in ref.tensors()))
    s_ref = lww_merge_plain(ref, ops, fresh=True)
    s_got = lww_merge(got, ops, fresh=True)
    compare(f'fresh K+1 = {k3 + 1} in key chunks of {plan.key_chunk}',
            ref, got, k3, s_ref, s_got)

    # kills pre-pass + merge, on each in-place route
    for lanes in (24, 40):
        cols = random_cols(rng, n, k, lanes, ctr0=7)
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
        compare(f'kills pre-pass + merge, P = {lanes}', ref, got, k)

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
    for fresh in (False, True):
        ref, got = clone(base2), clone(base2)
        lww_merge_plain(ref, ops, fresh=fresh)
        lww_merge(got, ops, fresh=fresh)
        compare(f'P = 3000 lanes per doc{" (fresh)" if fresh else ""}',
                ref, got, k2)

    # the full seam shape
    rng2 = np.random.default_rng(1)
    seam = seeded(rng2, SEAM_DOCS, SEAM_COLS - 1)
    ops = OpBatch(*random_cols(rng2, SEAM_DOCS, SEAM_COLS - 1, N_CHANGES,
                               ctr0=7)).to(dev)
    for fresh in (False, True):
        ref, got = clone(seam), clone(seam)
        lww_merge_plain(ref, ops, fresh=fresh)
        lww_merge(got, ops, fresh=fresh)
        compare(f'seam shape {SEAM_DOCS} x {SEAM_COLS}'
                f'{" (fresh)" if fresh else ""}', ref, got, SEAM_COLS - 1)
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

SLEEP_CYCLES = 40_000_000      # ~20 ms: the host queues every timed call
FLUSH_BYTES = 256 << 20        # > the H100's 50 MB L2


def time_ms(fn, reps=50, flush=None):
    """Device ms per call of `fn`. The calls are queued behind a sleep
    kernel, so the host's launch cost is off the clock. With `flush` (an
    int32 buffer of FLUSH_BYTES), each call follows a write of the whole
    buffer, which evicts the L2, and only the call is timed (median of
    the calls)."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(reps if flush is not None else 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    if flush is None:
        pairs[0][0].record()
        for _ in range(reps):
            fn()
        pairs[0][1].record()
    else:
        for start, end in pairs:
            flush.fill_(1)
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    if flush is None:
        return pairs[0][0].elapsed_time(pairs[0][1]) / reps
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def call_ms(fn, reps=50):
    """Ms per call of `fn` back to back with the host issuing each call
    (the host's launch cost included where it is the longer)."""
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


REPS = 50


def rising(ops, count):
    """`count` batches equal to `ops` but for their packed ids, which rise
    from one batch to the next above every id before them. Applied in
    turn to one grid, every batch moves the winner of each cell it sets,
    as the later batches of a long-lived fleet do (the same batch applied
    again would move none after its first time)."""
    from automerge_tpu_torch.fleet.tensor_doc import ACTOR_BITS, OpBatch
    span = (int(ops.packed.max()) >> ACTOR_BITS) + 1
    return [OpBatch(ops.key_id, ops.packed + ((r * span) << ACTOR_BITS),
                    ops.value, ops.is_set, ops.is_inc, ops.valid)
            for r in range(count)]


def timed(timer, merge, seed, batches, **kw):
    """`timer` (time_ms or call_ms) of `merge(state, batch)` on a fresh
    copy of the grid `seed`, with the next of `batches` in each call."""
    from automerge_tpu_torch.fleet.merge_cases import clone
    state = clone(seed)
    it = iter(batches)
    return timer(lambda: merge(state, next(it)), **kw)


def kernel_numbers(grid_shape, baseline=None):
    """The merge at the main path's shapes: the fresh-fleet set-only
    variant the seam's first batch takes (noinc + fresh, fresh route)
    and the general in-place variant a later batch takes (warp route),
    each with L2 warm and flushed. In-place batches rise (`rising`), so
    every timed launch moves winners. Beside them: the CTA-per-doc
    schedule (the cta route the wrapper keeps for P > 32, forced at
    P = 20); the public wrapper `lww_merge`, whose per-call int32 stats
    allocation adds one fill (`fill_ms`), queued behind a sleep (`api_ms`)
    and issued call by call from the host (`call_ms`), and the same for
    `baseline` (another checkout's merge_kernel module, e.g. the parent
    commit: `base_*`); the plain version; the bound; and floors: the
    three grids' zero_() and one zero_() of as many bytes (the card's
    write rate); the warp route at P = 0 (launch and CTA scheduling of
    the same grid with no lanes) and with every key out of range (the
    lanes loaded and grouped, no cell touched)."""
    import numpy as np
    import torch
    from automerge_tpu_torch.fleet.merge_cases import (clone, launch_along,
                                                       random_cols, seeded)
    from automerge_tpu_torch.fleet.merge_kernel import (lww_merge,
                                                        lww_merge_plain)
    from automerge_tpu_torch.fleet.tensor_doc import OpBatch
    dev = torch.device(DEVICE)
    n, k1 = grid_shape
    rng = np.random.default_rng(2)
    stats = torch.zeros(1, dtype=torch.int32, device=dev)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    seed = seeded(rng, n, k1 - 1, dev)
    out = {}
    lane_bytes = 3 * 4 + 3 * 1        # key/packed/value int32 + 3 bools
    for variant, noinc, fresh in (('noinc_fresh', True, True),
                                  ('general', False, False)):
        cols = random_cols(rng, n, N_KEYS, N_CHANGES, ctr0=7,
                           inc=not noinc)
        cols[5][:] = True
        if noinc:
            cols[4][:] = False
        ops = OpBatch(*cols).to(dev)
        # a fresh launch zeroes the grids first: the same batch again is
        # the same work
        batches = [ops] * (REPS + 1) if fresh else rising(ops, REPS + 1)
        route = 'fresh' if fresh else 'warp'

        def kernel(along):
            return lambda st, b: launch_along(along, st, b, noinc, stats)

        def api(wrapper):
            return lambda st, b: wrapper(st, b, noinc=noinc, fresh=fresh)

        nums = {'ms': timed(time_ms, kernel(route), seed, batches),
                'cold_ms': timed(time_ms, kernel(route), seed, batches,
                                 reps=20, flush=flush)}
        if not fresh:
            nums['cta_ms'] = timed(time_ms, kernel('cta'), seed, batches)
            nums['cta_cold_ms'] = timed(time_ms, kernel('cta'), seed,
                                        batches, reps=20, flush=flush)
        wrappers = [('', lww_merge)]
        if baseline is not None:
            wrappers.append(('base_', baseline.lww_merge))
        for tag, wrapper in wrappers:
            nums[f'{tag}api_ms'] = timed(time_ms, api(wrapper), seed,
                                         batches)
            nums[f'{tag}api_cold_ms'] = timed(time_ms, api(wrapper), seed,
                                              batches, reps=20, flush=flush)
            nums[f'{tag}call_ms'] = timed(call_ms, api(wrapper), seed,
                                          batches)
        nums['plain_ms'] = timed(time_ms, api(lww_merge_plain), seed,
                                 batches, reps=10)
        if fresh:
            st = clone(seed)
            nums['zero_floor_ms'] = time_ms(
                lambda: [t.zero_() for t in st.tensors()])
            flat = torch.empty(n * k1 * 3, dtype=torch.int32, device=dev)
            nums['zero_one_ms'] = time_ms(flat.zero_)
            del flat
            nums['fill_ms'] = time_ms(
                lambda: torch.zeros(1, dtype=torch.int32, device=dev))
        else:
            empty = OpBatch(*(c[:, :0] for c in cols)).to(dev)
            nums['empty_grid_ms'] = timed(time_ms, kernel('warp'), seed,
                                          [empty] * (REPS + 1))
            dropped = OpBatch(np.full_like(cols[0], k1), *cols[1:]).to(dev)
            nums['no_cells_ms'] = timed(time_ms, kernel('warp'), seed,
                                        [dropped] * (REPS + 1))
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
        nums.update(bound_ms=max(bytes_ms, ops_ms),
                    bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                    bytes=n_bytes, route=route)
        out[variant] = nums
        log(f'lww_merge {variant} at {n} x {k1}, {N_CHANGES} lanes: ' +
            ', '.join(f'{key} {val:.4f}' if isinstance(val, float) else
                      f'{key} {val}' for key, val in nums.items()))
    return out


def load_baseline(path):
    """The merge wrapper of another checkout of this repository (e.g. the
    parent commit, unpacked with `git archive`), loaded under a module
    name of its own: it builds its own kernel source into that
    checkout."""
    import importlib.util
    src = os.path.join(path, 'automerge_tpu_torch', 'fleet',
                       'merge_kernel.py')
    if not os.path.exists(src):
        fail(f'--baseline: {src} not found')
    spec = importlib.util.spec_from_file_location('baseline_merge_kernel',
                                                  src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    args = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    args.add_argument('--baseline', metavar='DIR',
                      help='another checkout of this repository (e.g. the '
                      'parent commit) whose merge wrapper phase 4 times '
                      'beside this one, by the same method')
    args = args.parse_args()
    baseline = load_baseline(args.baseline) if args.baseline else None
    t_start = time.perf_counter()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    build_all(baseline)
    max_err = kernel_vs_plain()
    launches, grid_bytes, grid_shape, per_doc = main_path()
    nums = kernel_numbers(grid_shape, baseline)
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
