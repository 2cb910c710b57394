#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build: the native codec (g++) and the five CUDA sources (nvcc,
   sm_90a: the LWW merge, the register scan, the RGA sequence scan, the
   Bloom pair, the hash-index pair) are compiled from this checkout's
   sources, all at once;
2. kernel vs plain: seeded inputs go through each CUDA kernel and its
   plain torch version on the card and must agree exactly. The merge:
   int32 equality on the real key columns and the valid-lane count,
   every variant (general, noinc, fresh, noinc+fresh) at P = 0, 1, 20,
   31, 32, 33 and 40 lanes, on both sides of the warp / cta route split;
   the cta route forced at P = 20 and 32; full key collision, duplicate
   packed ids with a re-delivered standing winner, and negative incs on
   the warp, cta and fresh routes; fresh rows wider than a shared-memory
   tile (key chunks); kills pre-pass + merge on both in-place routes;
   duplicate delivery with counter keep/reset over 3 rounds; P = 3000;
   and the full seam shape. The sync kernels (fleet/sync_cases.py): the
   hash-index insert and probe with every key at one start slot, a chain
   wrapping at cap - 1, in-batch duplicates, the 0.6 load bound, many
   spaces, 8-slot sectors that wrap at cap - 1, a race for the first
   empty slot after three used ones, twins that meet each other's
   claimed slot and a table filled to 0.6 in one batch (equal membership
   and new-key counts: the insert's slot layout may differ where rows
   race; both probes find every inserted key and no stranger that shares
   a key's start slot and space); the Bloom build and probe
   over skewed filter sizes, rows at and across 16-byte edges, padding
   rows and a zero tail, a row over many CTAs' worth of bytes, the
   longest row one shared-memory window holds and a longer one (equal
   bytes and answers); the register scan on every corner of
   fleet/register_cases.py (among them one key for all of a doc's ops,
   and half the lanes on one key) at P = 0, 1, 5, 20, 31, 32 and 33 (8
   actor slots), at 256, 1, 2, 3, 4 and 16 actor slots, with 1 and 6 pred
   lanes, and at P = 1000 (all five arrays and the lane count equal); the
   sequence scan on every corner of
   fleet/seq_cases.py (a row at capacity, unknown referents, a cyclic
   chain, duplicate and dead preds, wrapping counters, lanes past the
   width, refs to later inserts, duplicate ids, one node's ops inside a
   chunk, a failing insert mid-row, ...) at P = 0, 1, 20 and 256 at 4
   and at 256 actor lanes along the wrapper's own route, and at P = 40
   and 256 along the forced 'global' route (all eight arrays and the
   applied count equal; the 'serial' and 'capacity' corners must send
   rows to the kernel's serial route), on 3 rows of a class past the
   resident route (the plan takes 'global') and on a class of 1,025
   rows x 8,195 nodes x 256 lanes, past 2^31 cells;
3. main paths, each with every launch count set to 0 just before it and
   read just after:
   - seam: the fleet backend seam at full size (10,000 docs x 1,000 keys
     x 20 changes per doc, one set op per change, two actors on one
     shared chain): DocFleet(device='cuda') -> init_docs ->
     apply_changes_docs(mirror=False) -> materialize_docs, checked
     against the last writer per key, the host OpSet engine and a save()
     round trip, with one merge dispatch per batch;
   - pipelined seam: the same batch through
     apply_changes_docs_pipelined(sub_batches=4), whose grids and save()
     must equal four sequential apply_changes_docs calls over the same
     splits (and whose save() equals the one-call seam's), one dispatch
     per sub-batch; changes/s beside apply_changes_docs's, in turns;
   - exact seam: DocFleet(exact_device=True, device='cuda') at the same
     width (10,000 docs, key capacity 1,001, register state [10000,
     1024, 8]): init_docs, then three batches through
     apply_changes_docs(mirror=False) (register_cases.exact_seam_changes:
     a 20-change chain whose sets pred their key's standing op;
     concurrent changes by two new actors, one sorting first, that
     renumber every lane, resurrect a deleted key, conflict and set a
     counter; an inc), one register dispatch per batch; every doc's
     materialize_docs and conflicts_all equal the host OpSet's, 4 sampled
     docs' device-served get_patch() equal the host's patch, save()
     round-trips, nothing inexact; changes/s of its first batch beside
     the LWW seam's, in turns;
   - text seam (seam-text-1k; BASELINE config 2 has 2,000 docs, cut to
     1,000 for the script's time limit): DocFleet(doc_capacity=1,000) ->
     init_docs -> one apply_changes_docs(mirror=False) of BASELINE
     config 2's trace (fleet/seq_cases.py text_changes: a makeText and
     10,000 ops, ~80 % inserts, ~20 % deletes, 3 actors taking turns on
     one chain, 32 ops per change) for every doc, then 2 incremental
     batches of 256 ops; dispatches [2, 1, 1] (the root key's merge and
     one sequence dispatch per batch, one size class active), one
     seq_scan launch per batch; every doc's text equals the host OpSet's,
     4 sampled docs' get_patch() and save() equal the host's and save()
     round-trips, nothing inexact, no fallbacks; the same once more in
     exact-device mode; ops/s (median of 3 warm reps);
   - load: the bulk loader and the parked form. The seam's document
     (its 20-change chain, saved) loads 10,000 times through
     load_docs(DocFleet(doc_capacity=10,000, key_capacity=1,000)):
     every doc bulk-loaded, every doc == the seam's, every unedited
     save() == the loaded bytes; one more change to every doc is one
     lww_merge launch on the in-place (warp) route, 4 docs == the host
     OpSet; 1,000 docs are parked (park_docs), take one more change
     each and rebuild (rebuild_docs) into a fresh fleet, whose
     materialize_docs and save() equal 1,000 docs never parked; load
     docs/s (median of 3) and a traced load (the install writes' device
     ms beside their byte bound); the same load in exact-device mode
     (registers [10000, 1024, 8], nothing inexact; the follow-up is one
     register_scan launch, 4 device-served patches == the host's); and
     the text seam's document (10,512 ops) loaded 1,000 times (one
     size class [1024, 16387, 4], no migration, no scan launched, every
     text == the seam's), then a further batch of 256 ops, one seq_scan
     launch, every text == the host OpSet's; a traced text load;
   - api: the port's Automerge.* API with
     set_default_backend(FleetBackend(DocFleet(...))) on the card, each
     leg with the launch counts set to 0 just before it. The integration
     shapes (automerge_tpu_torch/api_cases.py integration_docs: maps,
     nested maps, lists, rows-in-lists, Text, Table, Counter, a concurrent
     merge with conflicts, save/load, history, the changes API and a sync
     round; fixed actors, times and uuids) on DocFleet(64 docs, 64 keys) in
     both modes: every document's value and save() and what
     materialize_docs reads from the card == the same script through the
     host backend, the sequence rows and device arrays (grids' real key
     columns, or the registers) == a CPU fleet's; lww_merge (or
     register_scan) and seq_scan launched. The mixed document (bench.py
     bench_backend_mixed: a nested config map, rows-in-lists, strings,
     floats and bools, then 15 changes; actor 'ab' * 16, seed 0, fixed
     time) applied to 10,000 docs through apply_changes_docs into
     DocFleet(doc_capacity=10,000, key_capacity=64) (bench.py's default
     is 500 docs; 10,000 is the seam cells' fleet): one lww_merge launch
     per batch, no fallback, every doc read from the card == the
     authoring document, the grid and sequence rows == a CPU fleet's;
     changes/s (median of 3 warm reps) and ops per change; a traced rep.
     The per-doc API at hub scale: 500 docs on one FleetBackend through
     A.load of the mixed document's save(), each taking one A.change by
     a second actor and one A.merge of a concurrent edit, then one read
     that flushes them: every value, and every doc read from the card, ==
     the host backend's (its doc with the doc's own edit, held to the
     host backend's doc on 16 sampled docs), the 16 sampled docs' save()
     == the host backend's and their grid rows == a CPU fleet's; the API
     calls' and the read's wall time;
   - query: the query engine (bench.py _sec_query at BENCH_QUERY_DOCS =
     BENCH_QUERY_SUBS = 10,000), each leg with the launch counts set to 0
     just before it: 10,000 docs x 6 single-set changes (change c sets
     k{c} to d * 100 + c) on DocFleet(device='cuda'), the mid frontier
     taken after change 3; materialize_at_docs of all 10,000 docs at the
     mid frontier: one dispatch per batched read, every doc and grid row
     read from the card == k0..k3 = d * 100 + c, docs/s (median of 3
     after a warm rep) and a traced rep; the subscription tick: 10,000
     subscribers, 3 cursor classes, one new change per doc per tick, 0
     merge dispatches and 1 frontier compare (the batched quiet proof)
     per tick, p50 and p99 over 5 ticks, the diff reuse
     ratio and a traced tick; the all-quiet tick (bench.py _sec_frontier
     (b)): a fresh 10,000-doc fleet, 10,000 subscribers at head, each of
     7 ticks exactly 1 frontier_compare dispatch, run on the card and
     answering as the CPU does, and 0 merge dispatches, every class
     proven quiet; the compare's device time at the tick's shape beside
     its byte bound. In both paths the first 64 calls of each kernel
     wrapper of each leg are held to the plain version after it, as in
     the storage path;
   - service: the multi-tenant service (bench.py _sec_service): the
     three standing legs of automerge_tpu_torch/service_cases.py
     run_standard_legs (clean, chaos, 2x overload) at 10,000 sessions,
     256 tenants, 20,000 requests, seed 0 and a 0.25 sync fraction, each
     on its own DocFleet(device='cuda') in LWW mode on the real clock,
     with the launch counts set to 0 just before the leg and read just
     after (lww_merge and the four sync kernels must have launched) and
     the leg's device activity traced (the idle share): no untyped
     escape, no edit mismatch, every drained sync session converged, the
     SLO audit exact, brownout transitions under overload; every audited
     edit doc's materialize_docs and grid row read from the card == a
     CPU fleet fed exactly its committed changes; the kernel ledger on
     for the clean leg, its report printed, its apply_op_batch*
     dispatches == the lww_merge launches; render_prometheus of
     the clean leg's SLO registry timed (bench.py _sec_slo (b)). Then
     bench.py _sec_faults' quarantine round: 2,000 docs with 2 poisoned,
     exactly those quarantined, the other 1,998 docs and grid rows read
     from the card == a CPU fleet's, the health counters' deltas, its
     time against a clean round's in turns; and one sync_until_quiet
     between two card-backed docs over LossyLinks that drop, duplicate
     and reorder, which must converge. The first 64 calls of each kernel
     wrapper of each leg are held to the plain version after it;
   - shard: the shard cluster and the control plane
     (automerge_tpu_torch/shard_cases.py run_shard_leg, the port's copy
     of tools/loadgen.py's shard leg), each leg with the launch counts
     set to 0 just before it and read just after, its device activity
     traced (the idle share), its first 64 calls of each kernel held to
     the plain version after it (the router pumps its shards from two
     threads: PathCheck keeps its books under a lock): bench.py
     _sec_shards' warm-up and paced clean sweep at its own shape (96
     tenants, 1,200 requests, 48 arrivals a tick, 30 ms ticks, 2 pump
     threads, replication every 4 ticks) over 1, 2 and 4 shards (req/s,
     slipped ticks); its kill-one-of-four leg (4 shards, 12 tenants, 400
     requests, chaos links, seed 5, the kill at tick 12 and the revive
     at 40; MTTR) in LWW and in exact mode; one shard killed and revived
     3x (576 tenants over 3 shards), with torch.cuda.memory_allocated()
     around each kill and revive and each dead shard's fleet freed; a
     kill-one-of-four at a deployment's size (4,096 tenants, ~2,048 docs
     a shard fleet, 8,192 requests, 256 arrivals a tick, a rebalance
     after the revive); tests/test_control.py's acceptance episode
     under an active and a shadow controller (decisions per policy,
     reversals, settle ticks, fixed point, the two decision sequences
     compared); and bench.py _sec_control's lockstep pair (400 ticks, 8
     tenants, 20 submits a tenant a tick, 3 passes after a warm one:
     the overhead, the decide latency, shadow == active). Every shard
     leg: no untyped escape, acked_lost 0 and replica_mismatches 0 in
     every audit, and every tenant's (512 seeded ones at the deployment
     size) home and replica docs read from the card (materialize_docs,
     and the grid rows or registers) == each other == a CPU fleet fed
     its acked changes;
   - storage: durability and the storage tier, each leg with the launch
     counts set to 0 just before it. The durable seam: the seam's batch
     through DurableFleet(fsync_bytes=4 MiB) on the card, whose grids
     and save() equal the bare seam's and whose journal parses back to
     the input change bytes doc by doc; journaled against bare
     changes/s as paired per-rep overhead (bench.py _sec_durability's
     method, 6 pairs in turns after a warm pair) beside the reference's
     15 % budget. Recovery: a checkpoint, one more change per doc (the
     journal suffix), a crash (the manager dropped unclosed), then
     DurableFleet.recover on 3 fresh copies: every save(),
     materialize_docs and grid row (read from the card: per key the
     winner's op id, the value and the counter) == pre-crash, 10,000
     snapshot docs, 10,000 replayed records, nothing quarantined, 10,000
     bulk-loaded, lww_merge launched; recovery docs/s (median); then a
     torn tail and one rotted record: exactly that record's doc
     quarantined, every other doc == pre-crash likewise. Exact recovery
     (DurableFleet(exact_device=True), the exact seam's three batches,
     a checkpoint after the first): materialize_docs, conflicts_all and
     save() == pre-crash, nothing inexact, register_scan launched. Text
     recovery, cut to 128 docs of the text seam's trace for time: every
     text and save() == pre-crash after a 256-op suffix, seq_scan
     launched. A crash dose (fleet/crash_cases.py, modes lww and exact,
     on the card) with no failure. The tier (bench.py
     _sec_storage_tier, cut from 1,000,000 docs for the script's time
     limit): 250,000 docs of 2,048 distinct 2-change documents parked on
     a disk arena; park docs/s, revive docs/s in
     batches of 1,024 warm and after advise_cold (every revived doc's
     save(), materialize_docs and grid row == its chunk's, repark keeps
     the ids), resident bytes per doc, disk
     bytes; a 10 % discard + vacuum_now leaves the other chunks
     byte-identical; close + StorageEngine.open recovers every id and
     chunk. Then materialize_at_docs of 256 of the reopened engine's
     parked docs at their heads (bench.py BENCH_TIER_MAT) in one
     dispatch, none revived: every doc and grid row read from the card
     and every save() == its chunk's; docs/s (median of 3). The mixed
     round: 100,000 of those parked docs, each with a
     peer whose sync state the per-link host protocol ran to quiescence;
     1,024 peers send one new change a round: receive_sync_messages_mixed
     revives exactly those 1,024 in one batched revive,
     generate_sync_messages_mixed revives none, skips 98,976 parked
     links and costs 1 hash-index + 1 Bloom dispatch (the probe of the
     peers' filters: the revived docs have nothing the peers lack, so
     no filter is built); 64 divergent and 64 quiet sampled links'
     messages == the host protocol's (the divergent docs' save() and
     materialize_docs too); the revived docs' heads == their peers' once
     each exchange finishes (off the clock), their materialize_docs
     (from the grids) == the peers' host OpSet, and they repark; round
     p50 (median of 3) and links/s; then a round in which
     the hub's copy of each divergent doc changed too, whose generate
     costs 1 hash-index + 2 Bloom dispatches (the build of the hub's
     filters, the probe of the peers'), and a traced round; lww_merge
     and the four sync kernels must have launched. In every leg the
     first 64 calls of each kernel wrapper (outside the timed and
     traced runs) are copied, inputs and results, and held to the
     kernel's plain version after the leg (exact; the hash-index insert
     by membership and new-key count): every kernel the path launched
     must have been held so at least once;
   - sync: a hub of 4 docs (chains of depth 8) serving 100,000 peer
     links (bench.py's fabric sweep, top leg) with its frontier index at
     2^21 slots: a cold round, a round that lands the staged sent sets,
     then 3 timed steady rounds, each peer soliciting a full resend;
     each steady round must cost exactly 1 hash-index and 1 Bloom
     dispatch, and 512 sampled links' messages must equal the per-link
     host protocol's over host backends (cold and steady); then a fresh
     10,000-doc fleet receives the cold round through
     receive_sync_messages_docs (its materialize_docs and save() must
     equal the hub's docs), each replica makes a local edit and replies,
     probing the hub's filter (64 sampled replies equal the host
     protocol's); every sync kernel and the merge must have launched;
4. numbers: seam changes/s (median of 5 warm reps); the merge kernel's
   device time from CUDA events, with the host's launches queued behind a
   sleep kernel, with L2 warm and flushed: noinc+fresh (fresh route)
   beside the zero_() floor of the same bytes, and general (warp route, on
   batches whose packed ids rise, so every launch moves winners) beside
   the CTA-per-doc schedule (the cta route at P = 20), an empty grid
   (P = 0) and a batch that touches no cell; the public wrapper timed
   both ways (queued, and issued call by call from the host); each
   beside its plain version and its bound; then each sync kernel on the
   largest inputs the sync path handed it (recorded during the path),
   held to its plain version there (and both probes find every key the
   insert placed), timed beside its plain version and its bound (the
   build also after an L2 eviction that leaves no dirty line, the insert
   on its table restored before each call, and also followed by such an
   eviction, the probe with the L2 warm and after a clean eviction); the
   register scan on every batch the exact seam and the exact text seam
   handed it (held to its plain version there; L2 warm and after a clean
   eviction, each launch on the touched rows restored off the clock, and
   launches queued back to back); the sequence
   scan held to its plain version on every batch the text seam handed it,
   in full (all rows, all columns, all eight arrays and the count; its
   route and serial rows read), then timed on each (L2 warm and flushed,
   the state restored off the clock) beside that batch's plain time and
   its bound; the torch-op linearize and materialize on the text seam's
   size classes beside their byte bounds; the torch ops that stand for
   the JAX package's other XLA kernels (the doc and register row
   zeroings, the register read and lane permutation, the uniform Bloom
   pair, the frontier compare) at their paths' shapes beside their byte bounds and their
   calls on the main paths; the inline torch ops of DocFleet that the
   storage path launched (grid and register grows, the grid's actor
   remap and the register lane permutation), each at the largest shape
   it had there, beside its byte bound and its calls, and the counter
   rebase, the sequence pool grow and the sequence row copy at the
   largest shape the main paths gave them; traced breakdowns
   of the seam, the pipelined seam, the exact seam, the text seam and
   one steady sync round; the
   grid bytes, and the card's name and power limit.

    python3 chip_smoke.py --baseline DIR

also builds the merge, register, sequence, Bloom and hash-index kernels
of another checkout (e.g. the parent commit, unpacked with `git
archive`) and times its wrappers in phase 4 beside this one's, by the
same methods (the register scan, the sequence scan, the Bloom build and
the hash-index insert and probe in turns: baseline, this, this,
baseline).

The last stdout line is {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository beside it, the script exits non-zero
and prints no result.
"""

import argparse
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
    from automerge_tpu_torch.fleet import (merge_kernel, register_kernel,
                                           seq_kernel, sync_kernels)
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
            ('lww_merge', lambda: merge_kernel.build() is not None),
            ('registers', lambda: register_kernel.build() is not None),
            ('sequence', lambda: seq_kernel.build() is not None),
            ('bloom', lambda: sync_kernels.build_bloom() is not None),
            ('hashindex', lambda: sync_kernels.build_hashindex() is not None)]
    if baseline is not None:
        jobs += [
            ('baseline lww_merge',
             lambda: baseline['merge'].build() is not None),
            ('baseline registers',
             lambda: baseline['reg'].build() is not None),
            ('baseline sequence',
             lambda: baseline['seq'].build() is not None),
            ('baseline bloom',
             lambda: baseline['sync'].build_bloom() is not None),
            ('baseline hashindex',
             lambda: baseline['sync'].build_hashindex() is not None)]
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


def sync_kernel_vs_plain():
    """The sync kernels against their plain versions on the corner
    inputs of fleet/sync_cases.py; any disagreement fails."""
    import numpy as np
    import torch
    from automerge_tpu_torch.fleet import sync_cases
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(40)
    for name in sync_cases.INDEX_CASES:
        case = sync_cases.index_case(name, rng, dev)
        got = sync_cases.index_both(case)
        if got['insert'] or got['probe'] or got['wrong']:
            fail(f'hash-index kernels != plain on {name}: {got}')
        log(f'kernel == plain: hashindex insert + probe, {name} '
            f'({len(case["keys"])} rows into {len(case["tspace"])} slots, '
            f'{got["n_new"]} new)')
    for counts in sorted(sync_cases.BLOOM_COUNTS):
        got = sync_cases.bloom_both(rng, sync_cases.BLOOM_COUNTS[counts], dev)
        if got['build'] or got['probe'] or got['missed']:
            fail(f'Bloom kernels != plain on {counts} sizes: {got}')
        log(f'kernel == plain: bloom build + probe, {counts} sizes '
            f'({got["filters"]} filters, {got["bytes"]} B)')
    for name in sync_cases.BLOOM_PROBE_CASES:
        case = sync_cases.bloom_probe_case(name, rng, dev)
        got = sync_cases.bloom_probe_both(case)
        want_hits = {'all_present': got['valid'], 'all_absent': 0}
        if got['probe'] or got['hits'] != want_hits.get(name, got['hits']):
            fail(f'Bloom probe kernel != plain on {name}: {got}')
        log(f'kernel == plain: bloom probe, {name} ({got["lanes"]} lanes, '
            f'{got["hits"]} hits, {case[0].numel()} B of filters)')
        del case


# the widest register batch: 32 tiles of 32 columns (cut from 3,000
# lanes: the host's plain loop took ~66 s of the script's time limit)
REGISTER_WIDE_P = 1_000
# (docs, keys, actor slots, P, D, where the plain version runs)
REGISTER_CONFIGS = tuple(
    [(300, 40, 8, p, 4, None) for p in (0, 1, 5, 20, 31, 32, 33)] +
    [(48, 9, a, 20, 4, None) for a in (256, 1, 2, 3, 4, 16)] +
    [(64, 9, a, 33, d, None) for a in (8, 256) for d in (1, 6)] +
    [(40, 40, 8, REGISTER_WIDE_P, 4, 'cpu')])


def register_kernel_vs_plain():
    """The register scan against its plain version on every corner of
    fleet/register_cases.py (among them one key for all of a doc's ops,
    and half the lanes on one key): at P = 0, 1, 5, 20, 31, 32 and 33
    lanes (8 actor slots, 4 pred lanes: 32 or 8 docs to a warp, one tile
    or two), at 256 actor slots and at 1, 2, 3, 4 and 16, with 1 and 6
    pred lanes, and at P = REGISTER_WIDE_P (the plain version on the CPU
    there: its Python loop would make ~65,000 launches). Returns the largest
    difference seen (0, or the script fails)."""
    import numpy as np
    from automerge_tpu_torch.fleet import register_cases as rc
    max_err = 0
    for i, name in enumerate(rc.CASES):
        rng = np.random.default_rng(80 + i)
        for n, keys, slots, lanes, d, plain in REGISTER_CONFIGS:
            state, batch = rc.case(name, rng, n, keys, slots, lanes, d)
            got = rc.both(state, batch, DEVICE, plain)
            max_err = max(max_err, got['max_abs_err'])
            if got['differ'] or got['max_abs_err']:
                fail(f'register_scan != plain on {name} at P = {lanes}, '
                     f'A = {slots}, D = {d}: {got}')
        log(f'kernel == plain: register_scan, {name} (P = 0, 1, 5, 20, '
            f'31, 32, 33 and {REGISTER_WIDE_P} at 8 slots; P = 20 at 256, 1, '
            f'2, 3, 4 '
            f'and 16 slots; D = 1 and 6 at P = 33)')
    return max_err


@contextlib.contextmanager
def one_cpu_thread():
    """torch's CPU ops on one thread while the plain versions run on the
    host: their tensors are small, and the intra-op pool costs ~10x a
    scan column on them."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# the widest sequence batch: two of phase B's 128-column windows (cut
# from 512 lanes: the host's plain loop took ~65 s of the script's time
# limit)
SEQ_WIDE_P = 256
# (rows, actor lanes, P, route): None = the wrapper's own plan
SEQ_CONFIGS = ((64, 4, 0, None), (64, 4, 1, None), (64, 4, 20, None),
               (16, 4, SEQ_WIDE_P, None), (16, 256, 0, None),
               (16, 256, 1, None), (16, 256, 20, None),
               (16, 256, SEQ_WIDE_P, None), (32, 4, 40, 'global'),
               (16, 4, SEQ_WIDE_P, 'global'))


def seq_kernel_vs_plain():
    """The sequence scan against its plain version on the card on every
    corner of fleet/seq_cases.py (among them a row at capacity, unknown
    referents, a cyclic chain, refs to later inserts, duplicate ids, one
    node's ops inside a chunk, a failing insert mid-row), at P = 0, 1, 20
    and SEQ_WIDE_P op lanes at 4 and at 256 actor lanes along the
    wrapper's own route ('resident' at these classes) and at P = 40 and
    SEQ_WIDE_P along the
    'global' route (forced), exactly (all eight arrays and the applied
    count); the
    'serial' and 'capacity' corners must send rows to the kernel's serial
    route. At P = SEQ_WIDE_P the plain version runs on the host (one torch
    thread): on the card its Python loop costs ~8 ms a column whatever
    the rows. Then a class past the resident route (the wrapper's plan
    takes 'global') and a fleet whose rows x nodes x lanes pass 2^31
    cells. Returns the largest difference seen (0, or the script fails)."""
    import numpy as np
    from automerge_tpu_torch.fleet import seq_cases as sc
    max_err, serial = 0, {}
    with one_cpu_thread():
        for i, name in enumerate(sc.CASES):
            for n, slots, lanes, route in SEQ_CONFIGS:
                rng = np.random.default_rng(120 + i)
                state, batch = sc.case(name, rng, n, 64, slots, lanes)
                got = sc.both(state, batch, DEVICE,
                              'cpu' if lanes == SEQ_WIDE_P else None,
                              route=route)
                max_err = max(max_err, got['max_abs_err'])
                if got['differ'] or got['max_abs_err']:
                    fail(f'seq_scan != plain on {name} at P = {lanes}, '
                         f'A = {slots}, {got["route"]} route: {got}')
                serial[name] = serial.get(name, 0) + got['serial_rows']
            log(f'kernel == plain: seq_scan, {name} (P = 0, 1, 20 and '
                f'{SEQ_WIDE_P} at 4 and 256 lanes, the wrapper\'s plan; P = 40 '
                f'and {SEQ_WIDE_P} '
                f'along the global route; {serial[name]} rows on the serial '
                f'route)')
        if not serial['serial'] or not serial['capacity']:
            fail(f'the serial route never ran: {serial}')
        rng = np.random.default_rng(5)
        state, batch = sc.case('random', rng, 3, sc.GLOBAL_CAPACITY, 4, 30)
        got = sc.both(state, batch, DEVICE)
    if got['differ'] or got['max_abs_err'] or got['route'] != 'global':
        fail(f'seq_scan != plain on a class past the resident route: {got}')
    log(f'kernel == plain: seq_scan on 3 rows of {sc.GLOBAL_CAPACITY + 3} '
        f'nodes, {got["route"]} route (the wrapper\'s plan)')
    return max(max_err, got['max_abs_err'], seq_wide_offsets())


def seq_wide_offsets():
    """seq_scan on a class of 1,025 rows x 8,195 nodes x 256 lanes (2.15e9
    cells per lane array, past 2^31: int64 offsets) whose last two rows
    carry a batch: those rows must equal the plain version's on a
    two-row state of the same inputs."""
    import numpy as np
    import torch
    from automerge_tpu_torch.fleet import seq_cases as sc
    from automerge_tpu_torch.fleet import seq_kernel
    from automerge_tpu_torch.fleet.sequence import (SeqOpBatch, SeqState,
                                                    seq_state_from_numpy)
    rows, cap, a, p = 1025, 8192, 256, 64
    if rows * (cap + 3) * a <= 2 ** 31:
        fail('the wide case does not pass 2^31 cells')
    small, batch = sc.case('random', np.random.default_rng(7), 2, cap, a, p)
    want = seq_state_from_numpy(*small, device=DEVICE)
    n_want = int(seq_kernel.seq_scan_plain(want, batch.to(DEVICE)))
    big = SeqState.empty(rows, cap, a, device=DEVICE)
    tail = slice(rows - 2, rows)
    for t, x in zip(big.tensors(), seq_state_from_numpy(
            *small, device=DEVICE).tensors()):
        t[tail] = x
    cols = []
    for c in batch.columns():
        full = np.zeros((rows,) + c.shape[1:], c.dtype)
        full[rows - 2:] = c
        cols.append(full)
    n_got = int(seq_kernel.seq_scan(big, SeqOpBatch(*cols).to(DEVICE)))
    err = abs(n_got - n_want)
    for name, x, y in zip(sc.NAMES, big.tensors(), want.tensors()):
        d = int((x[tail].long() - y.long()).abs().max())
        if d:
            fail(f'seq_scan != plain past 2^31 cells: {name} ({d})')
        err = max(err, d)
    if big.inexact[:rows - 2].any() or big.n[:rows - 2].any():
        fail('seq_scan wrote rows without ops past 2^31 cells')
    log(f'kernel == plain: seq_scan on [{rows}, {cap + 3}, {a}] '
        f'({rows * (cap + 3) * a} cells per lane array), rows '
        f'{rows - 2}-{rows - 1}, {n_got} ops applied')
    del big
    torch.cuda.empty_cache()
    return err


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


SUB_BATCHES = 4


def run_seam(per_doc, split=None, mode='plain'):
    """One seam run on a fresh fleet: `mode` 'plain' is one
    apply_changes_docs call, 'pipelined' one apply_changes_docs_pipelined
    call of SUB_BATCHES sub-batches, 'sequential' SUB_BATCHES
    apply_changes_docs calls over the pipelined call's splits. `split`
    (a dict) receives the seconds of fleet + init_docs and of the apply
    up to its sync."""
    import torch
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, apply_changes_docs_pipelined,
        init_docs)
    t0 = time.perf_counter()
    fleet = DocFleet(doc_capacity=N_DOCS, key_capacity=N_KEYS + 1,
                     device=DEVICE)
    handles = init_docs(N_DOCS, fleet)
    t1 = time.perf_counter()
    d0 = fleet.metrics.dispatches
    if mode == 'plain':
        handles, _ = apply_changes_docs(handles, per_doc, mirror=False)
    elif mode == 'pipelined':
        handles, _ = apply_changes_docs_pipelined(
            handles, per_doc, sub_batches=SUB_BATCHES)
    else:
        steps = [-(-len(c) // SUB_BATCHES) for c in per_doc]
        for b in range(SUB_BATCHES):
            handles, _ = apply_changes_docs(
                handles, [c[b * k:(b + 1) * k] for c, k in zip(per_doc, steps)],
                mirror=False)
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
    return launches, fleet.state.nbytes(), tuple(w.shape), per_doc, handles


def traced(run):
    """`run()` once with the host-phase spans on and torch.profiler
    tracing CPU + CUDA. Returns the wall seconds, the seconds per span
    name (summed; `@main` names the main thread's share; `python_gc` the
    seconds the interpreter's garbage collector paused the run), and the
    device-side rows (kernels, copies) as (ms, name, count), longest
    first. The traced run is slower than an untraced one; read the
    shares."""
    import threading as _threading
    import torch
    from automerge_tpu_torch import observability
    from automerge_tpu_torch.observability import spans
    observability.enable(span_capacity=1 << 18)
    spans.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pauses = [0.0, 0.0]        # [seconds paused, start of the current pause]

    def on_gc(phase, _info):
        if phase == 'start':
            pauses[1] = time.perf_counter()
        else:
            pauses[0] += time.perf_counter() - pauses[1]
    with torch.profiler.profile(activities=acts) as prof:
        gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
    observability.disable()
    main_tid = _threading.get_ident()
    phases = {'python_gc': pauses[0]}
    for rec in spans.iter_spans():
        for name in (rec['name'], rec['name'] + '@main') \
                if rec['tid'] == main_tid else (rec['name'],):
            phases[name] = phases.get(name, 0) + rec['dur_ns'] / 1e9
    rows = []
    for evt in prof.key_averages():
        # device-side rows only (kernels, copies): host ops such as
        # aten::copy_ also report their children's device time
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(evt, 'self_cuda_time_total', 0)
        if dev_us:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    return wall, phases, rows


def device_line(wall, rows):
    """Log the device's busy time against the wall time; returns the
    idle share."""
    busy = sum(ms for ms, _, _ in rows)
    copies = sum(ms for ms, key, _ in rows if 'Memcpy' in key)
    idle = 1 - busy / 1e3 / wall
    log(f'device busy {busy:.3f} ms of {wall * 1e3:.1f} ms wall (idle share '
        f'{idle:.4f}; copies {copies:.3f} ms); top: ' +
        '; '.join(f'{key} x{cnt} {ms:.3f} ms' for ms, key, cnt in rows[:6]))
    return idle


def breakdown(per_doc, mode='plain'):
    """One traced seam run (`mode` as run_seam's): seconds per seam
    phase, and the device's busy time against the run's wall time. For
    the pipelined seam, `turbo_parse@main` is the main thread's wait on
    the producer and `native_parse` the producer's parse."""
    split = {}
    wall, phases, rows = traced(lambda: run_seam(per_doc, split, mode))
    order = ('turbo_setup', 'turbo_parse', 'turbo_parse@main',
             'native_parse', 'turbo_gate', 'turbo_commit', 'turbo_stage',
             'turbo_dispatch', 'dispatch_grid', 'python_gc')
    log(f'breakdown, {mode} seam (traced run, wall {wall * 1e3:.1f} ms): '
        f'init_docs {split["init_s"] * 1e3:.1f} ms, apply '
        f'{split["apply_s"] * 1e3:.1f} ms; ' +
        ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms'
                  for name in order))
    device_line(wall, rows)


def pipelined_path(per_doc, seam_handles):
    """The pipelined seam at the seam's shape: grids and save() equal
    the sequential sub-batch seam's, save() equals the one-call seam's,
    one dispatch per sub-batch; then changes/s of both in turns."""
    import numpy as np
    from automerge_tpu_torch.fleet import merge_kernel
    from automerge_tpu_torch.fleet.tensor_doc import state_to_numpy
    merge_kernel.reset_launches()
    fleet, handles, dispatches = run_seam(per_doc, mode='pipelined')
    launches = dict(merge_kernel.LAUNCHES)
    if dispatches != SUB_BATCHES or fleet.metrics.turbo_calls != SUB_BATCHES:
        fail(f'pipelined seam: {dispatches} dispatches, '
             f'{fleet.metrics.turbo_calls} turbo calls (want {SUB_BATCHES})')
    if launches['lww_merge'] < 1:
        fail('the pipelined seam never launched lww_merge')
    seq_fleet, seq_handles, _ = run_seam(per_doc, mode='sequential')
    for name, a, b in zip(('winners', 'values', 'counters'),
                          state_to_numpy(seq_fleet.state),
                          state_to_numpy(fleet.state)):
        if a.shape != b.shape or not np.array_equal(a[:, :-1], b[:, :-1]):
            fail(f'pipelined seam {name} grid != the sequential seam\'s')
    saves = [bytes(h['state'].save()) for h in handles]
    if saves != [bytes(h['state'].save()) for h in seq_handles] or \
            saves != [bytes(h['state'].save()) for h in seam_handles]:
        fail('pipelined seam save() != the sequential / one-call seam\'s')
    log(f'pipelined seam: {N_DOCS} docs x {N_CHANGES} changes in '
        f'{SUB_BATCHES} sub-batches, {dispatches} dispatches, lww_merge '
        f'launches {launches["lww_merge"]}; grids == sequential sub-batch '
        f'seam, all {N_DOCS} save() == sequential and one-call seam')
    rates = {'plain': [], 'pipelined': []}
    for mode in ('plain', 'pipelined', 'pipelined', 'plain') * 3:
        t0 = time.perf_counter()
        run_seam(per_doc, mode=mode)
        rates[mode].append(N_DOCS * N_CHANGES / (time.perf_counter() - t0))
    for mode, reps in rates.items():
        log(f'{mode} seam changes/s (median of {len(reps)}, in turns): '
            f'{statistics.median(reps):.1f}  reps {[round(r) for r in reps]}')


# ---- the exact seam ---------------------------------------------------------

class RegisterRecorder:
    """While on, keeps a copy of every batch the fleet hands the register
    scan and of the state before that call, so phase 4 can hold and time
    the kernel on the main path's own inputs. The wrapper still counts
    its launches as before."""

    def __init__(self):
        self.saved = []

    def __enter__(self):
        from automerge_tpu_torch.fleet import registers
        self._real = registers.register_scan

        def call(state, ops):
            self.saved.append((registers.RegisterState(
                *(t.clone() for t in state.tensors())),
                registers.RegisterOpBatch(*(c.clone()
                                            for c in ops.columns()))))
            return self._real(state, ops)
        registers.register_scan = call
        return self

    def __exit__(self, *exc):
        from automerge_tpu_torch.fleet import registers
        registers.register_scan = self._real


def run_exact_seam(batches, split=None):
    """One exact seam run on a fresh fleet: DocFleet(exact_device=True),
    init_docs, then one apply_changes_docs(mirror=False) call per batch
    (every doc gets the same bytes). `split` (a dict) receives the
    seconds of fleet + init_docs and of the first batch up to its sync.
    Returns the fleet, the handles and the dispatches of each batch."""
    import torch
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, init_docs)
    t0 = time.perf_counter()
    fleet = DocFleet(doc_capacity=N_DOCS, key_capacity=N_KEYS + 1,
                     exact_device=True, device=DEVICE)
    handles = init_docs(N_DOCS, fleet)
    t1 = time.perf_counter()
    dispatches = []
    for i, batch in enumerate(batches):
        d0 = fleet.metrics.dispatches
        handles, _ = apply_changes_docs(
            handles, [list(batch) for _ in range(N_DOCS)], mirror=False)
        dispatches.append(fleet.metrics.dispatches - d0)
        if i == 0:
            torch.cuda.synchronize()
            if split is not None:
                split['init_s'] = t1 - t0
                split['apply_s'] = time.perf_counter() - t1
    torch.cuda.synchronize()
    return fleet, handles, dispatches


def exact_path(per_doc):
    """The exact seam at full width (see the module docstring). Returns
    its launches and the register scan's recorded inputs."""
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.columnar import (decode_change_meta,
                                              decode_document)
    from automerge_tpu_torch.fleet import register_cases, register_kernel
    from automerge_tpu_torch.fleet.backend import (_leaf_value, get_patch,
                                                   materialize_docs)
    batches = register_cases.exact_seam_changes(N_CHANGES, N_KEYS)
    register_kernel.reset_launches()
    with RegisterRecorder() as rec:
        fleet, handles, dispatches = run_exact_seam(batches)
    launches = dict(register_kernel.LAUNCHES)
    if dispatches != [1, 1, 1]:
        fail(f'exact seam: {dispatches} register dispatches per batch '
             f'(want 1 each)')
    if launches['register_scan'] < 1:
        fail('the exact seam never launched register_scan')
    rs = fleet.reg_state
    shape = tuple(rs.reg.shape)
    # _ensure_reg_capacity: docs at capacity, keys pow2(1,001), 8 slots
    want_shape = (N_DOCS, 1024, 8)
    want_bytes = N_DOCS * 1024 * 8 * (4 + 1 + 4 + 4) + N_DOCS
    if rs.reg.device.type != DEVICE or shape != want_shape or \
            rs.nbytes() != want_bytes:
        fail(f'exact seam: register state {shape} on {rs.reg.device}, '
             f'{rs.nbytes()} B (want {want_shape} on {DEVICE}, '
             f'{want_bytes} B)')
    hb = host.init()
    for batch in batches:
        hb, _ = host.apply_changes(hb, batch)
    want_patch = host.get_patch(hb)
    want = _leaf_value(want_patch['diffs'])
    want_conflicts = {key: {op_id: leaf['value'] for op_id, leaf in
                            cands.items()}
                      for key, cands in want_patch['diffs']['props'].items()
                      if len(cands) > 1}
    docs = materialize_docs(handles)
    if any(doc != want for doc in docs):
        bad = next(i for i, doc in enumerate(docs) if doc != want)
        fail(f'exact seam: doc {bad} != the host OpSet: {docs[bad]} vs '
             f'{want}')
    conflicts = fleet.conflicts_all()
    named = [{key: {_op_name(fleet, p): v for p, v in c.items()}
              for key, c in doc.items()} for doc in conflicts]
    if len(named) != N_DOCS or any(c != want_conflicts for c in named):
        fail(f'exact seam: conflicts_all != the host OpSet\'s '
             f'({named[0]} vs {want_conflicts})')
    hashes = sorted(decode_change_meta(b, True)['hash']
                    for batch in batches for b in batch)
    for d in (0, 1, N_DOCS // 2, N_DOCS - 1):
        if get_patch(handles[d]) != want_patch:
            fail(f'exact seam: doc {d} get_patch() != the host patch')
        saved = bytes(handles[d]['state'].save())
        if sorted(ch['hash'] for ch in decode_document(saved)) != hashes \
                or saved != bytes(host.save(hb)):
            fail(f'exact seam: doc {d} save() does not round-trip')
    if fleet.inexact_slots():
        fail(f'exact seam: inexact slots {sorted(fleet.inexact_slots())}')
    log(f'exact seam: {N_DOCS} docs, 3 batches ({N_CHANGES} + 2 + 1 '
        f'changes per doc), register dispatches {dispatches}, '
        f'register_scan launches {launches["register_scan"]}, register '
        f'state {shape} on {rs.reg.device} = {rs.nbytes()} B; all '
        f'{N_DOCS} docs\' materialize_docs and conflicts_all == host '
        f'OpSet (conflicts on {sorted(want_conflicts)}), 4 sampled '
        f'get_patch() == host patch, save() round-trips and == host '
        f'save(), no inexact slot')
    del fleet, handles, rs
    rates = {'exact': [], 'lww': []}
    for mode in ('exact', 'lww', 'lww', 'exact') * 2 + ('exact', 'lww'):
        gc.collect()        # the last run's fleet returns its memory first
        t0 = time.perf_counter()
        if mode == 'exact':
            run_exact_seam(batches[:1])
        else:
            run_seam(per_doc)
        rates[mode].append(N_DOCS * N_CHANGES / (time.perf_counter() - t0))
    for mode, reps in rates.items():
        log(f'{mode} seam changes/s (first batch, median of {len(reps)}, '
            f'in turns): {statistics.median(reps):.1f}  reps '
            f'{[round(r) for r in reps]}')
    return launches, rec.saved, batches


def _op_name(fleet, packed):
    from automerge_tpu_torch.fleet.tensor_doc import unpack_op_id
    ctr, num = unpack_op_id(int(packed))
    return f'{ctr}@{fleet.actors.actors[num]}'


# ---- the text seam -----------------------------------------------------------

# 1,000 docs: BASELINE config 2's 2,000, cut for the script's time limit
TEXT_DOCS, TEXT_OPS, TEXT_MORE = 1_000, 10_000, (256, 256)
TEXT_REPS = 3      # 5 before the storage path: the script's time limit


class SeqRecorder:
    """While on, keeps a copy of every batch the fleet hands the sequence
    scan and of the state before that call, so phase 4 can hold the
    kernel to its plain version on each of the main path's own inputs and
    time it on the largest. The wrapper still counts its launches as
    before."""

    def __init__(self):
        self.saved = []

    def __enter__(self):
        from automerge_tpu_torch.fleet import sequence
        self._real = sequence.seq_scan

        def call(state, ops):
            self.saved.append((sequence.SeqState(
                *(t.clone() for t in state.tensors())),
                sequence.SeqOpBatch(*ops.columns())))
            return self._real(state, ops)
        sequence.seq_scan = call
        return self

    def __exit__(self, *exc):
        from automerge_tpu_torch.fleet import sequence
        sequence.seq_scan = self._real


def run_text_seam(batches, exact=False, split=None):
    """One text seam run on a fresh fleet: DocFleet(exact_device=exact),
    init_docs(TEXT_DOCS), then one apply_changes_docs(mirror=False) call
    per batch (every doc gets the same bytes), up to a sync. `split` (a
    dict) receives the seconds of fleet + init_docs and of the applies.
    Returns the fleet, the handles, and the dispatches and seq_scan
    launches of each batch."""
    import torch
    from automerge_tpu_torch.fleet import seq_kernel
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, init_docs)
    t0 = time.perf_counter()
    fleet = DocFleet(doc_capacity=TEXT_DOCS, key_capacity=4,
                     exact_device=exact, device=DEVICE)
    handles = init_docs(TEXT_DOCS, fleet)
    t1 = time.perf_counter()
    dispatches, launches = [], []
    for batch in batches:
        d0, l0 = fleet.metrics.dispatches, seq_kernel.LAUNCHES['seq_scan']
        handles, _ = apply_changes_docs(
            handles, [list(batch) for _ in range(TEXT_DOCS)], mirror=False)
        dispatches.append(fleet.metrics.dispatches - d0)
        launches.append(seq_kernel.LAUNCHES['seq_scan'] - l0)
    torch.cuda.synchronize()
    if split is not None:
        split['init_s'] = t1 - t0
        split['apply_s'] = time.perf_counter() - t1
    return fleet, handles, dispatches, launches


def pool_bytes(fleet):
    return {cls: (tuple(st.reg.shape), st.nbytes())
            for cls, st in sorted(fleet.seq_pools.pools.items())}


def check_text_seam(fleet, handles, dispatches, launches, want, tag):
    """The text seam's checks at full size (see the module docstring)."""
    from automerge_tpu_torch.columnar import decode_document
    from automerge_tpu_torch.fleet.backend import get_patch, materialize_docs
    want_doc, want_patch, want_save, hashes = want
    if dispatches != [2, 1, 1] or launches != [1, 1, 1]:
        fail(f'{tag}: dispatches {dispatches}, seq_scan launches '
             f'{launches} per batch (want [2, 1, 1] and one launch each)')
    if fleet.metrics.fallbacks:
        fail(f'{tag}: {fleet.metrics.fallbacks} fallbacks')
    for cls, st in fleet.seq_pools.pools.items():
        if st.elem_id.device.type != DEVICE or bool(st.inexact.any()):
            fail(f'{tag}: class {cls} on {st.elem_id.device}, inexact rows '
                 f'{int(st.inexact.sum())}')
    if fleet.exact_device and fleet.inexact_slots():
        fail(f'{tag}: inexact slots {sorted(fleet.inexact_slots())[:8]}')
    docs = materialize_docs(handles)
    if len(docs) != TEXT_DOCS or any(doc != want_doc for doc in docs):
        bad = next(i for i, doc in enumerate(docs) if doc != want_doc)
        fail(f'{tag}: doc {bad} text != the host OpSet\'s')
    for d in (0, 1, TEXT_DOCS // 2, TEXT_DOCS - 1):
        if get_patch(handles[d]) != want_patch:
            fail(f'{tag}: doc {d} get_patch() != the host patch')
        saved = bytes(handles[d]['state'].save())
        if saved != want_save or sorted(
                ch['hash'] for ch in decode_document(saved)) != hashes:
            fail(f'{tag}: doc {d} save() != the host\'s or does not '
                 f'round-trip')


def text_path():
    """The text seam at full size (see the module docstring). Returns the
    launches of every kernel, the scan's recorded input, the final LWW
    fleet's pool states, the batches and the register scan's recorded
    inputs of the exact run."""
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.columnar import decode_change_meta
    from automerge_tpu_torch.fleet import (merge_kernel, register_kernel,
                                           seq_cases, seq_kernel)
    from automerge_tpu_torch.fleet.backend import _leaf_value
    batches = seq_cases.text_changes(TEXT_OPS, more=TEXT_MORE)
    n_ops = TEXT_OPS + sum(TEXT_MORE)
    hb = host.init()
    for batch in batches:
        hb, _ = host.apply_changes(hb, batch)
    want_patch = host.get_patch(hb)
    want = (_leaf_value(want_patch['diffs']), want_patch,
            bytes(host.save(hb)),
            sorted(decode_change_meta(b, True)['hash']
                   for batch in batches for b in batch))
    for mod in (merge_kernel, register_kernel, seq_kernel):
        mod.reset_launches()
    with SeqRecorder() as rec:
        fleet, handles, dispatches, launches = run_text_seam(batches)
    kernel_launches = {**merge_kernel.LAUNCHES, **seq_kernel.LAUNCHES,
                       'seq_scan_routes': dict(seq_kernel.ROUTE_LAUNCHES)}
    if kernel_launches['seq_scan'] < 1 or kernel_launches['lww_merge'] < 1:
        fail(f'the text seam never launched a kernel: {kernel_launches}')
    check_text_seam(fleet, handles, dispatches, launches, want, 'text seam')
    text_len = len(want[0]['t'])
    log(f'text seam: {TEXT_DOCS} docs x {n_ops} ops ({len(batches[0])} + '
        f'{len(batches[1])} + {len(batches[2])} changes, 3 actors; text of '
        f'{text_len} chars), dispatches {dispatches}, seq_scan launches '
        f'{launches}, kernel launches {kernel_launches}; pools '
        f'(shape, bytes) {pool_bytes(fleet)}; all {TEXT_DOCS} texts == host '
        f'OpSet, 4 sampled get_patch() and save() == host, save() '
        f'round-trips, nothing inexact, no fallbacks')
    pools = dict(fleet.seq_pools.pools)
    del fleet, handles
    register_kernel.reset_launches()
    l0 = seq_kernel.LAUNCHES['seq_scan']
    with RegisterRecorder() as xrec:
        xfleet, xhandles, xdisp, xlaunch = run_text_seam(batches,
                                                         exact=True)
    if register_kernel.LAUNCHES['register_scan'] < 1 or \
            seq_kernel.LAUNCHES['seq_scan'] - l0 < 1:
        fail('the exact text seam never launched register_scan / seq_scan')
    check_text_seam(xfleet, xhandles, xdisp, xlaunch, want,
                    'exact text seam')
    log(f'exact text seam: dispatches {xdisp}, seq_scan launches '
        f'{xlaunch}, register_scan launches '
        f'{register_kernel.LAUNCHES["register_scan"]}; all {TEXT_DOCS} '
        f'texts == host OpSet, 4 sampled device-served get_patch() and '
        f'save() == host, nothing inexact, no fallbacks')
    del xfleet, xhandles
    rates = []
    for _ in range(TEXT_REPS):
        gc.collect()        # the last run's fleet returns its memory first
        t0 = time.perf_counter()
        run_text_seam(batches)
        rates.append(TEXT_DOCS * n_ops / (time.perf_counter() - t0))
    log(f'text seam ops/s (median of {TEXT_REPS} warm reps): '
        f'{statistics.median(rates):.1f}  reps {[round(r) for r in rates]}')
    return kernel_launches, rec.saved, pools, batches, xrec.saved


# ---- the load path ----------------------------------------------------------

LOAD_REPS = 3            # load docs/s: the median of 3, as bench.py measures
PARKED_DOCS = 1_000


class RouteRecorder:
    """While on, records the route of every lww_merge launch plan."""

    def __init__(self):
        self.routes = []

    def __enter__(self):
        from automerge_tpu_torch.fleet import merge_kernel
        self._real = merge_kernel._launch_plan

        def plan(*args, **kwargs):
            out = self._real(*args, **kwargs)
            self.routes.append(out.route)
            return out
        merge_kernel._launch_plan = plan
        return self

    def __exit__(self, *exc):
        from automerge_tpu_torch.fleet import merge_kernel
        merge_kernel._launch_plan = self._real


def follow_up(actor, seq, start_op, heads, key, value):
    """One change setting `key` on top of `heads`."""
    from automerge_tpu_torch.columnar import encode_change
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': list(heads),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': value, 'datatype': 'int', 'pred': []}]})


def install_line(tag, wall, rows, cells_bytes):
    """The load's device time: the install writes (the index_put kernels)
    beside their byte bound, and the device's busy share."""
    writes = [(ms, cnt) for ms, key, cnt in rows if 'index' in key.lower()]
    bound = bound_of(cells_bytes, 0)
    if not writes:
        # torch.profiler's trace of a short run sometimes holds no device
        # activity at all: the writes were not measured, not free
        log(f'{tag} install writes: not measured (the profiler recorded '
            f'no device activity), bound {bound["bound_ms"]:.4f} ms '
            f'({cells_bytes} B); {card_line()}')
        return dict(ms=None, launches=None, **bound)
    ms = sum(m for m, _ in writes)
    launches = sum(c for _, c in writes)
    log(f'{tag} install writes: {ms:.4f} ms device in {launches} index '
        f'kernels, bound {bound["bound_ms"]:.4f} ms ({cells_bytes} B); '
        f'{card_line()}')
    device_line(wall, rows)
    return dict(ms=ms, launches=launches, **bound)


def load_breakdown(nums):
    """One traced LWW load (see load_path): the install writes' device
    time beside their byte bound."""
    lww = nums['lww']
    gc.collect()
    wall, phases, rows = traced(lww.pop('run'))
    lww.update(install_line(
        f'LWW load (traced, wall {wall * 1e3:.1f} ms, bulk_load span '
        f'{phases.get("bulk_load", 0) * 1e3:.1f} ms)', wall, rows,
        lww.pop('bytes')))


def load_path():
    """The bulk loader and the parked form at full width (see the module
    docstring). Returns the kernel launches of its follow-up batches and
    the install writes' numbers."""
    import torch
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.fleet import (load_docs, merge_kernel,
                                           register_kernel, seq_cases,
                                           seq_kernel)
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, _leaf_value, apply_changes_docs, get_patch,
        materialize_docs, park_docs, rebuild_docs)
    for mod in (merge_kernel, register_kernel, seq_kernel):
        mod.reset_launches()
    changes, heads, last = seam_workload()
    hb = host.init()
    hb, _ = host.apply_changes(hb, changes)
    saved = bytes(host.save(hb))
    if _leaf_value(host.get_patch(hb)['diffs']) != last:
        fail('load path: the saved seam document != the last writers')
    nums = {}

    def load(exact=False):
        fleet = DocFleet(doc_capacity=N_DOCS, key_capacity=N_KEYS,
                         exact_device=exact, device=DEVICE)
        handles = load_docs([saved] * N_DOCS, fleet)
        torch.cuda.synchronize()
        return fleet, handles

    # LWW: load, read, save, one more change
    fleet, handles = load()
    if fleet.metrics.docs_bulk_loaded != N_DOCS:
        fail(f'load path: {fleet.metrics.docs_bulk_loaded} of {N_DOCS} '
             f'docs bulk-loaded')
    docs = materialize_docs(handles)
    if any(doc != last for doc in docs):
        bad = next(i for i, doc in enumerate(docs) if doc != last)
        fail(f'load path: doc {bad} != the seam\'s document')
    if any(bytes(h['state'].save()) != saved for h in handles):
        fail('load path: an unedited save() != the loaded bytes')
    extra = follow_up('cc' * 16, 1, N_CHANGES + 1, heads, 'loaded', 7)
    with RouteRecorder() as rr:
        handles, _ = apply_changes_docs(handles, [[extra]] * N_DOCS,
                                        mirror=False)
        torch.cuda.synchronize()
    if merge_kernel.LAUNCHES['lww_merge'] != 1 or rr.routes != ['warp']:
        fail(f'load path: the follow-up batch took {rr.routes} '
             f'({merge_kernel.LAUNCHES["lww_merge"]} launches; want one '
             f'in-place launch)')
    hb2, _ = host.apply_changes(hb, [extra])
    want2 = _leaf_value(host.get_patch(hb2)['diffs'])
    docs = materialize_docs(handles)
    for d in (0, 1, N_DOCS // 2, N_DOCS - 1):
        if docs[d] != want2 or bytes(handles[d]['state'].save()) != \
                bytes(host.save(hb2)):
            fail(f'load path: doc {d} after the follow-up != host OpSet')
    cells = int((fleet.state.winners != 0).sum())
    log(f'load path (LWW): {N_DOCS} copies of the seam document '
        f'({len(saved)} B) into grids {tuple(fleet.state.winners.shape)} '
        f'x3 int32 = {fleet.state.nbytes()} B, docs_bulk_loaded '
        f'{fleet.metrics.docs_bulk_loaded}, all docs == the seam\'s, '
        f'unedited save() == loaded bytes; one more change: lww_merge '
        f'launches {merge_kernel.LAUNCHES["lww_merge"]} on route '
        f'{rr.routes}, 4 docs == host OpSet')

    # park 1,000 docs, change them, rebuild them into a fresh fleet
    parked = handles[:PARKED_DOCS]
    control = handles[PARKED_DOCS:2 * PARKED_DOCS]
    n_parked = park_docs(parked)
    if n_parked != PARKED_DOCS:
        fail(f'load path: park_docs parked {n_parked} of {PARKED_DOCS}')
    more = follow_up('cc' * 16, 2, N_CHANGES + 2,
                     host.get_heads(hb2), 'parked', 9)
    both = parked + control
    both, _ = apply_changes_docs(both, [[more]] * len(both), mirror=False)
    if any(h['state']._impl._doc_pending is None
           for h in both[:PARKED_DOCS]):
        fail('load path: a parked doc left its parked form')
    fresh = DocFleet(doc_capacity=PARKED_DOCS, key_capacity=N_KEYS,
                     device=DEVICE)
    rebuilt = rebuild_docs(both[:PARKED_DOCS], fresh)
    torch.cuda.synchronize()
    want_docs = materialize_docs(both[PARKED_DOCS:])
    want_saves = [bytes(h['state'].save()) for h in both[PARKED_DOCS:]]
    if materialize_docs(rebuilt) != want_docs or \
            [bytes(h['state'].save()) for h in rebuilt] != want_saves:
        fail('load path: rebuilt parked docs != docs never parked')
    log(f'park and rebuild: {n_parked} loaded docs parked, one change '
        f'each (delta tails), rebuilt into a fresh fleet: '
        f'materialize_docs and save() == {PARKED_DOCS} docs never parked')
    del fleet, handles, parked, control, both, fresh, rebuilt
    gc.collect()

    # load docs/s, and one traced load
    rates = []
    for _ in range(LOAD_REPS):
        gc.collect()
        t0 = time.perf_counter()
        load()
        rates.append(N_DOCS / (time.perf_counter() - t0))
    log(f'load docs/s (median of {LOAD_REPS}): '
        f'{statistics.median(rates):.1f}  reps {[round(r) for r in rates]}; '
        f'{card_line()}')
    # each cell: its two int64 indices and three int64 columns read, three
    # int32 cells written (traced at the end: load_breakdown)
    nums['lww'] = dict(run=load, bytes=cells * (5 * 8 + 12),
                       docs_per_s=statistics.median(rates))
    gc.collect()

    # Exact: the same load into the register state
    xfleet, xhandles = load(exact=True)
    xfleet_bytes = xfleet.reg_state.nbytes()
    if xfleet.metrics.docs_bulk_loaded != N_DOCS or xfleet.inexact_slots():
        fail(f'exact load: {xfleet.metrics.docs_bulk_loaded} bulk-loaded, '
             f'{len(xfleet.inexact_slots())} inexact slots')
    if any(doc != last for doc in materialize_docs(xhandles)):
        fail('exact load: a doc != the seam\'s document')
    xhandles, _ = apply_changes_docs(xhandles, [[extra]] * N_DOCS,
                                     mirror=False)
    torch.cuda.synchronize()
    if register_kernel.LAUNCHES['register_scan'] != 1:
        fail(f'exact load: the follow-up batch launched register_scan '
             f'{register_kernel.LAUNCHES["register_scan"]} times')
    xdocs = materialize_docs(xhandles)
    for d in (0, 1, N_DOCS // 2, N_DOCS - 1):
        if xdocs[d] != want2 or get_patch(xhandles[d]) != \
                host.get_patch(hb2):
            fail(f'exact load: doc {d} after the follow-up != host OpSet')
    xcells = int((xfleet.reg_state.reg != 0).sum())
    log(f'load path (exact): {N_DOCS} docs into registers '
        f'{tuple(xfleet.reg_state.reg.shape)} ({xfleet_bytes} B), nothing '
        f'inexact, all docs == the seam\'s; one more change: register_scan '
        f'launches {register_kernel.LAUNCHES["register_scan"]}, 4 docs\' '
        f'materialize_docs and device-served get_patch() == host OpSet')
    del xfleet, xhandles
    gc.collect()

    # Text: the text seam's document, TEXT_DOCS copies
    batches = seq_cases.text_changes(TEXT_OPS, more=TEXT_MORE + (256,))
    tb_ = host.init()
    for batch in batches[:-1]:
        tb_, _ = host.apply_changes(tb_, batch)
    tsaved = bytes(host.save(tb_))
    want_text = _leaf_value(host.get_patch(tb_)['diffs'])
    n_ops = TEXT_OPS + sum(TEXT_MORE)

    def tload():
        fleet = DocFleet(doc_capacity=TEXT_DOCS, key_capacity=4,
                         device=DEVICE)
        handles = load_docs([tsaved] * TEXT_DOCS, fleet)
        torch.cuda.synchronize()
        return fleet, handles

    l0 = seq_kernel.LAUNCHES['seq_scan']
    loaded = []
    wall, phases, rows = traced(lambda: loaded.append(tload()))
    tfleet, thandles = loaded.pop()
    if seq_kernel.LAUNCHES['seq_scan'] != l0:
        fail('text load: the load launched the sequence scan')
    if any(tfleet.seq_pools.free.values()):
        fail(f'text load: rows migrated between size classes '
             f'({ {c: len(f) for c, f in tfleet.seq_pools.free.items()} })')
    if tfleet.metrics.docs_bulk_loaded != TEXT_DOCS or \
            any(bool(st.inexact.any())
                for st in tfleet.seq_pools.pools.values()):
        fail('text load: a doc fell back or a row is inexact')
    tdocs = materialize_docs(thandles)
    if any(doc != want_text for doc in tdocs):
        fail('text load: a text != the text seam\'s')
    elems = sum(int(st.n.sum()) for st in tfleet.seq_pools.pools.values())
    lanes = sum(int((st.reg != 0).sum())
                for st in tfleet.seq_pools.pools.values())
    nodes = TEXT_DOCS * max(st.nxt.shape[1]
                            for st in tfleet.seq_pools.pools.values())
    log(f'load path (text): {TEXT_DOCS} copies of the text seam\'s '
        f'document ({n_ops} ops, {len(tsaved)} B) in {wall:.1f} s '
        f'({TEXT_DOCS / wall:.1f} docs/s; {card_line()}; traced; '
        f'bulk_load span {phases.get("bulk_load", 0):.1f} s), pools '
        f'(shape, bytes) {pool_bytes(tfleet)}, all texts == the text '
        f'seam\'s, nothing inexact, no migration, no scan launched')
    thandles, _ = apply_changes_docs(thandles, [batches[-1]] * TEXT_DOCS,
                                     mirror=False)
    torch.cuda.synchronize()
    if seq_kernel.LAUNCHES['seq_scan'] - l0 != 1:
        fail(f'text load: the follow-up batch launched seq_scan '
             f'{seq_kernel.LAUNCHES["seq_scan"] - l0} times')
    tb_, _ = host.apply_changes(tb_, batches[-1])
    want_text = _leaf_value(host.get_patch(tb_)['diffs'])
    tdocs = materialize_docs(thandles)
    if any(doc != want_text for doc in tdocs):
        fail('text load: a text after the follow-up != the host OpSet\'s')
    log(f'text load, a further {len(batches[-1])}-change batch of 256 ops: '
        f'seq_scan launches 1, all {TEXT_DOCS} texts == host OpSet')
    del tfleet, thandles
    gc.collect()
    # the chain rows written whole (int32, with their n), each element's
    # two indices and id, each lane's three indices and four values
    nums['text'] = install_line(
        'text load', wall, rows,
        nodes * 4 + elems * (3 * 8 + 4) + lanes * (7 * 8 + 13))
    launches = {**merge_kernel.LAUNCHES, **register_kernel.LAUNCHES,
                **seq_kernel.LAUNCHES}
    return launches, nums


# ---- the Automerge.* API ----------------------------------------------------

API_SHAPES_DOCS, API_SHAPES_KEYS = 64, 64
API_DOCS = 10_000        # the mixed document's fleet: the seam cells' 10,000
                         # docs (bench.py BENCH_MIXED_DOCS defaults to 500)
API_REPS = 3             # changes/s: the median of 3 warm reps
API_HUB_DOCS = 500       # per-doc API docs on one FleetBackend (1,000
                         # until the service path joined the script)
API_SAMPLES = 16         # of them, run through the host backend as well


def device_arrays(fleet):
    """Copies of the fleet's device state as numpy arrays: the registers
    in exact mode, else the LWW grids' real key columns (column K is
    scratch)."""
    from automerge_tpu_torch.fleet import registers
    from automerge_tpu_torch.fleet.tensor_doc import state_to_numpy
    if fleet.exact_device:
        return [a.copy() for a in
                registers.register_state_to_numpy(fleet.reg_state)]
    return [a[:, :fleet.key_cap].copy() for a in state_to_numpy(fleet.state)]


def api_shapes(exact, device):
    """api_cases.integration_docs through the port's Automerge.* API with
    a FleetBackend(DocFleet(64 docs, 64 keys)) on `device`. Returns the
    documents, saves, what materialize_docs read from the device, the
    sequence rows rendered from the device, the device arrays and the
    fleet."""
    import automerge_tpu_torch as A
    from automerge_tpu_torch import api_cases
    from automerge_tpu_torch.fleet.backend import (DocFleet, FleetBackend,
                                                   materialize_docs)
    fleet = DocFleet(doc_capacity=API_SHAPES_DOCS,
                     key_capacity=API_SHAPES_KEYS, exact_device=exact,
                     device=device)
    A.set_default_backend(FleetBackend(fleet))
    try:
        docs = api_cases.integration_docs(A)
        names = list(docs)
        read = materialize_docs(
            [A.Frontend.get_backend_state(docs[n]) for n in names])
        saves = [bytes(A.save(docs[n])) for n in names]
    finally:
        A.set_default_backend(A.backend)
    return dict(docs=[docs[n].to_py() for n in names], saves=saves,
                read=read, seq=fleet.render_seq_all(),
                arrays=device_arrays(fleet), fleet=fleet)


def api_path():
    """The Automerge.* API on the card (see the module docstring): the
    integration shapes in both modes, the mixed document at 10,000 docs
    and the per-doc API at API_HUB_DOCS docs. Each leg runs with every
    launch count set to 0 just before it; the kernel calls each leg kept
    are held to the plain versions after it. Returns the launches summed
    over the legs and the calls held to the plain versions."""
    import numpy as np
    import torch
    import automerge_tpu_torch as A
    from automerge_tpu_torch import api_cases
    from automerge_tpu_torch.columnar import decode_change
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, FleetBackend, apply_changes_docs, init_docs,
        materialize_docs)
    legs = {}
    host = api_cases.integration_docs(A)
    names = list(host)
    want = dict(docs=[host[n].to_py() for n in names],
                saves=[bytes(A.save(host[n])) for n in names],
                read=[api_cases.reading(A, host[n]) for n in names])
    with PathCheck('api path') as check:
        for exact in (False, True):
            tag = 'integration shapes, ' + ('exact' if exact else 'lww')
            got = storage_leg(
                tag, legs, lambda: api_shapes(exact, DEVICE),
                needs=('register_scan' if exact else 'lww_merge',
                       'seq_scan'), path='api path')
            with check.paused():
                cpu = api_shapes(exact, 'cpu')
            for key in ('docs', 'saves', 'read'):
                if got[key] != want[key]:
                    bad = next(n for n, a, b in zip(names, got[key],
                                                    want[key]) if a != b)
                    fail(f'api path, {tag}: {key} of {bad!r} != the host '
                         f'backend\'s')
            if got['seq'] != cpu['seq'] or \
                    any(not np.array_equal(a, b) for a, b in
                        zip(got['arrays'], cpu['arrays'])):
                fail(f'api path, {tag}: the card\'s sequence rows or '
                     f'device arrays != a CPU fleet\'s')
            if got['fleet'].metrics.promotions:
                fail(f'api path, {tag}: a document left the fleet')
            log(f'api path, {tag}: {len(names)} documents (values, save(), '
                f'materialize_docs read from the card) == the host '
                f'backend\'s; sequence rows and device arrays == a CPU '
                f'fleet\'s')
            check.verify(tag)
            del got, cpu

        mixed = api_cases.mixed_doc(A)
        changes = [bytes(b) for b in A.get_all_changes(mixed)]
        ops_per_change = sum(len(decode_change(b)['ops'])
                             for b in changes) / len(changes)
        per_doc = [list(changes) for _ in range(API_DOCS)]
        want_read = api_cases.reading(A, mixed)

        def mixed_run():
            fleet = DocFleet(doc_capacity=API_DOCS, key_capacity=64,
                             device=DEVICE)
            handles = init_docs(API_DOCS, fleet)
            merges = kernel_launches()['lww_merge']
            handles, _ = apply_changes_docs(handles, per_doc, mirror=False)
            torch.cuda.synchronize()
            merges = kernel_launches()['lww_merge'] - merges
            if fleet.metrics.fallbacks or not fleet.metrics.turbo_calls:
                fail(f'api path, mixed document: {fleet.metrics.fallbacks} '
                     f'fallbacks, {fleet.metrics.turbo_calls} turbo calls')
            if merges != 1:
                fail(f'api path, mixed document: {merges} merge launches '
                     f'for one batch (want 1)')
            return fleet, handles

        def mixed_leg():
            fleet, handles = mixed_run()
            read = materialize_docs(handles)
            if any(doc != want_read for doc in read):
                bad = next(i for i, doc in enumerate(read)
                           if doc != want_read)
                fail(f'api path, mixed document: doc {bad} read from the '
                     f'card != the authoring document')
            rows = grid_view(fleet, handles, 'api path, mixed document')
            cpu = DocFleet(doc_capacity=1, key_capacity=64, device='cpu')
            with check.paused():
                one = init_docs(1, cpu)
                one, _ = apply_changes_docs(one, [list(changes)],
                                            mirror=False)
            # the sequence rows hold links to the rows' maps: compare
            # their reprs (a link names its object, not its fleet)
            seq = {repr(v) for v in fleet.render_seq_all().values()}
            if any(row != rows[0] for row in rows) or \
                    rows[:1] != grid_view(cpu, one, 'api path, CPU doc') or \
                    len(fleet.render_seq_all()) != API_DOCS or \
                    seq != {repr(v) for v in cpu.render_seq_all().values()}:
                fail('api path, mixed document: a grid row or sequence row '
                     'on the card != a CPU fleet\'s')
            return len(read)
        n_read = storage_leg('mixed document', legs, mixed_leg,
                             needs=('lww_merge', 'seq_scan'),
                             path='api path')
        check.verify('mixed document')
        rates = []
        with check.paused():
            for _ in range(API_REPS):
                t0 = time.perf_counter()
                mixed_run()
                rates.append(API_DOCS * len(changes) /
                             (time.perf_counter() - t0))
            wall, phases, rows = traced(mixed_run)
        rate = statistics.median(rates)
        log(f'api path, mixed document (bench.py bench_backend_mixed at '
            f'{API_DOCS} docs): {len(changes)} changes, '
            f'{ops_per_change:.2f} ops per change; changes/s (median of '
            f'{API_REPS} warm reps) {rate:.1f} {[round(r) for r in rates]};'
            f' one merge launch per batch, no fallback; every one of '
            f'{n_read} docs read from the card == the authoring document, '
            f'grid and sequence rows == a CPU fleet\'s')
        log(f'breakdown, api mixed document (traced run, wall '
            f'{wall * 1e3:.1f} ms): ' +
            ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms' for name
                      in ('turbo_parse', 'turbo_gate', 'turbo_commit',
                          'turbo_stage', 'turbo_dispatch', 'dispatch_grid',
                          'dispatch_seq', 'python_gc')))
        idle = device_line(wall, rows)

        saved = bytes(A.save(mixed))
        peer = api_cases.change(
            A, A.load(saved, 'ee' * 16),
            lambda r: (r['tags'].update({'peer': 1}),
                       r['todo'].append({'t': 'peer', 'done': True})))
        peer_saved = bytes(A.save(peer))

        def per_doc_script(n, only=None):
            # the second actors cycle through 128 (bench.py's d % 128): a
            # fleet's actor table holds 256
            out = []
            for i in range(n) if only is None else only:
                doc = A.load(saved, f'{i % 128:08x}' * 4)
                doc = api_cases.change(
                    A, doc, lambda r, i=i: r['cfg']['opts'].update(
                        {'hub': i}))
                out.append(A.merge(doc, A.load(peer_saved, 'ee' * 16)))
            return out
        sample = [k * API_HUB_DOCS // API_SAMPLES for k in range(API_SAMPLES)]
        host_docs = per_doc_script(0, sample)

        def template(i):
            # doc i's value: the host backend's doc 0 with its own edit
            # (held to the host backend's doc on every sampled doc)
            value = api_cases.reading(A, host_docs[0])
            value['cfg']['opts']['hub'] = i
            return value
        for i, doc in zip(sample, host_docs):
            if api_cases.reading(A, doc) != template(i):
                fail(f'api path, per-doc API: host doc {i} != the template')

        def hub_leg(device, only=None):
            fleet = DocFleet(doc_capacity=2 * API_HUB_DOCS, key_capacity=64,
                             device=device)
            A.set_default_backend(FleetBackend(fleet))
            try:
                t0 = time.perf_counter()
                docs = per_doc_script(API_HUB_DOCS, only)
                t1 = time.perf_counter()
                handles = [A.Frontend.get_backend_state(d) for d in docs]
                read = materialize_docs(handles)
                if device == DEVICE:
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                saves = {i: bytes(A.save(docs[i])) for i in
                         (sample if only is None else range(len(docs)))}
            finally:
                A.set_default_backend(A.backend)
            if fleet.metrics.promotions:
                fail('api path, per-doc API: a document left the fleet')
            return dict(docs=docs, read=read, saves=saves,
                        rows=grid_view(fleet, [handles[i] for i in saves],
                                       'api path, per-doc API'),
                        api_s=t1 - t0, read_s=t2 - t1)
        got = storage_leg('per-doc API', legs, lambda: hub_leg(DEVICE),
                          needs=('lww_merge',), path='api path')
        for i, (doc, read) in enumerate(zip(got['docs'], got['read'])):
            if api_cases.reading(A, doc) != template(i) or \
                    read != template(i):
                fail(f'api path, per-doc API: doc {i} (its value, or as '
                     f'read from the card) != the host backend\'s')
        with check.paused():
            cpu = hub_leg('cpu', sample)
        for k, i in enumerate(sample):
            if got['saves'][i] != bytes(A.save(host_docs[k])) or \
                    cpu['saves'][k] != got['saves'][i]:
                fail(f'api path, per-doc API: save() of doc {i} != the host '
                     f'backend\'s')
        if got['rows'] != cpu['rows']:
            fail('api path, per-doc API: a sampled grid row on the card != '
                 'a CPU fleet\'s')
        check.verify('per-doc API')
        log(f'api path, per-doc API: {API_HUB_DOCS} docs on one '
            f'FleetBackend (A.load of the mixed document, A.change by a '
            f'second actor, A.merge of a concurrent edit): API calls '
            f'{got["api_s"]:.3f} s, the read that flushes them '
            f'{got["read_s"]:.3f} s (wall {got["api_s"] + got["read_s"]:.3f}'
            f' s); every value and read from the card == the host '
            f'backend\'s, {len(sample)} sampled save() and grid rows == the '
            f'host backend\'s and a CPU fleet\'s')
    total = {}
    for launches in legs.values():
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    log(f'api path launches: {total}; kernel calls held to their plain '
        f'versions: {check.checked}')
    missing = [name for name, n in total.items()
               if n and not check.checked[name]]
    if missing:
        fail(f'api path: no call of {missing} held to its plain version')
    return total, dict(checked=check.checked, worst=check.worst), \
        dict(changes_per_s=rate, ops_per_change=ops_per_change,
             mixed_idle_share=idle, hub_api_s=got['api_s'],
             hub_read_s=got['read_s'])


# ---- the query engine -------------------------------------------------------

# BENCH_r10_query.json's at_10k_docs_10k_subs
QUERY_DOCS, QUERY_SUBS = 10_000, 10_000
QUERY_TICKS = 5          # timed ticks, after a warm one
QUIET_TICKS = 7          # timed all-quiet ticks, after a warm one


def decode_hash(buf):
    """The hash of one encoded change."""
    from automerge_tpu_torch.columnar import decode_change_meta
    return decode_change_meta(buf, True)['hash']


class CompareSpy:
    """While on, keeps the inputs, the device and the answer of each
    `hashindex.frontier_compare` call (the subscription hub looks it up
    at call time)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from automerge_tpu_torch.fleet import hashindex
        self._real = hashindex.frontier_compare

        def call(*args, device=None):
            out = self._real(*args, device=device)
            self.calls.append(([a.copy() for a in args], device, out))
            return out
        hashindex.frontier_compare = call
        return self

    def __exit__(self, *exc):
        from automerge_tpu_torch.fleet import hashindex
        hashindex.frontier_compare = self._real


def query_path():
    """The query engine on the card (see the module docstring): the
    10,000-doc history, the batched time-travel read, the 10,000-
    subscriber tick and the all-quiet tick. Returns the launches summed
    over the legs, the calls held to the plain versions and the
    numbers."""
    import numpy as np
    import torch
    from automerge_tpu_torch import api_cases
    from automerge_tpu_torch.fleet import hashindex
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, free_docs, init_docs,
        materialize_docs)
    from automerge_tpu_torch.query import SubscriptionHub, materialize_at_docs
    legs, nums = {}, {}
    batches, heads, mid = api_cases.query_history(QUERY_DOCS)
    want = [{f'k{c}': d * 100 + c for c in range(4)}
            for d in range(QUERY_DOCS)]
    with PathCheck('query path') as check:
        def setup():
            fleet = DocFleet(device=DEVICE)
            handles = init_docs(QUERY_DOCS, fleet)
            for per_doc in batches:
                handles, _ = apply_changes_docs(handles, per_doc,
                                                mirror=False)
            return fleet, handles
        fleet, handles = storage_leg('setup', legs, setup,
                                     needs=('lww_merge',), path='query path')
        check.verify('setup')

        def read_mid():
            d0 = fleet.metrics.dispatches
            outs = materialize_at_docs(handles, mid, fleet=fleet)
            torch.cuda.synchronize()
            return outs, fleet.metrics.dispatches - d0

        def mat_leg():
            outs, dispatches = read_mid()
            if dispatches != 1:
                fail(f'query path, materialize_at: {dispatches} dispatches '
                     f'for one batched read (want 1)')
            if materialize_docs(outs) != want:
                fail('query path, materialize_at: a doc read from the card '
                     '!= k0..k3 = d * 100 + c')
            rows = grid_view(fleet, outs, 'query path, materialize_at')
            for d, row in enumerate(rows):
                if {k: v[2] for k, v in row.items()} != want[d] or \
                        any(v[0] != int(k[1:]) + 1 for k, v in row.items()):
                    fail(f'query path, materialize_at: grid row of doc {d} '
                         f'!= its first four changes')
            free_docs(outs)
            return dispatches
        dispatches = storage_leg('materialize_at', legs, mat_leg,
                                 needs=('lww_merge',), path='query path')
        check.verify('materialize_at')
        times = []
        with check.paused():
            for _ in range(3):
                t0 = time.perf_counter()
                outs, _d = read_mid()
                times.append(time.perf_counter() - t0)
                free_docs(outs)
            wall, phases, rows = traced(lambda: free_docs(read_mid()[0]))
        nums['materialize_docs_per_s'] = QUERY_DOCS / statistics.median(times)
        nums['materialize_dispatches'] = dispatches
        log(f'query path, materialize_at_docs of {QUERY_DOCS} docs at the '
            f'mid frontier: {nums["materialize_docs_per_s"]:.1f} docs/s '
            f'(median of 3 after a warm rep; '
            f'{[round(QUERY_DOCS / t) for t in times]}), {dispatches} '
            f'dispatch per batched read; every doc and grid row read from '
            f'the card == k0..k3 = d * 100 + c')
        log(f'breakdown, query materialize_at (traced run, wall '
            f'{wall * 1e3:.1f} ms): ' +
            ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms' for name
                      in ('materialize_at', 'turbo_parse', 'turbo_gate',
                          'turbo_dispatch', 'dispatch_grid', 'python_gc')))
        nums['materialize_idle_share'] = device_line(wall, rows)

        hub = SubscriptionHub()
        for d in range(QUERY_DOCS):
            hub.register(d, handles[d])
        classes = [[], None, 'head']
        for s in range(QUERY_SUBS):
            d = s % QUERY_DOCS
            cls = classes[(s // QUERY_DOCS) % 3]
            hub.subscribe(d, cursor=mid[d] if cls is None else
                          (heads[d] if cls == 'head' else []))

        def advance(rep):
            nonlocal handles
            per_doc = []
            for d in range(QUERY_DOCS):
                buf = api_cases.set_change(d, 7 + rep, heads[d], 'hot', rep)
                heads[d] = [decode_hash(buf)]
                per_doc.append([buf])
            handles, _ = apply_changes_docs(handles, per_doc, mirror=False)
            for d in range(QUERY_DOCS):
                hub.update_source(d, handles[d])

        def tick_leg():
            ticks, stats = [], []
            for rep in range(QUERY_TICKS + 1):
                advance(rep)
                c0, r0 = hub.stats['diffs_computed'], hub.stats['diffs_reused']
                d0, n0 = fleet.metrics.dispatches, hashindex.dispatch_count()
                t0 = time.perf_counter()
                events = hub.tick()
                sec = time.perf_counter() - t0
                # the batched quiet proof runs first on every tick: one
                # frontier compare, and no merge
                if fleet.metrics.dispatches != d0 or \
                        hashindex.dispatch_count() - n0 != 1:
                    fail('query path, tick: a subscription tick dispatched a '
                         'merge, or not exactly 1 frontier compare')
                if len(events) != QUERY_SUBS:
                    fail(f'query path, tick: {len(events)} events for '
                         f'{QUERY_SUBS} subscribers')
                if rep:
                    ticks.append(sec)
                    stats.append((hub.stats['diffs_computed'] - c0,
                                  hub.stats['diffs_reused'] - r0))
            return ticks, stats
        ticks, stats = storage_leg('subscription tick', legs, tick_leg,
                                   needs=('lww_merge',), path='query path')
        check.verify('subscription tick')
        if materialize_docs(handles) != [dict(w, k4=d * 100 + 4,
                                              k5=d * 100 + 5,
                                              hot=QUERY_TICKS)
                                         for d, w in enumerate(want)]:
            fail('query path, tick: a doc read from the card != its changes')
        computed, reused = map(sum, zip(*stats))
        nums.update(tick_p50_ms=float(np.median(ticks)) * 1e3,
                    tick_p99_ms=float(np.percentile(ticks, 99)) * 1e3,
                    tick_dispatches=0, tick_compares=1,
                    diff_reuse=reused / max(computed + reused, 1))
        with check.paused():
            wall, phases, rows = traced(lambda: (advance(QUERY_TICKS + 1),
                                                 hub.tick()))
        log(f'query path, subscription tick ({QUERY_SUBS} subscribers over '
            f'{QUERY_DOCS} docs, 3 cursor classes, one new change per doc '
            f'per tick): p50 {nums["tick_p50_ms"]:.1f} ms, p99 '
            f'{nums["tick_p99_ms"]:.1f} ms over {QUERY_TICKS} ticks, 0 '
            f'merge dispatches and 1 frontier compare (the quiet proof, '
            f'not all quiet) per tick, diff reuse '
            f'{nums["diff_reuse"]:.3f}; every doc read from the card == its '
            f'changes')
        log(f'breakdown, query tick with its batch (traced run, wall '
            f'{wall * 1e3:.1f} ms): ' +
            ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms' for name
                      in ('subscription_tick', 'turbo_dispatch',
                          'dispatch_grid', 'python_gc')))
        nums['tick_idle_share'] = device_line(wall, rows)
        del hub, handles, fleet
        gc.collect()

        def quiet_setup():
            qfleet = DocFleet(device=DEVICE)
            qhandles = init_docs(QUERY_DOCS, qfleet)
            qhandles, _ = apply_changes_docs(qhandles, batches[0],
                                             mirror=False)
            return qfleet, qhandles
        qfleet, qhandles = storage_leg('quiet setup', legs, quiet_setup,
                                       needs=('lww_merge',),
                                       path='query path')
        check.verify('quiet setup')
        qhub = SubscriptionHub()
        for d in range(QUERY_DOCS):
            qhub.register(d, qhandles[d])
        first = [[decode_hash(batches[0][d][0])] for d in range(QUERY_DOCS)]
        for s in range(QUERY_SUBS):
            qhub.subscribe(s % QUERY_DOCS, cursor=first[s % QUERY_DOCS])
        qhub.tick()                          # warm: builds the scan plan
        kernel_launches(reset=True)
        quiet_times = []
        with CompareSpy() as spy:
            for _ in range(QUIET_TICKS):
                n0, d0 = hashindex.dispatch_count(), qfleet.metrics.dispatches
                q0 = qhub.stats['quiet']
                t0 = time.perf_counter()
                events = qhub.tick()
                quiet_times.append(time.perf_counter() - t0)
                if events or (hashindex.dispatch_count() - n0,
                              qfleet.metrics.dispatches - d0) != (1, 0):
                    fail('query path, quiet tick: not exactly 1 compare and '
                         '0 merge dispatches, or not all quiet')
                if qhub.stats['quiet'] - q0 != QUERY_SUBS:
                    fail('query path, quiet tick: not every class proven '
                         'quiet')
        legs['quiet tick'] = kernel_launches()
        args, device, answer = spy.calls[-1]
        if len(spy.calls) != QUIET_TICKS or \
                torch.device(device).type != torch.device(DEVICE).type or \
                not np.array_equal(answer, hashindex.frontier_compare(
                    *args, device='cpu')) or not answer.all():
            fail('query path, quiet tick: the compare did not run on the '
                 'card, or its answer != the CPU\'s')
        k = len(args[1])
        k_pad = 1 << (k - 1).bit_length()
        dev = torch.device(DEVICE)
        cols = (torch.zeros((k_pad, 32), dtype=torch.uint8, device=dev),
                torch.ones(k_pad, dtype=torch.int32, device=dev))
        cols = cols + cols
        compare_ms = time_ms(lambda: hashindex._compare(*cols))
        bound = bound_of(k_pad * (32 * 2 + 4 * 2 + 1), k_pad * 40)
        wall, phases, rows = traced(qhub.tick)
        nums.update(quiet_tick_p50_ms=statistics.median(quiet_times) * 1e3,
                    quiet_compares=1, compare_ms=compare_ms,
                    compare_rows=k_pad, **{f'compare_{key}': v
                                            for key, v in bound.items()})
        log(f'query path, all-quiet tick ({QUERY_SUBS} subscribers at head '
            f'over {QUERY_DOCS} docs, bench.py _sec_frontier (b)): p50 '
            f'{nums["quiet_tick_p50_ms"]:.3f} ms over {QUIET_TICKS} ticks, '
            f'each exactly 1 frontier_compare dispatch on the card and 0 '
            f'merge dispatches, every class proven quiet, the answer == the '
            f'CPU\'s; the compare at the tick\'s shape ({k} classes padded '
            f'to {k_pad}) {compare_ms:.4f} ms, bound '
            f'{bound["bound_ms"]:.4f} ms ({bound["bound_by"]})')
        nums['quiet_idle_share'] = device_line(wall, rows)
    total = {}
    for launches in legs.values():
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    log(f'query path launches: {total}; kernel calls held to their plain '
        f'versions: {check.checked}')
    missing = [name for name, n in total.items()
               if n and not check.checked[name]]
    if missing:
        fail(f'query path: no call of {missing} held to its plain version')
    return total, dict(checked=check.checked, worst=check.worst), nums


# ---- the service path ------------------------------------------------------

SERVICE_SESSIONS, SERVICE_TENANTS, SERVICE_REQUESTS = 10_000, 256, 20_000
SERVICE_SYNC_FRACTION = 0.25     # bench.py _sec_service: run_standard_legs
SERVICE_NEEDS = ('lww_merge', 'bloom_build', 'bloom_probe',
                 'hashindex_insert', 'hashindex_probe')
RENDER_REPS = 5                  # render_prometheus: the median of 5
FAULT_DOCS, FAULT_POISONED = 2_000, (1, 1_000)   # bench.py _sec_faults
FAULT_REPS = 3                   # quarantine and clean rounds, in turns


@contextlib.contextmanager
def device_trace(out):
    """Trace the block's device activity only (torch.profiler's CUDA
    activity: the kernel and copy records, no host-op recording, so the
    block runs at close to its untraced speed). Sets out['wall'] (s) and
    out['rows'] (the device rows as `traced` returns them), summed from
    the profiler's raw records: `key_averages()` over a service leg's
    hundreds of thousands of records added 23-34 s of Python to each
    leg on the card's host."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        out['wall'] = time.perf_counter() - t0
    per = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ns, count = per.get(evt.name(), (0, 0))
        per[evt.name()] = (ns + evt.duration_ns(), count + 1)
    out['rows'] = sorted(((ns / 1e6, name, count)
                          for name, (ns, count) in per.items() if ns),
                         reverse=True)


def fault_workload(count):
    """bench.py _sec_faults' round: one single-set change a doc, actors
    cycling under the fleet's 256-actor cap."""
    from automerge_tpu_torch.columnar import encode_change
    return [[encode_change({
        'actor': f'{d % 128:04x}' * 4, 'seq': 1, 'startOp': 1,
        'time': 0, 'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': 'k',
                 'value': d, 'datatype': 'int', 'pred': []}]})]
        for d in range(count)]


def service_legs(check, legs, nums):
    """The three standing legs of the reference's bench (bench.py
    _sec_service: clean, chaos, 2x overload) through
    service_cases.run_standard_legs on the card, each with the launch
    counts set to 0 just before it and read just after, its kernel calls
    held to the plain versions after it, and its audited edit docs read
    from the card beside a CPU fleet fed exactly the committed changes.
    The kernel ledger is on for the clean leg. Returns the reports."""
    from automerge_tpu_torch import service_cases
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, init_docs, materialize_docs)
    from automerge_tpu_torch.observability import perf, render_prometheus
    current = {}

    @contextlib.contextmanager
    def around(name):
        current['leg'] = name
        kernel_launches(reset=True)
        if name == 'clean':
            perf.reset_ledger()
            perf.enable_ledger()
        t0 = time.perf_counter()
        trace = {}
        try:
            with device_trace(trace):
                yield
        finally:
            perf.disable_ledger()
        legs[name] = launches = kernel_launches()
        current[name] = device_line(trace['wall'], trace['rows'])
        missing = [k for k in SERVICE_NEEDS if launches[k] < 1]
        if missing:
            fail(f'service path, {name}: never launched {missing}')
        log(f'service path, {name}: launches {launches} '
            f'({time.perf_counter() - t0:.1f} s)')
        if name == 'clean':
            current['ledger'] = perf.kernel_report()
        check.verify(name)

    def audit(service, handles, committed):
        tag = f'service path, {current["leg"]}'
        if not handles:
            fail(f'{tag}: no edit doc to audit')
        # the CPU fleet is no part of the leg: keep it out of the ledger
        ledger_on = perf.ledger_on()
        perf.disable_ledger()
        try:
            cpu = DocFleet(device='cpu')
            control, _ = apply_changes_docs(init_docs(len(handles), cpu),
                                            committed, mirror=False)
        finally:
            if ledger_on:
                perf.enable_ledger()
        if materialize_docs(handles) != materialize_docs(control):
            fail(f'{tag}: an edit doc read from the card != a CPU fleet '
                 f'fed exactly its committed changes')
        fleet = handles[0]['state'].fleet
        if grid_view(fleet, handles, tag) != grid_view(cpu, control, tag):
            fail(f'{tag}: an edit doc\'s grid row on the card != the CPU '
                 f'fleet\'s')
        out = {'docs': len(handles)}
        if current['leg'] == 'clean':
            times = []
            for _ in range(RENDER_REPS):
                t0 = time.perf_counter()
                page = render_prometheus(slo=service.slo)
                times.append(time.perf_counter() - t0)
            out.update(render_ms=statistics.median(times) * 1e3,
                       render_lines=page.count('\n'))
        return out

    reports = service_cases.run_standard_legs(
        sessions=SERVICE_SESSIONS, tenants=SERVICE_TENANTS,
        requests=SERVICE_REQUESTS, seed=0,
        sync_fraction=SERVICE_SYNC_FRACTION, device=DEVICE, around=around,
        audit=audit)
    for report in reports:
        name = report['leg']
        conv = report['convergence']
        slo = report['slo_audit']
        bad = [key for key in report['rejections']
               if key.startswith('UNTYPED')]
        if report['untyped_escapes'] or bad:
            fail(f'service path, {name}: untyped escapes '
                 f'{report["untyped_escapes"]} {bad}')
        if conv['edit_mismatches'] or \
                conv['sync_converged'] != conv['sync_drained']:
            fail(f'service path, {name}: convergence {conv}')
        if not slo or 'mismatches' not in slo or slo['mismatches'] or \
                not slo['pairs_checked']:
            fail(f'service path, {name}: the SLO audit is not exact: {slo}')
        if name == 'overload' and not report['brownout_transitions']:
            fail('service path, overload: no brownout transition')
        if report['submitted'] < SERVICE_REQUESTS or \
                not report['completed_ok']:
            fail(f'service path, {name}: {report["submitted"]} submitted, '
                 f'{report["completed_ok"]} completed')
        nums[name] = {key: report[key] for key in (
            'completed_ok', 'submitted', 'p50_ms', 'p95_ms', 'p99_ms',
            'requests_per_s', 'rounds_per_s', 'elapsed_s', 'ticks',
            'rejections', 'brownout_transitions', 'chaos_corrupted',
            'disconnected', 'replayed')}
        nums[name].update(edit_docs_audited=conv['edit_docs_audited'],
                          sync_converged=conv['sync_converged'],
                          slo_pairs=slo['pairs_checked'],
                          card_docs_read=report['audit']['docs'],
                          idle_share=current[name])
        log(f'service path, {name}: {report["completed_ok"]}/'
            f'{report["submitted"]} ok at {SERVICE_SESSIONS} sessions / '
            f'{SERVICE_TENANTS} tenants, p50 {report["p50_ms"]} ms, p99 '
            f'{report["p99_ms"]} ms, {report["requests_per_s"]} req/s, '
            f'{report["rounds_per_s"]} rounds/s, rejections '
            f'{report["rejections"]}, brownout transitions '
            f'{report["brownout_transitions"]}, convergence {conv}, SLO '
            f'audit exact over {slo["pairs_checked"]} pairs; '
            f'{report["audit"]["docs"]} edit docs and grid rows read from '
            f'the card == a CPU fleet\'s; device idle share '
            f'{current[name]:.4f}')
    clean = reports[0]['audit']
    nums['render_ms'] = clean['render_ms']
    nums['render_lines'] = clean['render_lines']
    log(f'service path, render_prometheus of the clean leg\'s SLO registry '
        f'({clean["render_lines"]} lines): {clean["render_ms"]:.3f} ms '
        f'(median of {RENDER_REPS})')
    # the ledger of the clean leg (the ledger is off during its CPU
    # audit): every apply_op_batch* dispatch on the card is one lww_merge
    # launch
    ledger = current['ledger']
    applies = sum(row['dispatches'] for kind, row in ledger.items()
                  if kind.startswith('apply_op_batch'))
    merges = legs['clean']['lww_merge']
    if applies != merges:
        fail(f'service path, clean: the ledger counts {applies} '
             f'apply_op_batch* dispatches, lww_merge launched {merges} '
             f'times')
    nums['ledger'] = {kind: {'dispatches': row['dispatches'],
                             'seconds': row['seconds'],
                             'signatures': len(row['signatures'])}
                      for kind, row in ledger.items()}
    log(f'service path, clean leg kernel ledger (dispatches, host-blocking '
        f's, signatures): ' + '; '.join(
            f'{kind} {row["dispatches"]} {row["seconds"]:.4f} '
            f'{len(row["signatures"])}' for kind, row in sorted(
                ledger.items())) +
        f'; apply_op_batch* {applies} = lww_merge launches {merges}')
    log('service path, clean leg ledger report: ' + json.dumps(
        {kind: row for kind, row in sorted(ledger.items())}))
    return reports


def fault_leg(check, legs, nums):
    """bench.py _sec_faults on the card: one quarantine round over
    FAULT_DOCS docs with two poisoned, against a clean round of the
    same docs (in turns); exactly the poisoned docs quarantined, every
    other doc and grid row read from the card == a CPU fleet's; the
    health counters' deltas. Then one sync_until_quiet between two
    card-backed docs over LossyLinks that drop, duplicate and reorder."""
    from automerge_tpu_torch import observability
    from automerge_tpu_torch.fleet import backend as fleet_backend
    from automerge_tpu_torch.fleet.backend import DocFleet, init_docs
    from automerge_tpu_torch.fleet.faults import LossyLink, sync_until_quiet
    import torch

    def poisoned():
        per_doc = fault_workload(FAULT_DOCS)
        for bad in FAULT_POISONED:
            buf = bytearray(per_doc[bad][0])
            buf[10] ^= 0xFF
            per_doc[bad] = [bytes(buf)]
        return per_doc

    def quarantine_round():
        fleet = DocFleet(device=DEVICE)
        handles = init_docs(FAULT_DOCS, fleet)
        per_doc = poisoned()
        t0 = time.perf_counter()
        out, _patches, errors = fleet_backend.apply_changes_docs(
            handles, per_doc, mirror=False, on_error='quarantine')
        torch.cuda.synchronize()
        return time.perf_counter() - t0, fleet, out, errors

    def clean_round():
        fleet = DocFleet(device=DEVICE)
        handles = init_docs(FAULT_DOCS, fleet)
        per_doc = fault_workload(FAULT_DOCS)
        t0 = time.perf_counter()
        fleet_backend.apply_changes_docs(handles, per_doc, mirror=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run():
        clean_round()                       # warm: the dispatch shapes
        h0 = observability.health_counts()
        sec, fleet, out, errors = quarantine_round()
        delta = {k: v for k, v in observability.health_delta(h0).items()
                 if v}
        bad = [d for d, e in enumerate(errors) if e is not None]
        if bad != list(FAULT_POISONED):
            fail(f'service path, faults: quarantined {bad}, poisoned '
                 f'{list(FAULT_POISONED)}')
        keep = [d for d in range(FAULT_DOCS) if d not in FAULT_POISONED]
        cpu = DocFleet(device='cpu')
        ref = init_docs(FAULT_DOCS, cpu)
        ref, _patches, ref_errors = fleet_backend.apply_changes_docs(
            ref, poisoned(), mirror=False, on_error='quarantine')
        if [d for d, e in enumerate(ref_errors) if e is not None] != bad:
            fail('service path, faults: the CPU fleet quarantined other '
                 'docs')
        got = [out[d] for d in keep]
        want = [ref[d] for d in keep]
        tag = 'service path, faults'
        if fleet_backend.materialize_docs(got) != \
                fleet_backend.materialize_docs(want) or \
                grid_view(fleet, got, tag) != grid_view(cpu, want, tag):
            fail(f'{tag}: a surviving doc read from the card != the CPU '
                 f'fleet\'s')
        quarantine, clean = [sec], []
        with check.paused():
            for _ in range(FAULT_REPS):
                clean.append(clean_round())
                quarantine.append(quarantine_round()[0])
        q, c = statistics.median(quarantine), statistics.median(clean)
        nums['faults'] = dict(
            quarantined=bad, survivors_read=len(keep),
            quarantine_docs_per_s=FAULT_DOCS / q,
            clean_docs_per_s=FAULT_DOCS / c, quarantine_cost=q / c,
            health_delta=delta)
        log(f'service path, faults: a {FAULT_DOCS}-doc round with docs '
            f'{bad} poisoned quarantined exactly them; the other '
            f'{len(keep)} docs and grid rows read from the card == a CPU '
            f'fleet\'s; {FAULT_DOCS / q:.1f} docs/s quarantined vs '
            f'{FAULT_DOCS / c:.1f} clean ({q / c:.3f}x the clean round\'s '
            f'time; medians of {FAULT_REPS + 1} and {FAULT_REPS}, in '
            f'turns); health counters this round: {delta}')

        # two card-backed docs, each on its own fleet, diverge (one holds
        # the fault round's doc 0 and 8 changes of one actor, the other 8
        # of another), then sync over lossy links
        from automerge_tpu_torch.columnar import encode_change
        pair = []
        for actor, first in (('aa', fault_workload(1)[0]), ('bb', [])):
            (handle,) = init_docs(1, DocFleet(device=DEVICE))
            (handle,), _ = fleet_backend.apply_changes_docs([handle], [
                first + [encode_change({
                    'actor': actor * 16, 'seq': s + 1, 'startOp': s + 1,
                    'time': 0, 'message': '', 'deps': [],
                    'ops': [{'action': 'set', 'obj': '_root',
                             'key': f'{actor}{s}', 'value': s,
                             'datatype': 'int', 'pred': []}]})
                    for s in range(8)]], mirror=False)
            pair.append(handle)
        fault_p = dict(p_drop=0.2, p_dup=0.1, p_reorder=0.1)
        na, nb, rounds, stats = sync_until_quiet(
            pair[0], pair[1], fleet_backend, fleet_backend,
            LossyLink(seed=21, budget=12, **fault_p),
            LossyLink(seed=22, budget=12, **fault_p))
        docs = fleet_backend.materialize_docs([na, nb])
        if fleet_backend.get_heads(na) != fleet_backend.get_heads(nb) or \
                docs[0] != docs[1] or len(docs[0]) != 17:
            fail('service path, lossy sync: the two card-backed docs did '
                 'not converge')
        if any(not h['state'].is_fleet for h in (na, nb)):
            fail('service path, lossy sync: a doc left its fleet')
        nums['lossy_sync'] = dict(rounds=rounds, stats=stats)
        log(f'service path, lossy sync: two card-backed docs converged over '
            f'LossyLinks (drop 0.2, dup 0.1, reorder 0.1) in {rounds} '
            f'rounds, both read from the card == each other (17 keys); '
            f'link stats {stats}')
    storage_leg('faults', legs, run, needs=('lww_merge',),
                path='service path')
    check.verify('faults')


def service_path():
    """The multi-tenant service on the card (see the module docstring).
    Returns the launches summed over its legs, the calls held to the
    plain versions and the numbers."""
    legs, nums = {}, {}
    with PathCheck('service path') as check:
        service_legs(check, legs, nums)
        gc.collect()
        fault_leg(check, legs, nums)
    total = {}
    for launches in legs.values():
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    log(f'service path launches: {total}; kernel calls held to their plain '
        f'versions: {check.checked}')
    missing = [name for name, n in total.items()
               if n and not check.checked[name]]
    if missing:
        fail(f'service path: no call of {missing} held to its plain version')
    return total, dict(checked=check.checked, worst=check.worst), nums


# ---- the shard cluster and the control plane -------------------------------

# bench.py _sec_shards: the warm-up, the paced clean sweep at its own shape
# and the kill-one-of-four leg (its tenants: max(8, 96 // 8))
SHARD_WARMUP = dict(n_shards=2, tenants=8, requests=100, arrivals_per_tick=8,
                    service_kwargs={'batch_limit': 8}, seed=0)
SHARD_SWEEP = (1, 2, 4)
SHARD_CLEAN = dict(tenants=96, requests=1_200, arrivals_per_tick=48, seed=0,
                   tick_dt=0.03, subscribe_fraction=0.1, sync_fraction=0.05,
                   service_kwargs={'batch_limit': 8}, pump_threads=2,
                   repl_every=4, pace=True)
SHARD_KILL = dict(n_shards=4, tenants=12, requests=400, arrivals_per_tick=8,
                  chaos=True, seed=5, kills=((12, 1, 40),), mttr_bound=12)
# one shard killed and revived 3x (tests/test_service_chaos.py's schedule)
# at 64x its tenants: the card's memory before the first kill and after
# the last revive says whether a dead shard's fleet is freed
SHARD_CYCLES = dict(n_shards=3, tenants=576, requests=1_728,
                    arrivals_per_tick=48, chaos=True, seed=7,
                    kills=((10, 0, 30), (60, 0, 80), (110, 0, 130)))
# a deployment's size on one card: ~2,048 docs a shard fleet, counting
# homes and replicas; SCALE_AUDITED tenants (seeded) read from the card
SHARD_SCALE = dict(n_shards=4, tenants=4_096, requests=8_192,
                   arrivals_per_tick=256, chaos=True, seed=0,
                   kills=((20, 1, 60),))
SCALE_AUDITED = 512
# tests/test_control.py's acceptance episode, active and then shadow
CONTROL_KILL = dict(n_shards=4, tenants=16, requests=600, chaos=True, seed=2,
                    kills=((25, 0, 50),), settle_bound=300)
# bench.py _sec_control's lockstep pair
CONTROL_TICKS, CONTROL_TENANTS, CONTROL_SUBMITS = 400, 8, 20
CONTROL_WINDOW = 10
CONTROL_PASSES = 3       # bench.py takes max(REPS, 9): cut for the time limit
SHARD_NEEDS = ('lww_merge',)         # every LWW shard leg
# the path: every apply, replication receive and migration revive
# (lww_merge; register_scan in exact mode), every replication round's
# generate and receive (the Bloom pair), the hash index once a shard
# fleet holds more keys than its host mode (the deployment-size leg)
SHARD_PATH_NEEDS = ('lww_merge', 'register_scan', 'bloom_build',
                    'bloom_probe', 'hashindex_insert', 'hashindex_probe')


def register_view(fleet, handles, tag):
    """Each doc's registers as an exact fleet on the card holds them, in
    terms that do not depend on the fleet's slot, key, actor or lane
    numbering: {key: sorted (op id, killed, value, counter sum) of its
    live lanes}; 'inexact' for a doc whose inexact flag the register
    scan raised (its history left the registers' exact shape: the host
    mirror serves it). Fails unless each doc is fleet-resident."""
    import numpy as np
    from automerge_tpu_torch.fleet import registers
    reg, killed, value, counter, inexact = \
        registers.register_state_to_numpy(fleet.reg_state)
    keys = fleet.keys.keys
    out = []
    for h in handles:
        st = h['state']
        slot = st._impl.slot
        if not st.is_fleet or st.fleet is not fleet:
            fail(f'{tag}: a doc is not served from the registers (slot '
                 f'{slot})')
        if inexact[slot]:
            out.append('inexact')
            continue
        cells = {}
        for k, lane in zip(*np.nonzero(reg[slot, :len(keys)])):
            v = int(value[slot, k, lane])
            cells.setdefault(keys[k], []).append((
                _op_name(fleet, reg[slot, k, lane]),
                bool(killed[slot, k, lane]),
                repr(fleet.value_table[-v - 2]) if v <= -2 else v,
                int(counter[slot, k, lane])))
        out.append({key: sorted(lanes) for key, lanes in cells.items()})
    return out


def card_view(handles, tag):
    """Each doc's device state read from its own fleet on the card
    (`grid_view` for an LWW fleet, `register_view` for an exact one), in
    the order of `handles`, whose docs may live on several fleets."""
    groups = {}
    for i, h in enumerate(handles):
        fleet = h['state'].fleet
        groups.setdefault(id(fleet), (fleet, []))[1].append(i)
    out = [None] * len(handles)
    for fleet, idx in groups.values():
        hs = [handles[i] for i in idx]
        view = register_view if fleet.exact_device else grid_view
        for i, cells in zip(idx, view(fleet, hs, tag)):
            out[i] = cells
    return out


def shard_audit(tag, sample=None):
    """The `audit=` hook of a shard leg: after the leg's final audit, each
    audited tenant's (every tenant's, or `sample` seeded ones) home doc
    and replica doc are read from their shards' fleets on the card
    (materialize_docs and `card_view`) and must equal each other and a
    CPU fleet fed that tenant's acked changes, plus any change its home
    holds whose ticket never acked (the contract is acked => present;
    the hook's result, the report's `audit`, counts them in
    'unacked_committed'). A one-shard cluster has no replicas: its homes
    alone are read."""
    import random
    from automerge_tpu_torch import backend as host_backend
    from automerge_tpu_torch.columnar import decode_change_meta
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, init_docs, materialize_docs)

    def meta(buf):
        return decode_change_meta(bytes(buf), True)

    def audit(router, acked):
        names = sorted(acked)
        if sample is not None:
            names = sorted(random.Random(0).sample(names, sample))
        homes, reps, fed, extra = [], [], [], 0
        paired = len(router.shards) > 1
        for name in names:
            rec = router.tenant_record(name)
            if rec.session is None or \
                    paired and rec.replica_handle is None:
                fail(f'{tag}: tenant {name} ends with no home or no replica')
            homes.append(rec.session.handle)
            if paired:
                reps.append(rec.replica_handle)
            mine = {meta(b)['hash']: bytes(b) for b in acked[name]}
            for buf in host_backend.get_all_changes(rec.session.handle):
                h = meta(buf)['hash']
                if h not in mine:
                    mine[h] = bytes(buf)
                    extra += 1
            fed.append(sorted(mine.values(), key=lambda b: meta(b)['seq']))
        cpu = DocFleet(exact_device=homes[0]['state'].fleet.exact_device,
                       device='cpu')
        control, _ = apply_changes_docs(init_docs(len(names), cpu), fed,
                                        mirror=False)
        want = materialize_docs(control)
        cells = card_view(control, tag)
        for docs in (homes, reps) if paired else (homes,):
            if materialize_docs(docs) != want:
                fail(f'{tag}: a home or replica doc read from the card != a '
                     f'CPU fleet fed its acked changes')
            if card_view(docs, tag) != cells:
                fail(f'{tag}: a home or replica doc\'s device rows on the '
                     f'card != the CPU fleet\'s')
        return dict(tenants_read=len(names), replicas_read=len(reps),
                    unacked_committed=extra,
                    changes=sum(len(f) for f in fed),
                    inexact=cells.count('inexact'))
    return audit


def shard_leg(check, legs, nums, name, sample=None, needs=SHARD_NEEDS,
              **kw):
    """One shard_cases.run_shard_leg on the card, with the launch counts
    set to 0 just before it and read just after (each kernel of `needs`
    must launch), its device activity traced (the idle share), its first
    64 calls of each kernel held to the plain version after it, its
    audits exact and its tenants read from the card (`shard_audit`).
    Returns the report."""
    from automerge_tpu_torch import shard_cases
    kernel_launches(reset=True)
    t0 = time.perf_counter()
    out = {}
    with device_trace(out):
        report = shard_cases.run_shard_leg(
            name, device=DEVICE,
            audit=shard_audit(f'shard path, {name}', sample), **kw)
    audit = report['audit']
    legs[name] = launches = kernel_launches()
    missing = [k for k in needs if launches[k] < 1]
    if missing:
        fail(f'shard path, {name}: never launched {missing}')
    final = report['final_audit']
    bad = [a for a in report['audits']
           if a['acked_lost'] or a['replica_mismatches']]
    if not report['ok'] or bad or final['acked_lost'] or \
            final['replica_mismatches'] or report['untyped_escapes'] or \
            not report['completed_ok']:
        fail(f'shard path, {name}: the leg is not ok: ' + json.dumps({
            k: report.get(k) for k in ('ok', 'untyped_escapes', 'drained',
                                       'completed_ok', 'mttr_ticks',
                                       'audits', 'control')}))
    idle = device_line(out['wall'], out['rows'])
    check.verify(name)
    nums[name] = dict(
        {k: report[k] for k in (
            'shards', 'tenants', 'submitted', 'completed_ok',
            'requests_per_s', 'elapsed_s', 'ticks', 'ticks_slipped',
            'ticks_slipped_per_shard', 'rejections', 'kills', 'failovers',
            'mttr_ticks', 'scrub_mismatches', 'shard_health_delta')},
        acked_lost=final['acked_lost'],
        replica_mismatches=final['replica_mismatches'],
        acked_changes_checked=final['acked_changes_checked'],
        replica_pairs=final['replica_pairs'], audits=len(report['audits']),
        card=audit, idle_share=idle, launches=launches,
        seconds=time.perf_counter() - t0)
    if 'control' in report:
        nums[name]['control'] = report['control']
    log(f'shard path, {name}: {report["completed_ok"]}/{report["submitted"]}'
        f' ok over {report["shards"]} shards x {report["tenants"]} tenants in'
        f' {report["ticks"]} ticks, {report["requests_per_s"]} req/s, slipped '
        f'ticks {report["ticks_slipped"]} {report["ticks_slipped_per_shard"]}'
        f', kills {report["kills"]}, failovers {report["failovers"]}, MTTR '
        f'{report["mttr_ticks"]} ticks, acked_lost {final["acked_lost"]}, '
        f'replica_mismatches {final["replica_mismatches"]} over '
        f'{len(report["audits"])} audits ({final["acked_changes_checked"]} '
        f'acked changes, {final["replica_pairs"]} pairs); '
        f'{audit["tenants_read"]} tenants\' home docs and '
        f'{audit["replicas_read"]} replica docs, and their device rows, read '
        f'from the card == each other == a CPU fleet fed their '
        f'{audit["changes"]} changes ({audit["unacked_committed"]} of them '
        f'committed but never acked; {audit["inexact"]} docs inexact on '
        f'both); launches {launches}; idle share '
        f'{idle:.4f}; '
        f'{time.perf_counter() - t0:.1f} s')
    return report


@contextlib.contextmanager
def memory_around_kills(out):
    """While entered, records torch.cuda.memory_allocated() just before
    each ShardRouter.kill_shard and just after each revive_shard (after a
    gc.collect()), and keeps a weak reference to each killed shard's
    fleet; `out` gets the records and how many of those fleets are still
    alive at the end (after a gc.collect())."""
    import weakref
    import torch
    from automerge_tpu_torch.shard import ShardRouter
    real_kill, real_revive = ShardRouter.kill_shard, ShardRouter.revive_shard
    marks, dead = [], []

    def kill(self, shard_id):
        gc.collect()
        torch.cuda.synchronize()
        marks.append(('kill', self.ticks, torch.cuda.memory_allocated()))
        dead.append(weakref.ref(self.shards[shard_id].fleet))
        real_kill(self, shard_id)

    def revive(self, shard_id):
        real_revive(self, shard_id)
        gc.collect()
        torch.cuda.synchronize()
        marks.append(('revive', self.ticks, torch.cuda.memory_allocated()))
    ShardRouter.kill_shard, ShardRouter.revive_shard = kill, revive
    try:
        yield
    finally:
        ShardRouter.kill_shard, ShardRouter.revive_shard = \
            real_kill, real_revive
    gc.collect()
    out.update(marks=marks, dead_fleets_alive=sum(
        ref() is not None for ref in dead), dead_fleets=len(dead))


def control_kill_legs(check, legs, nums):
    """tests/test_control.py's acceptance episode on the card, under an
    active controller and then a shadow one: every shard leg check, and
    fixed_point, <= 2 reversals per policy and the settle bound; the
    decisions per policy, and whether the shadow run's decision sequence
    (tick, policy, action, target, direction) equals the active run's."""
    from automerge_tpu_torch.control import Controller
    kept = []
    real = Controller.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        kept.append(self)
    logs = {}
    for mode in ('active', 'shadow'):
        Controller.__init__ = init
        try:
            report = shard_leg(check, legs, nums, f'control_kill_{mode}',
                               control=mode, **CONTROL_KILL)
        finally:
            Controller.__init__ = real
        ctl = report['control']
        if not ctl['fixed_point'] or \
                any(n > 2 for n in ctl['reversals'].values()):
            fail(f'shard path, control_kill_{mode}: no fixed point or more '
                 f'than 2 reversals a policy: {ctl}')
        if mode == 'active' and (not ctl['decisions'].get('shard_balance')
                                 or ctl['settle_ticks'] is None or
                                 ctl['settle_ticks'] >
                                 CONTROL_KILL['settle_bound']):
            fail(f'shard path, control_kill_active: the heal lane did not '
                 f'settle the placement: {ctl}')
        logs[mode] = [(e['tick'], e['policy'], e['action'], e['target'],
                       e['direction'])
                      for e in kept.pop().decision_log()]
        log(f'shard path, control_kill_{mode}: decisions {ctl["decisions"]}'
            f', reversals {ctl["reversals"]}, settle_ticks '
            f'{ctl["settle_ticks"]}, fixed_point {ctl["fixed_point"]}, '
            f'decide_s_max {ctl["decide_s_max"]}')
    same = 0
    for a, s in zip(logs['active'], logs['shadow']):
        if a != s:
            break
        same += 1
    nums['control_kill_parity'] = dict(
        equal=logs['active'] == logs['shadow'], common_prefix=same,
        active=len(logs['active']), shadow=len(logs['shadow']))
    log(f'shard path, control_kill: the shadow run\'s decision sequence '
        f'equals the active run\'s: {logs["active"] == logs["shadow"]} (the '
        f'first {same} of {len(logs["active"])} active and '
        f'{len(logs["shadow"])} shadow decisions agree; an active rehome '
        f'moves the tenant, and the shadow leg keeps the loadgen\'s '
        f'rebalance after the revive)')


def control_overhead(legs, nums):
    """bench.py _sec_control on the card: a service under a shadow
    controller and a bare one, each on its own DocFleet on the card,
    driven through the same tick loop, each tick of each timed apart in
    alternating order (CONTROL_PASSES passes after a warm one, the
    collector off while timing); the overhead of the per-tick-index
    medians' sums; then one active episode's decide latencies and the
    shadow-vs-active parity of the decision sequences."""
    import numpy as np
    from automerge_tpu_torch.control import Controller
    from automerge_tpu_torch.errors import AutomergeError
    from automerge_tpu_torch.fleet.backend import DocFleet
    from automerge_tpu_torch.service import DocService
    kernel_launches(reset=True)
    t0 = time.perf_counter()

    def build(mode):
        ctrl = Controller(mode=mode, window=CONTROL_WINDOW) if mode else None
        svc = DocService(fleet=DocFleet(device=DEVICE), control=ctrl,
                         tenant_rate=2.0, tenant_burst=4.0)
        sessions = [svc.open_session(f'tenant{t}')
                    for t in range(CONTROL_TENANTS)]
        return ctrl, svc, sessions

    def run_tick(svc, sessions, now):
        for s in sessions:
            for _i in range(CONTROL_SUBMITS):
                try:
                    svc.submit(s, 'sync', None)
                except AutomergeError:
                    pass
        svc.pump(now)

    def lockstep(order_flip):
        ctrl, svc_on, ses_on = build('shadow')
        _c, svc_off, ses_off = build(None)
        off_ns, on_ns = np.empty(CONTROL_TICKS), np.empty(CONTROL_TICKS)
        now = 0.0
        gc.disable()
        try:
            for i in range(CONTROL_TICKS):
                first_on = (i + order_flip) % 2
                for leg in (first_on, 1 - first_on):
                    start = time.perf_counter_ns()
                    if leg:
                        run_tick(svc_on, ses_on, now)
                    else:
                        run_tick(svc_off, ses_off, now)
                    (on_ns if leg else off_ns)[i] = \
                        time.perf_counter_ns() - start
                now += 0.1
        finally:
            gc.enable()
        decisions = ctrl.decision_log()
        del ctrl, svc_on, ses_on, svc_off, ses_off
        gc.collect()
        return off_ns, on_ns, decisions

    off_mat, on_mat, pass_pcts = [], [], []
    shadow_log = None
    for p in range(CONTROL_PASSES + 1):
        off_ns, on_ns, shadow_log = lockstep(p % 2)
        if p == 0:
            continue                 # the first pass is a warm-up
        off_mat.append(off_ns)
        on_mat.append(on_ns)
        pass_pcts.append(float((on_ns.sum() - off_ns.sum()) / off_ns.sum())
                         * 100.0)
    off_total = float(np.median(np.array(off_mat), axis=0).sum()) / 1e9
    on_total = float(np.median(np.array(on_mat), axis=0).sum()) / 1e9
    overhead = (on_total - off_total) / off_total * 100.0
    ctrl, svc, sessions = build('active')
    now = 0.0
    for _ in range(CONTROL_TICKS):
        run_tick(svc, sessions, now)
        now += 0.1
    gauges = ctrl.gauges()
    active_log = ctrl.decision_log()
    del ctrl, svc, sessions
    gc.collect()

    def strip(entries):
        return [(e['tick'], e['policy'], e['action'], e['target'],
                 e['direction']) for e in entries]
    parity = strip(shadow_log) == strip(active_log)
    if not parity or not active_log:
        fail(f'shard path, control_overhead: the shadow decisions != the '
             f'active ones ({len(shadow_log)} vs {len(active_log)})')
    legs['control_overhead'] = launches = kernel_launches()
    reqs = CONTROL_TICKS * CONTROL_TENANTS * CONTROL_SUBMITS
    nums['control_overhead'] = dict(
        off_rate=reqs / off_total, on_rate=reqs / on_total,
        overhead_pct=overhead, pass_pcts=pass_pcts, passes=len(off_mat),
        decisions=len(active_log), windows=gauges['windows'],
        decide_us_last=gauges['decide_s_last'] * 1e6,
        decide_us_max=gauges['decide_s_max'] * 1e6, shadow_parity=parity,
        launches=launches, seconds=time.perf_counter() - t0)
    log(f'shard path, control_overhead: on {reqs / on_total:.1f} req/s vs '
        f'off {reqs / off_total:.1f} req/s over {CONTROL_TICKS} ticks x '
        f'{CONTROL_TENANTS} tenants x {CONTROL_SUBMITS} submits ('
        f'{overhead:+.2f} % overhead; per-tick medians over {len(off_mat)} '
        f'passes, passes {[round(p, 2) for p in pass_pcts]} %); decide '
        f'{gauges["decide_s_last"] * 1e6:.1f} us last, '
        f'{gauges["decide_s_max"] * 1e6:.1f} us max over '
        f'{gauges["windows"]} windows; {len(active_log)} decisions, shadow '
        f'== active: {parity}; launches {launches}; '
        f'{time.perf_counter() - t0:.1f} s')


def shard_path():
    """The shard cluster and the control plane on the card (see the
    module docstring). Returns the launches summed over its legs, the
    calls held to the plain versions and the numbers."""
    legs, nums = {}, {}
    with PathCheck('shard path') as check:
        shard_leg(check, legs, nums, 'shards_warmup', **SHARD_WARMUP)
        for n in SHARD_SWEEP:
            shard_leg(check, legs, nums, f'shards_clean_{n}', n_shards=n,
                      **SHARD_CLEAN)
        shard_leg(check, legs, nums, 'shards_kill_one_of_four', **SHARD_KILL)
        shard_leg(check, legs, nums, 'shards_kill_one_of_four_exact',
                  needs=('register_scan',), exact_device=True,
                  **SHARD_KILL)
        mem = {}
        with memory_around_kills(mem):
            shard_leg(check, legs, nums, 'shards_kill_revive_3x',
                      **SHARD_CYCLES)
        nums['shards_kill_revive_3x']['memory'] = mem
        log(f'shard path, shards_kill_revive_3x: torch.cuda.memory_allocated'
            f'() before the first kill {mem["marks"][0][2]} B, after the '
            f'last revive and gc.collect() {mem["marks"][-1][2]} B (every '
            f'mark: {mem["marks"]}); {mem["dead_fleets_alive"]} of '
            f'{mem["dead_fleets"]} dead shards\' fleets still alive')
        if mem['dead_fleets_alive']:
            fail('shard path, shards_kill_revive_3x: a dead shard\'s fleet '
                 'is still alive after its revive')
        gc.collect()
        shard_leg(check, legs, nums, 'shards_kill_scale',
                  sample=SCALE_AUDITED, **SHARD_SCALE)
        gc.collect()
        control_kill_legs(check, legs, nums)
        control_overhead(legs, nums)
        check.verify('control_overhead')
    sweep = {n: nums[f'shards_clean_{n}']['requests_per_s']
             for n in SHARD_SWEEP}
    nums['sweep'] = dict(req_s=sweep, monotonic=sweep[1] < sweep[2] <
                         sweep[4])
    log(f'shard path, clean paced sweep ({SHARD_CLEAN["tenants"]} tenants, '
        f'batch_limit 8, tick {SHARD_CLEAN["tick_dt"] * 1e3:.0f} ms, '
        f'repl_every 4, 2 pump threads): ' + ', '.join(
            f'{n} shards {r} req/s ({r / sweep[1]:.2f}x, '
            f'{nums[f"shards_clean_{n}"]["ticks_slipped"]} slipped)'
            for n, r in sweep.items()))
    total = {}
    for launches in legs.values():
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    log(f'shard path launches: {total}; kernel calls held to their plain '
        f'versions: {check.checked}')
    missing = [name for name in SHARD_PATH_NEEDS if not total[name]]
    if missing:
        fail(f'shard path: never launched {missing}')
    missing = [name for name, n in total.items()
               if n and not check.checked[name]]
    if missing:
        fail(f'shard path: no call of {missing} held to its plain version')
    return total, dict(checked=check.checked, worst=check.worst), nums


# ---- the sync plane's main path --------------------------------------------

LINKS, HUB_DOCS, DEPTH = 100_000, 4, 8
WARM_ROUNDS = 3
SAMPLE_LINKS = 512
REPLICAS = 10_000
SAMPLE_REPLIES = 64


def hub_chain(actor, n):
    """bench.py's fabric chain: n single-set changes by one actor."""
    from automerge_tpu_torch.columnar import decode_change_meta, encode_change
    bufs, deps = [], []
    for i in range(n):
        buf = encode_change({
            'actor': actor, 'seq': i + 1, 'startOp': i + 1, 'time': 0,
            'message': '', 'deps': deps,
            'ops': [{'action': 'set', 'obj': '_root', 'key': f'k{i % 5}',
                     'value': i, 'datatype': 'int', 'pred': []}]})
        deps = [decode_change_meta(buf, True)['hash']]
        bufs.append(buf)
    return bufs


def solicit(states):
    """Every peer asks for a full resend (empty filter), as bench.py's
    fabric sweep does: the worst-case steady state."""
    for s in states:
        s['theirHeads'] = []
        s['theirHave'] = [{'lastSync': [], 'bloom': b''}]
        s['theirNeed'] = []


class Recorder:
    """While on, keeps a copy of the inputs of the largest call each sync
    kernel wrapper gets (the table before the call, for the insert), so
    phase 4 can hold and time the kernels on the main path's own inputs.
    The wrappers still count their launches as before."""

    SIZE = {'bloom_build': lambda a: a[0].shape[0] * a[0].shape[1],
            'bloom_probe': lambda a: a[3].shape[0] * a[3].shape[1],
            'hashindex_insert': lambda a: a[2].shape[0],
            'hashindex_probe': lambda a: a[2].shape[0]}

    def __init__(self):
        self.saved = {}
        self._real = {}

    def __enter__(self):
        from automerge_tpu_torch.fleet import sync_kernels
        for name in self.SIZE:
            real = getattr(sync_kernels, name)
            self._real[name] = real
            setattr(sync_kernels, name, self._wrap(name, real))
        return self

    def __exit__(self, *exc):
        from automerge_tpu_torch.fleet import sync_kernels
        for name, real in self._real.items():
            setattr(sync_kernels, name, real)

    def _wrap(self, name, real):
        import torch

        def call(*args, **kwargs):
            size = self.SIZE[name](args)
            if size >= self.saved.get(name, (-1,))[0]:
                self.saved[name] = (size, [
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args], dict(kwargs))
            return real(*args, **kwargs)
        return call


def sync_path():
    """The hub, the receive leg and the replies (see the module
    docstring). Returns its numbers and the recorded kernel inputs."""
    import torch
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.columnar import decode_change_meta, encode_change
    from automerge_tpu_torch.fleet import (bloom, hashindex, merge_kernel,
                                           sync_driver, sync_kernels)
    from automerge_tpu_torch.fleet.backend import (DocFleet,
                                                   apply_changes_docs,
                                                   init_docs,
                                                   materialize_docs)
    rows = [hub_chain(f'{0xe0 + d:02x}' * 16, DEPTH) for d in range(HUB_DOCS)]
    hashes = [[decode_change_meta(b, True)['hash'] for b in row]
              for row in rows]
    fleet = DocFleet(device=DEVICE)
    hub = init_docs(HUB_DOCS, fleet)
    hub, _ = apply_changes_docs(hub, rows, mirror=False)
    fidx = fleet.frontier_index(device_min=1, capacity=2 * LINKS * DEPTH)
    links = [hub[i % HUB_DOCS] for i in range(LINKS)]
    states = [host.init_sync_state() for _ in range(LINKS)]
    generate = sync_driver.generate_sync_messages_docs
    out = {}
    merge_kernel.reset_launches()
    sync_kernels.reset_launches()
    rec = Recorder()
    with rec:
        solicit(states)
        t0 = time.perf_counter()
        states, cold = generate(links, states)
        torch.cuda.synchronize()
        out['cold_ms'] = (time.perf_counter() - t0) * 1e3
        if any(m is None for m in cold) or not all(
                isinstance(s['sentHashes'], hashindex.PeerSentSet)
                for s in states):
            fail('sync: the cold round left a link without a message or '
                 'a peer-space')
        solicit(states)         # lands every link's staged sent set
        t0 = time.perf_counter()
        states, _ = generate(links, states)
        torch.cuda.synchronize()
        out['land_ms'] = (time.perf_counter() - t0) * 1e3
    times, disp = [], set()
    for _ in range(WARM_ROUNDS):
        solicit(states)
        h0, b0 = hashindex.dispatch_count(), bloom.dispatch_count()
        t0 = time.perf_counter()
        states, warm = generate(links, states)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        disp.add((hashindex.dispatch_count() - h0,
                  bloom.dispatch_count() - b0))
    if disp != {(1, 1)} or any(m is None for m in warm):
        fail(f'sync: steady rounds cost {disp} (hash-index, Bloom) '
             f'dispatches, want (1, 1)')
    table = fidx.table
    out.update(round_ms=[t * 1e3 for t in times],
               p50_ms=statistics.median(times) * 1e3,
               links_per_s=LINKS / statistics.median(times),
               table=(table.cap, table.occupancy, table.resident_bytes()))
    # the per-link host protocol over host backends of the same bytes
    host_docs = [host.apply_changes(host.init(), row)[0] for row in rows]
    step = LINKS // SAMPLE_LINKS
    for i in range(0, LINKS, step)[:SAMPLE_LINKS]:
        d = i % HUB_DOCS
        st = host.init_sync_state()
        solicit([st])
        _st, want = host.generate_sync_message(host_docs[d], st)
        if bytes(want) != bytes(cold[i]):
            fail(f'sync: cold message of link {i} != the host protocol\'s')
        st = dict(host.init_sync_state(), sentHashes=set(hashes[d]),
                  lastSentHeads=list(host.get_heads(host_docs[d])))
        solicit([st])
        _st, want = host.generate_sync_message(host_docs[d], st)
        if bytes(want) != bytes(warm[i]):
            fail(f'sync: steady message of link {i} != the host '
                 f'protocol\'s')
    log(f'sync hub: {LINKS} links over {HUB_DOCS} docs of depth {DEPTH}, '
        f'table {table.cap} slots ({table.occupancy} keys, '
        f'{table.resident_bytes()} B); cold round {out["cold_ms"]:.1f} ms, '
        f'landing round {out["land_ms"]:.1f} ms, steady rounds ' +
        ', '.join(f'{t:.1f}' for t in out['round_ms']) +
        f' ms (p50 {out["p50_ms"]:.1f} ms, {out["links_per_s"]:.1f} '
        f'links/s), 1 hash-index + 1 Bloom dispatch each; '
        f'{SAMPLE_LINKS} sampled links == host protocol (cold, steady)')

    # the receive leg: a fresh fleet of replicas takes the cold round
    with rec:
        replica = DocFleet(doc_capacity=REPLICAS, key_capacity=16,
                           device=DEVICE)
        replica.frontier_index(device_min=1,
                               capacity=2 * REPLICAS * (DEPTH + 1))
        peers = init_docs(REPLICAS, replica)
        peer_states = [host.init_sync_state() for _ in range(REPLICAS)]
        t0 = time.perf_counter()
        peers, peer_states, _ = sync_driver.receive_sync_messages_docs(
            peers, peer_states, cold[:REPLICAS])
        torch.cuda.synchronize()
        out['receive_ms'] = (time.perf_counter() - t0) * 1e3
        hub_docs = materialize_docs(hub)
        hub_saves = [bytes(h['state'].save()) for h in hub]
        got = materialize_docs(peers)
        for i, (doc, p) in enumerate(zip(got, peers)):
            if doc != hub_docs[i % HUB_DOCS] or \
                    bytes(p['state'].save()) != hub_saves[i % HUB_DOCS]:
                fail(f'sync: replica {i} != hub doc {i % HUB_DOCS}')
        edits = [[encode_change({
            'actor': 'cc' * 16, 'seq': 1, 'startOp': DEPTH + 1, 'time': 0,
            'message': '', 'deps': list(p['heads']),
            'ops': [{'action': 'set', 'obj': '_root', 'key': 'local',
                     'value': i, 'datatype': 'int', 'pred': []}]})]
            for i, p in enumerate(peers)]
        t0 = time.perf_counter()
        peers, _ = apply_changes_docs(peers, edits, mirror=False)
        peer_states, replies = generate(peers, peer_states)
        torch.cuda.synchronize()
        out['reply_ms'] = (time.perf_counter() - t0) * 1e3
    out['launches'] = dict(sync_kernels.LAUNCHES,
                           lww_merge=merge_kernel.LAUNCHES['lww_merge'])
    for i in range(0, REPLICAS, REPLICAS // SAMPLE_REPLIES):
        hb, hs = host.init(), host.init_sync_state()
        hb, hs, _ = host.receive_sync_message(hb, hs, cold[i])
        hb = host.apply_changes(hb, edits[i])[0]
        _hs, want = host.generate_sync_message(hb, hs)
        if replies[i] is None or bytes(want) != bytes(replies[i]):
            fail(f'sync: reply of replica {i} != the host protocol\'s')
    missing = [k for k, v in out['launches'].items() if v < 1]
    if missing:
        fail(f'sync path never launched {missing}')
    log(f'sync receive leg: {REPLICAS} replicas received the cold round in '
        f'{out["receive_ms"]:.1f} ms, materialize_docs and save() == the '
        f'hub\'s; local edits + replies in {out["reply_ms"]:.1f} ms, '
        f'{SAMPLE_REPLIES} sampled replies == host protocol; launches '
        f'{out["launches"]}')
    out['inputs'] = {name: saved[1:] for name, saved in rec.saved.items()}
    out['links'], out['states'] = links, states
    return out


HOST_PHASES = ('get_change_hashes', 'changes_to_send_prescan',
               'changes_to_send_finish', '_fused_sent_filter',
               'probe_peer_sets', 'flush_peer_sets', 'hashes_to_rows',
               'build_bloom_filters_batch_begin',
               'build_bloom_filters_batch_finish',
               'probe_bloom_filters_batch_begin', 'encode_sync_message',
               'hashes_to_words')


def sync_breakdown(sync):
    """One more steady round at 100,000 links, traced and profiled on
    the host (cProfile): seconds per sync span, the cumulative seconds
    of the sync driver's host phases and the functions with the most self
    time, and the device's busy time against the round's wall time. The
    profiler slows the host; read the shares."""
    import cProfile
    import pstats
    from automerge_tpu_torch.fleet.sync_driver import \
        generate_sync_messages_docs
    links, states = sync['links'], sync['states']
    solicit(states)
    host = cProfile.Profile()
    wall, phases, rows = traced(
        lambda: host.runcall(generate_sync_messages_docs, links, states))
    order = ('sync_generate', 'bloom_build', 'bloom_build_wait',
             'bloom_probe', 'bloom_probe_wait', 'sync_encode', 'python_gc')
    log(f'breakdown, steady sync round (traced and profiled, wall '
        f'{wall * 1e3:.1f} ms): ' +
        ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms'
                  for name in order))
    stats = pstats.Stats(host).stats
    cum = {}
    for (path, line, func), (_cc, nc, _tt, ct, _callers) in stats.items():
        if func in HOST_PHASES and 'automerge_tpu_torch' in path:
            cum[func] = cum.get(func, 0) + ct
    log('host phases (cumulative s): ' + ', '.join(
        f'{name} {sec:.3f}' for name, sec in
        sorted(cum.items(), key=lambda kv: -kv[1])))
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    log('host self time (s): ' + '; '.join(
        f'{func} ({os.path.basename(path)}:{line}) {tt:.3f} x{nc}'
        for (path, line, func), (_cc, nc, tt, _ct, _c) in top))
    device_line(wall, rows)


# ---- the storage path -----------------------------------------------------

DUR_PAIRS = 6            # timed pairs of the durable seam, after a warm pair
DUR_BUDGET_PCT = 15      # the reference's journaled-seam budget (bench.py)
RECOVERY_COPIES = 3      # recovery docs/s: the median over fresh copies
TEXT_RECOVERY_DOCS = 128  # the text leg's cut: 128 of the text seam's docs
                          # (cut from 256 for the shard path's time)
# bench.py _sec_storage_tier parks 1,000,000 docs; cut to 250,000 since
# the service path joined the script (the reopen of the remaining 90 %
# was its longest piece: ~107-124 s at 900,000 docs)
TIER_DOCS, TIER_DISTINCT, REVIVE_BATCH = 250_000, 2_048, 1_024
MIXED_LINKS, MIXED_DIVERGENT, MIXED_SAMPLES, MIXED_ROUNDS = (
    100_000, 1_024, 64, 3)


def kernel_launches(reset=False):
    """Every kernel's launch count (after setting them all to 0 when
    `reset`)."""
    from automerge_tpu_torch.fleet import (merge_kernel, register_kernel,
                                           seq_kernel, sync_kernels)
    mods = (merge_kernel, register_kernel, seq_kernel, sync_kernels)
    if reset:
        for mod in mods:
            mod.reset_launches()
    out = {}
    for mod in mods:
        out.update(mod.LAUNCHES)
    return out


class InlineRecorder:
    """While on, records the inline torch ops of DocFleet that the paths
    launch: each grid and register grow (the shapes before and after),
    each actor remap of the grid and of the registers (the shape it
    rewrote), each counter rebase that shifted a grid row on the device
    (the grid's shape), each sequence pool grow (the [rows, nodes,
    lanes] before and after) and each batch of sequence row copies (the
    two pools' shapes and the rows copied)."""

    METHODS = ('_ensure_capacity', '_ensure_reg_capacity', '_remap_actors',
               '_remap_reg_actors', '_rebase_slot')

    def __init__(self):
        self.events = {'grid_grow': [], 'register_grow': [],
                       'grid_remap': [], 'register_remap': [],
                       'counter_rebase': [], 'seq_grow': [],
                       'row_copy': []}
        self._real = {}

    def __enter__(self):
        from automerge_tpu_torch.fleet import sequence
        from automerge_tpu_torch.fleet.backend import DocFleet
        for name in self.METHODS:
            self._real[(DocFleet, name)] = getattr(DocFleet, name)
            setattr(DocFleet, name,
                    self._wrap(name, self._real[(DocFleet, name)]))
        grow = self._real[(sequence, 'grow_seq_state')] = \
            sequence.grow_seq_state
        copy = self._real[(sequence.SeqPools, 'copy_rows')] = \
            sequence.SeqPools.copy_rows
        events = self.events

        def lanes(st):
            return tuple(st.reg.shape)

        def grow_seq_state(state, *args, **kwargs):
            out = grow(state, *args, **kwargs)
            if out is not state:
                events['seq_grow'].append((lanes(state), lanes(out)))
            return out

        def copy_rows(pools, src_cls, src_idxs, dst_cls, dst_idxs):
            out = copy(pools, src_cls, src_idxs, dst_cls, dst_idxs)
            events['row_copy'].append((lanes(pools.pools[src_cls]),
                                       lanes(pools.pools[dst_cls]),
                                       len(src_idxs)))
            return out
        sequence.grow_seq_state = grow_seq_state
        sequence.SeqPools.copy_rows = copy_rows
        return self

    def __exit__(self, *exc):
        for (owner, name), real in self._real.items():
            setattr(owner, name, real)

    def _wrap(self, name, real):
        def shape(fleet, grid):
            st = fleet.state if grid else fleet.reg_state
            return None if st is None else \
                tuple((st.winners if grid else st.reg).shape)

        def call(fleet, *args, **kwargs):
            if name == '_rebase_slot':
                d0 = fleet.metrics.dispatches
                out = real(fleet, *args, **kwargs)
                if fleet.metrics.dispatches != d0:
                    self.events['counter_rebase'].append(shape(fleet, True))
                return out
            grid = name in ('_ensure_capacity', '_remap_actors')
            before = shape(fleet, grid)
            out = real(fleet, *args, **kwargs)
            after = shape(fleet, grid)
            if name.startswith('_ensure'):
                if before is not None and after != before:
                    self.events['grid_grow' if grid else
                                'register_grow'].append((before, after))
            elif after is not None:
                self.events['grid_remap' if grid else
                            'register_remap'].append(after)
            return out
        return call


def inline_numbers(events, main_events, grid_shape):
    """Each inline op the storage path launched (`events`), timed at the
    largest shape it had there (device ms, queued behind a sleep, L2
    warm), beside its byte bound and its calls on the path; then the
    counter rebase, the sequence pool grow and the sequence row copy at
    the largest shape every main path gave them (`main_events`; a rebase
    no path ran is timed on a row of the seam's grid, `grid_shape`). Bytes: the grow
    reads the old cells once and writes the new array once; the remap
    reads and writes the cells it rewrites; the rebase reads and writes
    one grid row; the row copy reads the source rows and writes as many
    cells."""
    import numpy as np
    import torch
    import types
    from automerge_tpu_torch.fleet.backend import DocFleet
    dev = torch.device(DEVICE)
    out = {}
    cell = {'grid': (4, 4, 4), 'register': (4, 1, 4, 4)}
    dtypes = {'grid': (torch.int32,) * 3,
              'register': (torch.int32, torch.bool, torch.int32,
                           torch.int32)}
    for kind in ('grid', 'register'):
        grows = events[f'{kind}_grow']
        if grows:
            before, after = max(grows, key=lambda g: int(np.prod(g[1])))
            old = [torch.ones(before, dtype=dt, device=dev)
                   for dt in dtypes[kind]]

            # the old scratch key column (before[1] - 1) is dropped
            keep = (slice(0, before[0]), slice(0, before[1] - 1)) + \
                tuple(slice(0, x) for x in before[2:])

            def grow(old=old, after=after, keep=keep):
                for arr in old:
                    new = torch.zeros(after, dtype=arr.dtype, device=dev)
                    new[keep] = arr[keep]
            old_cells = int(np.prod(before)) // before[1] * (before[1] - 1)
            out[f'{kind}_grow'] = dict(
                ms=time_ms(grow, reps=5), calls=len(grows),
                shape=f'{before} -> {after}',
                **bound_of(sum(cell[kind]) * (old_cells +
                                              int(np.prod(after))), 0))
    remaps = events['grid_remap']
    if remaps:
        n, k = max(remaps, key=lambda s: s[0] * s[1])
        w = torch.randint(1, 1 << 20, (n, k), dtype=torch.int32,
                          device=dev)
        perm = torch.arange(256, dtype=torch.int32, device=dev).flip(0)
        mask = 255

        def remap():
            remapped = (w & ~mask) | perm[(w & mask).long()]
            w.copy_(torch.where(w != 0, remapped, 0))
        out['grid_remap'] = dict(
            ms=time_ms(remap, reps=10), calls=len(remaps),
            shape=f'[{n}, {k}] int32',
            **bound_of(n * k * 4 * 2, n * k * 4))
    remaps = events['register_remap']
    if remaps:
        n, k, a = max(remaps, key=lambda s: s[0] * s[1] * s[2])
        arrs = [torch.ones((n, k, a), dtype=dt, device=dev)
                for dt in dtypes['register']]
        move, renum = DocFleet._lane_permutation(
            types.SimpleNamespace(device=dev), np.arange(1, a), a)
        out['register_remap'] = dict(
            ms=time_ms(lambda: (renum(move(arrs[0], 0)),
                                move(arrs[1], False), move(arrs[2], 0),
                                move(arrs[3], 0)), reps=5),
            calls=len(remaps), shape=f'[{n}, {k}, {a}]',
            **bound_of(n * k * a * sum(cell['register']) * 2,
                       n * k * a * 8))
    out.update(seq_inline_numbers(main_events, grid_shape))
    for name in ('grid_grow', 'register_grow', 'grid_remap',
                 'register_remap', 'counter_rebase', 'seq_grow', 'row_copy'):
        where = 'main paths' if name in ('counter_rebase', 'seq_grow',
                                         'row_copy') else 'storage path'
        if name not in out:
            log(f'inline op backend.{name}: no call on the {where}')
            continue
        nums = out[name]
        log(f'inline op backend.{name} at {nums["shape"]}: '
            f'{nums["ms"]:.4f} ms, bound {nums["bound_ms"]:.4f} ms '
            f'({nums["bound_by"]}, {nums["bytes"]} B), calls on the '
            f'{where} {nums["calls"]}')
    return out


def seq_bytes(shape):
    """Bytes of a sequence pool [rows, nodes, lanes]: elem_id and nxt per
    node, reg, killed, val and counter per (node, lane), n and inexact
    per row."""
    rows, nodes, lanes = shape
    return rows * (nodes * (4 + 4 + lanes * (4 + 1 + 4 + 4)) + 4 + 1)


def seq_inline_numbers(events, grid_shape):
    """The counter rebase, the sequence pool grow and the sequence row
    copy (see inline_numbers)."""
    import torch
    from automerge_tpu_torch.fleet.sequence import (SeqPools, SeqState,
                                                    grow_seq_state)
    dev = torch.device(DEVICE)
    out = {}
    rebases = events['counter_rebase']
    n, k = max(rebases, key=lambda s: s[1]) if rebases else grid_shape
    w = torch.randint(1, 1 << 20, (n, k), dtype=torch.int32, device=dev)
    slot, delta = n // 2, 5 << 8

    def rebase():
        w[slot] = torch.where(w[slot] != 0, w[slot] - delta, 0)
    out['counter_rebase'] = dict(
        ms=time_ms(rebase), calls=len(rebases),
        shape=f'a row of [{n}, {k}] int32',
        **bound_of(k * 4 * 2, k * 3))
    grows = events['seq_grow']
    copies = events['row_copy']
    if grows:
        before, after = max(grows, key=lambda g: seq_bytes(g[1]))
    else:
        # no pool grew in place (each dispatch's reserve() sizes a new
        # class at once): time the largest pool a row copy filled
        # doubling its rows, as the next dispatch's reserve would
        before = max((c[1] for c in copies), key=seq_bytes,
                     default=(1_024, 16_387, 4))
        after = (2 * before[0],) + before[1:]
    old = SeqState.empty(before[0], before[1] - 3, actor_slots=before[2],
                         device=dev)
    out['seq_grow'] = dict(
        ms=time_ms(lambda: grow_seq_state(old, after[0], after[1] - 3,
                                          after[2]), reps=5),
        calls=len(grows), shape=f'{before} -> {after}',
        **bound_of(seq_bytes(before) + seq_bytes(after), 0))
    del old
    if copies:
        src, dst, rows = max(copies, key=lambda c: c[2] * c[0][1])
        pools = SeqPools(device=dev)
        pools.pools = {0: SeqState.empty(src[0], src[1] - 3,
                                         actor_slots=src[2], device=dev),
                       1: SeqState.empty(dst[0], dst[1] - 3,
                                         actor_slots=dst[2], device=dev)}
        idxs = list(range(rows))
        out['row_copy'] = dict(
            ms=time_ms(lambda: pools.copy_rows(0, idxs, 1, idxs), reps=10),
            calls=len(copies),
            rows=sum(c[2] for c in copies),
            shape=f'{rows} rows of {src} -> {dst}',
            **bound_of(2 * seq_bytes((rows,) + src[1:]), 0))
        del pools
    return out


PATH_CHECKS = 64    # calls of each kernel a storage leg holds to plain


def _kept(x):
    """A copy of a kernel wrapper's argument or result: tensors and the
    fleet's state and batch classes are cloned, the rest kept as is."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, 'tensors'):          # FleetState, RegisterState, SeqState
        return type(x)(*(t.clone() for t in x.tensors()))
    if hasattr(x, 'columns'):          # OpBatch, RegisterOpBatch, SeqOpBatch
        return type(x)(*(t.clone() for t in x.columns()))
    return x


def _abs_err(a, b):
    """Max abs difference of two equal-shaped tensors (the shapes must
    agree: a mismatch counts as an error of 1)."""
    if a.shape != b.shape:
        return 1
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _merge_err(before, kwargs, out, after):
    from automerge_tpu_torch.fleet.merge_kernel import lww_merge_plain
    state, ops = before
    err = abs(int(lww_merge_plain(state, ops, **kwargs)) - int(out))
    # the real key columns: the last one is the padded lanes' scratch
    return max([err] + [_abs_err(x[:, :-1], y[:, :-1]) for x, y in
                        zip(state.tensors(), after[0].tensors())])


def _scan_err(plain):
    def err(before, kwargs, out, after):
        state, ops = before
        n = abs(int(plain(state, ops)) - int(out))
        return max([n] + [_abs_err(x, y) for x, y in
                          zip(state.tensors(), after[0].tensors())])
    return err


def _output_err(plain):
    def err(before, kwargs, out, after):
        return _abs_err(plain(*before, **kwargs), out)
    return err


def _insert_err(before, kwargs, out, after):
    """The new-key count, and the table's membership (the kernel's slot
    layout may differ where rows race for a slot)."""
    from automerge_tpu_torch.fleet.sync_cases import same_members
    from automerge_tpu_torch.fleet.sync_kernels import hashindex_insert_plain
    tkey, tspace = before[:2]
    err = abs(int(hashindex_insert_plain(*before[:5])) - int(out))
    return err + int(not same_members(after[0], after[1], tkey, tspace))


class PathCheck:
    """While entered, keeps a copy of the inputs of the first PATH_CHECKS
    calls of each kernel wrapper in each leg of `path`, of what each call
    returned and of the state it changed in place; `verify` then runs
    each kernel's plain version on the kept inputs, off the path's
    clock, and fails on any disagreement. `paused()` keeps nothing (the
    timed runs). The wrappers count their launches as before; the plain
    versions launch none of the counted kernels."""

    # (module, wrapper, leading arguments changed in place)
    TARGETS = (('apply', 'lww_merge', 1), ('registers', 'register_scan', 1),
               ('sequence', 'seq_scan', 1), ('sync_kernels', 'bloom_build', 0),
               ('sync_kernels', 'bloom_probe', 0),
               ('sync_kernels', 'hashindex_insert', 2),
               ('sync_kernels', 'hashindex_probe', 0))

    def __init__(self, path='storage path'):
        from automerge_tpu_torch.fleet import (register_kernel, seq_kernel,
                                               sync_kernels)
        self.path = path
        self.errs = {
            'lww_merge': _merge_err,
            'register_scan': _scan_err(register_kernel.register_scan_plain),
            'seq_scan': _scan_err(seq_kernel.seq_scan_plain),
            'bloom_build': _output_err(sync_kernels.bloom_build_plain),
            'bloom_probe': _output_err(sync_kernels.bloom_probe_plain),
            'hashindex_insert': _insert_err,
            'hashindex_probe': _output_err(sync_kernels.hashindex_probe_plain)}
        self.on, self.kept, self.seen = True, [], {}
        self._lock = threading.Lock()
        self.checked = {name: 0 for name in self.errs}
        self.worst = {name: 0 for name in self.errs}
        self._real = []

    def __enter__(self):
        import importlib
        for mod_name, name, inplace in self.TARGETS:
            mod = importlib.import_module(
                f'automerge_tpu_torch.fleet.{mod_name}')
            real = getattr(mod, name)
            self._real.append((mod, name, real))
            setattr(mod, name, self._wrap(name, real, inplace))
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._real:
            setattr(mod, name, real)

    @contextlib.contextmanager
    def paused(self):
        self.on = False
        try:
            yield
        finally:
            self.on = True

    def _wrap(self, name, real, inplace):
        def call(*args, **kwargs):
            # the shard router pumps its shards from two threads at once
            with self._lock:
                n = self.seen.get(name, 0)
                keep = self.on and n < PATH_CHECKS
                if keep:
                    self.seen[name] = n + 1
            if not keep:
                return real(*args, **kwargs)
            before = [_kept(a) for a in args]
            out = real(*args, **kwargs)
            kept = (name, before, kwargs, _kept(out),
                    [_kept(a) for a in args[:inplace]])
            with self._lock:
                self.kept.append(kept)
            return out
        return call

    def verify(self, leg):
        """Hold every call kept since the last leg to its plain version;
        fail on a disagreement. Starts the next leg's count (and clock:
        the log gives the leg's seconds and the check's)."""
        t0 = time.perf_counter()
        with self._lock:
            kept, self.kept, self.seen = self.kept, [], {}
        per = {}
        for name, before, kwargs, out, after in kept:
            kw = {k: v for k, v in kwargs.items()
                  if k not in ('max_occupancy', 'load_max')}
            err = self.errs[name](before, kw, out, after)
            if err:
                fail(f'{self.path}, {leg}: {name} != its plain version on '
                     f'a call of the path (max abs err {err})')
            per[name] = per.get(name, 0) + 1
            self.checked[name] += 1
            self.worst[name] = max(self.worst[name], err)
        del kept
        t1 = time.perf_counter()
        log(f'{self.path}, {leg}: kernel calls held to their plain '
            f'versions (max abs err 0): {per}; leg {t0 - self._t:.1f} s, '
            f'check {t1 - t0:.1f} s')
        self._t = t1


def grid_view(fleet, handles, tag):
    """Each doc's cells as the LWW grids on the card hold them, in terms
    that do not depend on the fleet's slot, key or actor numbering: {key:
    (the winner's op counter with its slot's base, its actor, the value,
    the counter sum)} over the live key columns of its slot. Fails unless
    each doc is served from the grids (fleet-resident, no counter
    overflow, no delete fallback), so that materialize_docs reads them
    too."""
    import numpy as np
    from automerge_tpu_torch.fleet.tensor_doc import (ACTOR_BITS, MAX_ACTORS,
                                                      state_to_numpy)
    winners, values, counters = state_to_numpy(fleet.state)
    keys, actors = fleet.keys.keys, fleet.actors.actors
    out = []
    for h in handles:
        st = h['state']
        slot = st._impl.slot
        if not st.is_fleet or st.fleet is not fleet or \
                slot in fleet.grid_overflow or slot in fleet.del_fallback:
            fail(f'{tag}: a doc is not served from the grids (slot {slot})')
        row = winners[slot, :len(keys)]
        base = fleet.ctr_base.get(slot, 0)
        cells = {}
        for k in np.flatnonzero(row):
            w, v = int(row[k]), int(values[slot, k])
            cells[keys[k]] = ((w >> ACTOR_BITS) + base,
                              actors[w & (MAX_ACTORS - 1)],
                              repr(fleet.value_table[-v - 2]) if v <= -2
                              else v, int(counters[slot, k]))
        out.append(cells)
    return out


def storage_leg(name, legs, run, needs=(), path='storage path'):
    """Run one leg of `path` with every launch count set to 0 just
    before it; fail unless each kernel of `needs` launched."""
    kernel_launches(reset=True)
    out = run()
    launches = kernel_launches()
    legs[name] = launches
    missing = [k for k in needs if launches[k] < 1]
    if missing:
        fail(f'{path}, {name}: never launched {missing}')
    log(f'{path}, {name}: launches {launches}')
    return out


def docs_by_doc(records, n):
    """Journal records -> per durable id, the CHANGE payloads in order."""
    from automerge_tpu_torch.fleet import durability
    out = [[] for _ in range(n)]
    for kind, did, payload in records:
        if kind == durability.KIND_CHANGE:
            out[did].append(bytes(payload))
    return out


def durable_seam(per_doc, root, check):
    """The seam's batch through a DurableFleet with group commit
    (bench.py _sec_durability's configuration), held to the bare seam;
    then the journaled against the bare seam in paired turns (`check`,
    a PathCheck, paused). Returns the first durable run's manager and
    handles, and the numbers."""
    import torch
    from automerge_tpu_torch.fleet import durability
    from automerge_tpu_torch.fleet.backend import apply_changes_docs
    from automerge_tpu_torch.fleet.tensor_doc import state_to_numpy

    def bare():
        split = {}
        fleet, handles, _ = run_seam(per_doc, split)
        return split['apply_s'], fleet, handles

    def journaled(k):
        mgr = durability.DurableFleet(
            os.path.join(root, f'seam{k}'), fsync_bytes=4 << 20,
            compact_bytes=1 << 40, doc_capacity=N_DOCS,
            key_capacity=N_KEYS + 1, device=DEVICE)
        handles = mgr.init_docs(N_DOCS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles, _ = apply_changes_docs(handles, per_doc, mirror=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, mgr, handles

    def settle():
        gc.collect()
        os.sync()

    _s, fleet, handles = bare()
    _s, mgr, dhandles = journaled('check')
    for name, a, b in zip(('winners', 'values', 'counters'),
                          state_to_numpy(fleet.state),
                          state_to_numpy(mgr.fleet.state)):
        if a.shape != b.shape or not (a[:, :-1] == b[:, :-1]).all():
            fail(f'durable seam: {name} grid != the bare seam\'s')
    saves = [bytes(h['state'].save()) for h in handles]
    if [bytes(h['state'].save()) for h in dhandles] != saves:
        fail('durable seam: a save() != the bare seam\'s')
    mgr.journal.sync()
    jpath = os.path.join(mgr.path, durability._journal_name(mgr.seq))
    with open(jpath, 'rb') as f:
        records, info = durability.parse_journal_bytes(f.read())
    if info['torn_tail_bytes'] or info['rotted'] or \
            docs_by_doc(records, N_DOCS) != per_doc:
        fail('durable seam: the journal != the input change bytes, doc by '
             'doc')
    log(f'durable seam: {N_DOCS} docs x {N_CHANGES} changes through '
        f'DurableFleet(fsync_bytes=4 MiB, device={DEVICE!r}); grids and '
        f'all {N_DOCS} save() == the bare seam\'s; the journal '
        f'({os.path.getsize(jpath)} B, {len(records)} records) parses '
        f'back to the input change bytes doc by doc')
    del fleet, handles
    deltas, rates = [], {'bare': [], 'journaled': []}
    with check.paused():      # the timed runs
        for k in range(DUR_PAIRS + 1):
            pair = {}
            for mode in (('bare', 'journaled') if k % 2 else
                         ('journaled', 'bare')):
                settle()
                if mode == 'bare':
                    pair[mode] = bare()[0]
                else:
                    secs, m, _h = journaled(k)
                    m.close()
                    shutil.rmtree(m.path, ignore_errors=True)
                    pair[mode] = secs
            if k == 0:
                continue            # the warm pair
            deltas.append(pair['journaled'] - pair['bare'])
            for mode, secs in pair.items():
                rates[mode].append(N_DOCS * N_CHANGES / secs)
    bare_s = N_DOCS * N_CHANGES / statistics.median(rates['bare'])
    overhead = statistics.median(deltas) / bare_s * 100
    nums = dict(bare_rate=statistics.median(rates['bare']),
                journaled_rate=statistics.median(rates['journaled']),
                overhead_pct=overhead, deltas_ms=[d * 1e3 for d in deltas])
    log(f'durable seam changes/s (apply only, median of {DUR_PAIRS} pairs '
        f'in turns): journaled {nums["journaled_rate"]:.1f} vs bare '
        f'{nums["bare_rate"]:.1f}; paired overhead {overhead:+.2f} % '
        f'(median per-pair delta over the median bare time; the '
        f'reference\'s budget {DUR_BUDGET_PCT} %); deltas ms '
        f'{[round(d, 2) for d in nums["deltas_ms"]]}; {card_line()}')
    box = []
    with check.paused():
        wall, phases, rows = traced(lambda: box.append(journaled('traced')))
    box[0][1].close()
    shutil.rmtree(box[0][1].path, ignore_errors=True)
    del box
    order = ('apply_batch', 'turbo_parse', 'turbo_gate', 'turbo_commit',
             'turbo_stage', 'turbo_dispatch', 'journal_append',
             'journal_commit', 'journal_fsync', 'python_gc')
    log(f'breakdown, journaled seam (traced run, wall {wall * 1e3:.1f} ms, '
        f'fleet + init_docs included): ' +
        ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms'
                  for name in order))
    device_line(wall, rows)
    return mgr, dhandles, nums


def recover_copy(src, dst, **kw):
    """Recover a fresh copy of a durability directory on the card, timed
    to its sync. Returns (manager, handles, report, seconds)."""
    import torch
    from automerge_tpu_torch.fleet.durability import DurableFleet
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    gc.collect()
    t0 = time.perf_counter()
    mgr, handles, report = DurableFleet.recover(dst, device=DEVICE, **kw)
    torch.cuda.synchronize()
    return mgr, handles, report, time.perf_counter() - t0


def recovery_leg(mgr, handles, root, legs, check):
    """Checkpoint the durable seam's fleet, one more change per doc (the
    journal suffix), crash (the manager is dropped unclosed), then
    recover copies of the directory on the card (timed, `check` paused);
    then a torn tail and one rotted record. Each recovered fleet's
    documents and grids (read from the card) and saves are held to the
    pre-crash fleet's."""
    from automerge_tpu_torch.fleet import crash_cases, durability
    from automerge_tpu_torch.fleet.backend import (apply_changes_docs,
                                                   materialize_docs)
    _changes, heads, last = seam_workload()
    mgr.checkpoint()
    more = follow_up('dd' * 16, 1, N_CHANGES + 1, heads, 'suffix', 3)
    handles, _ = apply_changes_docs(handles, [[more]] * N_DOCS, mirror=False)
    mgr.journal.sync()
    pre = [bytes(h['state'].save()) for h in handles]
    pre_docs = materialize_docs(handles)
    if pre_docs != [dict(last, suffix=3)] * N_DOCS:
        fail('recovery: a pre-crash doc != the last writer per key + the '
             'suffix')
    pre_grid = grid_view(mgr.fleet, handles, 'recovery, pre-crash')
    path = mgr.path
    del mgr, handles             # the crash: never closed
    secs = []

    def held(rmgr, rec, dids, tag):
        """The recovered docs `dids`: save(), materialize_docs and the
        grids == pre-crash; returns the ids that differ."""
        if any(did not in rec for did in dids):
            fail(f'{tag}: a doc is missing')
        docs = [rec[did] for did in dids]
        got_docs, got_grid = materialize_docs(docs), grid_view(rmgr.fleet,
                                                               docs, tag)
        return [did for k, did in enumerate(dids) if
                bytes(docs[k]['state'].save()) != pre[did] or
                got_docs[k] != pre_docs[did] or got_grid[k] != pre_grid[did]]

    def recover_all():
        for k in range(RECOVERY_COPIES):
            with check.paused():
                rmgr, rec, report, s = recover_copy(
                    path, os.path.join(root, f'recovered{k}'))
            secs.append(s)
            bad = held(rmgr, rec, range(N_DOCS), 'recovery')
            if report.snapshot_docs != N_DOCS or \
                    report.replayed_records != N_DOCS or \
                    report.quarantined or not report.ok or bad or \
                    rmgr.fleet.metrics.docs_bulk_loaded != N_DOCS:
                fail(f'recovery: {report}, bulk-loaded '
                     f'{rmgr.fleet.metrics.docs_bulk_loaded}, docs != '
                     f'pre-crash (save(), materialize_docs or grids): '
                     f'{bad[:8]}')
            rmgr.close()
            shutil.rmtree(rmgr.path, ignore_errors=True)
    storage_leg('recovery', legs, recover_all, needs=('lww_merge',))
    rate = N_DOCS / statistics.median(secs)
    traced_dir = os.path.join(root, 'traced')
    box = []
    with check.paused():
        wall, phases, rows = traced(
            lambda: box.append(recover_copy(path, traced_dir)))
    box[0][0].close()
    del box
    log(f'breakdown, recovery (traced, wall {wall * 1e3:.1f} ms): ' +
        ', '.join(f'{name} {sec * 1e3:.1f} ms' for name, sec in
                  sorted(phases.items()) if name.startswith('recovery_')
                  and '@' not in name) +
        f', python_gc {phases.get("python_gc", 0) * 1e3:.1f} ms')
    device_line(wall, rows)
    shutil.rmtree(traced_dir, ignore_errors=True)
    log(f'recovery: {N_DOCS} docs (snapshot of {N_CHANGES}-change docs + '
        f'a {N_DOCS}-record journal suffix) on {RECOVERY_COPIES} fresh '
        f'copies: every save(), materialize_docs and grid row (the '
        f'winner\'s op id, value and counter per key, read from the card) '
        f'== pre-crash, snapshot_docs {N_DOCS}, replayed_records {N_DOCS}, '
        f'nothing quarantined, {N_DOCS} bulk-loaded; recovery docs/s '
        f'(median) {rate:.1f}, seconds {[round(s, 3) for s in secs]}; '
        f'{card_line()}')

    # a torn tail and one rotted record in a further copy
    faulted = os.path.join(root, 'faulted')
    shutil.copytree(path, faulted)
    jpath, data, spans, _bounds = crash_cases.journal_record_spans(faulted)
    suffix = [i for i, sp in enumerate(spans)
              if sp['kind'] == durability.KIND_CHANGE and sp['batch']]
    victim = spans[suffix[len(suffix) // 2]]
    at = (victim['pay'][0] + victim['pay'][1]) // 2
    rotted = bytearray(data)
    rotted[at] ^= 0x20
    tail = durability.encode_frame(durability.KIND_CHANGE, 0, more)
    torn = len(tail) // 2
    with open(jpath, 'wb') as f:
        f.write(bytes(rotted) + tail[:torn])
    rmgr, rec, report, _s = recover_copy(faulted, faulted + '-recovered')
    vid = victim['did']
    bad = held(rmgr, rec, [did for did in range(N_DOCS) if did != vid],
               'recovery of a torn, rotted journal')
    if sorted(report.quarantined) != [vid] or report.torn_tail_bytes != \
            torn or report.rotted_records != 1 or bad:
        fail(f'recovery of a torn, rotted journal: {report}, docs != '
             f'pre-crash: {bad[:8]} (victim {vid})')
    rmgr.close()
    log(f'recovery of a torn tail ({torn} B) and one rotted record (doc '
        f'{vid}): exactly doc {vid} quarantined, the other {N_DOCS - 1} '
        f'docs\' save(), materialize_docs and grid rows == pre-crash')
    return rate


def exact_recovery_leg(root, legs, check):
    """An exact-device durable fleet at the exact seam's width: batch 1,
    a checkpoint, batches 2 and 3 (the suffix), the crash and a recovery
    on the card, held to the pre-crash fleet. `check` (a PathCheck) is
    paused while the pre-crash fleet takes the exact seam's batches,
    whose register scans phase 4 holds to the plain version."""
    from automerge_tpu_torch.fleet import register_cases
    from automerge_tpu_torch.fleet.backend import (apply_changes_docs,
                                                   materialize_docs)
    from automerge_tpu_torch.fleet.durability import DurableFleet
    batches = register_cases.exact_seam_changes(N_CHANGES, N_KEYS)
    mgr = DurableFleet(os.path.join(root, 'exact'), exact_device=True,
                       fsync_bytes=4 << 20, compact_bytes=1 << 40,
                       doc_capacity=N_DOCS, key_capacity=N_KEYS + 1,
                       device=DEVICE)
    handles = mgr.init_docs(N_DOCS)
    with check.paused():
        for i, batch in enumerate(batches):
            handles, _ = apply_changes_docs(handles, [list(batch)] * N_DOCS,
                                            mirror=False)
            if i == 0:
                mgr.checkpoint()
    mgr.journal.sync()

    def view(fleet, hs):
        conflicts = fleet.conflicts_all()
        return (materialize_docs(hs),
                [{key: {_op_name(fleet, p): v for p, v in c.items()}
                  for key, c in conflicts[h['state']._impl.slot].items()}
                 for h in hs],
                [bytes(h['state'].save()) for h in hs])
    pre = view(mgr.fleet, handles)
    path = mgr.path
    del mgr, handles

    def recover():
        return recover_copy(path, path + '-recovered', exact_device=True)
    rmgr, rec, report, secs = storage_leg(
        'exact recovery', legs, recover, needs=('register_scan',))
    got = view(rmgr.fleet, [rec[did] for did in range(N_DOCS)])
    if got != pre or not report.ok or rmgr.fleet.inexact_slots():
        fail(f'exact recovery: docs, conflicts or save() != pre-crash, or '
             f'inexact slots ({report})')
    log(f'exact recovery: {N_DOCS} docs (register state '
        f'{tuple(rmgr.fleet.reg_state.reg.shape)}), replayed '
        f'{report.replayed_records} records in {secs:.3f} s: '
        f'materialize_docs, conflicts_all and save() == pre-crash, '
        f'nothing inexact')
    rmgr.close()


def text_recovery_leg(root, legs, check):
    """The text seam's trace on TEXT_RECOVERY_DOCS durable docs: the
    10,000-op batch, a checkpoint, one 256-op batch (the suffix), the
    crash and a recovery on the card. `check` (a PathCheck) is paused
    while the pre-crash fleet takes the text seam's batches, whose
    sequence scans phase 4 holds to the plain version."""
    from automerge_tpu_torch.fleet import seq_cases
    from automerge_tpu_torch.fleet.backend import apply_changes_docs
    from automerge_tpu_torch.fleet.durability import DurableFleet
    batches = seq_cases.text_changes(TEXT_OPS, more=TEXT_MORE[:1])
    mgr = DurableFleet(os.path.join(root, 'text'), fsync_bytes=4 << 20,
                       compact_bytes=1 << 40,
                       doc_capacity=TEXT_RECOVERY_DOCS, key_capacity=4,
                       device=DEVICE)
    handles = mgr.init_docs(TEXT_RECOVERY_DOCS)
    with check.paused():
        for i, batch in enumerate(batches):
            handles, _ = apply_changes_docs(
                handles, [list(batch)] * TEXT_RECOVERY_DOCS, mirror=False)
            if i == 0:
                mgr.checkpoint()
    mgr.journal.sync()
    pre_texts = mgr.fleet.render_seq_all()
    pre = [bytes(h['state'].save()) for h in handles]
    path = mgr.path
    del mgr, handles

    def recover():
        return recover_copy(path, path + '-recovered')
    rmgr, rec, report, secs = storage_leg('text recovery', legs, recover,
                                          needs=('seq_scan',))
    texts = rmgr.fleet.render_seq_all()
    if sorted(texts.values()) != sorted(pre_texts.values()) or \
            None in texts.values() or \
            [bytes(rec[d]['state'].save()) for d in
             range(TEXT_RECOVERY_DOCS)] != pre or not report.ok:
        fail(f'text recovery: a text or save() != pre-crash ({report})')
    log(f'text recovery: {TEXT_RECOVERY_DOCS} docs of the text seam\'s '
        f'trace (cut from {TEXT_DOCS} for time; {TEXT_OPS} ops + a '
        f'{TEXT_MORE[0]}-op suffix of {report.replayed_records} records) '
        f'in {secs:.3f} s: every text and save() == pre-crash')
    rmgr.close()


def tier_leg(root):
    """bench.py _sec_storage_tier's population on the card: TIER_DOCS
    parked docs (TIER_DISTINCT distinct 2-change documents) on a
    disk-backed arena; revive in batches of REVIVE_BATCH, warm and
    cold; a 10 % discard and a vacuum; close and reopen. Returns the
    reopened engine, the distinct chunks and the numbers."""
    import torch
    from automerge_tpu_torch.columnar import DocChunkView, decode_change_meta
    from automerge_tpu_torch.fleet.backend import (
        DocFleet, apply_changes_docs, free_docs, init_docs, materialize_docs)
    from automerge_tpu_torch.fleet.storage import StorageEngine
    from automerge_tpu_torch.observability.perf import (page_fault_counts,
                                                        rss_bytes)
    fleet = DocFleet(device=DEVICE)
    handles = init_docs(TIER_DISTINCT, fleet)
    heads = [[] for _ in range(TIER_DISTINCT)]
    for c in range(2):
        per = []
        for d in range(TIER_DISTINCT):
            buf = follow_up(f'{d % 128:04x}' * 4, c + 1, c + 1, heads[d],
                            f'k{c}', d * 1000 + c)
            heads[d] = [decode_change_meta(buf, True)['hash']]
            per.append([buf])
        handles, _ = apply_changes_docs(handles, per, mirror=False)
    chunks = [bytes(h['state'].save()) for h in handles]
    want_docs = materialize_docs(handles)
    if want_docs != [{'k0': d * 1000, 'k1': d * 1000 + 1}
                     for d in range(TIER_DISTINCT)]:
        fail('tier: a distinct doc != its two changes')
    want_grid = grid_view(fleet, handles, 'tier, the distinct docs')
    rows = [(v.heads, v.clock, v.max_op, v.n_changes)
            for v in map(DocChunkView, chunks)]
    free_docs(handles)
    del fleet, handles
    path = os.path.join(root, 'arena')
    eng = StorageEngine(path=path, device=DEVICE)
    eng.main.reserve(TIER_DOCS)
    rss0 = rss_bytes()[0]
    t0 = time.perf_counter()
    for i in range(0, TIER_DOCS, TIER_DISTINCT):
        k = min(TIER_DISTINCT, TIER_DOCS - i)
        eng.ingest_chunks(chunks[:k], rows=rows[:k])
    park_rate = TIER_DOCS / (time.perf_counter() - t0)
    rss1 = rss_bytes()[0]
    stats = eng.memory_stats()
    if len(eng.main) != TIER_DOCS:
        fail(f'tier: {len(eng.main)} docs parked of {TIER_DOCS}')

    def revive_rate(windows):
        rates = []
        for w in windows:
            ids = list(range(w * REVIVE_BATCH, (w + 1) * REVIVE_BATCH))
            t0 = time.perf_counter()
            got = eng.revive(ids)
            torch.cuda.synchronize()
            rates.append(len(ids) / (time.perf_counter() - t0))
            if [bytes(h['state'].save()) for h in got] != \
                    [chunks[i % TIER_DISTINCT] for i in ids] or \
                    materialize_docs(got) != \
                    [want_docs[i % TIER_DISTINCT] for i in ids] or \
                    grid_view(eng.fleet, got, 'tier, revive') != \
                    [want_grid[i % TIER_DISTINCT] for i in ids]:
                fail(f'tier: a revived doc\'s save(), materialize_docs or '
                     f'grid row != its chunk\'s (window {w})')
            eng.repark(got, ids)
            if any(i not in eng._row_of for i in ids):
                fail('tier: repark lost an id')
        return statistics.median(rates), rates
    warm, warm_reps = revive_rate([1, 3, 5])
    _mn0, mj0 = page_fault_counts()
    eng.main._arena.advise_cold()
    cold, cold_reps = revive_rate([9, 11, 13])
    _mn1, mj1 = page_fault_counts()
    log(f'tier: {TIER_DOCS} docs parked ({TIER_DISTINCT} distinct 2-change '
        f'docs) on a disk arena at {park_rate:.1f} docs/s; resident '
        f'{stats["resident_per_doc"]:.1f} B/doc, RSS +{rss1 - rss0} B, '
        f'disk {stats["disk_bytes"]} B; revive docs/s in batches of '
        f'{REVIVE_BATCH} (median of 3): warm {warm:.1f} '
        f'{[round(r) for r in warm_reps]}, cold (after advise_cold) '
        f'{cold:.1f} {[round(r) for r in cold_reps]} ({mj1 - mj0} major '
        f'faults); every revived doc\'s save(), materialize_docs and grid '
        f'row (read from the card) == its chunk\'s; repark keeps the ids; '
        f'{card_line()}')
    gone = list(range(0, TIER_DOCS, 10))
    eng.discard(gone)
    t0 = time.perf_counter()
    eng.vacuum_now()
    vacuum_s = time.perf_counter() - t0
    keep = [i for i in range(TIER_DOCS) if i % 10]

    def check(e, tag):
        if sorted(e._row_of) != keep:
            fail(f'tier: {tag}: ids != the {len(keep)} kept')
        for i in keep:
            if bytes(e.chunk(i)) != chunks[i % TIER_DISTINCT]:
                fail(f'tier: {tag}: chunk of doc {i} changed')
    check(eng, 'after a 10 % discard and vacuum_now')
    disk = eng.memory_stats()['disk_bytes']
    eng.close()
    t0 = time.perf_counter()
    eng = StorageEngine.open(path, device=DEVICE)
    open_s = time.perf_counter() - t0
    check(eng, 'after close and open')
    log(f'tier: a 10 % discard ({len(gone)} docs) + vacuum_now in '
        f'{vacuum_s:.3f} s left the other {len(keep)} chunks '
        f'byte-identical (disk {disk} B); close + StorageEngine.open in '
        f'{open_s:.3f} s recovered every id and chunk')
    return eng, chunks, dict(park_rate=park_rate, warm=warm, cold=cold,
                             resident_per_doc=stats['resident_per_doc'],
                             disk_bytes=stats['disk_bytes'],
                             major_faults=mj1 - mj0)


TIER_MAT = 256       # bench.py BENCH_TIER_MAT: parked docs per batched read


def tier_mat_leg(eng, chunks, check):
    """bench.py _sec_storage_tier's mat_rate on the tier's reopened disk
    engine: materialize_at_docs of TIER_MAT parked docs at their heads,
    read off their chunks without reviving them. The first read is
    checked (one dispatch; every doc read from the card and its grid row
    == its chunk's distinct doc; no doc revived, the engine unchanged),
    then docs/s is the median of 3."""
    import torch
    from automerge_tpu_torch.fleet.backend import free_docs, materialize_docs
    from automerge_tpu_torch.query import materialize_at_docs
    ids = [i for i in range(1, TIER_DOCS) if i % 10][:TIER_MAT]
    sources = [(eng, i) for i in ids]
    heads = [eng.heads(i) for i in ids]
    parked = len(eng.main)

    def read():
        outs = materialize_at_docs(sources, heads, fleet=eng.fleet)
        torch.cuda.synchronize()
        return outs
    d0 = eng.fleet.metrics.dispatches
    outs = read()
    if eng.fleet.metrics.dispatches - d0 != 1:
        fail(f'tier materialize_at: {eng.fleet.metrics.dispatches - d0} '
             f'dispatches for one batched read (want 1)')
    want = [{'k0': d * 1000, 'k1': d * 1000 + 1}
            for d in (i % TIER_DISTINCT for i in ids)]
    rows = grid_view(eng.fleet, outs, 'tier materialize_at')
    if materialize_docs(outs) != want or \
            [{k: v[2] for k, v in row.items()} for row in rows] != want or \
            [bytes(h['state'].save()) for h in outs] != \
            [chunks[i % TIER_DISTINCT] for i in ids]:
        fail('tier materialize_at: a doc read from the card, its grid row or '
             'its save() != its chunk\'s')
    free_docs(outs)
    if len(eng.main) != parked or any(i not in eng._row_of for i in ids):
        fail('tier materialize_at: the read revived a parked doc')
    times = []
    with check.paused():
        for _ in range(3):
            t0 = time.perf_counter()
            outs = read()
            times.append(time.perf_counter() - t0)
            free_docs(outs)
    rate = TIER_MAT / statistics.median(times)
    log(f'tier materialize_at: {TIER_MAT} parked docs of the reopened disk '
        f'engine read at their heads in one dispatch, none revived: '
        f'{rate:.1f} docs/s (median of 3 after a checked read; '
        f'{[round(TIER_MAT / t) for t in times]}); every doc and grid row '
        f'read from the card and every save() == its chunk\'s')
    return rate


def quiet_handshakes(chunks):
    """For each chunk, both sides' sync states once the per-link host
    protocol between a host backend of the chunk and an empty peer has
    gone quiet, and the peer's saved document."""
    from automerge_tpu_torch import backend as host
    out = []
    for chunk in chunks:
        ours, peer = host.load(chunk), host.init()
        s, p = host.init_sync_state(), host.init_sync_state()
        for _ in range(10):
            s, m1 = host.generate_sync_message(ours, s)
            if m1 is not None:
                peer, p, _ = host.receive_sync_message(peer, p, m1)
            p, m2 = host.generate_sync_message(peer, p)
            if m2 is not None:
                ours, s, _ = host.receive_sync_message(ours, s, m2)
            if m1 is None and m2 is None:
                break
        else:
            fail('mixed round: a handshake never went quiet')
        out.append((s, p, bytes(host.save(peer))))
    return out


def _copy_state(s):
    return dict(s, sentHashes=set(s['sentHashes']))


def mixed_leg(eng, chunks, legs, check):
    """MIXED_LINKS parked docs of the tier, each with one peer whose
    sync state is converged and quiet; MIXED_DIVERGENT peers each send
    one new change a round: receive_sync_messages_mixed, then
    generate_sync_messages_mixed; then a round in which the hub's copy
    of each divergent doc changed too (see the module docstring). The
    timed and traced rounds run with `check` (a PathCheck) paused; the
    round with hub-side changes, which launches every kernel of the
    leg, runs with it on."""
    import torch
    from automerge_tpu_torch import backend as host
    from automerge_tpu_torch.fleet import bloom, hashindex, sync_driver
    from automerge_tpu_torch.fleet.backend import (_leaf_value,
                                                   apply_changes_docs,
                                                   materialize_docs)
    from automerge_tpu_torch.fleet.storage import _stats as storage_stats
    ids = sorted(eng._row_of)[:MIXED_LINKS]
    t0 = time.perf_counter()
    quiet = quiet_handshakes(chunks)
    hand_s = time.perf_counter() - t0
    states = [_copy_state(quiet[i % TIER_DISTINCT][0]) for i in ids]
    step = MIXED_LINKS // MIXED_DIVERGENT
    div = list(range(0, MIXED_LINKS, step))[:MIXED_DIVERGENT]
    peers = {j: [host.load(quiet[ids[j] % TIER_DISTINCT][2]),
                 _copy_state(quiet[ids[j] % TIER_DISTINCT][1])]
             for j in div}
    eng.fleet.frontier_index(device_min=1, capacity=1 << 16)
    revives = []
    real_revive = eng.revive

    def revive(rids, durable=None):
        revives.append(len(rids))
        return real_revive(rids, durable)
    eng.revive = revive
    docs = list(ids)
    rounds = {'secs': [], 'catch_up': {}}

    def catch_up(r):
        """The rest of each divergent link's exchange, off the clock,
        through the live rounds (receive / generate_sync_messages_docs)
        until its peer goes quiet: a peer whose new change hit our
        filter's false positive sends it only after our reply names it
        in `need`."""
        nonlocal docs, states
        sub = [docs[j] for j in div]
        sub_states = [states[j] for j in div]
        for step in range(10):
            backs = []
            for j in div:
                peer, ps = peers[j]
                ps, back = host.generate_sync_message(peer, ps)
                peers[j] = [peer, ps]
                backs.append(back)
            if all(b is None for b in backs):
                break
            rounds['catch_up'][r] = (step + 1,
                                     sum(b is not None for b in backs))
            sub, sub_states, _ = sync_driver.receive_sync_messages_docs(
                sub, sub_states, backs)
            sub_states, sub_msgs = sync_driver.generate_sync_messages_docs(
                sub, sub_states)
            for j, m in zip(div, sub_msgs):
                if m is not None:
                    peer, ps = peers[j]
                    peer, ps, _ = host.receive_sync_message(peer, ps, m)
                    peers[j] = [peer, ps]
        else:
            fail(f'mixed round {r}: the divergent links never went quiet')
        for k, j in enumerate(div):
            docs[j], states[j] = sub[k], sub_states[k]

    def host_doc(backend):
        return _leaf_value(host.get_patch(backend)['diffs'])

    def hold_to_host(r, sample, hub, before, msgs, replies, saves, views):
        """The sampled links' messages (and the divergent ones'
        documents: save() and materialize_docs, read from the card)
        against the per-link host protocol over host backends of the
        same bytes."""
        for k, j in enumerate(sample):
            ours, st = host.load(hub[k]), _copy_state(before[k])
            if msgs[j] is not None:
                ours, st, _ = host.receive_sync_message(ours, st, msgs[j])
            _st, want = host.generate_sync_message(ours, st)
            got = replies[j]
            if (want is None) != (got is None) or \
                    (want is not None and bytes(want) != bytes(got)):
                fail(f'mixed round {r}: link {j}\'s message != the host '
                     f'protocol\'s')
            if msgs[j] is not None and (
                    bytes(host.save(ours)) != saves[div.index(j)] or
                    host_doc(ours) != views[div.index(j)]):
                fail(f'mixed round {r}: link {j}\'s document != the '
                     f'host\'s')

    def one_round(r, trace=False, local=False):
        """One round: the divergent peers' new changes (with `local`, a
        change to the hub's copy of each divergent doc first, parked
        again), then the receive and the generate (timed, or traced with
        `trace`), then the peers take the replies, the exchanges finish
        and the revived docs repark. Returns the seconds (or the traced
        numbers)."""
        nonlocal docs, states
        if local:
            live = real_revive([ids[j] for j in div])
            live, _ = apply_changes_docs(live, [[follow_up(
                'f0' * 16, 1, 200, h['heads'], 'hub', r)]
                for h in live], mirror=False)
            eng.repark(live, [ids[j] for j in div])
            del live
        msgs = [None] * MIXED_LINKS
        for j in div:
            peer, ps = peers[j]
            # 32 peer actors in all: a fleet holds at most 256 actors
            change = follow_up(f'{j % 32:02x}' + 'e' * 30, r + 1, 100 + r,
                               host.get_heads(peer), 'peer', r)
            peer, _ = host.apply_changes(peer, [change])
            ps, msgs[j] = host.generate_sync_message(peer, ps)
            peers[j] = [peer, ps]
        # sampled divergent links: those whose sent set is still a host
        # set (a link a live round served holds a peer-space of the
        # fleet's index, which the host protocol cannot take)
        sample = [] if trace else [
            j for j in div if isinstance(states[j]['sentHashes'], set)
        ][:MIXED_SAMPLES]
        if not trace and len(sample) < MIXED_SAMPLES:
            fail(f'mixed round {r}: only {len(sample)} divergent links '
                 f'to sample')
        if sample:
            sample += list(range(1, 1 + MIXED_SAMPLES))
        hub = [bytes(eng.chunk(ids[j])) for j in sample]
        before = [_copy_state(states[j]) for j in sample]
        revives.clear()
        skipped0 = storage_stats['storage_parked_syncs_skipped']
        seen = {}

        def exchange():
            nonlocal docs, states
            docs, states, _p = sync_driver.receive_sync_messages_mixed(
                eng, docs, states, msgs)
            seen['receive_revives'] = list(revives)
            h0, b0 = hashindex.dispatch_count(), bloom.dispatch_count()
            docs, states, seen['replies'] = \
                sync_driver.generate_sync_messages_mixed(eng, docs, states)
            torch.cuda.synchronize()
            seen['dispatches'] = (hashindex.dispatch_count() - h0,
                                  bloom.dispatch_count() - b0)
        if trace:
            secs = traced(exchange)
        else:
            t0 = time.perf_counter()
            exchange()
            secs = time.perf_counter() - t0
        replies = seen['replies']
        skipped = storage_stats['storage_parked_syncs_skipped'] - skipped0
        live = [j for j, d in enumerate(docs) if not isinstance(d, int)]
        # the generate's one frontier-index probe and its Bloom probe of
        # the peers' filters; with `local`, also the one Bloom build of
        # the hub's new changes
        want = (1, 2 if local else 1)
        if seen['receive_revives'] != [MIXED_DIVERGENT] or \
                revives != seen['receive_revives'] or live != div or \
                skipped != MIXED_LINKS - MIXED_DIVERGENT or \
                seen['dispatches'] != want:
            fail(f'mixed round {r}: revives {seen["receive_revives"]} then '
                 f'{revives[len(seen["receive_revives"]):]}, {len(live)} '
                 f'live, {skipped} parked syncs skipped, generate '
                 f'dispatches {seen["dispatches"]} (want '
                 f'[{MIXED_DIVERGENT}], none, {div[:3]}..., '
                 f'{MIXED_LINKS - MIXED_DIVERGENT}, {want})')
        saves = [bytes(docs[j]['state'].save()) for j in div]
        revived = [docs[j] for j in div]
        grid_view(eng.fleet, revived, f'mixed round {r}')
        views = materialize_docs(revived)
        del revived
        for j in div:
            peer, ps = peers[j]
            if replies[j] is not None:
                peer, ps, _ = host.receive_sync_message(peer, ps,
                                                        replies[j])
            peers[j] = [peer, ps]
        catch_up(r)
        for j in div:
            if sorted(docs[j]['state'].heads) != \
                    host.get_heads(peers[j][0]):
                fail(f'mixed round {r}: link {j}\'s heads != its peer\'s')
        revived = [docs[j] for j in div]
        grid_view(eng.fleet, revived, f'mixed round {r}')
        if materialize_docs(revived) != [host_doc(peers[j][0])
                                         for j in div]:
            fail(f'mixed round {r}: a revived doc (read from the card) != '
                 f'its peer\'s host OpSet')
        del revived
        eng.repark([docs[j] for j in div], [ids[j] for j in div])
        docs = list(ids)
        if not trace:
            hold_to_host(r, sample, hub, before, msgs, replies, saves,
                         views)
        return secs

    def run_rounds():
        with check.paused():
            for r in range(MIXED_ROUNDS):
                rounds['secs'].append(one_round(r))
        rounds['local_ms'] = one_round(MIXED_ROUNDS, local=True) * 1e3
    storage_leg('mixed round', legs, run_rounds,
                needs=('lww_merge', 'bloom_build', 'bloom_probe',
                       'hashindex_insert', 'hashindex_probe'))
    p50 = statistics.median(rounds['secs'])
    log(f'mixed round: {MIXED_LINKS} parked links (quiet handshakes of '
        f'{TIER_DISTINCT} distinct docs in {hand_s:.1f} s), '
        f'{MIXED_DIVERGENT} peers with one new change each: one batched '
        f'revive of {MIXED_DIVERGENT} docs per receive, none per generate, '
        f'{MIXED_LINKS - MIXED_DIVERGENT} parked syncs skipped, the '
        f'generate 1 hash-index + 1 Bloom dispatch (the probe of the '
        f'peers\' filters); {MIXED_SAMPLES} divergent and {MIXED_SAMPLES} '
        f'quiet sampled links == host protocol each round (the divergent '
        f'docs\' save() and materialize_docs too); every revived doc\'s '
        f'heads == its peer\'s, and its materialize_docs (from the grids) '
        f'== its peer\'s host OpSet (catch-up exchanges and links per '
        f'round off the clock: {rounds["catch_up"]}), reparked; round ms '
        f'{[round(s * 1e3, 1) for s in rounds["secs"]]} (p50 '
        f'{p50 * 1e3:.1f} ms, {MIXED_LINKS / p50:.1f} links/s); a round '
        f'whose hub docs changed too: {rounds["local_ms"]:.1f} ms, the '
        f'generate 1 hash-index + 2 Bloom dispatches (a build, a probe; '
        f'its kernel calls are copied for the plain-version check); '
        f'{card_line()}')
    with check.paused():
        (wall, phases, rows) = one_round(MIXED_ROUNDS + 1, trace=True)
    top = sorted(((v, k) for k, v in phases.items() if '@' not in k),
                 reverse=True)[:8]
    log(f'breakdown, mixed round (traced receive + generate, wall '
        f'{wall * 1e3:.1f} ms): ' +
        ', '.join(f'{name} {sec * 1e3:.1f} ms' for sec, name in top))
    device_line(wall, rows)
    eng.revive = real_revive
    return dict(p50_ms=p50 * 1e3, links_per_s=MIXED_LINKS / p50,
                round_ms=[s * 1e3 for s in rounds['secs']],
                local_round_ms=rounds['local_ms'])


def storage_path(per_doc):
    """Durability and the storage tier on the card (see the module
    docstring): the durable seam, recovery (LWW, exact and text), a
    crash-injection dose, the 250,000-doc tier and the mixed
    live/parked sync round. Every leg runs with the launch counts set
    to 0 just before it, and the kernel calls each leg kept (PathCheck)
    are held to the plain versions after it. Returns the path's launches
    (summed over its legs), the calls held to the plain versions and
    their max abs errors, its numbers and the inline ops it launched."""
    from automerge_tpu_torch.fleet import crash_cases
    legs = {}
    root = tempfile.mkdtemp(prefix='chip-smoke-storage-')
    log(f'storage path: scratch {root}, filesystem free '
        f'{shutil.disk_usage(root).free} B')
    nums = {}
    try:
        with InlineRecorder() as inline, PathCheck() as check:
            mgr, handles, nums['durable'] = storage_leg(
                'durable seam', legs,
                lambda: durable_seam(per_doc, root, check),
                needs=('lww_merge',))
            check.verify('durable seam')
            nums['recovery_docs_per_s'] = recovery_leg(mgr, handles, root,
                                                       legs, check)
            del mgr, handles
            check.verify('recovery')
            gc.collect()
            exact_recovery_leg(root, legs, check)
            check.verify('exact recovery')
            text_recovery_leg(root, legs, check)
            check.verify('text recovery')

            def dose():
                stats = crash_cases.run_crashtest(
                    n_seeds=1, n_points=2, modes=['lww', 'exact'],
                    device=DEVICE)
                if stats['failures'] or stats['cases'] < 16:
                    fail(f'crash dose: {stats["cases"]} cases, failures '
                         f'{stats["failures"][:5]}')
                log(f'crash dose: {stats["cases"]} cases (modes lww, '
                    f'exact; 1 seed, 2 points), no failure')
            storage_leg('crash dose', legs, dose,
                        needs=('lww_merge', 'register_scan'))
            check.verify('crash dose')
            gc.collect()
            eng, chunks, nums['tier'] = storage_leg(
                'tier', legs, lambda: tier_leg(root))
            check.verify('tier')
            nums['tier_mat_docs_per_s'] = storage_leg(
                'tier materialize_at', legs,
                lambda: tier_mat_leg(eng, chunks, check),
                needs=('lww_merge',))
            check.verify('tier materialize_at')
            nums['mixed'] = mixed_leg(eng, chunks, legs, check)
            check.verify('mixed round')
            eng.close()
            del eng
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {}
    for launches in legs.values():
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    log(f'storage path launches: {total}; kernel calls held to their plain '
        f'versions: {check.checked}')
    missing = [name for name, n in total.items()
               if n and not check.checked[name]]
    if missing:
        fail(f'storage path: no call of {missing} held to its plain version')
    return total, dict(checked=check.checked, worst=check.worst), nums, \
        inline.events


# ---- phase 4 ---------------------------------------------------------------

SLEEP_CYCLES = 40_000_000      # ~20 ms: the host queues every timed call
FLUSH_BYTES = 256 << 20        # > the H100's 50 MB L2


def evict(flush):
    """Evict the L2 before a timed call: `flush` is an int32 buffer of
    FLUSH_BYTES, written whole (the lines it leaves are dirty), or a
    callable (`clean_evictor`)."""
    if callable(flush):
        flush()
    else:
        flush.fill_(1)


def clean_evictor(buf):
    """An L2 eviction that leaves no dirty line: a read of the whole
    buffer, so a timed call that follows pays no write-back of the lines
    an earlier write (a restore) left."""
    return lambda: buf.sum()


def time_ms(fn, reps=50, flush=None):
    """Device ms per call of `fn`. The calls are queued behind a sleep
    kernel, so the host's launch cost is off the clock. With `flush`
    (see `evict`), each call follows an eviction of the L2, and only the
    call is timed (median of the calls)."""
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
            evict(flush)
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


def time_restored(fn, restore, reps=20, flush=None):
    """Device ms of `fn()` (median of `reps` calls), each call on the
    state `restore()` puts back first, off the clock: for a kernel that
    changes its inputs, as the hash-index insert and the scans do. The
    calls are queued behind a sleep kernel, so the host's launch cost is
    off the clock; with `flush` (as for time_ms) each restore is followed
    by an eviction of the L2."""
    import torch
    restore()
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        restore()
        if flush is not None:
            evict(flush)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_of(n_bytes, n_ops):
    """The least time the card could take: bytes over the memory rate or
    integer operations over the issue rate, whichever is longer."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes=n_bytes, ops=n_ops,
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations')


SYNC_KERNELS = {
    'bloom_build': ('automerge_tpu_torch/fleet/csrc/bloom.cu',
                    'automerge_tpu/fleet/bloom.py:187'),
    'bloom_probe': ('automerge_tpu_torch/fleet/csrc/bloom.cu',
                    'automerge_tpu/fleet/bloom.py:201'),
    'hashindex_insert': ('automerge_tpu_torch/fleet/csrc/hashindex.cu',
                         'automerge_tpu/fleet/hashindex.py:221'),
    'hashindex_probe': ('automerge_tpu_torch/fleet/csrc/hashindex.cu',
                        'automerge_tpu/fleet/hashindex.py:264'),
}


def turns_of(module, baseline):
    """The modules to time in turns: this checkout's alone, or with
    `baseline` (another checkout's module of the same name) as
    (baseline, this, this, baseline), tagged 'base_' and ''."""
    if baseline is None:
        return [('', module)]
    return [('base_', baseline), ('', module), ('', module),
            ('base_', baseline)]


PROBE_ROUNDS = 6     # a probe's gain over its parent may be a few per cent


def sync_kernel_numbers(inputs, baseline=None):
    """Each sync kernel on the largest inputs the sync path handed its
    wrapper: held to its plain version there, and timed (device ms;
    queued behind a sleep, or per call on a restored table for the
    insert) beside its plain version and its bound. The build is timed
    with the L2 warm and after a clean eviction (`clean_evictor`,
    cold_ms), beside a floor (zero_ms: one zero_() of its output); the
    insert on the table restored before each call, as
    is (ms: the restore's 72 MB of writes are still dirty in the L2) and
    followed by a clean eviction (clean_ms), beside a floor of its key
    stores (key_scatter_ms: torch's index_copy_ of the new keys to the
    slots the kernel gave them); each probe with the L2 warm and after a
    clean eviction (clean_ms), the Bloom probe beside a floor (zero_ms:
    one zero_() of its [rows, H] output). With `baseline` (another
    checkout's sync_kernels, e.g. the parent commit's) its build, insert
    and probes are timed by the same methods in turns (baseline, this,
    this, baseline; base_*), each probe in PROBE_ROUNDS such turns
    (medians, and each time's least and largest as *_range). The bounds count
    what this run's data needs: the valid flag (and the probes' output
    byte) of every lane, the words or key and space of valid lanes only,
    the per-row int64s of rows that hold a valid lane only, and the
    output once. The index's scattered slot accesses move 32-byte
    sectors: the distinct sectors of the valid rows' start spaces (read),
    a key sector per new key (written) or per distinct found key (read),
    and the distinct sectors of the new keys' spaces (written).
    Operations: ~22 integer operations per valid Bloom lane (15 modulo
    steps, 7 bit sets or tests), ~16 per valid index row. No single
    PyTorch call computes any of them (library_ms null)."""
    import torch
    from automerge_tpu_torch.fleet import sync_cases
    from automerge_tpu_torch.fleet import sync_kernels as sk
    out = {}
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=DEVICE)
    clean = clean_evictor(buf)

    def space_sectors(slots):
        return int(torch.unique(slots // 8).numel()) * 32

    (words, valid, row_bits, bit_off, total_bits), _kw = inputs['bloom_build']
    got = sk.bloom_build(words, valid, row_bits, bit_off, total_bits)
    want = sk.bloom_build_plain(words, valid, row_bits, bit_off, total_bits)
    r, h = words.shape[:2]
    v = int(valid.sum())
    live = int(valid.any(dim=1).sum())
    times = {}
    for tag, mod in turns_of(sk, baseline):
        def build():
            return mod.bloom_build(words, valid, row_bits, bit_off,
                                   total_bits)
        times.setdefault(tag + 'ms', []).append(time_ms(build))
        times.setdefault(tag + 'cold_ms', []).append(
            time_ms(build, reps=20, flush=clean))
    err = int((got.int() - want.int()).abs().max())
    out['bloom_build'] = dict(
        shape=f'{r} rows x {h} lanes ({v} valid) -> {total_bits // 8} B',
        max_abs_err=err,
        **{k: statistics.median(t) for k, t in times.items()},
        # a floor: one launch that writes the output once
        zero_ms=time_ms(got.zero_),
        plain_ms=time_ms(lambda: sk.bloom_build_plain(
            words, valid, row_bits, bit_off, total_bits), reps=5),
        **bound_of(r * h + v * 12 + live * 16 + total_bits // 8, v * 22))

    (flat, row_bits, byte_off, words, valid), _kw = inputs['bloom_probe']
    got = sk.bloom_probe(flat, row_bits, byte_off, words, valid)
    want = sk.bloom_probe_plain(flat, row_bits, byte_off, words, valid)
    r, h = words.shape[:2]
    v = int(valid.sum())
    live_rows = valid.any(dim=1)
    live = int(live_rows.sum())
    filter_bytes = int(row_bits[live_rows].sum()) // 8
    err, hits = int((got != want).sum()), int(got.sum())
    times = {}
    for tag, mod in turns_of(sk, baseline) * PROBE_ROUNDS:
        def bprobe():
            return mod.bloom_probe(flat, row_bits, byte_off, words, valid)
        times.setdefault(tag + 'ms', []).append(time_ms(bprobe))
        times.setdefault(tag + 'clean_ms', []).append(
            time_ms(bprobe, reps=20, flush=clean))
    out['bloom_probe'] = dict(
        shape=f'{r} rows x {h} lanes ({v} valid, {hits} hits) '
              f'over {flat.numel()} B',
        max_abs_err=err,
        **{k: statistics.median(t) for k, t in times.items()},
        **{k.replace('ms', 'range'): [min(t), max(t)]
           for k, t in times.items()},
        # a floor: one launch that writes the [rows, H] output once
        zero_ms=time_ms(got.zero_),
        plain_ms=time_ms(lambda: sk.bloom_probe_plain(
            flat, row_bits, byte_off, words, valid), reps=5),
        **bound_of(r * h * 2 + v * 12 + live * 16 + filter_bytes, v * 22))

    (tkey0, tspace0, keys, spaces, valid), kw = inputs['hashindex_insert']
    tkey, tspace = tkey0.clone(), tspace0.clone()

    def restore():
        tkey.copy_(tkey0)
        tspace.copy_(tspace0)

    n_new = int(sk.hashindex_insert(tkey, tspace, keys, spaces, valid, **kw))
    p_tkey, p_tspace = tkey0.clone(), tspace0.clone()
    p_new = int(sk.hashindex_insert_plain(p_tkey, p_tspace, keys, spaces,
                                          valid))
    same = n_new == p_new and sync_cases.same_members(tkey, tspace, p_tkey,
                                                      p_tspace)
    del p_tkey, p_tspace
    n = len(keys)
    v = int(valid.sum())
    cap = len(tspace)
    starts = sk.start_pos(keys[valid], spaces[valid], cap)
    new_slots = torch.nonzero((tspace >= 0) & (tspace0 < 0)).flatten()
    n_bytes = (n + v * 36 + space_sectors(starts) + n_new * 32 +
               space_sectors(new_slots))
    # a floor of the insert's key stores: torch's scatter of the new keys
    # to the slots the kernel gave them, on a scratch table
    new_keys, scratch = tkey[new_slots].clone(), tkey0.clone()
    key_scatter_ms = time_ms(
        lambda: scratch.index_copy_(0, new_slots, new_keys), reps=20)
    del starts, new_slots, new_keys, scratch
    # both probes find every key the kernel placed
    missed = 0
    for probe in (sk.hashindex_probe, sk.hashindex_probe_plain):
        missed += int((probe(tkey, tspace, keys, spaces, valid) !=
                       valid).sum())
    times = {}
    for tag, mod in turns_of(sk, baseline):
        def insert():
            return mod.hashindex_insert(tkey, tspace, keys, spaces, valid,
                                        **kw)
        times.setdefault(tag + 'ms', []).append(
            time_restored(insert, restore))
        times.setdefault(tag + 'clean_ms', []).append(
            time_restored(insert, restore, flush=clean))
    out['hashindex_insert'] = dict(
        shape=f'{n} rows ({v} valid, {n_new} new) into {len(tspace)} slots '
              f'({int((tspace0 >= 0).sum())} in use)',
        max_abs_err=abs(n_new - p_new) + (0 if same else 1) + missed,
        **{k: statistics.median(t) for k, t in times.items()},
        key_scatter_ms=key_scatter_ms,
        plain_ms=time_restored(lambda: sk.hashindex_insert_plain(
            tkey, tspace, keys, spaces, valid), restore, reps=3),
        **bound_of(n_bytes, v * 16))

    (tkey, tspace, keys, spaces, valid), kw = inputs['hashindex_probe']
    got = sk.hashindex_probe(tkey, tspace, keys, spaces, valid, **kw)
    want = sk.hashindex_probe_plain(tkey, tspace, keys, spaces, valid, **kw)
    n = len(keys)
    v = int(valid.sum())
    found = int(got.sum())
    starts = sk.start_pos(keys[valid], spaces[valid], len(tspace))
    found_keys = len(torch.unique(
        torch.cat([spaces[got].view(-1, 1), keys[got]], dim=1), dim=0))
    n_bytes = n * 2 + v * 36 + space_sectors(starts) + found_keys * 32
    del starts
    times = {}
    for tag, mod in turns_of(sk, baseline) * PROBE_ROUNDS:
        def probe():
            return mod.hashindex_probe(tkey, tspace, keys, spaces, valid,
                                       **kw)
        times.setdefault(tag + 'ms', []).append(time_ms(probe))
        times.setdefault(tag + 'clean_ms', []).append(
            time_ms(probe, reps=20, flush=clean))
    out['hashindex_probe'] = dict(
        shape=f'{n} rows ({v} valid, {found} found) in {len(tspace)} slots '
              f'({int((tspace >= 0).sum())} in use)',
        max_abs_err=int((got != want).sum()),
        **{k: statistics.median(t) for k, t in times.items()},
        **{k.replace('ms', 'range'): [min(t), max(t)]
           for k, t in times.items()},
        plain_ms=time_ms(lambda: sk.hashindex_probe_plain(
            tkey, tspace, keys, spaces, valid, **kw), reps=3),
        **bound_of(n_bytes, v * 16))

    del buf
    for name, nums in out.items():
        log(f'{name} at the sync path\'s shape, {nums["shape"]}: ' +
            ', '.join(f'{key} {val:.4f}' if isinstance(val, float) else
                      f'{key} {val}' for key, val in nums.items()
                      if key != 'shape'))
        if nums['max_abs_err']:
            fail(f'{name} != plain at the sync path\'s shape '
                 f'(max abs err {nums["max_abs_err"]})')
    return out


# The JAX package's XLA kernels that the port runs as torch ops and no
# main path times on its own: (module, name, JAX kernel).
TORCH_OPS = (
    ('apply', 'zero_doc_rows_donated',
     'automerge_tpu/fleet/apply.py:226 _zero_doc_rows_impl'),
    ('registers', 'zero_register_rows_donated',
     'automerge_tpu/fleet/registers.py:232 _zero_register_rows_impl'),
    ('registers', 'visible_registers',
     'automerge_tpu/fleet/registers.py:247 _visible_registers_impl'),
    ('bloom', '_build_varsize', 'automerge_tpu/fleet/bloom.py:162'),
    ('bloom', '_probe_varsize', 'automerge_tpu/fleet/bloom.py:171'),
    ('hashindex', '_compare',
     'automerge_tpu/fleet/hashindex.py:311 _compare_kernel'),
    ('backend', 'DocFleet._remap_reg_actors',
     'automerge_tpu/fleet/backend.py inline jnp (register lane '
     'permutation)'),
)


class CallCounter:
    """While on, counts the calls of each TORCH_OPS function (each call
    is one or more torch launches), through the module attribute every
    caller looks up at call time."""

    def __init__(self):
        self.calls = {name: 0 for _mod, name, _src in TORCH_OPS}
        self._real = {}

    def __enter__(self):
        import importlib
        for mod, name, _src in TORCH_OPS:
            owner = importlib.import_module(
                f'automerge_tpu_torch.fleet.{mod}')
            *outer, attr = name.split('.')
            for part in outer:          # a method: patch its class
                owner = getattr(owner, part)
            real = getattr(owner, attr)
            self._real[(owner, attr)] = real
            setattr(owner, attr, self._wrap(name, real))
        return self

    def __exit__(self, *exc):
        for (owner, attr), real in self._real.items():
            setattr(owner, attr, real)

    def _wrap(self, name, real):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return real(*args, **kwargs)
        return call


FREED_DOCS = 1_000      # a 10 % churn of the seam's 10,000 docs


def torch_op_numbers(grid_shape, reg_shape, sync_bloom, calls):
    """Each TORCH_OPS function timed (device ms, queued behind a sleep,
    L2 warm) at the shapes its path uses, beside its byte bound and its
    calls on the main paths (`calls`, from a CallCounter): the two row
    zeroings freeing FREED_DOCS docs of the seam's grids and of the
    exact seam's register state; the register read on that state, and
    its lane permutation after a new actor sorts first (every lane moves
    up one; the four lane arrays read and written); the
    uniform Bloom pair on the sync path's 131,072 x 8 lanes (one 80-bit
    filter per row, as `build_bloom_filters` lays them); the frontier
    compare on as many rows as the sync hub has links, pow2-padded.
    Bytes: each input read once, each output written once (the zeroed
    rows written once)."""
    import numpy as np
    import torch
    import types
    from automerge_tpu_torch.fleet import apply, bloom, hashindex, registers
    from automerge_tpu_torch.fleet.backend import DocFleet
    from automerge_tpu_torch.fleet.registers import RegisterState
    from automerge_tpu_torch.fleet.tensor_doc import FleetState
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(7)
    out = {}
    n, k1 = grid_shape
    idx = torch.arange(0, n, n // FREED_DOCS, device=dev)[:FREED_DOCS]
    grids = FleetState.empty(n, k1 - 1, dev)
    out['zero_doc_rows_donated'] = (
        time_ms(lambda: apply.zero_doc_rows_donated(grids, idx)),
        bound_of(FREED_DOCS * (8 + 3 * k1 * 4), 0),
        f'{FREED_DOCS} of [{n}, {k1}] x3 int32')
    del grids
    rn, rk1, a = reg_shape
    state = RegisterState.empty(rn, rk1 - 1, a, dev)
    cell = 4 + 1 + 4 + 4                      # reg, killed, value, counter
    out['zero_register_rows_donated'] = (
        time_ms(lambda: registers.zero_register_rows_donated(state, idx)),
        bound_of(FREED_DOCS * (8 + rk1 * a * cell + 1), 0),
        f'{FREED_DOCS} of [{rn}, {rk1}, {a}]')
    out['visible_registers'] = (
        time_ms(lambda: registers.visible_registers(state), reps=10),
        bound_of(rn * rk1 * (a * (4 + 1 + 1) + 4 + 4), rn * rk1 * a * 6),
        f'[{rn}, {rk1}, {a}]')
    move, renum = DocFleet._lane_permutation(
        types.SimpleNamespace(device=dev), np.arange(1, a), a)
    out['DocFleet._remap_reg_actors'] = (
        time_ms(lambda: (renum(move(state.reg, 0)),
                         move(state.killed, False), move(state.value, 0),
                         move(state.counter, 0)), reps=5),
        bound_of(rn * rk1 * a * cell * 2, rn * rk1 * a * 8),
        f'[{rn}, {rk1}, {a}]')
    del state
    words, valid, _row_bits, _bit_off, _total = sync_bloom
    r, h = valid.shape
    b = bloom.num_filter_bits(h)
    row_bits = torch.full((r,), b, dtype=torch.int64, device=dev)
    init = torch.zeros((r, b), dtype=torch.bool, device=dev)
    v = int(valid.sum())
    bits = bloom._build_varsize(words, valid, row_bits, init)
    out['_build_varsize'] = (
        time_ms(lambda: bloom._build_varsize(words, valid, row_bits, init),
                reps=10),
        bound_of(r * h + v * 12 + r * 8 + r * b, v * 22),
        f'{r} rows x {h} lanes ({v} valid) -> [{r}, {b}] bool')
    out['_probe_varsize'] = (
        time_ms(lambda: bloom._probe_varsize(bits, row_bits, words, valid),
                reps=10),
        bound_of(r * h * 2 + v * 12 + r * 8 + r * b, v * 22),
        f'{r} rows x {h} lanes ({v} valid) over [{r}, {b}] bool')
    del bits, init
    k = 1 << (LINKS - 1).bit_length()
    cur = torch.from_numpy(rng.integers(0, 256, (k, 32), dtype=np.uint8))
    cols = (cur.to(dev), torch.ones(k, dtype=torch.int32, device=dev),
            cur.to(dev), torch.ones(k, dtype=torch.int32, device=dev))
    out['_compare'] = (
        time_ms(lambda: hashindex._compare(*cols)),
        bound_of(k * (32 * 2 + 4 * 2 + 1), k * 40),
        f'{k} rows')
    nums = {}
    for mod, name, src in TORCH_OPS:
        ms, bound, shape = out[name]
        nums[name] = dict(ms=ms, calls=calls[name], replaces=src,
                          shape=shape, **bound)
        log(f'torch op {mod}.{name} ({src}) at {shape}: {ms:.4f} ms, '
            f'bound {bound["bound_ms"]:.4f} ms ({bound["bound_by"]}, '
            f'{bound["bytes"]} B), calls on the main paths {calls[name]}')
    return nums


def register_bound(state0, ops):
    """The least bytes and operations the register scan needs on one
    batch: every lane's kind and overflow flag; each live lane's key,
    packed id, value and D preds; reg and killed (5 B) read from every
    distinct cell a live op reads (its own actor slot and its non-zero
    preds' slots); the four arrays (13 B) written at every distinct cell
    a set writes; the inexact flags read and written once. Operations:
    ~(10 + 6 D) integer operations per live lane."""
    import torch
    n, k1, a = state0.reg.shape
    p, d = ops.preds.shape[1:]
    live = ops.kind != 0
    doc = torch.arange(n, device=ops.kind.device).view(-1, 1).expand(n, p)
    row = (doc * k1 + ops.key_id.long())[live]
    slot = (ops.packed & 255).long()
    own = (row * a + slot[live])[slot[live] < a]
    pred_slot = (ops.preds & 255).long()
    pred_live = live.unsqueeze(-1) & (ops.preds != 0) & (pred_slot < a)
    pred_cells = ((doc * k1 + ops.key_id.long()).unsqueeze(-1) * a +
                  pred_slot)[pred_live]
    read_cells = int(torch.unique(torch.cat([own, pred_cells])).numel())
    sets = live & (ops.kind == 1) & (slot < a)
    set_cells = int(torch.unique(((doc * k1 + ops.key_id.long()) * a +
                                  slot)[sets]).numel())
    n_live = int(live.sum())
    n_bytes = (n * p * 5 + n_live * (12 + 4 * d) + read_cells * 5 +
               set_cells * 13 + n * 2)
    return bound_of(n_bytes, n_live * (10 + 6 * d))


def register_rounds(state0, ops):
    """The rounds the kernel's busiest warp runs on a batch, summed over
    its tiles (`register_kernel.tile_ranks`), and the tiles."""
    from automerge_tpu_torch.fleet import register_kernel as rk
    p, k1 = ops.kind.shape[1], state0.reg.shape[1]
    w = 1 << rk._segment_shift(p)
    ok = (ops.kind != 0) & (ops.key_id >= 0) & (ops.key_id < k1)
    rounds = 0
    for t in range(0, p, w):
        tile = ok[:, t:t + w]
        if tile.any():
            rank = rk.tile_ranks(ops.key_id[:, t:t + w], tile)
            rounds += int(rank[tile].max()) + 1
    return rounds, (p + w - 1) // w


REGISTER_TIMES = ('ms', 'clean_ms', 'queued_ms', 'base_ms', 'base_clean_ms',
                  'base_queued_ms')


def register_numbers(saved, baseline=None):
    """The register scan on every batch the exact seam and the exact text
    seam handed it (`saved`: (path, state before the call, batch)), in
    full: through the kernel and through its plain version, each on its
    own copy of the state, all five arrays and the lane count equal.
    Then timed on each batch (device ms; launches queued behind a sleep,
    each on the touched rows restored from the recording first, off the
    clock: L2 warm, and after a clean L2 eviction that leaves no dirty
    line, clean_ms; and REPS launches queued back to back on the state as
    they leave it, queued_ms, which takes the event pair's fixed cost off
    each launch) beside its plain version (launched call by call from
    the host) and its bound (`register_bound`). With `baseline` (another
    checkout's register_kernel, e.g. the parent commit's) its
    register_scan is timed by the same methods in turns (baseline, this,
    this, baseline; base_*). No single PyTorch call computes the scan (library_ms null).
    Returns the numbers of the exact seam's first (largest) batch, with
    every batch's under 'batches'."""
    import torch
    from automerge_tpu_torch.fleet import register_kernel as rk
    from automerge_tpu_torch.fleet.registers import RegisterState
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=DEVICE)
    clean = clean_evictor(buf)
    out, worst = [], 0
    for b, (path, state0, ops) in enumerate(saved):
        n, k1, a = state0.reg.shape
        p, d = ops.preds.shape[1:]
        got = RegisterState(*(t.clone() for t in state0.tensors()))
        want = RegisterState(*(t.clone() for t in state0.tensors()))
        err = abs(int(rk.register_scan(got, ops)) -
                  int(rk.register_scan_plain(want, ops)))
        for x, y in zip(got.tensors(), want.tensors()):
            err = max(err, int((x.long() - y.long()).abs().max()))
        del want
        if err:
            fail(f'register_scan != plain on the {path}\'s batch {b} (max '
                 f'abs err {err})')
        worst = max(worst, err)
        live = ops.kind != 0
        doc = torch.arange(n, device=ops.kind.device).view(-1, 1)
        rows = torch.unique((doc * k1 + ops.key_id.long())[live])
        snaps = [t.view(-1, a)[rows].clone() for t in state0.tensors()[:4]]

        def restore():
            for t, snap in zip(got.tensors()[:4], snaps):
                t.view(-1, a)[rows] = snap
            got.inexact.copy_(state0.inexact)

        times = {}
        for tag, mod in turns_of(rk, baseline):
            def scan():
                return mod.register_scan(got, ops)
            times.setdefault(tag + 'ms', []).append(
                time_restored(scan, restore))
            times.setdefault(tag + 'clean_ms', []).append(
                time_restored(scan, restore, flush=clean))
            # back to back, without the restores: the same cells each time
            times.setdefault(tag + 'queued_ms', []).append(time_ms(scan))
        rounds, tiles = register_rounds(state0, ops)
        nums = dict(
            path=path, batch=b,
            shape=f'[{n}, {k1}, {a}] state, {p} lanes x {d} preds per doc '
                  f'({int(live.sum())} live)', max_abs_err=err,
            rounds=rounds, tiles=tiles,
            **{k: statistics.median(t) for k, t in times.items()},
            plain_ms=time_restored(lambda: rk.register_scan_plain(got, ops),
                                   restore, reps=3),
            **register_bound(state0, ops))
        if baseline is not None:
            nums['base_over_new'] = nums['base_ms'] / nums['ms']
        del got, snaps
        log(f'register_scan on the {path}\'s batch {b}, {nums["shape"]}: ' +
            ', '.join(f'{key} {val:.4f}' if isinstance(val, float) else
                      f'{key} {val}' for key, val in nums.items()
                      if key not in ('shape', 'path', 'batch')) +
            (f'; turns {times}' if baseline is not None else ''))
        out.append(nums)
    del buf
    return dict(out[0], max_abs_err=worst, batches=out)


def exact_breakdown(batches):
    """One traced exact seam run (its first batch, as the timed reps):
    seconds per seam phase, and the device's busy time against the run's
    wall time."""
    split = {}
    wall, phases, rows = traced(lambda: run_exact_seam(batches[:1], split))
    order = ('turbo_setup', 'turbo_parse', 'turbo_gate', 'turbo_commit',
             'turbo_stage', 'turbo_dispatch', 'python_gc')
    log(f'breakdown, exact seam (traced run, first batch, wall '
        f'{wall * 1e3:.1f} ms): init_docs {split["init_s"] * 1e3:.1f} ms, '
        f'apply {split["apply_s"] * 1e3:.1f} ms; ' +
        ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms'
                  for name in order))
    device_line(wall, rows)


def seq_bound(state0, ops, got):
    """The least bytes and operations the scan needs on one batch, as
    {bound_ms, bytes, ops, bound_by, ...}: every lane's kind and flag;
    each live lane's ref, packed id, value and D preds; the elem_id of
    every slot allocated before the call (read to resolve the refs); the
    older cells the ops name (an insert's referent's nxt; an update's
    target lanes of reg, killed and counter); every array element the
    launch changes (`got` against `state0`), written once. Cells the
    launch writes before it reads them are not read from memory.
    Operations: ~30 integer operations per live op."""
    import torch
    from automerge_tpu_torch.fleet import seq_kernel as sk
    r, nodes, a = state0.reg.shape
    p, d = ops.preds.shape[1:]
    live = ops.kind != 0
    n_live = int(live.sum())
    written = sum(int((x != y).sum()) * x.element_size()
                  for x, y in zip(got.tensors(), state0.tensors()))
    # the older cells the ops name: ref 0 (the head) or an elem_id the row
    # held before the call
    held = state0.elem_id.sort(dim=1).values
    at = torch.searchsorted(held, ops.ref).clamp(max=nodes - 1)
    older = live & ((ops.ref == 0) |
                    (held.gather(1, at) == ops.ref))
    del held, at
    row = torch.arange(r, device=ops.kind.device).view(-1, 1).expand(r, p)
    cell = row.long() << 32 | (ops.ref.long() & 0xFFFFFFFF)
    ins = older & (ops.kind == sk.INSERT)
    upd = older & (ops.kind != sk.INSERT) & (ops.ref != 0)
    named = (int(torch.unique(cell[ins]).numel()) * 4 +
             int(torch.unique(cell[upd]).numel()) * 9 * a)
    touched = live.any(dim=1)
    index_bytes = 4 * int(state0.n[touched].long().sum())
    n_bytes = r * p * 5 + n_live * (12 + 4 * d) + index_bytes + named + \
        written
    return dict(bound_of(n_bytes, n_live * 30), written_bytes=written,
                index_bytes=index_bytes, named_bytes=named,
                touched_rows=int(touched.sum()))


def seq_numbers(saved, pools, baseline=None):
    """The sequence scan on every batch the text seam handed it (each
    recorded with the state before the call), in full: all rows and all
    op columns through the kernel and through its plain version, each on
    its own copy of the state, equal in all eight arrays and the applied
    count; the plain version's time is taken there (host-issued, one
    run), and the kernel's route and serial rows are read. Then the
    kernel is timed on each batch (device ms; launches queued behind a
    sleep, each on the state restored from the recording first, off the
    clock: L2 warm, and with the L2 flushed after the restore) beside its
    bound (`seq_bound`) and that batch's plain time; with `baseline`
    (another checkout's seq_kernel, e.g. the parent commit's) its
    seq_scan is timed on the same batches by the same method, in turns
    (baseline, this, this, baseline). No single PyTorch call computes
    the scan (library_ms null). Then the torch-op linearize and
    materialize on each of the path's size classes, beside their byte
    bounds. Returns the first (largest) batch's numbers, with every
    batch's under 'batches'."""
    import torch
    from automerge_tpu_torch.fleet import seq_kernel as sk
    from automerge_tpu_torch.fleet.sequence import (SeqState, linearize,
                                                    materialize)

    def copy(state):
        return SeqState(*(t.clone() for t in state.tensors()))

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                        device=saved[0][1].kind.device)
    err, out = 0, []
    for b, (state0, ops) in enumerate(saved):
        r, nodes, a = state0.reg.shape
        p, d = ops.preds.shape[1:]
        plan = sk._launch_plan(r, nodes, a, p, d)
        got, want = copy(state0), copy(state0)
        stats = sk._launch(got, ops, plan)
        n_got, serial = int(stats[0]), int(stats[1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        n_want = sk.seq_scan_plain(want, ops)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        e = abs(n_got - int(n_want))
        for x, y in zip(got.tensors(), want.tensors()):
            e = max(e, int((x.long() - y.long()).abs().max()))
        del want
        n_live = int((ops.kind != 0).sum())
        log(f'seq_scan == plain on the text seam\'s batch {b}: '
            f'{list(state0.reg.shape)} state, {list(ops.preds.shape)} '
            f'lanes x preds ({n_live} live, applied {n_got}; {plan.route} '
            f'route, {serial} rows serial): max abs err {e}, plain '
            f'{plain_ms:.4f} ms')
        if e:
            fail(f'seq_scan != plain on the text seam\'s batch {b} (max abs '
                 f'err {e})')
        err = max(err, e)
        bound = seq_bound(state0, ops, got)

        def restore():
            for t, t0 in zip(got.tensors(), state0.tensors()):
                t.copy_(t0)

        times = {}
        for tag, mod in turns_of(sk, baseline):
            times.setdefault(tag + 'ms', []).append(time_restored(
                lambda: mod.seq_scan(got, ops), restore, reps=5))
            times.setdefault(tag + 'cold_ms', []).append(time_restored(
                lambda: mod.seq_scan(got, ops), restore, reps=5,
                flush=flush))
        nums = dict(
            batch=b, shape=f'[{r}, {nodes}, {a}] state, {p} lanes x {d} '
            f'preds per row ({n_live} live)', route=plan.route,
            serial_rows=serial, ctas_per_sm=plan.ctas_per_sm,
            smem_bytes=plan.smem_bytes, applied=n_got, max_abs_err=e,
            plain_ms=plain_ms,
            **{k: statistics.median(v) for k, v in times.items()},
            **bound)
        if baseline is not None:
            nums['base_over_new'] = nums['base_ms'] / nums['ms']
        del got
        log(f'seq_scan on the text seam\'s batch {b}, {nums["shape"]}: ' +
            ', '.join(f'{key} {val:.4f}' if isinstance(val, float) else
                      f'{key} {val}' for key, val in nums.items()
                      if key not in ('shape', 'batch')) +
            (f'; turns {times}' if baseline is not None else ''))
        out.append(nums)
    del flush
    for cls, st in sorted(pools.items()):
        r, nodes, a = st.reg.shape
        lin = bound_of(r * nodes * 8 + r * 4, r * nodes * 4)
        mat = bound_of(r * nodes * 4 + r * nodes * a * 13 +
                       r * (nodes - 3) * 9 + r * 4, r * nodes * a * 4)
        log(f'torch ops on class {cls} [{r}, {nodes}, {a}]: linearize '
            f'{time_ms(lambda: linearize(st), reps=5):.4f} ms (bound '
            f'{lin["bound_ms"]:.4f} ms, {lin["bound_by"]}, {lin["bytes"]} '
            f'B), materialize {time_ms(lambda: materialize(st), reps=5):.4f}'
            f' ms (bound {mat["bound_ms"]:.4f} ms, {mat["bound_by"]}, '
            f'{mat["bytes"]} B)')
    first = dict(out[0], max_abs_err=err, batches=out)
    return first


def text_breakdown(batches):
    """One traced text seam run (its three batches): seconds per seam
    phase, and the device's busy time against the run's wall time."""
    split = {}
    wall, phases, rows = traced(lambda: run_text_seam(batches, split=split))
    order = ('turbo_setup', 'turbo_parse', 'turbo_gate', 'turbo_commit',
             'turbo_stage', 'turbo_dispatch', 'dispatch_seq', 'python_gc')
    log(f'breakdown, text seam (traced run, wall {wall * 1e3:.1f} ms): '
        f'init_docs {split["init_s"] * 1e3:.1f} ms, apply '
        f'{split["apply_s"] * 1e3:.1f} ms; ' +
        ', '.join(f'{name} {phases.get(name, 0) * 1e3:.1f} ms'
                  for name in order))
    device_line(wall, rows)


def load_baseline(path):
    """The merge, register, sequence and sync kernel modules of another
    checkout of this repository (e.g. the parent commit, unpacked with
    `git archive`), as {'merge', 'reg', 'seq', 'sync'}. Its package is
    loaded under a name of its own (`baseline_port`), so its imports
    resolve inside that checkout, and it builds its own kernel sources
    there."""
    import importlib
    import importlib.util
    pkg = os.path.join(path, 'automerge_tpu_torch')
    if not os.path.exists(os.path.join(pkg, 'fleet', 'merge_kernel.py')):
        fail(f'--baseline: no automerge_tpu_torch/fleet/merge_kernel.py '
             f'under {path}')
    spec = importlib.util.spec_from_file_location(
        'baseline_port', os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules['baseline_port'] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f'baseline_port.fleet.{module}')
            for name, module in (('merge', 'merge_kernel'),
                                 ('reg', 'register_kernel'),
                                 ('seq', 'seq_kernel'),
                                 ('sync', 'sync_kernels'))}


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
                      'parent commit) whose merge, register scan, sequence, '
                      'Bloom build and hash-index wrappers phase 4 times '
                      'beside this one, by the same methods')
    args = args.parse_args()
    baseline = load_baseline(args.baseline) if args.baseline else None
    base = baseline or {}
    t_start = time.perf_counter()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    phase_s = {}

    def lap(name, t0):
        phase_s[name] = time.perf_counter() - t0
        return time.perf_counter()
    build_all(baseline)
    t0 = lap('build', t_start)
    max_err = kernel_vs_plain()
    t0 = lap('merge vs plain', t0)
    sync_kernel_vs_plain()
    t0 = lap('sync kernels vs plain', t0)
    reg_err = register_kernel_vs_plain()
    t0 = lap('register scan vs plain', t0)
    seq_err = seq_kernel_vs_plain()
    lap('sequence scan vs plain', t0)
    with CallCounter() as counter, InlineRecorder() as inline_all:
        t0 = time.perf_counter()
        launches, grid_bytes, grid_shape, per_doc, seam_handles = \
            main_path()
        pipelined_path(per_doc, seam_handles)
        del seam_handles
        t0 = lap('seam and pipelined seam', t0)
        reg_launches, reg_saved, exact_batches = exact_path(per_doc)
        t0 = lap('exact seam', t0)
        text_launches, seq_input, seq_pools, text_batches, text_reg_saved = \
            text_path()
        t0 = lap('text seam', t0)
        load_launches, load_nums = load_path()
        t0 = lap('load', t0)
        api_launches, api_checks, api_nums = api_path()
        t0 = lap('api', t0)
        query_launches, query_checks, query_nums = query_path()
        t0 = lap('query', t0)
        service_launches, service_checks, service_nums = service_path()
        t0 = lap('service', t0)
        shard_launches, shard_checks, shard_nums = shard_path()
        gc.collect()
        t0 = lap('shard', t0)
        # the storage path before the sync hub: its legs then run without
        # the hub's 100,000 links alive, which each collector pass walks
        storage_launches, storage_checks, storage_nums, inline_events = \
            storage_path(per_doc)
        t0 = lap('storage', t0)
        sync = sync_path()
        t0 = lap('sync', t0)
    nums = kernel_numbers(grid_shape, base.get('merge'))
    sync_inputs = sync.pop('inputs')
    sync_nums = sync_kernel_numbers(sync_inputs, base.get('sync'))
    reg_input = [('exact seam', *saved) for saved in reg_saved] + \
        [('exact text seam', *saved) for saved in text_reg_saved]
    del reg_saved, text_reg_saved
    reg_nums = register_numbers(reg_input, base.get('reg'))
    torch_op_numbers(grid_shape, tuple(reg_input[0][1].reg.shape),
                     sync_inputs['bloom_build'][0], counter.calls)
    del reg_input, sync_inputs
    storage_nums['inline'] = inline_numbers(inline_events,
                                            inline_all.events, grid_shape)
    log(f'storage numbers: {json.dumps(storage_nums)}')
    log(f'api numbers: {json.dumps(dict(api_nums, launches=api_launches))}')
    log(f'query numbers: '
        f'{json.dumps(dict(query_nums, launches=query_launches))}')
    log(f'service numbers: '
        f'{json.dumps(dict(service_nums, launches=service_launches))}')
    log(f'shard numbers: '
        f'{json.dumps(dict(shard_nums, launches=shard_launches))}')
    seq_nums = seq_numbers(seq_input, seq_pools, base.get('seq'))
    del seq_input, seq_pools
    breakdown(per_doc)
    breakdown(per_doc, 'pipelined')
    exact_breakdown(exact_batches)
    text_breakdown(text_batches)
    sync_breakdown(sync)
    load_breakdown(load_nums)
    lap('numbers and breakdowns', t0)
    log(f'load path launches: {load_launches}')
    log(f'grid bytes: {grid_bytes}')
    log('phase seconds: ' + ', '.join(f'{name} {sec:.1f}'
                                      for name, sec in phase_s.items()))
    log(f'wall: {time.perf_counter() - t_start:.1f} s')
    log(card_line())
    main_nums = nums['noinc_fresh']
    kernels = [{
        'name': 'lww_merge', 'route': 'cuda',
        'source': 'automerge_tpu_torch/fleet/csrc/lww_merge.cu',
        'replaces': 'automerge_tpu/fleet/pallas_merge.py:198',
        'launches': launches['lww_merge'],
        'max_abs_err': max_err,
        'ms': main_nums['ms'], 'plain_ms': main_nums['plain_ms'],
        'bound_ms': main_nums['bound_ms'],
        'bound_by': main_nums['bound_by'],
        'library_ms': None}]
    for name, (source, replaces) in SYNC_KERNELS.items():
        k = sync_nums[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': sync['launches'][name],
            'max_abs_err': k['max_abs_err'],
            'ms': k['ms'], 'plain_ms': k['plain_ms'],
            'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
            'library_ms': None,
            **{key: k[key] for key in ('cold_ms', 'clean_ms', 'base_ms',
                                       'base_cold_ms', 'base_clean_ms',
                                       'zero_ms')
               if key in k}})
    kernels.append({
        'name': 'register_scan', 'route': 'cuda',
        'source': 'automerge_tpu_torch/fleet/csrc/registers.cu',
        'replaces': 'automerge_tpu/fleet/registers.py:207',
        'launches': reg_launches['register_scan'],
        'max_abs_err': max(reg_err, reg_nums['max_abs_err']),
        'ms': reg_nums['ms'], 'plain_ms': reg_nums['plain_ms'],
        'bound_ms': reg_nums['bound_ms'], 'bound_by': reg_nums['bound_by'],
        'library_ms': None,
        **{key: reg_nums[key] for key in REGISTER_TIMES if key in reg_nums},
        'batches': [{key: nums[key] for key in
                     ('path', 'shape', 'rounds', 'plain_ms', 'bound_ms') +
                     REGISTER_TIMES if key in nums}
                    for nums in reg_nums['batches']]})
    kernels.append({
        'name': 'seq_scan', 'route': 'cuda',
        'source': 'automerge_tpu_torch/fleet/csrc/sequence.cu',
        'replaces': 'automerge_tpu/fleet/sequence.py:436',
        'launches': text_launches['seq_scan'],
        'max_abs_err': max(seq_err, seq_nums['max_abs_err']),
        'ms': seq_nums['ms'], 'plain_ms': seq_nums['plain_ms'],
        'bound_ms': seq_nums['bound_ms'], 'bound_by': seq_nums['bound_by'],
        'library_ms': None,
        'routes': {route: n for route, n in
                   text_launches['seq_scan_routes'].items() if n},
        'batches': [{key: nums[key] for key in
                     ('shape', 'route', 'serial_rows', 'ms', 'cold_ms',
                      'plain_ms', 'bound_ms', 'base_ms', 'base_cold_ms')
                     if key in nums} for nums in seq_nums['batches']]})
    for entry in kernels:
        name = entry['name']
        entry['storage_launches'] = storage_launches[name]
        entry['storage_checked'] = storage_checks['checked'][name]
        entry['storage_max_abs_err'] = storage_checks['worst'][name]
        entry['api_launches'] = api_launches[name]
        entry['api_checked'] = api_checks['checked'][name]
        entry['query_launches'] = query_launches[name]
        entry['query_checked'] = query_checks['checked'][name]
        entry['service_launches'] = service_launches[name]
        entry['service_checked'] = service_checks['checked'][name]
        entry['shard_launches'] = shard_launches[name]
        entry['shard_checked'] = shard_checks['checked'][name]
        entry['max_abs_err'] = max(entry['max_abs_err'],
                                   api_checks['worst'][name],
                                   query_checks['worst'][name],
                                   service_checks['worst'][name],
                                   shard_checks['worst'][name])
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
