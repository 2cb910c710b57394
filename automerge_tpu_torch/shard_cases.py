"""The shard and tier legs of the load generator (the port's copy of the
shard and storage-tier legs of tools/loadgen.py).

`_ShardWriter`, `run_shard_leg`, `run_tier_leg` and `run_tier_kill_leg`
are copies with their imports re-pointed at this package. The
differences: each takes `device=` (the leg's fleets run on the card
unless the caller asks otherwise; `run_tier_kill_leg`'s child process
builds its fleet there too), and `run_shard_leg` takes an `audit=` hook
that gets the router and every tenant's acked change bytes after the
final audit (chip_smoke.py reads the card's home and replica rows
there). The service legs are in service_cases.py.
"""

import os
import random
import sys
import time

from . import backend as host_backend
from .backend import get_change_by_hash
from .columnar import decode_change_meta, encode_change
from .control import Controller
from .errors import AutomergeError
from .fleet import backend as fleet_backend
from .fleet.backend import DocFleet
from .fleet.faults import LossyLink
from .service import Backoff
from .shard import ShardRouter, shard_stats

__all__ = ['run_shard_leg', 'run_tier_leg', 'run_tier_kill_leg']

class _ShardWriter:
    """One tenant's write stream in shard mode: seq-consecutive changes
    from one actor, at most one apply in flight (seq ordering survives
    router-level retries), failed payloads RETRANSMITTED byte-identical
    (a re-minted seq with fresh content would collide with a copy the
    crash actually preserved — idempotent-by-hash replay is the safe
    retry)."""

    __slots__ = ('name', 'actor', 'seq', 'acked', 'inflight', 'stash')

    def __init__(self, name, actor):
        self.name = name
        self.actor = actor
        self.seq = 0
        self.acked = []          # payloads whose router tickets acked
        self.inflight = None     # (ticket, payload)
        self.stash = None        # failed payload awaiting retransmit

    def next_payload(self, rng):
        if self.stash is not None:
            payload, self.stash = self.stash, None
            return payload
        self.seq += 1
        return [encode_change({
            'actor': self.actor, 'seq': self.seq, 'startOp': self.seq,
            'time': 0, 'message': '', 'deps': [],
            'ops': [{'action': 'set', 'obj': '_root',
                     'key': f'k{rng.randrange(8)}',
                     'value': rng.randrange(10_000), 'datatype': 'int',
                     'pred': []}]})]


def run_shard_leg(name, *, n_shards=4, tenants=16, requests=800,
                  arrivals_per_tick=8, kills=(), chaos=False, seed=0,
                  lease_ticks=3, tick_dt=0.02, subscribe_fraction=0.2,
                  sync_fraction=0.1, rebalance_after_revive=True,
                  audit_rounds=True, exact_device=False,
                  link_budget=48, max_ticks=60_000, mttr_bound=None,
                  service_kwargs=None, pump_threads=None, repl_every=1,
                  pace=False, control=None, control_window=5,
                  settle_bound=None, device=None, audit=None):
    """The kill-and-recover chaos leg for the shard cluster (ISSUE-11).

    The port's keywords: `device` is where every shard's fleet lives
    (CUDA unless the caller asks otherwise). `audit(router, acked)`,
    when given, is called after the final audit with the router and,
    per tenant name, the change bytes of every acked apply in order;
    what it returns lands in the report as `audit`.

    Drives an open-loop workload (applies + subscription pulls + sync
    solicits) through a ``ShardRouter`` while crashing and reviving
    shards on a schedule: ``kills`` is a sequence of
    ``(kill_tick, shard_index, revive_tick)``. With ``chaos=True`` the
    inter-shard replication links are budgeted ``LossyLink``s
    (drop/dup/reorder/truncate/flip), so replication itself rides a
    hostile wire; the budget runs dry before the drain, which is what
    makes the post-quiet audit assertable.

    The two contract audits (run after each revive round when
    ``audit_rounds``, and always at the end):

    - ZERO ACKNOWLEDGED-WRITE LOSS: every change of every acked apply
      is present (by hash) on the tenant's CURRENT home doc — across
      every kill, failover, and rebalance in the schedule.
    - BYTE-IDENTICAL CONVERGENCE: after replication goes quiet, every
      tenant's home doc and replica doc save() to identical bytes.

    Plus the standing properties: zero untyped escapes (every failed
    ticket carries an AutomergeError), and failover MTTR — ticks from
    each kill to the first acked request served by a re-homed tenant's
    replica — reported per kill (``mttr_bound`` asserts a ceiling).

    ``control='active'|'shadow'`` rides a ``control.Controller`` on the
    router's pump (the self-driving leg, ISSUE-20): under ACTIVE
    control the leg's hardcoded ``rebalance_after_revive`` call is
    disabled — post-revive placement healing is exactly the control
    plane's heal lane, and this leg is where it earns that job. The
    leg's ``ok`` then also requires <= 2 direction reversals per policy
    (the anti-oscillation bound), a decision-free CONVERGENCE HOLD (10
    quiet decision windows pumped after the drain — an oscillating
    controller keeps hunting and fails it), and, with ``settle_bound``,
    that the last decision lands within that many ticks of the last
    revive. Both audits (zero acked-write loss, byte-identical
    convergence) run unchanged: a controller that converges by losing
    writes fails the same assert the chaos schedule does."""
    audit_hook = audit
    rng = random.Random(seed)
    clk = [0.0]
    link_seed = [seed * 7919 + 13]
    if control is not None and control not in ('active', 'shadow'):
        raise ValueError(f"control must be None, 'active' or 'shadow', "
                         f'got {control!r}')
    ctrl = Controller(mode=control, window=control_window) \
        if control is not None else None
    if control == 'active':
        # the heal lane owns post-revive placement now; the hardcoded
        # rebalance would fight it (and mask it)
        rebalance_after_revive = False

    def link_factory(src, dst):
        if not chaos:
            return None
        link_seed[0] += 1
        return LossyLink(seed=link_seed[0], p_drop=0.05, p_dup=0.02,
                         p_reorder=0.02, p_truncate=0.02, p_flip=0.02,
                         budget=link_budget)

    router = ShardRouter(
        n_shards=n_shards, clock=lambda: clk[0],
        lease_ticks=lease_ticks, link_factory=link_factory,
        exact_device=exact_device, service_kwargs=service_kwargs,
        pump_threads=pump_threads, repl_every=repl_every, device=device,
        # paced legs declare the cadence to the router too, so slipped
        # ticks are attributed PER SHARD (Shard.ticks_slipped -> the
        # labeled Prometheus counter), not just counted in this loop
        tick_budget_s=tick_dt if pace else None,
        control=ctrl,
        backoff=Backoff(base=tick_dt, factor=1.5, cap=tick_dt * 16,
                        retries=16, jitter=0.5, seed=seed + 3))
    shard_ids = router.ring.shard_ids()
    tenant_names = [f'tenant{t}' for t in range(tenants)]
    writers = {}
    for i, t in enumerate(tenant_names):
        router.open_tenant(t)
        writers[t] = _ShardWriter(t, f'{i % 192:08x}' + 'cd' * 12)

    counts = {'ok': 0}
    untyped = 0
    submitted = 0
    aux = []                    # subscribe/sync tickets in flight
    audits = []
    mttrs = []                  # one record per kill
    kill_list = sorted(kills)
    revive_pending = []         # (revive_tick, shard_id)
    last_revive_tick = None
    base_health = shard_stats()

    def pump():
        router.pump(now=clk[0])
        clk[0] += tick_dt

    def note_error(err):
        nonlocal untyped
        key = type(err).__name__
        counts[key] = counts.get(key, 0) + 1
        if not isinstance(err, AutomergeError):
            untyped += 1

    def harvest():
        for t, w in writers.items():
            if w.inflight is None:
                continue
            ticket, payload = w.inflight
            if not ticket.done:
                continue
            w.inflight = None
            if ticket.status == 'ok':
                counts['ok'] += 1
                w.acked.append(payload)
                for m in mttrs:
                    if m['mttr_ticks'] is None and t in m['tenants'] and \
                            router.tenant_record(t).home != m['shard']:
                        m['mttr_ticks'] = router.ticks - m['kill_tick']
            else:
                note_error(ticket.error)
                w.stash = payload        # retransmit the SAME bytes
        still = []
        for ticket in aux:
            if not ticket.done:
                still.append(ticket)
                continue
            if ticket.status == 'ok':
                counts['ok'] += 1
            else:
                note_error(ticket.error)
        aux[:] = still

    def writers_idle():
        return all(w.inflight is None for w in writers.values())

    def drain_quiet(budget=1200):
        for _ in range(budget):
            if router.idle() and router.replication_quiet() and \
                    not router.migrating() and writers_idle() and not aux:
                return True
            pump()
            harvest()
        return False

    def audit(tag):
        checked = lost = pairs = mismatched = homeless = 0
        for t, w in writers.items():
            rec = router.tenant_record(t)
            if rec.home is None or rec.session is None:
                homeless += 1
                continue
            for payload in w.acked:
                for b in payload:
                    checked += 1
                    h = decode_change_meta(bytes(b), True)['hash']
                    if get_change_by_hash(rec.session.handle, h) is None:
                        lost += 1
            if rec.replica_handle is not None:
                pairs += 1
                home_bytes = bytes(host_backend.save(rec.session.handle))
                rep_bytes = bytes(host_backend.save(rec.replica_handle))
                if home_bytes != rep_bytes:
                    mismatched += 1
        record = {'tag': tag, 'tick': router.ticks,
                  'acked_changes_checked': checked, 'acked_lost': lost,
                  'replica_pairs': pairs,
                  'replica_mismatches': mismatched,
                  'homeless_tenants': homeless}
        audits.append(record)
        return record

    start = time.perf_counter()
    slipped = 0
    while submitted < requests or not writers_idle() or aux or \
            kill_list or revive_pending:
        if router.ticks >= max_ticks:
            break
        if pace:
            # the serving tick is a CADENCE (tick_dt bounds batching
            # latency): sleep to the tick boundary, and when the tick's
            # work overran it, count the slip — a box whose per-tick
            # work does not fit the cadence shows it here instead of
            # silently reporting free-run throughput
            deadline = start + router.ticks * tick_dt
            wait = deadline - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                slipped += 1
        while kill_list and router.ticks >= kill_list[0][0]:
            ktick, sidx, rtick = kill_list.pop(0)
            sid = shard_ids[sidx]
            doomed = set(router.tenants_on(sid))
            router.kill_shard(sid)
            mttrs.append({'shard': sid, 'kill_tick': router.ticks,
                          'tenants': doomed, 'mttr_ticks': None})
            revive_pending.append((rtick, sid))
        for rtick, sid in list(revive_pending):
            if router.ticks >= rtick:
                revive_pending.remove((rtick, sid))
                router.revive_shard(sid)
                last_revive_tick = router.ticks
                if rebalance_after_revive:
                    router.rebalance()
                if audit_rounds:
                    # one recovery round settles: arrivals pause, the
                    # cluster drains to quiet, both audits run, then
                    # the workload resumes against the healed topology
                    drain_quiet()
                    audit(f'post-revive-{sid}')
        n_arrive = min(arrivals_per_tick, requests - submitted)
        for _ in range(max(0, n_arrive)):
            t = tenant_names[rng.randrange(tenants)]
            w = writers[t]
            roll = rng.random()
            if roll < subscribe_fraction:
                aux.append(router.submit(t, 'subscribe'))
                submitted += 1
            elif roll < subscribe_fraction + sync_fraction:
                aux.append(router.submit(t, 'sync', None))
                submitted += 1
            else:
                if w.inflight is not None:
                    continue             # writer busy: seq order first
                payload = w.next_payload(rng)
                ticket = router.submit(t, 'apply', payload)
                w.inflight = (ticket, payload)
                submitted += 1
        pump()
        harvest()
    drained = drain_quiet(budget=2400)
    fixed_point = None
    if ctrl is not None:
        # the convergence hold: pump 10 quiet decision windows with no
        # arrivals — a converged controller makes ZERO further
        # decisions (an oscillating one keeps hunting and fails here)
        before = len(ctrl.decision_log())
        for _ in range(10 * control_window):
            pump()
        harvest()
        fixed_point = len(ctrl.decision_log()) == before
    elapsed = time.perf_counter() - start   # serving window: audits are
    final = audit('final')                  # verification, not serving
    audit_result = None
    if audit_hook is not None:
        audit_result = audit_hook(router, {
            t: [b for payload in w.acked for b in payload]
            for t, w in writers.items()})

    health = shard_stats()
    link_stats = {}
    for (src, dst), link in router._links.items():
        if link is not None:
            link_stats[f'{src}->{dst}'] = dict(link.stats)
    report = {
        'leg': name,
        'shards': n_shards,
        'tenants': tenants,
        'requests_offered': requests,
        'submitted': submitted,
        'completed_ok': counts['ok'],
        'rejections': {k: v for k, v in sorted(counts.items())
                       if k != 'ok'},
        'untyped_escapes': untyped,
        'elapsed_s': round(elapsed, 3),
        'ticks': router.ticks,
        'requests_per_s': round(counts['ok'] / elapsed, 1)
        if elapsed else None,
        'lease_ticks': lease_ticks,
        'paced': bool(pace),
        'ticks_slipped': slipped if pace else None,
        'ticks_slipped_per_shard': {sid: router.shards[sid].ticks_slipped
                                    for sid in shard_ids} if pace else None,
        'scrub_mismatches': len(router.scrub_mismatches),
        'kills': len(mttrs),
        'failovers': len(router.failovers),
        'mttr_ticks': [m['mttr_ticks'] for m in mttrs],
        'drained': drained,
        'audits': audits,
        'final_audit': final,
        'shard_health_delta': {k: health[k] - base_health.get(k, 0)
                               for k in health
                               if health[k] != base_health.get(k, 0)},
        'link_stats': link_stats,
    }
    if audit_hook is not None:
        report['audit'] = audit_result
    ok = (untyped == 0 and final['acked_lost'] == 0 and
          final['replica_mismatches'] == 0 and
          all(a['acked_lost'] == 0 and a['replica_mismatches'] == 0
              for a in audits) and drained)
    if mttr_bound is not None:
        ok = ok and all(m['mttr_ticks'] is not None and
                        m['mttr_ticks'] <= mttr_bound
                        for m in mttrs if m['tenants'])
    if ctrl is not None:
        gauges = ctrl.gauges()
        per_policy = {}
        for (policy, _action, _mode), n in gauges['decisions'].items():
            per_policy[policy] = per_policy.get(policy, 0) + n
        last_tick = gauges['last_decision_tick']
        settle = None
        if last_revive_tick is not None and last_tick is not None and \
                last_tick > last_revive_tick:
            settle = last_tick - last_revive_tick
        report['control'] = {
            'mode': control,
            'window': control_window,
            'windows': gauges['windows'],
            'decisions': per_policy,
            'actuations': sum(
                n for (_p, _a, mode), n in gauges['decisions'].items()
                if mode == 'active'),
            'reversals': gauges['reversals'],
            'last_decision_tick': last_tick,
            'last_revive_tick': last_revive_tick,
            'settle_ticks': settle,
            'fixed_point': fixed_point,
            'decide_s_max': gauges['decide_s_max'],
            'ledger_entries': len(ctrl.decision_log()),
        }
        # the anti-oscillation bound: a policy flip-flopping on one
        # target more than twice in an episode is hunting, not
        # converging — and the post-drain hold must be decision-free
        ok = ok and all(n <= 2 for n in gauges['reversals'].values())
        ok = ok and fixed_point
        if settle_bound is not None and last_revive_tick is not None:
            ok = ok and (settle is None or settle <= settle_bound)
    report['ok'] = ok
    router.close()
    return report


def run_tier_leg(name='tier_hybrid', *, docs=512, hot=48, rounds=30,
                 writes_per_round=24, seed=0, budget_docs=None,
                 stage_schedule=None, path=None, device=None):
    """Hybrid live/parked storage-tier leg (ISSUE-15 acceptance): a
    hot-skewed write stream over a doc population living under a
    RESIDENT-BYTES ceiling, with the cost-based tiering plane doing ALL
    demotion — zero manual ``park`` calls — fed by the round-17 memory
    watermarks (``fleet_resident_bytes``). Parked docs that take writes
    revive through the engine (live/parked churn -> arena garbage ->
    cost-model vacuums), and a brownout stage schedule (stage 2 mid-leg
    by default) runs the model's defer/fire ledger, flight-recorded.

    Final CONVERGENCE AUDIT: every doc — live or parked — must be
    byte-identical to a control fleet fed exactly the committed
    changes (parked docs compare their canonical chunk bytes; no
    revive). Returns the leg report dict; ``ok`` summarizes.

    ``device`` (the port's keyword) is where the leg's fleet and its
    control fleet live: CUDA unless the caller asks otherwise."""
    import shutil
    import tempfile
    from .fleet.backend import init_docs
    from .fleet.storage import StorageEngine
    from .fleet.tiering import (ClockDemote, CostModel, TieringController,
                                tiering_stats)
    from .observability.perf import sample_watermarks

    rng = random.Random(seed)
    root = path or tempfile.mkdtemp(prefix='loadgen-tier-')
    own_root = path is None
    fleet = DocFleet(device=device)
    eng = StorageEngine(fleet, path=os.path.join(root, 'arena'))

    # the demote signal: LIVE (unfrozen) docs. The fleet's device grids
    # are capacity-sized (fleet_resident_bytes cannot fall when a doc
    # parks — only a capacity shrink moves it), so the leg budgets the
    # per-doc HOST cost directly: live-doc count against a doc budget,
    # with the byte watermarks sampled into the report for the record.
    def resident():
        return sum(1 for h in by_doc.values()
                   if h is not None and not h.get('frozen'))

    handles = init_docs(docs, fleet)
    ledger = [[] for _ in range(docs)]       # committed changes per doc
    seqs = [0] * docs
    by_doc = {d: handles[d] for d in range(docs)}   # live handle or None
    parked_id = [None] * docs

    def write_round(targets):
        per_handle, hs = [], []
        for d in targets:
            seqs[d] += 1
            heads = fleet_backend.get_heads(by_doc[d])
            buf = encode_change({
                'actor': f'{d:04x}' * 4, 'seq': seqs[d],
                'startOp': seqs[d], 'time': 0, 'message': '',
                'deps': heads,
                'ops': [{'action': 'set', 'obj': '_root',
                         'key': f'k{seqs[d] % 4}', 'value': d * 100 + seqs[d],
                         'datatype': 'int', 'pred': []}]})
            ledger[d].append(buf)
            per_handle.append([buf])
            hs.append(by_doc[d])
        out, _ = fleet_backend.apply_changes_docs(hs, per_handle,
                                                  mirror=False)
        for d, h in zip(targets, out):
            by_doc[d] = h
        return out

    # seed every doc with one change so parked chunks are non-trivial
    write_round(list(range(docs)))
    if budget_docs is None:
        budget_docs = max(hot * 2, docs // 4)
    budget = budget_docs
    policy = ClockDemote(eng, budget_bytes=budget,
                         source=resident, batch=64)
    # the seam returns FRESH handle dicts each apply (the old ones
    # freeze): register the post-write handles, and re-register after
    # every round below — stale ring entries prune themselves
    policy.register(list(by_doc.values()))
    # an eager model at leg scale: revive-discard garbage pays for a
    # rewrite quickly at stage 0, while the stage-2 write penalty defers
    # it — both verdicts land in the flight record over one leg
    ctrl = TieringController(engine=eng, demote=policy,
                             model=CostModel(min_garbage_bytes=1024,
                                             garbage_byte_cost=8.0))
    t0 = dict(tiering_stats())
    if stage_schedule is None:
        stage_schedule = [0] * (rounds // 3) + [2] * (rounds // 3) + \
            [0] * (rounds - 2 * (rounds // 3))

    pressures = []
    revived = 0
    for r in range(rounds):
        # hot-skewed target draw: 80% hot set, 20% tail
        targets = sorted({
            rng.randrange(hot) if rng.random() < 0.8
            else rng.randrange(docs) for _ in range(writes_per_round)})
        # revive any parked targets through the engine (hybrid churn)
        need = [d for d in targets if by_doc[d] is None]
        if need:
            got = eng.revive([parked_id[d] for d in need])
            revived += len(need)
            for d, h in zip(need, got):
                by_doc[d] = h
                parked_id[d] = None
            policy.register(got)
        out = write_round(targets)
        policy.register(out)
        policy.touch(out)
        stage = stage_schedule[min(r, len(stage_schedule) - 1)]
        ctrl.tick(stage=stage)
        # fold the tick's parks back into the doc map (handle -> id
        # pairs from the clock, so a later write can revive by id)
        if policy.last_parked:
            doc_of = {id(h): d for d, h in by_doc.items()
                      if h is not None}
            for h, i in policy.last_parked:
                d = doc_of.get(id(h))
                if d is not None:
                    by_doc[d] = None
                    parked_id[d] = i
        pressures.append(policy.pressure())

    # ---- convergence audit: control fleet fed exactly the ledger ----
    control_fleet = DocFleet(device=device)
    control = init_docs(docs, control_fleet)
    control, _ = fleet_backend.apply_changes_docs(
        control, [list(l) for l in ledger], mirror=False)
    mismatches = 0
    for d in range(docs):
        want = bytes(control[d]['state'].save())
        if by_doc[d] is not None:
            got = bytes(by_doc[d]['state'].save())
        elif parked_id[d] is not None:
            got = bytes(eng.chunk(parked_id[d]))
        else:
            mismatches += 1
            continue
        if got != want:
            mismatches += 1
    t1 = dict(tiering_stats())
    final_pressure = policy.pressure()
    marks = sample_watermarks()
    report = {
        'leg': name, 'docs': docs, 'rounds': rounds,
        'watermarks': {k: marks.get(k, 0) for k in
                       ('rss', 'mainstore_bytes', 'mainstore_disk_bytes')},
        'demoted': t1['tiering_demoted_docs'] - t0['tiering_demoted_docs'],
        'model_vacuums': t1['tiering_vacuums'] - t0['tiering_vacuums'],
        'engine_vacuums': eng.vacuums,
        'deferred': t1['tiering_deferred'] - t0['tiering_deferred'],
        'revived': revived,
        'manual_parks': 0,
        'budget_bytes': budget,
        'final_pressure': round(final_pressure, 3),
        'max_late_pressure': round(max(pressures[rounds // 2:]), 3),
        'audit_mismatches': mismatches,
        'parked_final': len(eng.main),
    }
    report['ok'] = mismatches == 0 and report['demoted'] > 0 and \
        final_pressure <= 1.05
    eng.close()
    if own_root:
        shutil.rmtree(root, ignore_errors=True)
    return report


def run_tier_kill_leg(name='tier_kill', *, docs=32, seed=0, path=None,
                      device=None):
    """Kill-driven vacuum leg: a CHILD process parks a doc population
    on the mmap arena, discards a slice, and hard-dies (os._exit)
    INSIDE the vacuum's manifest swap; the parent recovers the arena
    via StorageEngine.open and audits every surviving doc byte-for-byte
    against the child's pre-kill expectations.

    ``device`` (the port's keyword) is where the child's fleet and the
    recovered engine's fleet live: CUDA unless the caller asks
    otherwise."""
    import shutil
    import subprocess
    import tempfile
    root = path or tempfile.mkdtemp(prefix='loadgen-tierkill-')
    own_root = path is None
    arena = os.path.join(root, 'arena')
    expect_path = os.path.join(root, 'expect.bin')
    script = f'''
import os, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.fleet import backend as fb
from automerge_tpu_torch.fleet.backend import DocFleet, init_docs
from automerge_tpu_torch.fleet.storage import StorageEngine
fleet = DocFleet(device={device!r})
eng = StorageEngine(fleet, path={arena!r}, vacuum_dead_fraction=None)
handles = init_docs({docs}, fleet)
per = [[encode_change({{'actor': f'{{d:04x}}' * 4, 'seq': 1, 'startOp': 1,
        'time': 0, 'message': '', 'deps': [],
        'ops': [{{'action': 'set', 'obj': '_root', 'key': 'k',
                 'value': d, 'datatype': 'int', 'pred': []}}]}})]
       for d in range({docs})]
handles, _ = fb.apply_changes_docs(handles, per, mirror=False)
saves = [bytes(h['state'].save()) for h in handles]
ids = eng.park(handles)
keep = ids[{docs} // 3:]
import struct
with open({expect_path!r}, 'wb') as f:
    for i in keep:
        f.write(struct.pack('<qI', i, len(saves[i])) + saves[i])
eng.discard(ids[:{docs} // 3])
eng.main.sync()
eng.main._arena.fault_point = 'exit:post_manifest'
eng.vacuum_now()       # never returns
'''
    proc = subprocess.run([sys.executable, '-c', script],
                          capture_output=True, timeout=600)
    report = {'leg': name, 'docs': docs,
              'child_exit': proc.returncode}
    if proc.returncode != 71:
        report['ok'] = False
        report['stderr'] = proc.stderr.decode()[-1000:]
        return report
    import struct
    from .fleet.storage import StorageEngine
    expect = {}
    with open(expect_path, 'rb') as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            i, ln = struct.unpack('<qI', head)
            expect[i] = f.read(ln)
    eng = StorageEngine.open(arena, device=device)
    mismatches = sum(
        1 for i, want in expect.items()
        if i not in eng._row_of or bytes(eng.chunk(i)) != want)
    missing = sorted(set(eng._row_of) - set(expect))
    report.update(recovered=len(eng._row_of),
                  expected=len(expect),
                  audit_mismatches=mismatches,
                  resurrected=len(missing),
                  ok=mismatches == 0 and not missing and
                  len(eng._row_of) == len(expect))
    eng.close()
    if own_root:
        shutil.rmtree(root, ignore_errors=True)
    return report

