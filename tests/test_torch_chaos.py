# The port's copy of tests/test_chaos.py: imports re-pointed at
# automerge_tpu_torch, fleets on the CPU (device='cpu'), its four
# families at a tier-1 dose; the reference's default dose of the
# differential (5 seeds x 80 steps) is test_chaos_differential_full,
# marked slow.
"""Cross-backend chaos differential: one randomized multi-actor workload
driven through the host backend and BOTH fleet device modes at once, with
save/load round-trips, bulk loads, clones, sync convergence, and history
queries interleaved — every read compared across implementations.

This is the wasm.js differential harness (ref test/wasm.js:27-36) scaled to
the whole surface: the host OpSet is the executable spec; the fleet paths
must be observationally identical through the public Backend contract."""

import os
import random

import pytest

import automerge_tpu_torch as A
from automerge_tpu_torch import backend as host_backend
from automerge_tpu_torch import native
from automerge_tpu_torch.fleet import backend as fleet_backend
from automerge_tpu_torch.fleet.backend import DocFleet, FleetBackend
from automerge_tpu_torch.fleet.faults import LossyLink, sync_until_quiet
from automerge_tpu_torch.fleet.loader import load_docs

# Three founding actors plus two that join mid-history. The joiners' hex
# sorts BEFORE every founder, so a join forces the fleet's sorted actor
# renumbering (tensor remap) in the middle of live device state.
FOUNDERS = ['89' * 8, 'ab' * 8, 'fe' * 8]
JOINERS = ['01' * 8, '34' * 8]
ALPHA = 'abcdefghijklmnop'

# Dose knobs: the in-tree default is ~10x the round-3 dose (5 seeds x 80
# steps x up to 5 actors + mid-run joins + rows-in-lists edits, vs
# 2 x 30 x 3) while staying inside the CI budget on this image's single
# core (~4 min); CHAOS_SEEDS / CHAOS_STEPS scale it 50x+ for deeper
# offline fuzzing (e.g. CHAOS_SEEDS=20 CHAOS_STEPS=250).
N_SEEDS = int(os.environ.get('CHAOS_SEEDS', '1'))
N_STEPS = int(os.environ.get('CHAOS_STEPS', '30'))
# the reference's in-tree dose, run by the slow variant
FULL_SEEDS, FULL_STEPS = 5, 80
# Offset for chunked offline doses: tools/chaos_dose.py runs the deep dose
# as several fresh pytest processes (the accumulated XLA CPU compile cache
# can segfault the compiler inside one long-lived process), each covering
# seeds [BASE, BASE + N_SEEDS).
SEED_BASE = int(os.environ.get('CHAOS_SEED_BASE', '0'))


def _random_edit(edit_seed):
    """One random mutation closure over the public proxy API. All draws
    come from a per-edit PRNG seeded up front, so applying the closure to
    identical documents in different universes performs identical edits."""

    def edit(r):
        rng = random.Random(edit_seed)
        roll = rng.random()
        t = r['text']
        lst = r['list']
        if roll < 0.14:
            t.insert_at(rng.randrange(len(t) + 1), rng.choice(ALPHA))
        elif roll < 0.22 and len(t):
            t.delete_at(rng.randrange(len(t)))
        elif roll < 0.30 and len(t):
            t.set(rng.randrange(len(t)), rng.choice(ALPHA).upper())
        elif roll < 0.40:
            key = rng.choice(ALPHA)
            choice = rng.random()
            if choice < 0.5:
                r[key] = rng.randrange(1000)
            elif choice < 0.7:
                r[key] = rng.choice(['str', 2.5, True, None])
            else:
                r[key] = A.Int(1589032171000) if choice < 0.8 else \
                    A.Uint(rng.randrange(99))
        elif roll < 0.48:
            k = rng.choice('xyz')
            m = r['counts']
            if k in m and hasattr(m[k], 'increment'):
                m[k].increment(1)    # Counters cannot be overwritten
            else:
                m[k] = A.Counter(rng.randrange(10))
        elif roll < 0.56:
            m = r['counts']
            k = rng.choice('xyz')
            if k in m and hasattr(m[k], 'increment'):
                m[k].increment(rng.randrange(-3, 9))
            else:
                m[k] = A.Counter(0)
        elif roll < 0.62:
            lst.insert(rng.randrange(len(lst) + 1), rng.randrange(100))
        elif roll < 0.67 and len(lst):
            lst[rng.randrange(len(lst))] = rng.randrange(100, 200)
        elif roll < 0.72 and len(lst):
            lst.delete_at(rng.randrange(len(lst)))
        elif roll < 0.78:
            # Objects nested inside sequences (fleet-resident since round
            # 4): insert a row map into the rows list
            rows = r['rows']
            rows.insert(rng.randrange(len(rows) + 1),
                        {'v': rng.randrange(50)})
        elif roll < 0.83 and len(r['rows']):
            # ... or edit a key inside an existing row
            rows = r['rows']
            row = rows[rng.randrange(len(rows))]
            if hasattr(row, 'keys'):
                row[rng.choice('vw')] = rng.randrange(500)
        elif roll < 0.86 and len(r['rows']):
            r['rows'].delete_at(rng.randrange(len(r['rows'])))
        elif roll < 0.90:
            r['nested'][rng.choice('pq')] = {'v': rng.randrange(50)}
        elif roll < 0.96:
            key = rng.choice(ALPHA)
            if key in r:
                del r[key]
        else:
            pass    # empty change
    return edit


class _Universe:
    """One backend implementation's replica set for the shared trace."""

    def __init__(self, name, backend):
        self.name = name
        self.backend = backend
        self.docs = []

    def with_backend(self, fn):
        prev = A.Backend()
        A.set_default_backend(self.backend)
        try:
            return fn()
        finally:
            A.set_default_backend(prev)


def fleet_handles(u):
    """Backend handles for every replica in a fleet universe."""
    return u.with_backend(
        lambda: [A.frontend.get_backend_state(d, 'chaos') for d in u.docs])


@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
@pytest.mark.parametrize('seed', list(range(SEED_BASE, SEED_BASE + N_SEEDS)))
def test_chaos_differential(seed):
    _chaos_differential(seed, N_STEPS)


@pytest.mark.slow
@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
@pytest.mark.parametrize('seed', list(range(FULL_SEEDS)))
def test_chaos_differential_full(seed):
    _chaos_differential(seed, FULL_STEPS)


def _chaos_differential(seed, n_steps):
    rng = random.Random(seed)
    fleet_lww = DocFleet(doc_capacity=8, key_capacity=64, device='cpu')
    fleet_exact = DocFleet(doc_capacity=8, key_capacity=64,
                           exact_device=True, device='cpu')
    universes = [
        _Universe('host', host_backend),
        _Universe('fleet-lww', FleetBackend(fleet_lww)),
        _Universe('fleet-exact', FleetBackend(fleet_exact)),
    ]
    actors = list(FOUNDERS)
    # Actors joining mid-history (exercises the fleet's sorted-actor
    # renumbering: both joiners sort before every founder)
    joins = {n_steps * 2 // 5: JOINERS[0], n_steps * 3 // 5: JOINERS[1]}
    compare_every = max(10, n_steps // 4)
    # Mid-run total device loss: at this step every fleet replica is
    # rebuilt from its change logs into a FRESH DocFleet (the donation-
    # failure contract, fleet/apply.py) and the run continues on the
    # rebuilt state — all later compares prove the loss was invisible.
    rebuild_at = n_steps // 2

    def conflict_views(doc):
        """Conflict sets for every root key (winners can agree while the
        losing branches diverge — the round-4 counter-attribution bug hid
        exactly there)."""
        return {k: A.get_conflicts(doc, k) for k in doc.keys()}

    def compare(tag):
        base = None
        for u in universes:
            views = [dict(d) for d in u.docs]
            conflicts = [u.with_backend(lambda d=d: conflict_views(d))
                         for d in u.docs]
            saves = [bytes(u.with_backend(lambda d=d: A.save(d)))
                     for d in u.docs]
            if base is None:
                base = (u.name, views, saves, conflicts)
            else:
                assert views == base[1], \
                    f'{tag}: {u.name} reads diverge from {base[0]}'
                assert saves == base[2], \
                    f'{tag}: {u.name} save bytes diverge from {base[0]}'
                assert conflicts == base[3], \
                    f'{tag}: {u.name} conflicts diverge from {base[0]}'
        return base[2]

    # seed replicas: identical initial change everywhere — change times are
    # pinned to 0 throughout, or wall-clock seconds straddling a universe
    # boundary would legitimately fork the change hashes
    for u in universes:
        def build():
            base = A.change(
                A.init(actors[0]), {'message': 'Initialization', 'time': 0},
                lambda d: d.update({'text': A.Text('seed'), 'list': [1, 2],
                                    'rows': [], 'counts': {}, 'nested': {}}))
            return [base] + [A.merge(A.init(a), base) for a in actors[1:]]
        u.docs = u.with_backend(build)

    for step in range(n_steps):
        if step == rebuild_at:
            for u in universes[1:]:
                fresh = DocFleet(doc_capacity=8, key_capacity=64,
                                 exact_device=u.backend.fleet.exact_device,
                                 device='cpu')
                rebuilt = fleet_backend.rebuild_docs(fleet_handles(u), fresh)
                for d, h in zip(u.docs, rebuilt):
                    d._state['backendState'] = h
                u.backend.fleet = fresh
        if step in joins:
            actor = joins[step]
            actors.append(actor)
            for u in universes:
                u.docs.append(u.with_backend(
                    lambda u=u: A.merge(A.init(actor), u.docs[0])))
        i = rng.randrange(len(actors))
        action = rng.random()
        if action < 0.55:
            edit = _random_edit(rng.getrandbits(32))
            for u in universes:
                u.docs[i] = u.with_backend(
                    lambda u=u, i=i: A.change(u.docs[i], {'time': 0}, edit))
        elif action < 0.75:
            j = rng.randrange(len(actors))
            if j != i:
                for u in universes:
                    u.docs[i] = u.with_backend(
                        lambda u=u: A.merge(u.docs[i], u.docs[j]))
        elif action < 0.85:
            # save/load round-trip replaces the replica
            for u in universes:
                def reload(u=u, i=i):
                    buf = A.save(u.docs[i])
                    return A.load(buf, actors[i])
                u.docs[i] = u.with_backend(reload)
        elif action < 0.95:
            for u in universes:
                u.docs[i] = u.with_backend(
                    lambda u=u, i=i: A.clone(u.docs[i], actors[i]))
        else:
            for u in universes:
                u.docs[i] = u.with_backend(
                    lambda u=u, i=i: A.empty_change(u.docs[i], {'time': 0}))
        if step % compare_every == compare_every - 1:
            # full convergence point: merge everything into replica 0
            for u in universes:
                def converge(u=u):
                    out = A.clone(u.docs[0])
                    for d in u.docs[1:]:
                        out = A.merge(out, d)
                    return out
                merged = u.with_backend(converge)
                u.docs.append(merged)
            compare(f'step {step}')
            for u in universes:
                u.docs.pop()

    saves = compare('final')

    # LIVE-fleet bulk device reads (materialize_docs — the default-mode
    # grid / register readback, incl. the round-5 pred-scoped delete
    # semantics) must match the host frontend views in BOTH device modes
    host_views = [dict(d) for d in universes[0].docs]
    for u in universes[1:]:
        handles = fleet_handles(u)
        mats = u.with_backend(
            lambda h=handles: fleet_backend.materialize_docs(h))
        for k, (m, e) in enumerate(zip(mats, host_views)):
            assert m == e, f'live bulk read {u.name} doc {k}'

    # histories and heads agree everywhere
    for u in universes[1:]:
        for d0, d1 in zip(universes[0].docs, u.docs):
            h0 = universes[0].with_backend(lambda: A.get_history(d0))
            h1 = u.with_backend(lambda: A.get_history(d1))
            assert [e.change['hash'] for e in h0] == \
                [e.change['hash'] for e in h1]

    # bulk-load every final save into fresh fleets: reads must match
    for exact in (False, True):
        fresh = DocFleet(doc_capacity=8, key_capacity=64,
                         exact_device=exact, device='cpu')
        handles = load_docs(saves, fresh)
        mats = fleet_backend.materialize_docs(handles)
        expect = [dict(d) for d in universes[0].docs]
        for k, (m, e) in enumerate(zip(mats, expect)):
            assert m == e, f'bulk-load(exact={exact}) doc {k}'
        # and the loaded docs save back verbatim
        for h, buf in zip(handles, saves):
            assert bytes(fleet_backend.save(h)) == buf

    # sync convergence: bulk-loaded fleet replicas (BOTH device modes)
    # sync against fresh host peers until both sides go quiet, ending on
    # identical heads
    for exact in (False, True):
        sync_fleet = DocFleet(doc_capacity=4, key_capacity=64,
                              exact_device=exact, device='cpu')
        handle = load_docs([saves[0]], sync_fleet)[0]
        peer = host_backend.init()
        s1, s2 = A.init_sync_state(), A.init_sync_state()
        for _ in range(16):
            s1, msg = fleet_backend.generate_sync_message(handle, s1)
            if msg is not None:
                peer, s2, _ = host_backend.receive_sync_message(peer, s2,
                                                                msg)
            s2, msg2 = host_backend.generate_sync_message(peer, s2)
            if msg2 is not None:
                handle, s1, _ = fleet_backend.receive_sync_message(
                    handle, s1, msg2)
            if msg is None and msg2 is None:
                break
        assert host_backend.get_heads(peer) == \
            fleet_backend.get_heads(handle), f'sync exact={exact}'


# ---------------------------------------------------------------------------
# Wire-fault universe: the same divergent two-actor workload synced over a
# seeded LossyLink (drop/dup/reorder/truncate/bit-flip) in the host universe
# and BOTH fleet device modes. Sync messages are byte-identical across
# universes, so one wire seed produces the SAME fault trace everywhere —
# all universes must converge to identical heads and byte-identical saves,
# proving loss is survivable and corruption contained, never propagated.
# ---------------------------------------------------------------------------

N_WIRE_SEEDS = int(os.environ.get('CHAOS_WIRE_SEEDS', '3'))


def _divergent_pair(backend_impl, edits_a, edits_b):
    """Two replicas sharing a seeded base, then editing independently
    (no merges): maximal divergence for the sync wire to reconcile."""
    prev = A.Backend()
    A.set_default_backend(backend_impl)
    try:
        base = A.change(
            A.init(FOUNDERS[0]), {'message': 'Initialization', 'time': 0},
            lambda d: d.update({'text': A.Text('seed'), 'list': [1, 2],
                                'rows': [], 'counts': {}, 'nested': {}}))
        doc_b = A.merge(A.init(FOUNDERS[1]), base)
        doc_a = base
        for edit in edits_a:
            doc_a = A.change(doc_a, {'time': 0}, edit)
        for edit in edits_b:
            doc_b = A.change(doc_b, {'time': 0}, edit)
        return (A.frontend.get_backend_state(doc_a, 'wire'),
                A.frontend.get_backend_state(doc_b, 'wire'))
    finally:
        A.set_default_backend(prev)


@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
@pytest.mark.parametrize('wire_seed', list(range(N_WIRE_SEEDS)))
def test_chaos_lossy_wire(wire_seed):
    rng = random.Random(1000 + wire_seed)
    edits_a = [_random_edit(rng.getrandbits(32)) for _ in range(12)]
    edits_b = [_random_edit(rng.getrandbits(32)) for _ in range(12)]
    fault_p = dict(p_drop=0.12, p_dup=0.08, p_reorder=0.08,
                   p_truncate=0.08, p_flip=0.08)

    results = []
    for name, impl in (
            ('host', host_backend),
            ('fleet-lww', FleetBackend(DocFleet(doc_capacity=4,
                                                key_capacity=64,
                                                device='cpu'))),
            ('fleet-exact', FleetBackend(DocFleet(doc_capacity=4,
                                                  key_capacity=64,
                                                  exact_device=True,
                                                  device='cpu')))):
        ha, hb = _divergent_pair(impl, edits_a, edits_b)
        link_ab = LossyLink(seed=wire_seed, budget=10, **fault_p)
        link_ba = LossyLink(seed=wire_seed + 500, budget=10, **fault_p)
        na, nb, rounds, stats = sync_until_quiet(
            ha, hb, impl, impl, link_ab, link_ba)
        heads_a = impl.get_heads(na)
        assert heads_a == impl.get_heads(nb), \
            f'{name} seed {wire_seed}: replicas diverged after quiet'
        views = None
        if name != 'host':
            # bulk device readback: the converged state must be served
            # from the device grids too, not just the host change log
            views = fleet_backend.materialize_docs([na, nb])
        results.append((name, heads_a,
                        bytes(impl.save(na)), bytes(impl.save(nb)),
                        link_ab.stats, link_ba.stats, views))

    base = results[0]
    host_views = [dict(A.load(base[2])), dict(A.load(base[3]))]
    for name, _h, _sa, _sb, _la, _lb, views in results[1:]:
        assert views == host_views, \
            f'{name}: device readback diverges from host universe'
    for other in results[1:]:
        assert other[1] == base[1], \
            f'{other[0]} heads diverge from {base[0]}'
        assert other[2] == base[2] and other[3] == base[3], \
            f'{other[0]} save bytes diverge from {base[0]}'
        # identical wire seeds + byte-identical messages => the fault
        # trace itself must align across universes
        assert other[4] == base[4] and other[5] == base[5], \
            f'{other[0]} fault trace diverged (messages not byte-identical?)'


# ---------------------------------------------------------------------------
# Durability universe: the divergent pair syncs over a LossyLink while peer
# A journals to disk (fleet universes through the backend seam hooks, the
# host universe through explicit journal records — same frames either way),
# checkpoints mid-run, then CRASHES: its in-memory state is dropped and
# rebuilt from the durability directory alone. The recovered peer resumes
# lossy sync to quiet. All three universes (host + both device modes) must
# converge to identical heads and byte-identical saves — a crash plus
# recovery is invisible at the wire level.
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
def test_chaos_checkpoint_crash_recover(tmp_path):
    from automerge_tpu_torch.errors import AutomergeError
    from automerge_tpu_torch.fleet import durability as D
    from automerge_tpu_torch.fleet.durability import DurableFleet, read_state

    rng = random.Random(4242)
    edits_a = [_random_edit(rng.getrandbits(32)) for _ in range(10)]
    edits_b = [_random_edit(rng.getrandbits(32)) for _ in range(10)]
    # canonical divergent saves (change bytes are backend-independent —
    # pinned by test_chaos_differential — so one build serves all
    # universes byte-identically)
    ha0, hb0 = _divergent_pair(host_backend, edits_a, edits_b)
    save_a = bytes(host_backend.save(ha0))
    save_b = bytes(host_backend.save(hb0))
    fault_p = dict(p_drop=0.15, p_dup=0.05, p_truncate=0.1, p_flip=0.1)
    n_pre_rounds = 6

    results = []
    for name, exact in (('host', None), ('fleet-lww', False),
                        ('fleet-exact', True)):
        ddir = str(tmp_path / name)
        if exact is None:
            impl = host_backend
            mgr = DurableFleet(ddir, device='cpu')
            ha = impl.load(save_a)
            hb = impl.load(save_b)
            # explicit baseline record (no seam hooks on the host path)
            did = mgr.journal.doc_id_for(ha['state'])
            mgr.journal.append(did, save_a)
            mgr.journal.commit()
            auto_journal = False
        else:
            impl = fleet_backend
            fleet_a = DocFleet(doc_capacity=4, key_capacity=64,
                               exact_device=exact, device='cpu')
            fleet_b = DocFleet(doc_capacity=4, key_capacity=64,
                               exact_device=exact, device='cpu')
            mgr = DurableFleet(ddir, fleet=fleet_a, device='cpu')
            # load goes through the apply seam, so the baseline chunk is
            # journaled by the hook — no explicit plumbing
            ha = fleet_backend.load(save_a, fleet_a)
            hb = fleet_backend.load(save_b, fleet_b)
            did = ha['state']._dur_id
            auto_journal = True

        # phase 1: lossy duplex rounds with a mid-run checkpoint
        link_ab = LossyLink(seed=9000, budget=8, **fault_p)
        link_ba = LossyLink(seed=9500, budget=8, **fault_p)
        sa, sb = impl.init_sync_state(), impl.init_sync_state()
        for r in range(n_pre_rounds):
            sa, msg_ab = impl.generate_sync_message(ha, sa)
            sb, msg_ba = impl.generate_sync_message(hb, sb)
            for payload in link_ab.transmit(msg_ab):
                try:
                    hb, sb, _ = impl.receive_sync_message(hb, sb, payload)
                except AutomergeError:
                    pass                       # corrupt == dropped
            for payload in link_ba.transmit(msg_ba):
                old_heads = impl.get_heads(ha)
                try:
                    ha, sa, _ = impl.receive_sync_message(ha, sa, payload)
                except AutomergeError:
                    continue
                if not auto_journal:
                    new = [bytes(c)
                           for c in impl.get_changes(ha, old_heads)]
                    if new:
                        mgr.journal.record_changes(ha['state'], new)
            if r == n_pre_rounds // 2:
                mgr.checkpoint()
        mgr.close()

        # CRASH: peer A's in-memory state is gone; rebuild from disk only
        pre_crash_save = bytes(impl.save(ha))
        del ha
        mgr2 = None
        if auto_journal:
            mgr2, rec, report = DurableFleet.recover(ddir, device='cpu',
                                                     exact_device=exact)
            ha2 = rec[did]
            assert report.ok, report
        else:
            st = read_state(ddir)
            ha2 = impl.load(st['docs'][did]) if did in st['docs'] \
                else impl.init()
            suffix = [bytes(p) for k, d2, p in st['journal_records']
                      if d2 == did and k == D.KIND_CHANGE]
            if suffix:
                ha2, _patch = impl.apply_changes(ha2, suffix)
        assert bytes(impl.save(ha2)) == pre_crash_save, \
            f'{name}: recovery lost acknowledged state'

        # phase 2: resume lossy sync (fresh links + sync states — a real
        # reconnect) until quiet
        link2_ab = LossyLink(seed=9100, budget=6, **fault_p)
        link2_ba = LossyLink(seed=9600, budget=6, **fault_p)
        na, nb, _rounds, _stats = sync_until_quiet(
            ha2, hb, impl, impl, link2_ab, link2_ba)
        heads = impl.get_heads(na)
        assert heads == impl.get_heads(nb), \
            f'{name}: replicas diverged after crash-recovery sync'
        if mgr2 is not None:
            # the recovered peer stayed durable through phase 2: one more
            # crash-recover round trip must reproduce the converged state
            mgr2.close()
            mgr3, rec3, _rep3 = DurableFleet.recover(ddir, device='cpu',
                                                     exact_device=exact)
            assert bytes(impl.save(rec3[did])) == bytes(impl.save(na)), \
                f'{name}: post-sync recovery diverges'
            mgr3.close()
        results.append((name, heads, bytes(impl.save(na)),
                        bytes(impl.save(nb)),
                        link_ab.stats, link_ba.stats))

    base = results[0]
    for other in results[1:]:
        assert other[1] == base[1], \
            f'{other[0]} heads diverge from {base[0]}'
        assert other[2] == base[2] and other[3] == base[3], \
            f'{other[0]} save bytes diverge from {base[0]}'
        # byte-identical messages => identical phase-1 fault traces
        assert other[4] == base[4] and other[5] == base[5], \
            f'{other[0]} fault trace diverged (messages not byte-identical?)'


@pytest.mark.skipif(not native.available(),
                    reason='native codec unavailable')
def test_chaos_lossy_wire_moves_health_counters():
    """The containment counters must actually move under wire faults —
    silent success would mean the faults were never injected."""
    from automerge_tpu_torch.observability import health_counts
    rng = random.Random(77)
    edits_a = [_random_edit(rng.getrandbits(32)) for _ in range(6)]
    edits_b = [_random_edit(rng.getrandbits(32)) for _ in range(6)]
    before = health_counts()
    ha, hb = _divergent_pair(host_backend, edits_a, edits_b)
    link_ab = LossyLink(seed=3, budget=16, p_drop=0.2, p_flip=0.25,
                        p_truncate=0.25)
    link_ba = LossyLink(seed=4, budget=16, p_drop=0.2, p_flip=0.25,
                        p_truncate=0.25)
    na, nb, _rounds, _stats = sync_until_quiet(ha, hb, host_backend,
                                               host_backend, link_ab,
                                               link_ba)
    assert host_backend.get_heads(na) == host_backend.get_heads(nb)
    after = health_counts()
    assert after['wire_faults'] > before['wire_faults']
