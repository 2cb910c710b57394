# The port's copy of tests/test_shard.py: imports re-pointed at
# automerge_tpu_torch, every router's shard fleets on the CPU
# (device='cpu'). tools/obs_report.py reads the port's snapshot and
# traces as it reads the reference's. Added at the end: the router needs
# CUDA unless it is given a device, and a revived shard drops its dead
# incarnation's fleet.
"""Shard scale-out unit + chaos coverage (ISSUE-11).

The tentpole properties, each pinned small enough for tier-1 (the full
kill matrices live in tests/test_service_chaos.py and under ``-m
slow``):

- RING: deterministic placement, preference lists of distinct shards,
  liveness filtering that skips dead shards without mutating the ring,
  and kill -> revive round-tripping to the original placement.
- REPLICATION ACK CONTRACT: an 'apply' acks only once its changes are
  on BOTH the home and replica docs; post-quiet the pair is
  byte-identical.
- FAILOVER: a killed shard's tenants re-home onto their replicas
  within the lease window; acked writes survive; the re-homed session
  gets the ``reset=True`` reconnect and its standing subscription
  cursor back — a cursor naming heads the replica never received
  resolves as a TYPED resync event, never a silently stale patch.
- MIGRATION: planned rebalance moves a tenant through park ->
  ingest_chunks -> revive with a real reads-only window (writes typed
  /retried, reads served) and byte-identical content.
- LINK FAULTS: LossyLink's stateful partition/crash classes go dark
  for K ticks and heal, counted in wire_faults, and sync_until_quiet
  converges across them.
- OBSERVABILITY: the Prometheus page stamps shard="..." on every
  sample; --stitch labels shard inputs and DISCLOSES a restarted
  shard's span-ring truncation while trace ids stitch across it.
"""

import io
import json
import os
import random
import sys

import pytest

from automerge_tpu_torch import backend as host_backend
from automerge_tpu_torch import native
from automerge_tpu_torch.backend import get_change_by_hash, get_heads
from automerge_tpu_torch.columnar import decode_change_meta, encode_change
from automerge_tpu_torch.errors import (AutomergeError, Overloaded,
                                  ShardUnavailable)
from automerge_tpu_torch.fleet.faults import LossyLink, sync_until_quiet
from automerge_tpu_torch.observability import (clear_spans, disable as obs_off,
                                         enable as obs_on,
                                         export_chrome_trace, span)
from automerge_tpu_torch.observability.export import render_prometheus
from automerge_tpu_torch.service.backoff import Backoff
from automerge_tpu_torch.shard import HashRing, ShardRouter, shard_stats

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tools'))

pytestmark = pytest.mark.skipif(not native.available(),
                                reason='native codec unavailable')


def _change(actor, seq, value=1):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': seq, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': 'k',
                 'value': value, 'datatype': 'int', 'pred': []}]})


def _router(n, clk, **kwargs):
    kwargs.setdefault('backoff', Backoff(base=0.02, factor=1.5,
                                         cap=0.32, retries=14, seed=1))
    kwargs.setdefault('lease_ticks', 3)
    return ShardRouter(n_shards=n, clock=lambda: clk[0], device='cpu',
                       **kwargs)


def _pump(router, clk, n=1, dt=0.02):
    for _ in range(n):
        router.pump(now=clk[0])
        clk[0] += dt


def _settle(router, clk, ticket, limit=200):
    for _ in range(limit):
        if ticket.done:
            return ticket
        _pump(router, clk)
    return ticket


class TestHashRing:
    def test_deterministic_and_distinct(self):
        a = HashRing(['s0', 's1', 's2', 's3'])
        b = HashRing(['s0', 's1', 's2', 's3'])
        for key in ('tenant0', 'tenant1', 'zebra'):
            pref = a.preference(key, 3)
            assert pref == b.preference(key, 3)
            assert len(pref) == len(set(pref)) == 3
            assert a.primary(key) == pref[0]
            assert a.replica(key) == pref[1]

    def test_alive_filter_skips_dead_without_mutating(self):
        ring = HashRing(['s0', 's1', 's2', 's3'])
        keys = [f'tenant{i}' for i in range(64)]
        before = {k: ring.primary(k) for k in keys}
        dead = before[keys[0]]
        alive = {s for s in ring.shard_ids() if s != dead}
        for k in keys:
            p = ring.primary(k, alive=alive)
            assert p in alive
            if before[k] != dead:
                # only the dead shard's tenants move
                assert p == before[k]
        # revival restores the original placement exactly
        assert {k: ring.primary(k) for k in keys} == before

    def test_balance_rough(self):
        ring = HashRing(['s0', 's1', 's2', 's3'])
        homes = [ring.primary(f't{i}') for i in range(400)]
        for sid in ring.shard_ids():
            share = homes.count(sid) / len(homes)
            assert 0.05 < share < 0.60, (sid, share)


class TestReplicationAck:
    def test_apply_acks_on_both_copies_and_converges(self):
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        payload = [_change('aa' * 16, 1)]
        ticket = _settle(router, clk, router.submit('t0', 'apply',
                                                    payload))
        assert ticket.status == 'ok', ticket.error
        h = decode_change_meta(payload[0], True)['hash']
        # the ack CONTRACT: resolved ok means both copies hold it NOW
        assert get_change_by_hash(rec.session.handle, h) is not None
        assert get_change_by_hash(rec.replica_handle, h) is not None
        assert router.run_until_quiet(200, advance=0.02)
        assert bytes(host_backend.save(rec.session.handle)) == \
            bytes(host_backend.save(rec.replica_handle))

    def test_replication_rides_lossy_links(self):
        links = {}

        def factory(src, dst):
            links[(src, dst)] = LossyLink(
                seed=len(links) + 7, p_drop=0.15, p_flip=0.1,
                p_dup=0.05, budget=24)
            return links[(src, dst)]

        clk = [0.0]
        router = _router(2, clk, link_factory=factory)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        tickets = []
        for seq in range(1, 6):
            tickets.append(_settle(router, clk, router.submit(
                't0', 'apply', [_change('bb' * 16, seq, seq)]),
                limit=400))
        assert all(t.status == 'ok' for t in tickets), \
            [(t.status, t.error) for t in tickets]
        assert router.run_until_quiet(600, advance=0.02)
        assert bytes(host_backend.save(rec.session.handle)) == \
            bytes(host_backend.save(rec.replica_handle))
        assert any(link.stats['sent'] > link.stats['delivered']
                   or link.stats['flipped'] for link in links.values())

    def test_quiet_pairs_skip_replication_rounds(self):
        """A converged-quiet pair with unmoved heads costs no
        replication round (steady state is O(dirty pairs)); the next
        committed apply wakes it."""
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        ticket = _settle(router, clk, router.submit(
            't0', 'apply', [_change('aa' * 16, 1)]))
        assert ticket.status == 'ok', ticket.error
        assert router.run_until_quiet(200, advance=0.02)
        idle_base = shard_stats()['shard_repl_rounds']
        _pump(router, clk, 20)
        assert shard_stats()['shard_repl_rounds'] == idle_base
        ticket = _settle(router, clk, router.submit(
            't0', 'apply', [_change('aa' * 16, 2)]))
        assert ticket.status == 'ok', ticket.error
        assert shard_stats()['shard_repl_rounds'] > idle_base

    def test_repl_every_group_commit_keeps_ack_contract(self):
        """repl_every > 1 batches replication rounds; the ack still
        waits for both copies, and the pair still converges."""
        clk = [0.0]
        router = _router(2, clk, repl_every=3)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        tickets = [router.submit('t0', 'apply', [_change('cc' * 16, s)])
                   for s in (1,)]
        for s in (2, 3):
            _pump(router, clk)
            tickets.append(router.submit(
                't0', 'apply', [_change('dd' * 16, s - 1, s)]))
        for t in tickets:
            _settle(router, clk, t, limit=400)
        assert all(t.status == 'ok' for t in tickets), \
            [(t.status, t.error) for t in tickets]
        for t, payload_seq in ((tickets[0], 1),):
            h = decode_change_meta(_change('cc' * 16, payload_seq),
                                   True)['hash']
            assert get_change_by_hash(rec.replica_handle, h) is not None
        assert router.run_until_quiet(400, advance=0.02)
        assert bytes(host_backend.save(rec.session.handle)) == \
            bytes(host_backend.save(rec.replica_handle))

    def test_corrupt_apply_bytes_resolve_typed_not_raised(self):
        """Bytes that don't even decode can never meet the ack
        contract: a fixed corrupt payload resolves typed immediately
        (no exception out of submit/pump), and a payload_fn transport
        retries with a fresh draw until clean bytes land."""
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        bad = _settle(router, clk, router.submit(
            't0', 'apply', [b'\x00garbage not a change']))
        assert bad.status == 'error'
        assert isinstance(bad.error, AutomergeError)
        draws = [b'\xffflip', bytes(_change('ee' * 16, 1))]
        healed = _settle(router, clk, router.submit(
            't0', 'apply', payload_fn=lambda: [draws.pop(0)]
            if draws else [bytes(_change('ee' * 16, 1))]), limit=400)
        assert healed.status == 'ok', healed.error

    def test_dead_replica_window_defers_ack_until_failover(self):
        """A killed replica shard's memory can't accept bytes even
        before the lease notices: an apply submitted in that window
        stays pending and acks only through the re-placed replica."""
        clk = [0.0]
        router = _router(3, clk)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        dead = rec.replica_on
        router.kill_shard(dead)
        ticket = router.submit('t0', 'apply', [_change('ab' * 16, 1)])
        # within the lease window: committed on home, NOT acked (the
        # only other copy would be a zombie)
        _pump(router, clk, router.lease_ticks)
        assert not ticket.done
        _settle(router, clk, ticket)
        assert ticket.status == 'ok', ticket.error
        assert rec.replica_on != dead and rec.replica_on is not None
        h = decode_change_meta(_change('ab' * 16, 1), True)['hash']
        assert get_change_by_hash(rec.replica_handle, h) is not None

    def test_revive_before_lease_expiry_still_fails_over(self):
        """kill -> revive inside the lease window: the crash destroyed
        the shard's memory regardless of detection timing, so revive
        forces the failover — no tenant may keep a session into the
        dead incarnation."""
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        first = _settle(router, clk, router.submit(
            't0', 'apply', [_change('cd' * 16, 1)]))
        assert first.status == 'ok', first.error
        home = rec.home
        base = shard_stats()['shard_failovers']
        router.kill_shard(home)
        _pump(router, clk)                     # < lease_ticks
        router.revive_shard(home)
        assert shard_stats()['shard_failovers'] == base + 1
        assert rec.home != home                # re-homed on the replica
        after = _settle(router, clk, router.submit(
            't0', 'apply', [_change('cd' * 16, 2)]), limit=400)
        assert after.status == 'ok', after.error
        h = decode_change_meta(_change('cd' * 16, 1), True)['hash']
        assert get_change_by_hash(rec.session.handle, h) is not None

    def test_threaded_pump_matches_serial(self):
        """Thread-per-shard pumping changes wall time, never state:
        the same workload acks the same tickets and converges to the
        same bytes as the serial pump."""
        saves = []
        for threads in (None, 4):
            clk = [0.0]
            router = _router(4, clk, pump_threads=threads)
            for i in range(6):
                router.open_tenant(f't{i}')
            tickets = [router.submit(f't{i}', 'apply',
                                     [_change(f'{i:02x}' * 16, 1, i)])
                       for i in range(6)]
            for t in tickets:
                _settle(router, clk, t)
            assert all(t.status == 'ok' for t in tickets), \
                [(t.status, t.error) for t in tickets]
            assert router.run_until_quiet(300, advance=0.02)
            saves.append(tuple(
                bytes(host_backend.save(
                    router.tenant_record(f't{i}').session.handle))
                for i in range(6)))
            router.close()
        assert saves[0] == saves[1]


class TestFailover:
    def test_kill_one_of_four_rehomes_within_lease(self):
        clk = [0.0]
        router = _router(4, clk)
        tenants = [f'tenant{i}' for i in range(8)]
        acked = {t: [] for t in tenants}
        for t in tenants:
            router.open_tenant(t)
        for i, t in enumerate(tenants):
            p = [_change(f'{i:08x}' + 'ab' * 12, 1)]
            tk = _settle(router, clk, router.submit(t, 'apply', p))
            assert tk.status == 'ok'
            acked[t].append(p)
        victim = router.tenant_record(tenants[0]).home
        doomed = router.tenants_on(victim)
        assert doomed
        router.kill_shard(victim)
        kill_tick = router.ticks
        inflight = []
        for t in doomed:
            i = tenants.index(t)
            p = [_change(f'{i:08x}' + 'ab' * 12, 2)]
            inflight.append((router.submit(t, 'apply', p), t, p))
        mttr = None
        for _ in range(200):
            _pump(router, clk)
            if mttr is None:
                for tk, t, _p in inflight:
                    if tk.done and tk.status == 'ok' and \
                            router.tenant_record(t).home != victim:
                        mttr = router.ticks - kill_tick
            if all(tk.done for tk, _t, _p in inflight):
                break
        for tk, t, p in inflight:
            assert tk.status == 'ok', (t, tk.error)
            acked[t].append(p)
            assert router.tenant_record(t).home != victim
        # served by the replica within the lease window (+ detection
        # tick + one retry hop)
        assert mttr is not None and mttr <= router.lease_ticks + 6, mttr
        assert router.run_until_quiet(400, advance=0.02)
        for t in tenants:
            rec = router.tenant_record(t)
            for p in acked[t]:
                for b in p:
                    h = decode_change_meta(bytes(b), True)['hash']
                    assert get_change_by_hash(rec.session.handle, h) \
                        is not None, (t, 'acked write lost')
            assert bytes(host_backend.save(rec.session.handle)) == \
                bytes(host_backend.save(rec.replica_handle))

    def test_reset_rule_and_subscription_resync_after_failover(self):
        """The satellite: a re-homed session handshakes fresh
        (reset=True) and its standing subscription cursor re-registers
        — heads the replica never received resolve as a TYPED resync
        event, never a silently stale patch."""
        links = {}

        def factory(src, dst):
            links[(src, dst)] = LossyLink(seed=3)   # clean until darkened
            return links[(src, dst)]

        clk = [0.0]
        # retries=0: the in-flight change-2 apply resolves TYPED at
        # failover instead of racing its retransmit ahead of the
        # subscribe (the retransmit path is pinned at the end)
        router = _router(2, clk, link_factory=factory,
                         backoff=Backoff(base=0.02, retries=0, seed=1))
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        victim, backup = rec.home, rec.replica_on
        # change 1 fully acked (on both copies), cursor caught up
        tk = _settle(router, clk, router.submit(
            't0', 'apply', [_change('cc' * 16, 1)]))
        assert tk.status == 'ok'
        sub = _settle(router, clk, router.submit('t0', 'subscribe'))
        assert sub.status == 'ok' and sub.result['kind'] == 'patch'
        # darken replication, then land change 2 on the HOME only: the
        # subscription serves it (cursor advances past what the replica
        # will ever see), the ack stays pending
        for link in links.values():
            link.crash(10_000)
        pend = router.submit('t0', 'apply', [_change('cc' * 16, 2)])
        for _ in range(20):
            _pump(router, clk)
        assert not pend.done          # await_replica: links are dark
        sub2 = _settle(router, clk, router.submit('t0', 'subscribe'))
        assert sub2.status == 'ok' and sub2.result['kind'] == 'patch'
        assert sub2.result['changes']
        stale_cursor = list(rec.cursor)
        # crash the home: failover promotes the replica
        router.kill_shard(victim)
        for _ in range(router.lease_ticks + 3):
            _pump(router, clk)
        assert rec.home == backup
        assert rec.needs_reset
        assert rec.session.sub_cursor == stale_cursor
        # the never-replicated change was NOT acked: typed, never lost
        # silently (its copy died with the primary)
        assert pend.done and pend.status == 'error'
        assert isinstance(pend.error, ShardUnavailable)
        # the standing subscription resolves TYPED resync (the cursor
        # names change 2, which the replica never received)
        sub3 = _settle(router, clk, router.submit('t0', 'subscribe'))
        assert sub3.status == 'ok', sub3.error
        assert sub3.result['kind'] == 'resync'
        # the first sync request after re-home runs the reset=True rule
        sync = _settle(router, clk, router.submit('t0', 'sync', None))
        assert sync.status == 'ok', sync.error
        assert not rec.needs_reset
        # the client retransmits the un-acked payload byte-identically
        # and it lands on the promoted home (degraded single-copy ack:
        # no second live shard)
        done = _settle(router, clk, router.submit(
            't0', 'apply', [_change('cc' * 16, 2)]), limit=400)
        assert done.status == 'ok', done.error
        h = decode_change_meta(_change('cc' * 16, 2), True)['hash']
        assert get_change_by_hash(rec.session.handle, h) is not None

    def test_unavailable_is_typed_after_budget(self):
        clk = [0.0]
        router = _router(1, clk,
                         backoff=Backoff(base=0.02, cap=0.08,
                                         retries=3, seed=2))
        router.open_tenant('t0')
        router.kill_shard(router.tenant_record('t0').home)
        for _ in range(router.lease_ticks + 2):
            _pump(router, clk)
        before = shard_stats()['shard_unavailable']
        ticket = _settle(router, clk, router.submit(
            't0', 'apply', [_change('dd' * 16, 1)]), limit=100)
        assert ticket.status == 'error'
        assert isinstance(ticket.error, ShardUnavailable)
        assert isinstance(ticket.error, AutomergeError)
        assert shard_stats()['shard_unavailable'] > before

    def test_replica_less_tenant_heals_on_revive(self):
        """A failover that found no spare shard leaves the tenant on
        degraded single-copy acks; the next revive must re-place its
        replica — not leave it single-copy forever."""
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        dead = rec.replica_on
        router.kill_shard(dead)
        for _ in range(router.lease_ticks + 2):
            _pump(router, clk)
        assert rec.replica_on is None       # no spare: replica-less
        degraded = _settle(router, clk, router.submit(
            't0', 'apply', [_change('ba' * 16, 1)]))
        assert degraded.status == 'ok', degraded.error
        router.revive_shard(dead)
        assert rec.replica_on == dead       # healed immediately
        full = _settle(router, clk, router.submit(
            't0', 'apply', [_change('ba' * 16, 2)]), limit=400)
        assert full.status == 'ok', full.error
        h = decode_change_meta(_change('ba' * 16, 2), True)['hash']
        assert get_change_by_hash(rec.replica_handle, h) is not None

    def test_full_outage_open_and_submit_stay_typed(self):
        """submit() for a FIRST-SEEN tenant during a full outage must
        not raise: the tenant records unplaced, its ticket resolves
        typed, and the next revive places it fresh."""
        clk = [0.0]
        router = _router(1, clk,
                         backoff=Backoff(base=0.02, cap=0.08,
                                         retries=2, seed=3))
        only = router.ring.shard_ids()[0]
        router.kill_shard(only)
        for _ in range(router.lease_ticks + 2):
            _pump(router, clk)
        ticket = _settle(router, clk, router.submit(
            'newcomer', 'apply', [_change('ad' * 16, 1)]), limit=100)
        assert ticket.status == 'error'
        assert isinstance(ticket.error, ShardUnavailable)
        router.revive_shard(only)
        rec = router.tenant_record('newcomer')
        assert rec.home == only and rec.session is not None
        ok = _settle(router, clk, router.submit(
            'newcomer', 'apply', [_change('ad' * 16, 1)]), limit=200)
        assert ok.status == 'ok', ok.error


class TestMigration:
    def test_rebalance_readonly_window_and_byte_identity(self):
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        origin = rec.home
        tk = _settle(router, clk, router.submit(
            't0', 'apply', [_change('ee' * 16, 1)]))
        assert tk.status == 'ok'
        assert router.run_until_quiet(200, advance=0.02)
        before_bytes = bytes(host_backend.save(rec.session.handle))
        # crash+revive the home: the tenant fails over, then rebalance
        # migrates it back through park -> ingest -> revive
        router.kill_shard(origin)
        for _ in range(router.lease_ticks + 3):
            _pump(router, clk)
        assert rec.home != origin
        router.revive_shard(origin)
        started = router.rebalance()
        assert started == 1
        saw_readonly = False
        migrations_before = shard_stats()['shard_migrations']
        for _ in range(60):
            _pump(router, clk)
            saw_readonly = saw_readonly or rec.read_only
            if rec.migrating is None and rec.home == origin:
                break
        assert rec.home == origin
        assert saw_readonly            # the reads-only window was real
        assert not rec.read_only
        assert shard_stats()['shard_migrations'] == migrations_before + 1
        assert bytes(host_backend.save(rec.session.handle)) == \
            before_bytes
        assert router.run_until_quiet(300, advance=0.02)
        assert bytes(host_backend.save(rec.replica_handle)) == \
            before_bytes

    def test_write_during_migration_gets_pushback_then_lands(self):
        clk = [0.0]
        router = _router(2, clk)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        origin = rec.home
        router.kill_shard(origin)
        for _ in range(router.lease_ticks + 3):
            _pump(router, clk)
        router.revive_shard(origin)
        router.rebalance()
        _pump(router, clk)             # enter the readonly window
        assert rec.read_only
        ticket = router.submit('t0', 'apply', [_change('ff' * 16, 1)])
        done = _settle(router, clk, ticket, limit=300)
        # the write rode the router's backoff across the window and
        # landed on the migrated-home doc (never silently dropped)
        assert done.status == 'ok', done.error
        h = decode_change_meta(_change('ff' * 16, 1), True)['hash']
        assert rec.home == origin
        assert get_change_by_hash(rec.session.handle, h) is not None


class TestTickTelemetry:
    def test_tick_budget_counts_slips_per_shard(self):
        """A router given a serving cadence attributes overrunning
        pumps PER SHARD (ISSUE-12 satellite) and the Prometheus page
        renders the labeled counters; a free-running router (no
        budget) never counts."""
        clk = [0.0]
        router = _router(2, clk, tick_budget_s=0.0)   # everything slips
        router.open_tenant('t0')
        ticket = _settle(router, clk, router.submit(
            't0', 'apply', [_change('aa' * 16, 1)]))
        assert ticket.status == 'ok', ticket.error
        slips = {sid: s.ticks_slipped for sid, s in router.shards.items()}
        assert all(n > 0 for n in slips.values())
        assert sum(slips.values()) <= shard_stats()['shard_ticks_slipped']
        page = render_prometheus(router=router)
        for sid in router.shards:
            assert (f'automerge_tpu_shard_ticks_slipped_total'
                    f'{{shard="{sid}"}}') in page
            assert f'automerge_tpu_shard_pump_seconds{{shard="{sid}"}}' \
                in page
        free = _router(2, [0.0])
        free.open_tenant('t0')
        free.pump(now=0.0)
        assert all(s.ticks_slipped == 0 for s in free.shards.values())

    def test_obs_report_metrics_mode_surfaces_slips(self, tmp_path):
        from automerge_tpu_torch.observability.export import MetricsExporter
        clk = [0.0]
        router = _router(2, clk, tick_budget_s=0.0)
        router.open_tenant('t0')
        _settle(router, clk, router.submit('t0', 'apply',
                                           [_change('aa' * 16, 1)]))
        snap = tmp_path / 'metrics.prom'
        MetricsExporter(port=None, router=router,
                        snapshot_path=str(snap)).write_snapshot()
        import obs_report
        out = io.StringIO()
        obs_report.render_metrics(str(snap), out=out)
        text = out.getvalue()
        assert 'per-shard slipped ticks' in text
        assert 'shard_ticks_slipped_total{shard="shard0"}' in text


class TestAntiEntropyScrub:
    def test_scrub_flags_silent_divergence_and_heals(self):
        """A replica whose state rotted OUT OF BAND (stand-in: the
        handle swapped for an empty doc) while the pair believes itself
        converged-quiet: the scrub flags it with a typed mismatch event
        and resets the handshake, and the next rounds re-converge the
        pair byte-identically — earlier than the tenant's next write
        would have surfaced it."""
        from automerge_tpu_torch.fleet import backend as fleet_backend
        base = shard_stats()['shard_scrub_mismatches']
        clk = [0.0]
        router = _router(2, clk, scrub_every=5)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        ticket = _settle(router, clk, router.submit(
            't0', 'apply', [_change('aa' * 16, 1)]))
        assert ticket.status == 'ok', ticket.error
        assert router.run_until_quiet(200, advance=0.02)
        assert rec.quiet
        # memory-rot stand-in: replica doc replaced by an empty one,
        # with the pair's bookkeeping still claiming convergence
        rec.replica_handle = fleet_backend.init(
            router.shards[rec.replica_on].fleet)
        rec.last_pair_heads = (rec.last_pair_heads[0], ())
        rec.quiet = True
        found = router.scrub_frontiers()
        assert found == 1
        assert shard_stats()['shard_scrub_mismatches'] == base + 1
        assert router.scrub_mismatches[-1]['tenant'] == 't0'
        assert not rec.quiet
        assert router.run_until_quiet(400, advance=0.02)
        assert bytes(host_backend.save(rec.session.handle)) == \
            bytes(host_backend.save(rec.replica_handle))

    def test_scrub_skips_lagging_and_racing_pairs(self):
        """Normal replication lag (quiet=False) and a home write that
        raced the scrub must NOT flag — divergence events mean damage,
        not traffic."""
        clk = [0.0]
        router = _router(2, clk, scrub_every=0)
        router.open_tenant('t0')
        rec = router.tenant_record('t0')
        ticket = _settle(router, clk, router.submit(
            't0', 'apply', [_change('aa' * 16, 1)]))
        assert ticket.status == 'ok', ticket.error
        assert router.run_until_quiet(200, advance=0.02)
        before = shard_stats()['shard_scrub_mismatches']
        # a home-side write the rounds have not replicated yet: heads
        # differ, home frontier moved -> the scrub must stay silent
        rec.session.handle = host_backend.apply_changes(
            rec.session.handle, [_change('aa' * 16, 2)])[0]
        assert router.scrub_frontiers() == 0
        assert shard_stats()['shard_scrub_mismatches'] == before
        assert router.run_until_quiet(200, advance=0.02)


class TestLinkFaults:
    def test_partition_darkens_then_heals(self):
        link = LossyLink(seed=0)
        assert link.partition(3)
        assert link.dark
        assert link.transmit(b'hello') == []
        assert link.stats['partitioned'] == 1
        assert link.stats['dark_dropped'] == 1
        for _ in range(3):
            link.tick()
        assert not link.dark
        assert link.transmit(b'hello') == [b'hello']

    def test_crash_drops_held_reorder_state(self):
        link = LossyLink(seed=1, p_reorder=1.0)
        assert link.transmit(b'first') == []      # held by the reorder
        assert link._held is not None
        assert link.crash(2)
        assert link._held is None                  # died with the peer
        assert link.stats['crashed'] == 1
        assert link.transmit(b'second') == []      # dark
        link.tick()
        link.tick()
        assert not link.dark

    def test_budget_bounds_dark_windows(self):
        link = LossyLink(seed=2, budget=1)
        assert link.partition(2)
        assert not link.partition(2)       # budget dry: no new window
        assert link.stats['partitioned'] == 1

    def test_wire_faults_health_counts_dark_windows(self):
        from automerge_tpu_torch.observability import health_counts
        before = health_counts()['wire_faults']
        link = LossyLink(seed=3)
        link.partition(1)
        link.crash(1)
        assert health_counts()['wire_faults'] == before + 2

    def test_sync_until_quiet_converges_across_partition(self):
        """A dead-peer window mid-handshake (distinct from per-message
        loss: EVERY message in the window vanishes) heals and the
        protocol + reconnect policy still converge."""
        rng = random.Random(0)
        doc_a = host_backend.init()
        doc_b = host_backend.init()
        for seq in range(1, 6):
            doc_a, _ = host_backend.apply_changes(doc_a, [_change(
                'aa' * 16, seq, rng.randrange(100))])
        link_ab = LossyLink(seed=4, p_partition=0.3, partition_ticks=4,
                            budget=3)
        link_ba = LossyLink(seed=5)
        a, b, rounds, stats = sync_until_quiet(
            doc_a, doc_b, host_backend, host_backend,
            link_ab=link_ab, link_ba=link_ba, stall_reset=4)
        assert sorted(host_backend.get_heads(a)) == \
            sorted(host_backend.get_heads(b))
        assert link_ab.stats['partitioned'] >= 1
        assert link_ab.stats['dark_dropped'] >= 1


class TestShardObservability:
    def test_prometheus_shard_label_on_every_sample(self):
        page = render_prometheus(shard='shard7')
        samples = [line for line in page.splitlines()
                   if line and not line.startswith('#')]
        assert samples
        assert all('shard="shard7"' in line for line in samples), \
            [line for line in samples if 'shard=' not in line][:3]
        assert 'shard=' not in render_prometheus()

    def test_exporter_carries_shard_label(self):
        from automerge_tpu_torch.observability.export import MetricsExporter
        exporter = MetricsExporter(port=None, shard='s1')
        assert 'shard="s1"' in exporter.render()

    def test_stitch_shard_labels_and_ring_truncation(self, tmp_path):
        """A restarted shard exports a WRAPPED span ring: stitch must
        label both shard inputs, disclose the truncation, and still
        report the trace id continuous across the failover."""
        import obs_report
        trace_id = 'deadbeef00000001'
        obs_on(span_capacity=128)
        try:
            clear_spans()
            with span('service_tick', trace=trace_id):
                pass
            export_chrome_trace(str(tmp_path / 'a.json'))
            # the 'restarted' shard: its ring wrapped, older spans gone
            clear_spans()
            for i in range(130):       # > capacity: forces the wrap
                with span('filler', i=i):
                    pass
            with span('sync_receive', trace=trace_id):
                pass
            export_chrome_trace(str(tmp_path / 'b.json'))
        finally:
            obs_off()
            # the wrapped ring would report its dropped spans to every
            # later page rendered in this process
            clear_spans()
        out = io.StringIO()
        shared = obs_report.render_stitch(
            [f'shard0={tmp_path / "a.json"}',
             f'shard1={tmp_path / "b.json"}'],
            str(tmp_path / 'stitched.json'), out=out)
        text = out.getvalue()
        assert trace_id in shared          # continuous across the wrap
        assert 'shard shard1: span ring truncated' in text
        with open(tmp_path / 'stitched.json') as f:
            merged = json.load(f)
        names = [e['args']['name'] for e in merged['traceEvents']
                 if e.get('ph') == 'M']
        assert names == ['shard0', 'shard1']


class TestPortDevice:
    def test_router_without_a_device_needs_cuda(self):
        import torch
        if torch.cuda.is_available():
            pytest.skip('a CUDA device is present')
        with pytest.raises(RuntimeError, match='CUDA'):
            ShardRouter(n_shards=2, clock=lambda: 0.0)

    def test_every_shard_fleet_on_the_routers_device(self):
        router = _router(3, [0.0])
        assert all(str(s.fleet.device) == 'cpu'
                   for s in router.shards.values())
        victim = router.ring.shard_ids()[0]
        router.kill_shard(victim)
        router.revive_shard(victim)
        assert str(router.shards[victim].fleet.device) == 'cpu'

    def test_revive_drops_the_dead_fleet(self):
        """Kill and revive one shard 3x under traffic: each dead
        incarnation's fleet, service and storage engine are unreachable
        once the router has failed its tenants over, so their device
        memory can be freed."""
        import gc
        import weakref
        clk = [0.0]
        router = _router(3, clk)
        for i in range(6):
            router.open_tenant(f't{i}')
        victim = router.tenant_record('t0').home
        dead = []
        for cycle in range(3):
            tickets = [router.submit(f't{i}', 'apply', [_change(
                f'{i:02x}' * 16, cycle + 1, cycle)]) for i in range(6)]
            for t in tickets:
                _settle(router, clk, t, limit=400)
            assert all(t.status == 'ok' for t in tickets), \
                [(t.status, t.error) for t in tickets]
            dead.append(weakref.ref(router.shards[victim].fleet))
            router.kill_shard(victim)
            _pump(router, clk, router.lease_ticks + 2)
            router.revive_shard(victim)
            router.rebalance()
            assert router.run_until_quiet(400, advance=0.02)
        gc.collect()
        assert [ref() for ref in dead] == [None, None, None]
        for i in range(6):
            rec = router.tenant_record(f't{i}')
            assert bytes(host_backend.save(rec.session.handle)) == \
                bytes(host_backend.save(rec.replica_handle))
