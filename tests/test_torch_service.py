# The port's copy of tests/test_service.py: imports re-pointed at
# automerge_tpu_torch, fleets on the CPU (device='cpu').
"""Unit coverage for the overload-safe serving core (ISSUE-7).

Policy objects (token bucket, backoff, retry budget, deadline, brownout
ladder) are tested on injected clocks — no wall-clock sleeps — and the
service-level contracts are pinned end to end: typed admission
rejections, all-or-nothing deadlines at the fused-dispatch seam,
transient-fault retries under budget, brownout transitions moving
health counters and the journal's fsync batching, and the two
containment holes the chaos client flushed out (corrupt magic bytes,
unknown-type chunks with bad checksums) staying typed quarantines.
"""

import os
import sys

import pytest

import automerge_tpu_torch.backend as host_backend
from automerge_tpu_torch import native
from automerge_tpu_torch.columnar import encode_change
from automerge_tpu_torch.errors import (AutomergeError, DeadlineExceeded,
                                  MalformedChange, Overloaded,
                                  RetriesExhausted, SyncStalled,
                                  TenantThrottled, WireCorruption)
from automerge_tpu_torch.fleet import backend as fleet_backend
from automerge_tpu_torch.fleet.backend import DocFleet
from automerge_tpu_torch.service import (AdmissionController, Backoff,
                                   BrownoutController, Deadline, DocService,
                                   RetryBudget, TokenBucket, service_stats)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason='native codec unavailable')


def change_bytes(actor, seq, val=1, key='k'):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': seq, 'time': 0,
        'message': '', 'deps': [],
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}]})


# ---------------------------------------------------------------------------
# policy objects (no fleet, no clocks but the injected one)
# ---------------------------------------------------------------------------


def test_token_bucket_refill_and_deny():
    b = TokenBucket(rate=10.0, burst=2.0)
    assert b.take(0.0) is None
    assert b.take(0.0) is None
    wait = b.take(0.0)
    assert wait is not None and wait > 0
    # after the advertised wait, a token is back
    assert b.take(0.0 + wait) is None


def test_backoff_schedule_bounded_and_deterministic():
    a = Backoff(base=0.1, factor=2.0, cap=1.0, retries=4, jitter=0.5,
                seed=7)
    b = Backoff(base=0.1, factor=2.0, cap=1.0, retries=4, jitter=0.5,
                seed=7)
    da = [a.delay(k) for k in range(8)]
    db = [b.delay(k) for k in range(8)]
    assert da == db                       # seeded => replayable
    for k, d in enumerate(da):
        assert 0 < d <= 1.0               # jitter only shrinks, cap holds
        assert d <= min(1.0, 0.1 * 2.0 ** k)
    assert not a.exhausted(3)
    assert a.exhausted(4)


def test_retry_budget_refills_at_rate():
    rb = RetryBudget(rate=1.0, burst=2.0)
    assert rb.spend(0.0) and rb.spend(0.0)
    assert not rb.spend(0.0)              # dry
    assert rb.denied == 1
    assert rb.spend(1.5)                  # refilled


def test_deadline_typed_check():
    clock = [0.0]
    d = Deadline.after(1.0, clock=lambda: clock[0])
    d.check()                             # fine
    clock[0] = 2.0
    assert d.expired()
    with pytest.raises(DeadlineExceeded) as exc:
        d.check(what='unit')
    assert exc.value.late_by == pytest.approx(1.0)
    assert isinstance(exc.value, ValueError)   # taxonomy contract


def test_admission_typed_rejections_and_fair_drain():
    adm = AdmissionController(rate=1000.0, burst=1000.0, queue_limit=4,
                              max_queued=6)
    for i in range(4):
        adm.admit('a', f'a{i}', now=0.0)
    with pytest.raises(TenantThrottled) as exc:
        adm.admit('a', 'a4', now=0.0)     # tenant queue full
    assert exc.value.tenant == 'a'
    adm.admit('b', 'b0', now=0.0)
    adm.admit('b', 'b1', now=0.0)
    with pytest.raises(Overloaded):
        adm.admit('c', 'c0', now=0.0)     # global ceiling
    # round-robin drain: b is not starved behind a's queue
    order = adm.drain(4)
    assert 'b0' in order[:3]
    # rate limiting is typed too, with a retry hint
    adm2 = AdmissionController(rate=1.0, burst=1.0, queue_limit=10,
                               max_queued=10)
    adm2.admit('t', 'r0', now=0.0)
    with pytest.raises(TenantThrottled) as exc:
        adm2.admit('t', 'r1', now=0.0)
    assert exc.value.retry_after > 0


def test_brownout_ladder_hysteresis_and_counters():
    from automerge_tpu_torch.service import brownout_stats
    bo = BrownoutController(high=0.8, low=0.2, up_ticks=2, down_ticks=3)
    before = brownout_stats()
    assert bo.observe(0.9) == 0           # one tick is not sustained
    assert bo.observe(0.9) == 1           # two ticks climb one stage
    assert bo.observe(0.5) == 1           # middle band holds
    bo.observe(0.9)
    assert bo.observe(0.9) == 2
    bo.observe(0.9), bo.observe(0.9)
    assert bo.stage == 3
    assert bo.shed_below() == bo.shed_priority
    assert bo.defer_compaction
    for _ in range(3):
        bo.observe(0.1)
    assert bo.stage == 2                  # one stage per transition
    after = brownout_stats()
    assert after['brownout_escalations'] - before['brownout_escalations'] == 3
    assert after['brownout_deescalations'] - \
        before['brownout_deescalations'] == 1
    assert len(bo.transitions) == 4


# ---------------------------------------------------------------------------
# service-level contracts (one shared small fleet; compile cost paid once)
# ---------------------------------------------------------------------------


def make_service(**kw):
    kw.setdefault('fleet', DocFleet(doc_capacity=8, key_capacity=64,
                                    device='cpu'))
    kw.setdefault('tenant_rate', 10_000.0)
    kw.setdefault('tenant_burst', 1000.0)
    return DocService(**kw)


def test_service_apply_and_sync_roundtrip():
    svc = make_service()
    s_edit, s_sync = svc.open_sessions(['t0', 't1'])
    t1 = svc.submit(s_edit, 'apply', [change_bytes('aa' * 16, 1, 7)])
    # client replica for the sync session
    import automerge_tpu_torch as A
    doc = A.frontend.get_backend_state(A.init('bb' * 16), 'svc-unit')
    doc, _ = host_backend.apply_changes(doc, [change_bytes('bb' * 16, 1, 9)])
    state, msg = host_backend.generate_sync_message(
        doc, host_backend.init_sync_state())
    t2 = svc.submit(s_sync, 'sync', msg)
    svc.pump()
    assert t1.status == 'ok' and t1.latency is not None
    assert t2.status == 'ok'
    # handshake to quiet: the client replica and the service doc converge
    for _ in range(12):
        doc, state, _ = host_backend.receive_sync_message(
            doc, state, t2.result) if t2.result is not None \
            else (doc, state, None)
        state, msg = host_backend.generate_sync_message(doc, state)
        if msg is None and t2.result is None:
            break
        t2 = svc.submit(s_sync, 'sync', msg)
        svc.pump()
    assert host_backend.get_heads(s_sync.handle) == \
        host_backend.get_heads(doc)


def test_expired_deadline_is_typed_and_never_partially_commits():
    svc = make_service()
    session = svc.open_session('t0')
    ok = svc.submit(session, 'apply', [change_bytes('cc' * 16, 1)])
    svc.pump()
    assert ok.status == 'ok'
    late = svc.submit(session, 'apply', [change_bytes('cc' * 16, 2)],
                      timeout=-0.001)
    svc.pump()
    assert late.status == 'error'
    assert isinstance(late.error, DeadlineExceeded)
    # all-or-nothing: the doc holds exactly the committed prefix
    assert len(host_backend.get_all_changes(session.handle)) == 1
    assert service_stats()['deadline_exceeded'] >= 1


def test_seam_deadline_checks_are_typed_and_pre_dispatch():
    fleet = DocFleet(doc_capacity=4, key_capacity=64, device='cpu')
    handles = fleet_backend.init_docs(2, fleet)
    clock = [0.0]
    expired = Deadline(-1.0, clock=lambda: clock[0])
    with pytest.raises(DeadlineExceeded):
        fleet_backend.apply_changes_docs(
            handles, [[change_bytes('aa' * 16, 1)], []], mirror=False,
            deadline=expired)
    # nothing mutated: the docs still apply cleanly afterwards
    out, _ = fleet_backend.apply_changes_docs(
        handles, [[change_bytes('aa' * 16, 1)], []], mirror=False)
    assert len(host_backend.get_all_changes(out[0])) == 1
    from automerge_tpu_torch.fleet.sync_driver import (
        generate_sync_messages_docs, receive_sync_messages_docs)
    with pytest.raises(DeadlineExceeded):
        generate_sync_messages_docs(
            out, [host_backend.init_sync_state() for _ in out],
            deadline=expired)
    with pytest.raises(DeadlineExceeded):
        receive_sync_messages_docs(
            out, [host_backend.init_sync_state() for _ in out],
            [None, None], mirror=False, deadline=expired)


def test_quarantine_failure_is_typed_and_contained():
    svc = make_service()
    good, bad = svc.open_sessions(['t0', 't0'])
    ok = svc.submit(good, 'apply', [change_bytes('aa' * 16, 1, 5)])
    buf = bytearray(change_bytes('bb' * 16, 1))
    buf[20] ^= 0xFF
    poisoned = svc.submit(bad, 'apply', [bytes(buf)])
    svc.pump()
    assert ok.status == 'ok'
    assert poisoned.status == 'error'
    assert isinstance(poisoned.error, AutomergeError)
    assert len(host_backend.get_all_changes(bad.handle)) == 0


def test_corrupt_magic_is_quarantined_not_stored():
    """Pin for the native codec fix: a change whose MAGIC bytes are
    corrupt must be a typed quarantine — before the fix the native
    parser skipped the magic check, the ops landed on the device, and
    the garbage bytes entered the change log where save() exploded."""
    fleet = DocFleet(doc_capacity=4, key_capacity=64, device='cpu')
    base = change_bytes('dd' * 16, 1)
    for pos in range(4):
        corrupt = bytearray(base)
        corrupt[pos] ^= 0x40
        handles = fleet_backend.init_docs(1, fleet)
        out, _, errs = fleet_backend.apply_changes_docs(
            handles, [[bytes(corrupt)]], mirror=False,
            on_error='quarantine')
        assert errs[0] is not None, f'magic flip at byte {pos} accepted'
        assert isinstance(errs[0].error, WireCorruption)
        assert len(host_backend.get_all_changes(out[0])) == 0
        host_backend.save(out[0])          # and the doc still saves
        fleet_backend.free_docs(out)


def test_unknown_chunk_type_with_bad_checksum_is_quarantined():
    """Pin for the screen fix: a bit flip IN the chunk-type byte makes
    the container an 'unknown type' whose checksum no longer validates —
    it must quarantine typed, not slide through as nothing-to-apply
    (which resolved the request ok without applying anything)."""
    fleet = DocFleet(doc_capacity=4, key_capacity=64, device='cpu')
    base = bytearray(change_bytes('ee' * 16, 1))
    base[8] ^= 0x20                        # type 0x01 -> 0x21
    handles = fleet_backend.init_docs(1, fleet)
    out, _, errs = fleet_backend.apply_changes_docs(
        handles, [[bytes(base)]], mirror=False, on_error='quarantine')
    assert errs[0] is not None
    assert isinstance(errs[0].error, WireCorruption)
    fleet_backend.free_docs(out)


def test_transient_fault_retries_then_succeeds():
    clock = [0.0]
    svc = make_service(clock=lambda: clock[0],
                       backoff=Backoff(base=0.01, cap=0.1, retries=5,
                                       seed=3))
    session = svc.open_session('t0')
    clean = [change_bytes('aa' * 16, 1, 3)]
    corrupt = bytearray(clean[0])
    corrupt[20] ^= 0xFF
    draws = [bytes(corrupt), bytes(corrupt), clean[0]]   # 2 faults, then ok

    def payload_fn():
        return [draws.pop(0)] if draws else clean

    before = service_stats()['service_retries']
    ticket = svc.submit(session, 'apply', payload_fn=payload_fn)
    for _ in range(20):
        if ticket.done:
            break
        svc.pump(now=clock[0])
        clock[0] += 0.05                   # ripen the backoff parking
    assert ticket.status == 'ok'
    assert service_stats()['service_retries'] - before == 2
    assert len(host_backend.get_all_changes(session.handle)) == 1


def test_retry_budget_exhaustion_is_typed():
    clock = [0.0]
    svc = make_service(clock=lambda: clock[0],
                       backoff=Backoff(base=0.01, cap=0.02, retries=3,
                                       seed=0),
                       retry_rate=100.0, retry_burst=100.0)
    session = svc.open_session('t0')
    corrupt = bytearray(change_bytes('aa' * 16, 1))
    corrupt[20] ^= 0xFF

    ticket = svc.submit(session, 'apply',
                        payload_fn=lambda: [bytes(corrupt)])
    for _ in range(30):
        if ticket.done:
            break
        svc.pump(now=clock[0])
        clock[0] += 0.05
    assert ticket.status == 'error'
    assert isinstance(ticket.error, RetriesExhausted)
    assert isinstance(ticket.error.__cause__, WireCorruption)
    assert ticket.error.attempts == 3
    assert len(host_backend.get_all_changes(session.handle)) == 0


def test_tenant_fairness_under_flood():
    """An aggressive tenant floods its queue; a light tenant's request
    still completes on the next pump (round-robin drain + per-tenant
    queues = the flood cannot age other tenants)."""
    svc = make_service(tenant_queue=512, max_queued=10_000,
                       batch_limit=64)
    heavy = [svc.open_session('whale') for _ in range(4)]
    light = svc.open_session('minnow')
    seqs = {id(s): 0 for s in heavy}
    flood = []
    for i in range(256):
        s = heavy[i % 4]
        seqs[id(s)] += 1
        flood.append(svc.submit(
            s, 'apply', [change_bytes(f'{i % 4:02x}' * 16, seqs[id(s)])]))
    t_light = svc.submit(light, 'apply', [change_bytes('ff' * 16, 1)])
    svc.pump()
    assert t_light.status == 'ok'          # served in the FIRST tick
    assert sum(1 for t in flood if t.done) < len(flood)  # whale still queued


def test_brownout_widen_fsync_and_restore(tmp_path):
    from automerge_tpu_torch.fleet.durability import DurableFleet
    durable = DurableFleet(str(tmp_path / 'dur'), fsync_bytes=64,
                           doc_capacity=8, key_capacity=64, device='cpu')
    svc = DocService(durable=durable, tenant_rate=10_000.0,
                     brownout=BrownoutController(high=0.5, low=0.1,
                                                 up_ticks=1, down_ticks=3,
                                                 fsync_widen_bytes=1 << 20))
    session = svc.open_session('t0')
    journal = durable.journal
    assert journal.fsync_bytes == 64
    svc.brownout.observe(0.9)              # stage 1: widen
    assert journal.fsync_bytes == 1 << 20
    # the widened loss window is visible through the health counter
    t = svc.submit(session, 'apply', [change_bytes('aa' * 16, 1)])
    svc.pump()
    assert t.status == 'ok'
    from automerge_tpu_torch.observability import health_counts
    assert health_counts()['pending_fsync_bytes'] > 0
    for _ in range(3):                     # de-escalate: restore + close
        svc.brownout.observe(0.0)
    assert journal.fsync_bytes == 64
    assert journal.pending_fsync_bytes == 0
    durable.close()


def test_brownout_stage3_sheds_low_priority_sync_typed():
    svc = make_service()
    session = svc.open_session('t0')
    svc.brownout.stage = 3                 # force the top of the ladder
    shed = svc.submit(session, 'sync', None, priority=0)
    kept = svc.submit(session, 'sync', None, priority=2)
    svc.pump()
    assert shed.status == 'error'
    assert isinstance(shed.error, Overloaded)
    assert shed.error.shed is True and shed.error.stage == 3
    assert kept.status == 'ok'
    from automerge_tpu_torch.service import brownout_stats
    assert brownout_stats()['shed_sync_rounds'] >= 1


def test_sync_reconnect_reset_converges_against_poisoned_server():
    """Regression for the reconnect livelock: a client that lost its
    sync state mid-handshake re-handshakes with reset=True; the service
    must answer from fresh state (simultaneous-handshake rule) instead
    of staying silent behind its stale sentHashes."""
    import automerge_tpu_torch as A
    svc = make_service()
    session = svc.open_session('t0')
    doc = A.frontend.get_backend_state(A.init('ab' * 16), 'reset-unit')
    doc, _ = host_backend.apply_changes(doc, [change_bytes('ab' * 16, 1)])
    state = host_backend.init_sync_state()
    # half a handshake, then the client loses its state (crash)
    state, msg = host_backend.generate_sync_message(doc, state)
    t = svc.submit(session, 'sync', msg)
    svc.pump()
    state = host_backend.init_sync_state()     # client-side reconnect
    converged = False
    fresh = True
    for _ in range(12):
        state, msg = host_backend.generate_sync_message(doc, state)
        t = svc.submit(session, 'sync', msg, reset=fresh)
        fresh = False
        svc.pump()
        assert t.status == 'ok'
        if t.result is not None:
            doc, state, _ = host_backend.receive_sync_message(
                doc, state, t.result)
        if msg is None and t.result is None:
            converged = True
            break
    assert converged
    assert host_backend.get_heads(session.handle) == \
        host_backend.get_heads(doc)


def test_async_facade_roundtrip():
    import asyncio
    from automerge_tpu_torch.service import AsyncDocService

    svc = make_service()
    session = svc.open_session('t0')
    facade = AsyncDocService(svc, idle_sleep=0.001)

    async def go():
        pump = asyncio.create_task(facade.run())
        ticket = await facade.submit(session, 'apply',
                                     [change_bytes('aa' * 16, 1)])
        with pytest.raises(DeadlineExceeded):
            await facade.submit(session, 'apply',
                                [change_bytes('aa' * 16, 2)],
                                timeout=-0.01)
        facade.stop()
        await pump
        return ticket

    ticket = asyncio.run(go())
    assert ticket.status == 'ok'


# ---------------------------------------------------------------------------
# satellites: flight-dump rate limit, stall give-up, loss-window counter
# ---------------------------------------------------------------------------


def test_flight_dump_rate_limit(tmp_path):
    from automerge_tpu_torch.observability import recorder
    try:
        recorder.configure(dump_dir=str(tmp_path), dump_limit=3,
                           dump_window_s=3600.0)
        before = recorder.flight_stats()
        for _ in range(8):
            recorder.dump_flight_record('unit_rate_limit')
        files = [f for f in os.listdir(tmp_path)
                 if f.startswith('flight-unit_rate_limit')]
        assert len(files) == 3             # the cap held on disk
        after = recorder.flight_stats()
        assert after['flight_dumps'] - before['flight_dumps'] == 8
        assert after['dumps_suppressed'] - before['dumps_suppressed'] == 5
        # suppressed dumps still assemble in memory, flagged
        assert recorder.last_flight_record()['suppressed'] is True
        # an explicit path bypasses the limit (operator override)
        report = recorder.dump_flight_record(
            'unit_rate_limit', path=str(tmp_path / 'explicit.json'))
        assert os.path.exists(report['path'])
    finally:
        recorder.configure(dump_dir=None, dump_limit=16,
                           dump_window_s=60.0)


def test_sync_until_quiet_typed_giveup_and_backoff():
    import automerge_tpu_torch as A
    from automerge_tpu_torch.fleet.faults import LossyLink, sync_until_quiet
    base = A.change(A.init('aa' * 16), lambda d: d.update({'x': 1}))
    db = A.merge(A.init('bb' * 16), base)
    da = A.change(base, lambda d: d.update({'y': 2}))
    db = A.change(db, lambda d: d.update({'z': 3}))
    ha = A.frontend.get_backend_state(da, 'giveup-a')
    hb = A.frontend.get_backend_state(db, 'giveup-b')
    # a dead wire: the driver must give up TYPED, not assert
    with pytest.raises(SyncStalled) as exc:
        sync_until_quiet(ha, hb, host_backend, host_backend,
                         LossyLink(seed=1, p_drop=1.0),
                         LossyLink(seed=2, p_drop=1.0), max_rounds=48)
    assert isinstance(exc.value, RetriesExhausted)
    assert exc.value.rounds == 48
    assert exc.value.detail['ab']['dropped'] > 0
    # bounded faults still converge through the jittered reconnects
    ha2 = A.frontend.get_backend_state(da, 'giveup-a2')
    hb2 = A.frontend.get_backend_state(db, 'giveup-b2')
    na, nb, _rounds, stats = sync_until_quiet(
        ha2, hb2, host_backend, host_backend,
        LossyLink(seed=3, p_drop=0.3, budget=6),
        LossyLink(seed=4, p_drop=0.3, budget=6))
    assert host_backend.get_heads(na) == host_backend.get_heads(nb)


def test_pending_fsync_bytes_counter_and_alert(tmp_path):
    from automerge_tpu_torch.fleet import durability as dur
    from automerge_tpu_torch.observability import health_counts, recorder
    prev = dur.set_fsync_alert_threshold(128)
    try:
        j = dur.ChangeJournal(str(tmp_path / 'journal-0.log'),
                              fsync_bytes=1 << 20)
        before_alerts = health_counts()['fsync_window_alerts']
        j.append(0, b'x' * 32)
        j.commit()                         # below threshold: no alert
        assert health_counts()['fsync_window_alerts'] == before_alerts
        j.append(0, b'y' * 256)
        j.commit()                         # crosses: one edge-triggered
        h = health_counts()
        assert h['pending_fsync_bytes'] >= 256
        assert h['fsync_window_alerts'] == before_alerts + 1
        assert any(e['kind'] == 'fsync_window_alert'
                   for e in recorder.recent_events())
        j.append(0, b'z' * 256)
        j.commit()                         # still open: NOT re-alerted
        assert health_counts()['fsync_window_alerts'] == before_alerts + 1
        j.sync()                           # window closes, counter drops
        assert health_counts()['pending_fsync_bytes'] == 0
        j.append(0, b'w' * 256)
        j.commit()                         # re-armed: alerts again
        assert health_counts()['fsync_window_alerts'] == before_alerts + 2
        j.close()
    finally:
        dur.set_fsync_alert_threshold(prev)


# ---------------------------------------------------------------------------
# query request kinds (round 13): time-travel reads + subscriptions
# ---------------------------------------------------------------------------

def _chained_change(actor, seq, deps, key, val):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': seq, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}]})


def _edited_session(svc, tenant='t0', rounds=3):
    """A session whose doc holds `rounds` chained changes; returns
    (session, frontiers) with frontiers[k] = heads after k changes."""
    from automerge_tpu_torch.columnar import decode_change_meta
    session = svc.open_session(tenant)
    frontier, frontiers = [], [[]]
    for r in range(rounds):
        buf = _chained_change('ee' * 16, r + 1, frontier, f'k{r}', r)
        frontier = [decode_change_meta(buf, True)['hash']]
        frontiers.append(list(frontier))
        t = svc.submit(session, 'apply', [buf])
        svc.pump()
        assert t.status == 'ok', t.error
    return session, frontiers


def test_materialize_at_kind_returns_historical_chunk():
    svc = make_service()
    session, frontiers = _edited_session(svc)
    t = svc.submit(session, 'materialize_at', frontiers[2])
    svc.pump()
    assert t.status == 'ok', t.error
    doc = host_backend.load(t.result)
    assert host_backend.get_heads(doc) == sorted(frontiers[2])
    # the ephemeral read doc was freed: session doc still live, fleet
    # slot count unchanged after the read batch
    assert session.handle['state'].is_fleet


def test_materialize_at_unknown_heads_typed_contained():
    from automerge_tpu_torch.errors import UnknownHeads
    svc = make_service()
    session, frontiers = _edited_session(svc)
    bad = svc.submit(session, 'materialize_at', ['ee' * 32])
    good = svc.submit(session, 'materialize_at', frontiers[1])
    svc.pump()
    assert bad.status == 'error'
    assert isinstance(bad.error, UnknownHeads)
    assert good.status == 'ok'     # the bad frontier cost only its slot


def test_subscribe_kind_incremental_and_wire_cursor():
    from automerge_tpu_torch.query import encode_cursor
    svc = make_service()
    session, frontiers = _edited_session(svc)
    # first pull: full state from the session's empty cursor
    t1 = svc.submit(session, 'subscribe')
    svc.pump()
    assert t1.status == 'ok'
    assert t1.result['kind'] == 'patch'
    assert len(t1.result['changes']) == 3
    shadow = host_backend.init()
    shadow, _ = host_backend.apply_changes(shadow, t1.result['changes'])
    assert bytes(host_backend.save(shadow)) == \
        bytes(session.handle['state'].save())
    # cursor advanced server-side: next pull is an empty patch
    t2 = svc.submit(session, 'subscribe')
    svc.pump()
    assert t2.result['changes'] == []
    # an explicit wire cursor replays from its frontier (idempotent)
    t3 = svc.submit(session, 'subscribe', encode_cursor(frontiers[1]))
    svc.pump()
    assert len(t3.result['changes']) == 2


def test_subscribe_hostile_cursor_fails_typed():
    from automerge_tpu_torch.errors import InvalidCursor
    svc = make_service()
    session, _ = _edited_session(svc, rounds=1)
    t = svc.submit(session, 'subscribe', b'\x00garbage')
    svc.pump()
    assert t.status == 'error'
    assert isinstance(t.error, InvalidCursor)


def test_subscribe_bogus_cursor_resyncs_typed():
    from automerge_tpu_torch.query import encode_cursor
    svc = make_service()
    session, _ = _edited_session(svc)
    t = svc.submit(session, 'subscribe', encode_cursor(['99' * 32]))
    svc.pump()
    assert t.status == 'ok'
    assert t.result['kind'] == 'resync'
    shadow = host_backend.init()
    shadow, _ = host_backend.apply_changes(shadow, t.result['changes'])
    assert bytes(host_backend.save(shadow)) == \
        bytes(session.handle['state'].save())


def test_subscription_push_is_first_shed():
    """Subscription pushes default to sub-priority: at brownout stage 3
    they shed (typed, cursor unmoved) while default-priority sync and
    apply keep flowing."""
    from automerge_tpu_torch.errors import Overloaded
    svc = make_service()
    session, _ = _edited_session(svc, rounds=1)
    svc.brownout.stage = 3
    sub = svc.submit(session, 'subscribe')
    app = svc.submit(session, 'apply',
                     [_chained_change('dd' * 16, 1, [], 'x', 1)])
    sync = svc.submit(session, 'sync', None)
    svc.pump()
    assert sub.status == 'error'
    assert isinstance(sub.error, Overloaded)
    assert sub.error.shed is True
    assert session.sub_cursor == []       # a shed never advances it
    assert app.status == 'ok'
    assert sync.status == 'ok'
    # explicit priority keeps a subscription alive through the shed
    kept = svc.submit(session, 'subscribe', priority=2)
    svc.pump()
    assert kept.status == 'ok'


def test_subscription_tick_diff_reuse_across_requests():
    from automerge_tpu_torch.query import query_stats
    svc = make_service()
    session, _ = _edited_session(svc)
    before = query_stats()['subscription_diff_reuse']
    tickets = [svc.submit(session, 'subscribe', []) for _ in range(6)]
    svc.pump()
    assert all(t.status == 'ok' for t in tickets)
    assert query_stats()['subscription_diff_reuse'] - before == 5


# ---------------------------------------------------------------------------
# the port against the reference: one fake-clock leg through both
# packages' load generators (tools/loadgen.py, service_cases.py)
# ---------------------------------------------------------------------------

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tools'))

import loadgen                                                  # noqa: E402
from automerge_tpu import native as ref_native                  # noqa: E402
from automerge_tpu.fleet.backend import DocFleet as RefFleet    # noqa: E402
from automerge_tpu.observability import (                       # noqa: E402
    health_counts as ref_health)
from automerge_tpu.service import DocService as RefService      # noqa: E402
from automerge_tpu_torch import service_cases                   # noqa: E402
from automerge_tpu_torch.observability import (                 # noqa: E402
    health_counts, slo_stats)
from automerge_tpu_torch.service import brownout_stats          # noqa: E402

# a small chaos leg: corruptions, deadlines, retries and the global
# ceiling all fire at this dose (typed rejections of four kinds)
LEG = dict(sessions=12, tenants=3, requests=60, seed=3, tick_dt=0.01,
           collect_saves=True, chaos=True)
# what a leg reports that is not wall time
EXACT_KEYS = ('leg', 'sessions', 'tenants', 'requests_offered', 'submitted',
              'completed_ok', 'rejections', 'untyped_escapes', 'ticks',
              'p50_ms', 'p95_ms', 'p99_ms', 'brownout_stage_final',
              'brownout_transitions', 'disconnected', 'replayed',
              'chaos_draws', 'chaos_corrupted', 'convergence', 'slo_audit',
              'slo_alerts', 'session_saves')


def _run_keeping_service(cls, health, run):
    """Run one leg; return its report, the health counters it moved and
    the service it built (kept to read its SLO registry)."""
    kept = []
    real = cls.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        kept.append(self)
    cls.__init__ = init
    try:
        before = health()
        report = run()
        after = health()
    finally:
        cls.__init__ = real
    moved = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    return report, moved, kept[0]


@pytest.mark.skipif(not ref_native.available(),
                    reason='reference native codec unavailable')
def test_fake_clock_leg_equals_the_reference():
    ref, ref_moved, ref_svc = _run_keeping_service(
        RefService, ref_health,
        lambda: loadgen.run_leg('x', fleet=RefFleet(), **LEG))
    got, got_moved, got_svc = _run_keeping_service(
        DocService, health_counts,
        lambda: service_cases.run_leg('x', fleet=DocFleet(device='cpu'),
                                      device='cpu', **LEG))
    for key in EXACT_KEYS:
        assert got[key] == ref[key], key
    assert got['untyped_escapes'] == 0 and got['completed_ok'] > 0
    assert len(got['rejections']) >= 4
    assert got_svc.slo.tallies() == ref_svc.slo.tallies()
    # the health counters the leg moved: the same keys in both packages,
    # and the service's own families by the same amounts
    assert set(got_moved) == set(ref_moved)
    families = set(service_stats()) | set(brownout_stats()) | \
        set(slo_stats())
    assert {k: v for k, v in got_moved.items() if k in families} == \
        {k: v for k, v in ref_moved.items() if k in families}


def test_service_without_a_device_needs_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        DocService()
    with pytest.raises(RuntimeError, match='CUDA'):
        service_cases.run_leg('x', sessions=2, tenants=1, requests=2)
