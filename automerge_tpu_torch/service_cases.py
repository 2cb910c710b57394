"""Zipf-tenant open-loop load generator + chaos client for the service
(the port's copy of the service legs of tools/loadgen.py).

`ZipfSampler`, `ChaosClient`, the edit and sync clients, `run_leg` and
`run_standard_legs` are copies with their imports re-pointed at this
package. The differences: `run_leg` takes `device=` (the leg's fleets
run on the card unless the caller asks otherwise) and an `audit=` hook
that gets the served documents and the changes each committed
(chip_smoke.py holds the card's rows to a CPU fleet's there);
`run_standard_legs` passes them on and takes `around=`, a context
around each leg. The shard legs and the tier legs are in
shard_cases.py.

The reference's description follows.

An OPEN-LOOP arrival process (arrivals do not wait for completions — the
honest overload model; a closed loop self-throttles and hides collapse)
over a Zipf-skewed tenant population (tenant 1 is the whale, the tail is
long — the distribution under which per-tenant fairness actually earns
its keep), with an optional CHAOS CLIENT that does everything a hostile
or broken real client does:

- corrupts sync/apply payloads in flight (seeded bit flips/truncation on
  a per-attempt transport draw, so service-side retries genuinely
  re-draw — some attempts arrive clean);
- violates deadlines (submits work with deadlines it cannot meet);
- replays already-delivered changes (idempotency probe);
- floods (bursts far past its token bucket, eating typed throttles);
- disconnects sessions mid-flight and abandons their queued work.

Three standard legs — ``clean``, ``chaos``, ``overload`` (2x arrival
rate into reduced admission capacity) — each reporting p50/p95/p99
request latency, sustained rounds/s and requests/s, every rejection
bucketed BY TYPE (an untyped escape anywhere fails the run), brownout
ladder transitions, and a convergence audit: every edit session's doc
must be byte-identical to an unloaded control fleet fed exactly the
committed requests, and every sync session's client replica must reach
head-equality with its service doc after a drain. Every leg also runs
the SLO AUDIT: the service SloRegistry's per-tenant outcome tallies
must match the client-observed typed outcomes EXACTLY, so a
double-count or missed-reject in the accounting plane fails the leg —
and ``latency_step=(tick, extra_s)`` injects a synthetic mid-leg
latency regression for timing the burn-rate alert's detection.
"""

import bisect
import contextlib
import random
import time

import automerge_tpu_torch as A
from . import backend as host_backend
from .columnar import encode_change
from .errors import AutomergeError
from .fleet import backend as fleet_backend
from .fleet.backend import DocFleet
from .observability.slo import outcome_class
from .service import DocService

__all__ = ['ZipfSampler', 'ChaosClient', 'run_leg', 'run_standard_legs']


class ZipfSampler:
    """Zipf(s) over n tenants: weight(k) ~ 1/k^s, sampled via one
    bisect on the cumulative table."""

    def __init__(self, n, s=1.2):
        weights = [1.0 / (k + 1) ** s for k in range(n)]
        total = sum(weights)
        self.cum = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self.cum.append(acc)

    def draw(self, rng):
        return bisect.bisect_left(self.cum, rng.random())


class ChaosClient:
    """Per-attempt transport mischief, seeded. ``wrap(payload)`` returns
    a payload_fn whose every call is one transport draw: usually the
    clean bytes, sometimes flipped/truncated/None. The service's retry
    path re-draws through it, so corruption is genuinely transient."""

    def __init__(self, seed, p_corrupt=0.3, p_truncate=0.1, p_drop=0.05):
        self.rng = random.Random(seed)
        self.p_corrupt = p_corrupt
        self.p_truncate = p_truncate
        self.p_drop = p_drop
        self.draws = 0
        self.corrupted = 0

    def _mangle_one(self, buf):
        roll = self.rng.random()
        if roll < self.p_drop:
            self.corrupted += 1
            return None
        if roll < self.p_drop + self.p_truncate and len(buf) > 1:
            self.corrupted += 1
            return buf[:self.rng.randrange(1, len(buf))]
        if roll < self.p_drop + self.p_truncate + self.p_corrupt and buf:
            self.corrupted += 1
            out = bytearray(buf)
            pos = self.rng.randrange(len(out))
            out[pos] ^= 1 << self.rng.randrange(8)
            return bytes(out)
        return buf

    def wrap_changes(self, buffers):
        """payload_fn for an 'apply' request (list of change bytes)."""
        clean = [bytes(b) for b in buffers]

        def draw():
            self.draws += 1
            out = []
            for buf in clean:
                got = self._mangle_one(buf)
                if got is None:
                    return None           # transport delivered nothing
                out.append(got)
            return out
        return draw

    def wrap_message(self, message):
        """payload_fn for a 'sync' request (one message or None)."""
        clean = None if message is None else bytes(message)

        def draw():
            self.draws += 1
            if clean is None:
                return None
            return self._mangle_one(clean)
        return draw


class _EditSession:
    """An apply-only client: a stream of seq-consecutive changes from
    one actor. Tracks what COMMITTED for the control-fleet audit."""

    __slots__ = ('session', 'actor', 'seq', 'committed', 'inflight')

    def __init__(self, session, actor):
        self.session = session
        self.actor = actor
        self.seq = 0
        self.committed = []        # payloads whose tickets resolved ok
        self.inflight = []         # (ticket, payload)

    def next_payload(self, rng):
        self.seq += 1
        return [encode_change({
            'actor': self.actor, 'seq': self.seq, 'startOp': self.seq,
            'time': 0, 'message': '', 'deps': [],
            'ops': [{'action': 'set', 'obj': '_root',
                     'key': f'k{rng.randrange(8)}',
                     'value': rng.randrange(10_000), 'datatype': 'int',
                     'pred': []}]})]

    def harvest(self):
        still = []
        for ticket, payload in self.inflight:
            if not ticket.done:
                still.append((ticket, payload))
            elif ticket.status == 'ok':
                self.committed.append(payload)
        self.inflight = still


class _SyncSession:
    """A sync client: a host-backend replica editing locally and
    reconciling with its service doc through the sync protocol."""

    __slots__ = ('session', 'actor', 'doc', 'state', 'seq', '_prev_state')

    def __init__(self, session, actor):
        self.session = session
        self.actor = actor
        doc = A.init(actor)
        self.doc = A.frontend.get_backend_state(doc, f'loadgen-{actor}')
        self.state = host_backend.init_sync_state()
        self.seq = 0
        self._prev_state = None

    def edit(self, rng):
        """One local change on the client replica (seq-consecutive,
        one op per change, deps = current replica heads)."""
        self.seq += 1
        change = encode_change({
            'actor': self.actor, 'seq': self.seq, 'startOp': self.seq,
            'time': 0, 'message': '',
            'deps': host_backend.get_heads(self.doc),
            'ops': [{'action': 'set', 'obj': '_root',
                     'key': f's{rng.randrange(4)}',
                     'value': rng.randrange(10_000), 'datatype': 'int',
                     'pred': []}]})
        self.doc, _ = host_backend.apply_changes(self.doc, [change])

    def generate(self):
        self._prev_state = self.state
        self.state, message = host_backend.generate_sync_message(
            self.doc, self.state)
        return message

    def rollback(self):
        """The generated message never left the client (admission
        refused the submit): restore the pre-generate sync state, or the
        optimistic sentHashes would poison the handshake exactly like a
        dropped wire message."""
        if self._prev_state is not None:
            self.state = self._prev_state

    def reconnect(self):
        """Client-side reconnect: fresh sync state (idempotent delivery
        makes this always safe; it costs re-advertisement only)."""
        self.state = host_backend.init_sync_state()

    def receive(self, reply):
        if reply is None:
            return
        try:
            self.doc, self.state, _ = host_backend.receive_sync_message(
                self.doc, self.state, bytes(reply))
        except AutomergeError:
            pass                   # corrupt reply == drop (containment)


def run_leg(name, *, sessions=1000, tenants=64, zipf_s=1.2,
            requests=10_000, arrivals_per_tick=64, sync_fraction=0.25,
            chaos=False, overload=False, seed=0, exact_device=False,
            durable_dir=None, fleet=None, deadline_s=None,
            service_kwargs=None, max_ticks=200_000, convergence=True,
            tick_dt=None, collect_saves=False, latency_step=None,
            device=None, audit=None):
    """One leg. Returns the report dict (see module docstring).

    The port's keywords: `device` is where the leg's fleet (or durable
    fleet) and its control fleet live (CUDA unless the caller asks
    otherwise). `audit(service, handles, committed)`, when given, is
    called after the control audit with the leg's service, the audited
    edit sessions' docs and, in the same order, the change bytes each
    committed; what it returns lands in the report as `audit`.

    `tick_dt` switches the service onto a FAKE clock advanced by that
    many seconds per pump — the whole leg becomes a deterministic
    function of its seed (the cross-device-mode byte-identity tests run
    the same script twice and diff the saves). `collect_saves` adds
    `session_saves` ({session_id: (actor, save_hex)}) to the report.

    `latency_step=(tick, extra_s)` injects a SYNTHETIC latency
    regression mid-leg (requires `tick_dt`): from that tick until the
    leg's arrivals end, every pump advances the fake clock by an extra
    `extra_s`, so every in-flight request's measured latency jumps by
    it — the controlled fault the SLO fast-window burn alert must catch
    (the bench `slo` section and the acceptance test time its
    detection). The report then carries `slo_step_tick` and
    `slo_alerts`.

    Every leg whose service keeps the default SLO accounting ends with
    the SLO AUDIT: the registry's per-tenant outcome tallies must match
    the client-side typed-outcome counts EXACTLY (`slo_audit` in the
    report; tools and main() fail on any mismatch) — the double-count /
    missed-reject detector for the accounting plane under quarantine
    storms."""
    rng = random.Random(seed)
    zipf = ZipfSampler(tenants, zipf_s)
    chaos_client = ChaosClient(seed + 1) if chaos else None

    durable = None
    if durable_dir is not None:
        from .fleet.durability import DurableFleet
        durable = DurableFleet(durable_dir, exact_device=exact_device,
                               fsync_bytes=1 << 16, device=device)
    elif fleet is None:
        fleet = DocFleet(exact_device=exact_device, device=device)
    kwargs = dict(tenant_rate=500.0, tenant_burst=200.0, tenant_queue=256,
                  max_queued=max(64, sessions * 2), batch_limit=4096)
    if overload:
        # 2x overload: offered load is twice what the service serves per
        # tick (batch_limit pins per-tick capacity at the base arrival
        # rate), into halved admission headroom — backlog builds, the
        # pressure signal sustains, and the brownout ladder must engage
        # while every rejection stays typed and fair
        # max_queued bounds absolute BACKLOG (latency), not sessions: at
        # 2x offered load the queue pins against it and the sustained
        # queue-pressure signal is what walks the brownout ladder
        kwargs.update(tenant_rate=125.0, tenant_burst=50.0,
                      tenant_queue=64,
                      max_queued=max(32, min(512, sessions)),
                      batch_limit=max(32, arrivals_per_tick))
        arrivals_per_tick *= 2
    if service_kwargs:
        kwargs.update(service_kwargs)
    if latency_step is not None and tick_dt is None:
        raise ValueError('latency_step needs the tick_dt fake clock')
    _clk = [0.0]
    if tick_dt is not None:
        kwargs.setdefault('clock', lambda: _clk[0])
    service = DocService(fleet=fleet, durable=durable, **kwargs)
    _inject = [False]              # latency_step currently applying

    def pump():
        if _inject[0]:
            # the injected regression: age every in-flight request by
            # extra_s before the tick serves it
            _clk[0] += latency_step[1]
        service.pump()
        if tick_dt is not None:
            _clk[0] += tick_dt

    tenant_names = [f'tenant{t}' for t in range(tenants)]
    tenant_of_session = [zipf.draw(rng) for _ in range(sessions)]
    raw = service.open_sessions(
        [tenant_names[t] for t in tenant_of_session])
    by_tenant = {}
    clients = []
    for i, session in enumerate(raw):
        # sessions draw from a bounded actor pool: the fleet interns
        # actor strings fleet-wide with a 256-actor ceiling, and actor
        # seq numbering is PER DOCUMENT, so distinct sessions (distinct
        # docs) sharing an actor string are fully independent
        actor = f'{i % 192:08x}' + 'ab' * 12
        if rng.random() < sync_fraction:
            client = _SyncSession(session, actor)
        else:
            client = _EditSession(session, actor)
        clients.append(client)
        by_tenant.setdefault(tenant_of_session[i], []).append(client)

    counts = {'ok': 0}
    # the client-side half of the SLO audit: every typed outcome this
    # client observes, tallied (tenant, budget class) — the registry's
    # server-side tallies must match these EXACTLY
    client_tally = {}
    latencies = []
    untyped = 0
    submitted = 0
    ticks = 0
    disconnected = 0
    replayed = 0

    def tally(tenant, error):
        key = (tenant, outcome_class(error))
        client_tally[key] = client_tally.get(key, 0) + 1

    def note(ticket):
        nonlocal untyped
        tally(ticket.tenant, ticket.error)
        if ticket.status == 'ok':
            counts['ok'] += 1
            if ticket.latency is not None:
                latencies.append(ticket.latency)
        else:
            err = ticket.error
            key = type(err).__name__
            counts[key] = counts.get(key, 0) + 1
            if not isinstance(err, AutomergeError):
                untyped += 1

    tickets = []

    def submit(client, kind, payload=None, payload_fn=None, timeout=None,
               priority=1):
        nonlocal untyped, submitted
        try:
            ticket = service.submit(client.session, kind, payload,
                                    payload_fn=payload_fn,
                                    timeout=timeout, priority=priority)
        except AutomergeError as exc:
            key = type(exc).__name__
            counts[key] = counts.get(key, 0) + 1
            tally(client.session.tenant, exc)
            return None
        except Exception as exc:       # would be an untyped escape
            counts[f'UNTYPED:{type(exc).__name__}'] = \
                counts.get(f'UNTYPED:{type(exc).__name__}', 0) + 1
            untyped += 1
            return None
        submitted += 1
        tickets.append((ticket, client))
        return ticket

    start = time.perf_counter()
    while (submitted < requests or not service.idle()) and \
            ticks < max_ticks:
        ticks += 1
        if latency_step is not None:
            # the regression applies only while arrivals keep coming
            # (mid-leg): the drain after the loop must converge clean
            _inject[0] = ticks >= latency_step[0] and submitted < requests
        # -- arrivals (open loop: these do not wait for completions)
        n_arrive = min(arrivals_per_tick, requests - submitted)
        for _ in range(max(0, n_arrive)):
            tenant = zipf.draw(rng)
            pool = by_tenant.get(tenant)
            if not pool:
                continue
            client = pool[rng.randrange(len(pool))]
            if client.session.closed:
                continue
            timeout = deadline_s
            priority = 1 if rng.random() < 0.7 else 0
            if chaos and rng.random() < 0.05:
                timeout = 0.0          # deadline the service cannot meet
            if isinstance(client, _EditSession):
                payload = client.next_payload(rng)
                if chaos and rng.random() < 0.3:
                    ticket = submit(client, 'apply',
                                    payload_fn=chaos_client.wrap_changes(
                                        payload),
                                    timeout=timeout, priority=priority)
                else:
                    ticket = submit(client, 'apply', payload,
                                    timeout=timeout, priority=priority)
                if ticket is not None:
                    client.inflight.append((ticket, payload))
                else:
                    # admission refused it: the client keeps the seq and
                    # re-mints it later (a seq gap would poison the
                    # actor's whole suffix)
                    client.seq -= 1
                if chaos and rng.random() < 0.05 and client.committed:
                    # replay an already-committed change (idempotency)
                    replayed += 1
                    submit(client, 'apply',
                           client.committed[rng.randrange(
                               len(client.committed))],
                           timeout=timeout, priority=priority)
            else:
                client.edit(rng)
                message = client.generate()
                if chaos and rng.random() < 0.3:
                    ticket = submit(client, 'sync',
                                    payload_fn=chaos_client.wrap_message(
                                        message),
                                    timeout=timeout, priority=priority)
                else:
                    ticket = submit(client, 'sync', message,
                                    timeout=timeout, priority=priority)
                if ticket is None:
                    # admission refused: the message never left the
                    # client — un-poison sentHashes
                    client.rollback()
            if chaos and rng.random() < 0.002 and \
                    len(service.sessions) > sessions // 2:
                # hard disconnect: abandon the session and its queue
                service.close_session(client.session)
                disconnected += 1
        # -- one service tick
        pump()
        # -- completions: sync clients consume replies, edit clients
        #    book their committed payloads
        still = []
        for ticket, client in tickets:
            if not ticket.done:
                still.append((ticket, client))
                continue
            note(ticket)
            if isinstance(client, _SyncSession) and ticket.status == 'ok':
                client.receive(ticket.result)
        tickets = still
        for client in clients:
            if isinstance(client, _EditSession):
                client.harvest()
    elapsed = time.perf_counter() - start
    _inject[0] = False

    # -- SLO audit: the registry's per-tenant outcome tallies vs the
    #    client-observed typed outcomes. Exact equality or the
    #    accounting plane double-counted / missed a reject somewhere in
    #    the retry/quarantine/disconnect machinery.
    slo_audit = None
    if service.slo is not None:
        pending = sum(1 for t, _ in tickets if not t.done)
        if pending:
            slo_audit = {'skipped': f'{pending} tickets still pending '
                                    f'at max_ticks'}
        else:
            server_tally = {}
            for (tenant, _kind), outcomes in service.slo.tallies().items():
                for cls, n in outcomes.items():
                    key = (tenant, cls)
                    server_tally[key] = server_tally.get(key, 0) + n
            mismatches = []
            for key in sorted(set(server_tally) | set(client_tally)):
                want = client_tally.get(key, 0)
                got = server_tally.get(key, 0)
                if want != got:
                    mismatches.append({'tenant': key[0], 'outcome': key[1],
                                       'client': want, 'registry': got})
            slo_audit = {'pairs_checked': len(set(server_tally) |
                                              set(client_tally)),
                         'mismatches': mismatches}

    # -- drain: finish the sync handshakes fault-free so convergence is
    #    assertable (the wire is quiet, the service keeps admitting)
    converged_sync = drained = 0
    if convergence:
        for client in clients:
            if not isinstance(client, _SyncSession) or \
                    client.session.closed:
                continue
            drained += 1
            # both ends may leave the loaded phase with poisoned
            # handshake state (failed/shredded requests are wire drops);
            # a drain is a RECONNECT — fresh client state, and the
            # service side resets through its own stall machinery
            client.reconnect()
            stalled = 0
            fresh = True
            for _ in range(96):
                message = client.generate()
                ticket = None
                for _ in range(1000):   # ride out throttling, typed —
                    try:                # whale tenants refill at rate
                        ticket = service.submit(client.session, 'sync',
                                                message, priority=5,
                                                reset=fresh)
                        break
                    except AutomergeError:
                        pump()
                fresh = False
                if ticket is None:
                    client.rollback()
                    break
                while not ticket.done:
                    pump()
                if ticket.status != 'ok':
                    client.rollback()   # never processed: un-poison
                    continue
                client.receive(ticket.result)
                service_heads = host_backend.get_heads(
                    client.session.handle)
                client_heads = host_backend.get_heads(client.doc)
                if message is None and ticket.result is None and \
                        service_heads == client_heads:
                    converged_sync += 1
                    break
                stalled += 1
                if stalled % 24 == 23:  # belt-and-braces reconnect
                    client.reconnect()
                    fresh = True

    # -- control audit: an unloaded fleet fed exactly the committed
    #    edits must byte-match the loaded service docs
    mismatches = 0
    audited = 0
    audit_result = None
    if convergence:
        control_fleet = DocFleet(exact_device=exact_device, device=device)
        edit_clients = [c for c in clients
                        if isinstance(c, _EditSession)
                        and not c.session.closed and c.committed]
        if edit_clients:
            control = fleet_backend.init_docs(len(edit_clients),
                                              control_fleet)
            committed = [[b for payload in c.committed for b in payload]
                         for c in edit_clients]
            control, _ = fleet_backend.apply_changes_docs(
                control, committed, mirror=False)
            for client, ctrl in zip(edit_clients, control):
                audited += 1
                if bytes(host_backend.save(client.session.handle)) != \
                        bytes(host_backend.save(ctrl)):
                    mismatches += 1
            if audit is not None:
                audit_result = audit(
                    service, [c.session.handle for c in edit_clients],
                    committed)

    latencies.sort()

    def pct(p):
        if not latencies:
            return None
        return latencies[min(len(latencies) - 1,
                             int(p * len(latencies)))]

    report = {
        'leg': name,
        'sessions': sessions,
        'tenants': tenants,
        'requests_offered': requests,
        'submitted': submitted,
        'completed_ok': counts['ok'],
        'rejections': {k: v for k, v in sorted(counts.items())
                       if k != 'ok'},
        'untyped_escapes': untyped,
        'elapsed_s': round(elapsed, 3),
        'ticks': ticks,
        'rounds_per_s': round(ticks / elapsed, 1) if elapsed else None,
        'requests_per_s': round(counts['ok'] / elapsed, 1)
        if elapsed else None,
        'p50_ms': round(pct(0.50) * 1e3, 3) if latencies else None,
        'p95_ms': round(pct(0.95) * 1e3, 3) if latencies else None,
        'p99_ms': round(pct(0.99) * 1e3, 3) if latencies else None,
        'brownout_stage_final': service.brownout.stage,
        'brownout_transitions': len(service.brownout.transitions),
        'disconnected': disconnected,
        'replayed': replayed,
        'chaos_draws': chaos_client.draws if chaos_client else 0,
        'chaos_corrupted': chaos_client.corrupted if chaos_client else 0,
        'convergence': {
            'edit_docs_audited': audited,
            'edit_mismatches': mismatches,
            'sync_drained': drained,
            'sync_converged': converged_sync,
        } if convergence else None,
        'slo_audit': slo_audit,
    }
    if audit is not None:
        report['audit'] = audit_result
    if service.slo is not None:
        report['slo_alerts'] = [
            {'tick': t, 'tenant': tenant, 'kind': kind, 'sli': sli,
             'window': window, 'edge': edge, 'burn': burn}
            for t, tenant, kind, sli, window, edge, burn in
            service.slo.alert_log]
        if latency_step is not None:
            report['slo_step_tick'] = latency_step[0]
    if collect_saves:
        report['session_saves'] = {
            c.session.id: (c.actor,
                           bytes(host_backend.save(c.session.handle)).hex())
            for c in clients if not c.session.closed}
    if durable is not None:
        durable.close()
    return report


def run_standard_legs(sessions=1000, tenants=64, requests=10_000,
                      seed=0, exact_device=False, sync_fraction=0.25,
                      device=None, around=None, **leg_kwargs):
    """The three standing legs: clean, chaos, 2x overload.

    The port's keywords: `device` as in `run_leg`; `around(name)`, when
    given, returns a context manager that each leg runs inside (the
    card check resets and reads its launch counters there); other
    keywords (`audit`, ...) pass on to every leg."""
    scope = around if around is not None else \
        (lambda _name: contextlib.nullcontext())
    legs = []
    with scope('clean'):
        legs.append(run_leg('clean', sessions=sessions, tenants=tenants,
                            requests=requests, seed=seed,
                            sync_fraction=sync_fraction,
                            exact_device=exact_device, device=device,
                            **leg_kwargs))
    with scope('chaos'):
        legs.append(run_leg('chaos', sessions=sessions, tenants=tenants,
                            requests=requests, chaos=True, seed=seed + 1,
                            sync_fraction=sync_fraction,
                            exact_device=exact_device, device=device,
                            **leg_kwargs))
    with scope('overload'):
        legs.append(run_leg('overload', sessions=sessions, tenants=tenants,
                            requests=requests, overload=True, seed=seed + 2,
                            sync_fraction=sync_fraction,
                            exact_device=exact_device, device=device,
                            **leg_kwargs))
    return legs
