"""The in-process multi-tenant serving core.

This is the ROADMAP's "in-process driver first" step toward the async
document service: ``DocService`` multiplexes tenant SESSIONS (each bound
to one document in a shared ``DocFleet``) onto the batched seams —
every tick's admitted apply work lands in ONE fused
``apply_changes_docs`` dispatch and every tick's sync work in one
batched receive + one batched generate round — while staying correct
and fair under overload:

- **Admission** (service/admission.py): typed ``Overloaded`` /
  ``TenantThrottled`` BEFORE any work is queued; round-robin drain so
  one tenant's flood cannot age another tenant's queue.
- **Deadlines** (service/deadline.py): checked when a request is pulled
  into a batch and re-checked by the seam immediately before the fused
  dispatch — a request fails ``DeadlineExceeded`` fully-unapplied or
  commits fully, never half-applied.
- **Retries** (service/backoff.py): a request carrying a ``payload_fn``
  (the transport re-draw — what a client retransmit delivers) is
  retried on wire-corruption faults with jittered backoff under a
  per-tenant retry budget; the budget dry or the schedule exhausted is
  a typed ``RetriesExhausted``, not another retry. Sync sessions that
  stall (traffic, no head progress — a dropped message poisoned
  ``sentHashes`` upstream) reconnect with fresh sync state on the same
  backoff curve and budget.
- **Brownout** (service/brownout.py): sustained admission pressure
  climbs the widen-fsync → defer-compaction → shed-background-sync
  ladder, every transition in the health counters and flight recorder.
- **Queries** (automerge_tpu/query/): the 'materialize_at' kind serves
  time-travel reads (all of a tick's reads in ONE fused replay
  dispatch), the 'subscribe' kind incremental patch pulls (one diff per
  (doc, cursor) equivalence class, zero device work). Subscription
  pushes default to sub-priority — the first citizens of the brownout
  shed stage.
- **SLO telemetry** (observability/slo.py): every resolution — and
  every typed admission-edge rejection — lands in the per-(tenant,
  kind) SLI accounting; one registry evaluation per tick drives the
  multi-window burn-rate alerts. ``slo=False`` is the telemetry-off
  build the <=2% overhead budget is measured against. Requests carry a
  ``TraceContext`` (observability/tracecontext.py): minted at submit
  while spans are recording, recorded as span LINKS on the fused batch
  spans, adopted from (and echoed into) the wire envelope on enveloped
  sync exchanges.

The core is deliberately tick-driven and synchronous (``pump()`` runs
one batch round; the engine below is single-threaded by contract);
``AsyncDocService`` is the asyncio facade that turns tickets into
awaitables and pumps from an event-loop task. All time flows through an
injected monotonic clock so tests and the loadgen drive it explicitly.
"""

import asyncio
import time

from ..errors import (AutomergeError, DeadlineExceeded, Overloaded,
                      RetriesExhausted, SessionClosed, WireCorruption)
from ..fleet import backend as fleet_backend
from ..fleet.hashindex import release_sync_state
from ..fleet.sync_driver import (generate_sync_messages_docs,
                                 receive_sync_messages_docs)
from ..observability import hist as _hist
from ..observability import perf as _perf
from ..observability import recorder as _flight
from ..observability import tracecontext as _trace
from ..observability.metrics import Counters, register_health_source
from ..observability.slo import SloRegistry
from ..observability.spans import on as _spans_on, span as _span
from .admission import AdmissionController
from .backoff import Backoff, RetryBudgetPool
from .brownout import BrownoutController
from .deadline import Deadline

__all__ = ['DocService', 'AsyncDocService', 'Session', 'Ticket',
           'service_stats']

_stats = Counters({
    'service_requests': 0,         # submitted (admitted) requests
    'service_completed': 0,        # tickets resolved ok
    'service_failed': 0,           # tickets resolved with a typed error
    'deadline_exceeded': 0,        # requests dropped at their deadline
    'service_retries': 0,          # transient-fault retries scheduled
    'retry_budget_exhausted': 0,   # typed RetriesExhausted resolutions
    'sync_reconnects': 0,          # stalled sessions reset with backoff
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def service_stats():
    return dict(_stats)


class Ticket:
    """One request's completion handle. ``status`` moves pending -> 'ok'
    (``result`` holds the reply, e.g. sync response bytes) or 'error'
    (``error`` holds the TYPED exception — shedding is never untyped).
    ``latency`` is submit-to-resolution seconds on the service clock.
    ``trace`` is the request's ``TraceContext`` (minted at submit while
    spans are recording — the span-link audience — or adopted from the
    client's wire envelope on an enveloped sync request); None when
    nobody is tracing."""

    __slots__ = ('kind', 'tenant', 'session_id', 'status', 'result',
                 'error', 'submitted_at', 'finished_at', '_future',
                 'trace', '_slo')

    def __init__(self, kind, tenant, session_id, submitted_at):
        self.kind = kind
        self.tenant = tenant
        self.session_id = session_id
        self.status = 'pending'
        self.result = None
        self.error = None
        self.submitted_at = submitted_at
        self.finished_at = None
        self._future = None
        self.trace = None
        self._slo = None

    @property
    def done(self):
        return self.status != 'pending'

    @property
    def latency(self):
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def _finish(self, now, result=None, error=None):
        if self.done:
            return
        self.finished_at = now
        if error is not None:
            self.status = 'error'
            self.error = error
            _stats.inc('service_failed')
        else:
            self.status = 'ok'
            self.result = result
            _stats.inc('service_completed')
        latency = self.finished_at - self.submitted_at
        _hist.record_value('service_request_s', latency, scale=1e9,
                           unit='s')
        if self._slo is not None:
            self._slo.record(self.tenant, self.kind, latency, error,
                             trace=None if self.trace is None
                             else self.trace.trace_id)
        if self._future is not None and not self._future.done():
            self._future.set_result(self)

    def __repr__(self):
        return (f'Ticket({self.kind}, tenant={self.tenant!r}, '
                f'status={self.status!r})')


class _Request:
    __slots__ = ('kind', 'session', 'payload', 'payload_fn', 'deadline',
                 'priority', 'ticket', 'attempts', 'not_before', 'reset',
                 'enveloped')

    def __init__(self, kind, session, payload, payload_fn, deadline,
                 priority, ticket, reset=False):
        self.kind = kind
        self.session = session
        self.payload = payload
        self.payload_fn = payload_fn
        self.deadline = deadline
        self.priority = priority
        self.ticket = ticket
        self.attempts = 0
        self.not_before = 0.0
        self.reset = reset
        self.enveloped = False     # sync payload arrived trace-wrapped

    def draw_payload(self):
        """This attempt's bytes: the transport re-draw when the client
        models retransmission, else the fixed payload."""
        if self.payload_fn is not None:
            return self.payload_fn()
        return self.payload


class Session:
    """One tenant session bound to one fleet document plus the
    service-side sync state for that client. ``sub_cursor`` is the
    session's subscription cursor: the heads frontier of the last patch
    the service pushed to it ('subscribe' requests with no explicit
    cursor continue from here)."""

    __slots__ = ('id', 'tenant', 'handle', 'sync_state', 'closed',
                 'sub_cursor', '_last_heads', '_stall_rounds',
                 '_reconnect_attempts', '_sub_served_tick',
                 '_heads_moved_tick')

    def __init__(self, sid, tenant, handle):
        self.id = sid
        self.tenant = tenant
        self.handle = handle
        self.sync_state = _init_sync_state()
        self.closed = False
        self.sub_cursor = []
        self._last_heads = None
        self._stall_rounds = 0
        self._reconnect_attempts = 0
        self._sub_served_tick = None   # tick of the last subscribe serve
        self._heads_moved_tick = None  # first heads movement since then


def _init_sync_state():
    from ..backend.sync import init_sync_state
    return init_sync_state()


class DocService:
    """See the module docstring. Construct over a fresh fleet, an
    existing ``DocFleet``, or a ``DurableFleet`` (whose journal the
    brownout ladder then manages)."""

    def __init__(self, fleet=None, durable=None, *,
                 tenant_rate=200.0, tenant_burst=50.0, tenant_queue=64,
                 max_queued=10_000, batch_limit=4096,
                 default_timeout=None,
                 backoff=None, retry_rate=20.0, retry_burst=40.0,
                 stall_rounds=8,
                 brownout=None, slo=None, tiering=None, control=None,
                 clock=time.monotonic):
        from ..fleet.backend import DocFleet
        self.durable = durable
        # `tiering`: a fleet/tiering.py TieringController. When attached,
        # the pump's background-maintenance step runs THROUGH its cost
        # model — auto-demote under watermark pressure, cost-based
        # vacuum/compaction — and brownout stage 2 becomes a pressure
        # INPUT to that model (write-cost multiplier) instead of the
        # legacy hard defer-compaction override.
        self.tiering = tiering
        # `control`: a control/ Controller. When attached, the pump
        # ticks it after the observability hooks — the feedback loop
        # (admission-rate adaptation, freshness pins) rides the same
        # cadence as the signals it consumes. The controller binds
        # itself to this service here.
        self.control = control
        if control is not None:
            control.attach(service=self)
        if durable is not None:
            fleet = durable.fleet
        self.fleet = fleet if fleet is not None else DocFleet()
        self.clock = clock
        self.admission = AdmissionController(
            rate=tenant_rate, burst=tenant_burst, queue_limit=tenant_queue,
            max_queued=max_queued)
        self.batch_limit = int(batch_limit)
        self.default_timeout = default_timeout
        self.backoff = backoff if backoff is not None else Backoff()
        self._retry_budgets = RetryBudgetPool(retry_rate, retry_burst)
        self.stall_rounds = int(stall_rounds)
        self.brownout = brownout if brownout is not None \
            else BrownoutController()
        # `slo`: None = a default SloRegistry (per-tenant SLI accounting
        # on, DEFAULT_POLICIES objectives), an SloRegistry = use that
        # (custom objectives), False = accounting fully off (the
        # telemetry-off leg the <=2% overhead budget is measured
        # against). Trace contexts are minted iff accounting is on or
        # spans are recording.
        self.slo = None if slo is False else \
            (slo if slo is not None else SloRegistry())
        self._attached_journal = None
        self._attach_brownout_journal()
        self.sessions = {}
        self._next_sid = 0
        self._delayed = []             # backoff-parked retries
        self.ticks = 0
        self._adm_counts = (0, 0, 0)   # admission deltas across ticks

    # -- wiring ---------------------------------------------------------

    def _attach_brownout_journal(self):
        journal = self.durable.journal if self.durable is not None else \
            self.fleet.journal
        if journal is not self._attached_journal:
            self.brownout.attach_journal(journal)
            self._attached_journal = journal

    def _retry_budget(self, tenant):
        return self._retry_budgets.get(tenant)

    # -- sessions -------------------------------------------------------

    def open_sessions(self, tenants):
        """Open one session per entry of `tenants` (a list of tenant
        names) with O(1) device work for the whole batch (init_docs)."""
        handles = self.durable.init_docs(len(tenants)) \
            if self.durable is not None \
            else fleet_backend.init_docs(len(tenants), self.fleet)
        out = []
        for tenant, handle in zip(tenants, handles):
            sid = self._next_sid
            self._next_sid += 1
            session = Session(sid, tenant, handle)
            self.sessions[sid] = session
            out.append(session)
        return out

    def open_session(self, tenant):
        return self.open_sessions([tenant])[0]

    def close_session(self, session):
        """Disconnect: free the doc; still-queued requests resolve typed
        ('session closed') when their turn comes."""
        if session.closed:
            return
        session.closed = True
        fleet_backend.free_docs([session.handle])
        release_sync_state(session.sync_state)
        self.sessions.pop(session.id, None)

    def adopt_session(self, tenant, handle):
        """Bind a fresh session to an EXISTING doc of this service's
        fleet — the shard failover/migration promotion path: the doc
        already lives here (a warm replica kept current by inter-shard
        replication, or a migrant revived from a transferred chunk) and
        gains a serving session without any init dispatch. The session
        starts from scratch on everything BUT the doc: fresh per-peer
        sync state (the re-homed client reconnects with ``reset=True``
        — both ends handshake fresh; delivery is idempotent) and an
        empty subscription cursor (the router re-registers the standing
        cursor it tracked, and a cursor naming heads this doc never saw
        resolves as a TYPED resync, never a silently stale patch)."""
        sid = self._next_sid
        self._next_sid += 1
        session = Session(sid, tenant, handle)
        self.sessions[sid] = session
        return session

    def release_session(self, session):
        """Unbind a session WITHOUT freeing its doc — the migration
        donor path: the doc's bytes were just parked/transferred (its
        slot is already free), so ``close_session``'s free would
        double-free. Still-queued requests resolve typed ('session
        closed') when their turn comes, exactly like a disconnect."""
        if session.closed:
            return
        session.closed = True
        release_sync_state(session.sync_state)
        self.sessions.pop(session.id, None)

    # -- submission ------------------------------------------------------

    def submit(self, session, kind, payload=None, *, payload_fn=None,
               deadline=None, timeout=None, priority=None, reset=False):
        """Admit one request. Raises typed ``Overloaded`` /
        ``TenantThrottled`` at the edge; returns a ``Ticket`` otherwise.
        `kind` is 'apply' (payload: list of change bytes for the
        session's doc), 'sync' (payload: the client's sync message
        bytes, or None to solicit a server message), 'materialize_at'
        (payload: a heads frontier — hex hash list or encoded cursor
        bytes; the result is the saved document chunk at that historical
        frontier), or 'subscribe' (payload: the client's cursor —
        encoded bytes, a heads list, or None to continue from the
        session's auto-advancing cursor; the result is a patch event
        carrying the changes since the cursor). `payload_fn` replaces a
        fixed payload with a per-attempt transport draw, which is what
        makes wire faults retryable. `timeout` seconds mint a deadline
        on the service clock; an explicit `deadline` wins. `priority`
        defaults to 1 — except 'subscribe', which defaults to 0:
        subscription pushes are the first work the brownout ladder's
        shed stage drops. `reset=True` on a sync request marks a CLIENT
        RECONNECT: the service discards its side of the handshake state
        before processing — without this, a server whose `sentHashes`
        already cover everything goes silent at a freshly-reconnected
        (state lost) client and the handshake livelocks."""
        if kind not in ('apply', 'sync', 'materialize_at', 'subscribe'):
            raise ValueError(f"kind must be 'apply', 'sync', "
                             f"'materialize_at', or 'subscribe', got "
                             f'{kind!r}')
        if priority is None:
            priority = 0 if kind == 'subscribe' else 1
        if session.closed:
            # the client's own fault (it kept a dead handle), so it
            # burns the per-tenant 'throttled' budget, NOT the
            # 'overloaded' budget that pages when the SERVICE sheds
            raise self._slo_reject(session.tenant, kind, SessionClosed(
                'session closed', retry_after=None, shed=False,
                stage=None))
        now = self.clock()
        if deadline is None:
            t = timeout if timeout is not None else self.default_timeout
            if t is not None:
                deadline = Deadline(now + t, clock=self.clock)
        ticket = Ticket(kind, session.tenant, session.id, now)
        ticket._slo = self.slo
        if self.slo is not None or _spans_on():
            # minting is lazy about its audience: mint while SLO
            # accounting is on (the forensic dumps carry the id, so an
            # alert's offending requests stitch into a trace) or while
            # spans record (the span-link audience); an enveloped sync
            # request brings its OWN context, adopted in the sync round
            ticket.trace = _trace.mint()
        request = _Request(kind, session, payload, payload_fn, deadline,
                           priority, ticket, reset=reset)
        try:
            self.admission.admit(session.tenant, request, now)
        except AutomergeError as exc:
            # edge rejections never mint a ticket, but they burn a
            # tenant's availability budget all the same — account them
            # before the typed raise leaves the building
            raise self._slo_reject(session.tenant, kind, exc)
        _stats.inc('service_requests')
        return ticket

    def _slo_reject(self, tenant, kind, exc):
        """Account a typed admission-edge rejection (latency 0: the
        request never entered the system) and hand the error back for
        raising."""
        if self.slo is not None:
            self.slo.record(tenant, kind, 0.0, exc)
        return exc

    # -- the tick --------------------------------------------------------

    def pump(self, now=None):
        """One service tick: drain a fair batch, drop expired deadlines,
        run the fused apply + sync rounds, schedule retries, feed the
        brownout ladder. Returns the tick's stats dict."""
        now = self.clock() if now is None else now
        self.ticks += 1
        start = time.perf_counter()
        with _span('service_tick', tick=self.ticks):
            stats = self._pump_inner(now)
        _hist.record_value('service_tick_s', time.perf_counter() - start,
                           scale=1e9, unit='s')
        if self.slo is not None:
            # one evaluation round per service tick: the SLO windows are
            # tick-denominated, like the brownout ladder's hysteresis
            self.slo.tick(now)
        # the seam-perf observatory rides the same cadence: a no-op flag
        # check unless perf.enable_baselines()/enable_observatory() ran
        _perf.maybe_tick()
        # the control plane ticks LAST: its decision windows read the
        # SLO/perf state the hooks above just rolled
        if self.control is not None:
            self.control.tick(now)
        return stats

    def _pump_inner(self, now):
        stats = {'completed': 0, 'failed': 0, 'deadline_dropped': 0,
                 'retried': 0, 'shed': 0}
        # pressure inputs: backlog BEFORE the drain (after it the queue
        # is empty whenever batch_limit covers the tick — an idle-looking
        # queue under heavy typed rejection), plus the rejected fraction
        # at the admission edge since the LAST tick (rejections happen at
        # submit time, between pumps)
        queue_pressure = self.admission.pressure()
        adm = self.admission.stats
        counts = (adm['admitted'], adm['rejected_overloaded'],
                  adm['rejected_throttled'])
        prev_counts = getattr(self, '_adm_counts', counts)
        self._adm_counts = counts
        admitted = counts[0] - prev_counts[0]
        rejected = (counts[1] - prev_counts[1]) + \
            (counts[2] - prev_counts[2])
        batch = self._ripe_retries(now)
        batch += self.admission.drain(self.batch_limit - len(batch))

        applies, syncs, queries, subs = [], [], [], []
        buckets = {'apply': applies, 'sync': syncs,
                   'materialize_at': queries, 'subscribe': subs}
        shed_floor = self.brownout.shed_below()
        for request in batch:
            ticket = request.ticket
            if request.session.closed:
                # client's fault (disconnect left requests queued):
                # throttled budget, same as the submit-edge twin above
                ticket._finish(now, error=SessionClosed(
                    'session closed', retry_after=None, shed=False,
                    stage=None))
                stats['failed'] += 1
                continue
            if request.deadline is not None and \
                    request.deadline.remaining(now) < 0:
                late = -request.deadline.remaining(now)
                ticket._finish(now, error=DeadlineExceeded(
                    f'{request.kind}: deadline exceeded by '
                    f'{late * 1e3:.2f}ms before dispatch',
                    deadline=request.deadline.at, late_by=late))
                _stats.inc('deadline_exceeded')
                stats['deadline_dropped'] += 1
                continue
            if request.kind in ('sync', 'subscribe') and \
                    shed_floor is not None and \
                    request.priority < shed_floor:
                # subscription pushes default to sub-priority, so they
                # are the FIRST work this stage drops (staleness, never
                # wrongness: the cursor doesn't advance on a shed)
                self.brownout.count_shed()
                ticket._finish(now, error=Overloaded(
                    f'{request.kind} shed at brownout stage '
                    f'{self.brownout.stage}', retry_after=0.1, shed=True,
                    stage=self.brownout.stage))
                stats['shed'] += 1
                continue
            buckets[request.kind].append(request)

        if applies:
            self._run_applies(applies, now, stats)
        if queries:
            self._run_queries(queries, now, stats)
        if subs:
            self._run_subscriptions(subs, now, stats)
        if syncs:
            self._run_syncs(syncs, now, stats)

        # background maintenance: with a tiering controller attached the
        # cost model owns every decision (demote, vacuum, journal
        # compaction) with the brownout stage as its pressure input —
        # stage 2 defers by raising the write-cost bar, and still fires
        # when replay debt overwhelms it (flight-recorded either way).
        # Without one, the legacy threshold + hard stage-2 defer apply.
        if self.tiering is not None:
            self.tiering.tick(stage=self.brownout.stage,
                              durable=self.durable)
            if self.durable is not None:
                self._attach_brownout_journal()
        elif self.durable is not None:
            if not self.brownout.defer_compaction:
                self.durable.maybe_compact()
            self._attach_brownout_journal()
        reject_pressure = rejected / (admitted + rejected) \
            if (admitted + rejected) >= 8 else 0.0
        self.brownout.observe(max(queue_pressure, reject_pressure))
        stats['stage'] = self.brownout.stage
        stats['queued'] = self.admission.queued + len(self._delayed)
        return stats

    def _ripe_retries(self, now):
        if not self._delayed:
            return []
        ripe = [r for r in self._delayed if r.not_before <= now]
        if ripe:
            self._delayed = [r for r in self._delayed
                             if r.not_before > now]
        return ripe

    def _min_deadline(self, requests):
        deadlines = [r.deadline for r in requests if r.deadline is not None]
        if not deadlines:
            return None
        return min(deadlines, key=lambda d: d.at)

    def _seam_deadline_abort(self, requests, now, stats):
        """The seam refused the whole batch pre-dispatch (typed
        DeadlineExceeded): nothing committed. Resolve the requests that
        are actually late; requeue the rest at the front, unserved."""
        requeue = {}
        for request in requests:
            if request.deadline is not None and \
                    request.deadline.remaining(now) < 0:
                late = -request.deadline.remaining(now)
                request.ticket._finish(now, error=DeadlineExceeded(
                    f'{request.kind}: deadline exceeded by '
                    f'{late * 1e3:.2f}ms before dispatch',
                    deadline=request.deadline.at, late_by=late))
                _stats.inc('deadline_exceeded')
                stats['deadline_dropped'] += 1
            else:
                requeue.setdefault(request.session.tenant, []).append(
                    request)
        for tenant, requests_ in requeue.items():
            self.admission.requeue_front(tenant, requests_)

    def _fail_or_retry(self, request, error, now, stats):
        """A typed per-doc failure: retry when it is plausibly transient
        (the request carries a transport re-draw and the fault class is
        wire corruption) within backoff + budget; resolve typed
        otherwise. Never an untyped escape."""
        transient = request.payload_fn is not None and \
            isinstance(error, WireCorruption)
        if transient and not self.backoff.exhausted(request.attempts) and \
                self._retry_budget(request.session.tenant).spend(now):
            delay = self.backoff.delay(request.attempts)
            request.attempts += 1
            request.not_before = now + delay
            self._delayed.append(request)
            _stats.inc('service_retries')
            stats['retried'] += 1
            return
        if transient:
            _stats.inc('retry_budget_exhausted')
            _flight.record_event('retry_exhausted',
                                 tenant=request.session.tenant,
                                 request_kind=request.kind,
                                 attempts=request.attempts,
                                 error=type(error).__name__)
            exhausted = RetriesExhausted(
                f'{request.kind}: transient fault persisted through '
                f'{request.attempts} retries',
                attempts=request.attempts, tenant=request.session.tenant)
            exhausted.__cause__ = error
            error = exhausted
        request.ticket._finish(now, error=error)
        stats['failed'] += 1

    # -- the apply round -------------------------------------------------

    def _run_applies(self, requests, now, stats):
        """All apply requests of the tick in ONE fused quarantining
        dispatch. Requests for the same session concatenate in drain
        order; a quarantined doc fails (or retries) every request that
        contributed to it — none of its changes committed."""
        by_session = {}
        for request in requests:
            by_session.setdefault(request.session.id, []).append(request)
        sessions = []
        per_doc = []
        doc_requests = []
        bad = []                    # (request, typed error) pre-dispatch
        for sid, requests_ in by_session.items():
            session = requests_[0].session
            changes = []
            kept = []
            for request in requests_:
                try:
                    payload = request.draw_payload()
                except Exception as exc:       # a payload_fn that died
                    # client-fault, like 'session closed': throttled
                    # budget, not the paging overloaded one
                    bad.append((request, Overloaded(
                        f'transport draw failed: {exc!r}',
                        retry_after=None, shed=False, stage=None,
                        budget='throttled')))
                    continue
                if payload is None:            # chaos disconnect mid-draw
                    bad.append((request, Overloaded(
                        'transport delivered nothing', retry_after=0.01,
                        shed=False, stage=None, budget='throttled')))
                    continue
                changes.extend(bytes(b) for b in payload)
                kept.append(request)
            if kept:
                sessions.append(session)
                per_doc.append(changes)
                doc_requests.append(kept)
        for request, error in bad:
            self._fail_or_retry(request, error, now, stats)
        if not sessions:
            return
        kept_requests = [r for kept in doc_requests for r in kept]
        # one fused dispatch serves N admitted requests: the batch span
        # records every member's trace id as a span LINK, so a stitched
        # trace can attribute the shared dispatch to each request tree
        # (links are built only while spans record — the off-path cost
        # is one flag check)
        batch_span = _span('service_apply_batch', docs=len(sessions))
        if _spans_on():
            batch_span.set(links=[r.ticket.trace.trace_id
                                  for r in kept_requests
                                  if r.ticket.trace is not None])
        with batch_span:
            try:
                new_handles, _patches, errors = \
                    fleet_backend.apply_changes_docs(
                        [s.handle for s in sessions], per_doc,
                        mirror=False, on_error='quarantine',
                        deadline=self._min_deadline(kept_requests))
            except DeadlineExceeded:
                self._seam_deadline_abort(kept_requests, now, stats)
                return
        for session, handle, err, requests_ in zip(
                sessions, new_handles, errors, doc_requests):
            # the quarantine seam returns a VALID handle for every slot
            # (rejected docs roll back, they don't freeze) — adopt it
            # either way; only the tickets differ
            session.handle = handle
            if err is None:
                if session._heads_moved_tick is None:
                    # the freshness SLI's anchor: the first commit that
                    # moves this doc's heads past the last subscription
                    # serve starts the staleness clock
                    session._heads_moved_tick = self.ticks
                for request in requests_:
                    request.ticket._finish(now, result=len(request.payload)
                                           if request.payload is not None
                                           else None)
                    stats['completed'] += 1
            else:
                # the doc's whole tick-batch was rejected: nothing from
                # these requests committed (all-or-nothing holds)
                for request in requests_:
                    self._fail_or_retry(request, err.error, now, stats)

    # -- the query round ---------------------------------------------------

    def _cursor_of(self, request, now, stats):
        """Resolve a request's frontier payload: encoded cursor bytes
        (typed InvalidCursor on hostile input — the fuzzed decode
        boundary), a heads list, or None (the session's auto-advancing
        subscription cursor). Returns None after resolving the ticket
        on failure."""
        from ..errors import InvalidCursor
        from ..query import _stats as _query_stats
        from ..query.subscriptions import decode_cursor
        try:
            payload = request.draw_payload()
        except Exception as exc:
            self._fail_or_retry(request, Overloaded(
                f'transport draw failed: {exc!r}', retry_after=None,
                shed=False, stage=None, budget='throttled'), now, stats)
            return None
        if payload is None:
            return list(request.session.sub_cursor)
        if isinstance(payload, (bytes, bytearray)):
            try:
                return decode_cursor(payload)
            except InvalidCursor as exc:
                _query_stats.inc('invalid_cursors')
                _flight.record_event('invalid_cursor',
                                     tenant=request.session.tenant,
                                     session=request.session.id,
                                     request_kind=request.kind,
                                     error=type(exc).__name__)
                self._fail_or_retry(request, exc, now, stats)
                return None
        return [str(h) for h in payload]

    def _run_queries(self, requests, now, stats):
        """All time-travel reads of the tick in ONE fused replay
        dispatch (query.materialize_at_docs): each request's result is
        the saved document chunk at its requested frontier. A frontier
        outside the doc's history fails typed (UnknownHeads) without
        costing the others their batch."""
        from ..query import materialize_at_docs

        live = []
        frontiers = []
        for request in requests:
            cursor = self._cursor_of(request, now, stats)
            if cursor is None:
                continue
            live.append(request)
            frontiers.append(cursor)
        if not live:
            return
        try:
            handles, errors = materialize_at_docs(
                [r.session.handle for r in live], frontiers,
                fleet=self.fleet, deadline=self._min_deadline(live),
                on_error='quarantine')
        except DeadlineExceeded:
            self._seam_deadline_abort(live, now, stats)
            return
        to_free = []
        for request, handle, err in zip(live, handles, errors):
            if err is not None:
                self._fail_or_retry(request, err.error, now, stats)
                continue
            request.ticket._finish(
                now, result=bytes(handle['state'].save()))
            stats['completed'] += 1
            to_free.append(handle)
        if to_free:
            fleet_backend.free_docs(to_free)

    def _run_subscriptions(self, requests, now, stats):
        """All subscription pulls of the tick: one diff per
        (session-doc, cursor-frontier) equivalence class — pure
        hash-graph work, zero device dispatches — shared by every
        subscriber in the class. Bogus/stale cursors get a typed full
        RESYNC event; the cursor only ever advances to heads the pushed
        changes actually reach (never a wrong patch)."""
        from ..errors import UnknownHeads
        from ..query import _stats as _query_stats
        from ..query.subscriptions import diff_since

        memo = {}
        with _span('subscription_tick', subscribers=len(requests)):
            for request in requests:
                session = request.session
                cursor = self._cursor_of(request, now, stats)
                if cursor is None:
                    continue
                ckey = (session.id, tuple(sorted(cursor)))
                event = memo.get(ckey)
                if event is None:
                    try:
                        changes, heads = diff_since(
                            session.handle, cursor,
                            what='service_subscribe')
                        event = {'kind': 'patch', 'changes': changes,
                                 'heads': heads}
                    except UnknownHeads as exc:
                        _query_stats.inc('subscription_resyncs')
                        _query_stats.inc('unknown_heads')
                        _flight.record_event(
                            'invalid_cursor', tenant=session.tenant,
                            session=session.id,
                            error=type(exc).__name__,
                            message=str(exc)[:200])
                        changes, heads = diff_since(
                            session.handle, [], what='service_resync')
                        event = {'kind': 'resync', 'changes': changes,
                                 'heads': heads,
                                 'error': type(exc).__name__}
                    memo[ckey] = event
                else:
                    _query_stats.inc('subscription_diff_reuse')
                _query_stats.inc('subscription_pushes')
                session.sub_cursor = list(event['heads'])
                if self.slo is not None:
                    # cursor lag in service ticks: how long this pull's
                    # changes sat waiting — anchored at the tick the
                    # doc's heads FIRST moved past the last serve, not
                    # at the last serve itself (a slow poller whose
                    # changes landed one tick ago reads lag 1, not its
                    # whole poll gap). An empty patch means the cursor
                    # was AT the heads: lag 0, the steady state.
                    lag = 0
                    if event['changes']:
                        moved = session._heads_moved_tick
                        if moved is not None:
                            lag = self.ticks - moved
                        elif session._sub_served_tick is not None:
                            # heads moved via an unstamped path: the
                            # poll gap is the honest upper bound
                            lag = self.ticks - session._sub_served_tick
                    self.slo.record_freshness(session.tenant, lag)
                session._sub_served_tick = self.ticks
                session._heads_moved_tick = None
                request.ticket._finish(now, result=event)
                stats['completed'] += 1

    # -- the sync round ----------------------------------------------------

    def _run_syncs(self, requests, now, stats):
        """All sync requests of the tick in one batched receive round +
        one batched generate round. Each request's result is the
        service's reply message (or None when the handshake is quiet)."""
        sessions = []
        incoming = []
        live = []
        seen = set()
        deferred = {}
        for request in requests:
            if request.session.id in seen:
                # a sync round is a handshake step: one per session per
                # tick (the batched seam needs distinct docs); extras
                # run next tick, order preserved
                deferred.setdefault(request.session.tenant, []).append(
                    request)
                continue
            try:
                payload = request.draw_payload()
            except Exception as exc:
                self._fail_or_retry(request, Overloaded(
                    f'transport draw failed: {exc!r}', retry_after=None,
                    shed=False, stage=None, budget='throttled'), now,
                    stats)
                continue
            if payload is not None:
                # a tracing client prepends the trace envelope to its
                # sync bytes: adopt ITS trace id for this request (the
                # client owns the trace) and remember to wrap the reply
                ctx, payload = _trace.unwrap(payload)
                # probed PER ATTEMPT: enveloped follows what THIS
                # attempt's bytes carried, so a corrupt payload that
                # happened to start with the magic (stripped here, then
                # rejected by the decoder) cannot latch a plain client
                # into enveloped replies after its clean retry
                request.enveloped = ctx is not None
                if ctx is not None:
                    request.ticket.trace = ctx
            if request.reset:
                # client reconnect: both ends handshake fresh (delivery
                # is idempotent; only optimization state is discarded —
                # including the old link's peer-space, handed back here
                # so the fresh state can never inherit the sent set)
                release_sync_state(request.session.sync_state)
                request.session.sync_state = _init_sync_state()
                request.session._stall_rounds = 0
            seen.add(request.session.id)
            sessions.append(request.session)
            incoming.append(bytes(payload) if payload is not None else None)
            live.append(request)
        for tenant, requests_ in deferred.items():
            self.admission.requeue_front(tenant, requests_)
        if not live:
            return
        # Reconnect rounds emulate the SIMULTANEOUS handshake: the reply
        # is generated from the fresh state BEFORE the client's message
        # lands. Receiving first would let the receive shortcut set
        # lastSentHeads without sending (the alternating-turn trap
        # documented in fleet/faults.py) and the reconnected client
        # would solicit a silent server forever.
        pre_replies = {}
        reset_sessions = [s for s, r in zip(sessions, live) if r.reset]
        if reset_sessions:
            states, messages = generate_sync_messages_docs(
                [s.handle for s in reset_sessions],
                [s.sync_state for s in reset_sessions])
            for session, state, message in zip(reset_sessions, states,
                                               messages):
                session.sync_state = state
                pre_replies[session.id] = message
        batch_span = _span('service_sync_batch', docs=len(sessions))
        if _spans_on():
            batch_span.set(links=[r.ticket.trace.trace_id for r in live
                                  if r.ticket.trace is not None])
        with batch_span:
            try:
                handles, states, _patches, errors = \
                    receive_sync_messages_docs(
                        [s.handle for s in sessions],
                        [s.sync_state for s in sessions], incoming,
                        mirror=False, on_error='quarantine',
                        deadline=self._min_deadline(live))
            except DeadlineExceeded:
                self._seam_deadline_abort(live, now, stats)
                return
        ok_sessions = []
        ok_requests = []
        served_handles = []
        for session, handle, state, err, request, message in zip(
                sessions, handles, states, errors, live, incoming):
            session.handle = handle     # valid for rejected slots too
            if err is not None:
                # corrupt client message: the doc CONTENT and sync state
                # are untouched (containment) — transient by nature
                self._fail_or_retry(request, err.error, now, stats)
                continue
            session.sync_state = state
            served_handles.append(handle)
            if message is not None and session._heads_moved_tick is None:
                # a received sync message may have applied changes: start
                # the freshness clock (conservative — a quiet handshake
                # stamps too, costing at most a one-serve overestimate)
                session._heads_moved_tick = self.ticks
            if request.reset:
                # reply = the pre-receive handshake generated above
                request.ticket._finish(now, result=self._wrap_reply(
                    request, pre_replies.get(session.id)))
                stats['completed'] += 1
                continue
            ok_sessions.append(session)
            ok_requests.append(request)
        # recency feedback from the SYNC path, not just writes: a doc
        # that answers handshakes every tick must not be auto-demoted
        self._touch_tiering(served_handles)
        if not ok_sessions:
            return
        self._detect_stalls(ok_sessions, now)
        new_states, replies = generate_sync_messages_docs(
            [s.handle for s in ok_sessions],
            [s.sync_state for s in ok_sessions])
        for session, state, reply, request in zip(
                ok_sessions, new_states, replies, ok_requests):
            session.sync_state = state
            request.ticket._finish(now,
                                   result=self._wrap_reply(request, reply))
            stats['completed'] += 1

    def _wrap_reply(self, request, reply):
        """Trace-envelope a sync reply IFF the request arrived enveloped
        (the client opted in; plain clients always get plain bytes) —
        stamped with the service's own span id so the two sides of the
        exchange are distinct nodes of one trace."""
        if reply is None or not request.enveloped or \
                request.ticket.trace is None:
            return reply
        return _trace.wrap(reply, request.ticket.trace.child())

    def _touch_tiering(self, handles):
        """Stamp served docs on the tiering demote ring (register plus
        the second-chance bit). The clock otherwise only hears about
        writes, so a read-mostly doc serving sync handshakes every tick
        would look cold and get parked mid-conversation."""
        demote = getattr(self.tiering, 'demote', None) \
            if self.tiering is not None else None
        if demote is None or not handles:
            return
        demote.register(handles)
        demote.touch(handles)

    def _detect_stalls(self, sessions, now):
        """Reconnect-on-stall with jittered backoff + the tenant retry
        budget: a session whose handshake keeps exchanging traffic
        without head movement resets its service-side sync state (change
        delivery is idempotent; only optimization state is lost). The
        stall threshold grows along the backoff curve per reset, and a
        dry retry budget SKIPS the reset (it retries when tokens refill)
        instead of hammering."""
        from ..backend import get_heads
        for session in sessions:
            heads = tuple(get_heads(session.handle))
            their = session.sync_state.get('theirHeads')
            # a stall is SPLIT BRAIN THAT PERSISTS: the peer's advertised
            # heads differ from ours and ours are not moving. A quiet
            # converged handshake (equal heads) is not a stall, however
            # long it idles — resetting there would livelock.
            split = their is not None and sorted(their) != sorted(heads)
            if split and heads == session._last_heads:
                session._stall_rounds += 1
            else:
                session._stall_rounds = 0
                if not split:
                    session._reconnect_attempts = 0
            session._last_heads = heads
            threshold = self.stall_rounds * (1 + session._reconnect_attempts)
            if session._stall_rounds < threshold:
                continue
            if not self._retry_budget(session.tenant).spend(now):
                continue
            release_sync_state(session.sync_state)
            session.sync_state = _init_sync_state()
            session._stall_rounds = 0
            session._reconnect_attempts += 1
            _stats.inc('sync_reconnects')
            _flight.record_event('sync_reconnect', session=session.id,
                                 tenant=session.tenant,
                                 attempt=session._reconnect_attempts)

    # -- drain helpers ----------------------------------------------------

    def idle(self):
        return self.admission.queued == 0 and not self._delayed

    def run_until_idle(self, max_ticks=10_000, advance=None):
        """Pump until no work is queued or parked. `advance` (seconds per
        tick) steps an injected fake clock via pump(now=...) so parked
        retries ripen without wall-clock sleeps."""
        now = self.clock()
        for _ in range(max_ticks):
            if self.idle():
                return True
            self.pump(now=now)
            if advance is not None:
                now += advance
        return self.idle()


class AsyncDocService:
    """asyncio facade: ``await submit(...)`` resolves when the pump loop
    (one ``run()`` task per service) serves the request. Admission
    rejections raise typed immediately; resolved-with-error tickets
    raise their typed error from ``await``."""

    def __init__(self, service, idle_sleep=0.001):
        self.service = service
        self.idle_sleep = idle_sleep
        self._stop = False

    async def submit(self, session, kind, payload=None, **kwargs):
        ticket = self.service.submit(session, kind, payload, **kwargs)
        ticket._future = asyncio.get_running_loop().create_future()
        await ticket._future
        if ticket.status == 'error':
            raise ticket.error
        return ticket

    async def run(self):
        """The pump task: tick while work is queued, sleep until the
        earliest parked retry ripens when backoff parking is the only
        pending work (pumping through a parked delay would busy-spin a
        core on no-op ticks), yield while idle."""
        while not self._stop:
            service = self.service
            if service.admission.queued:
                service.pump()
                await asyncio.sleep(0)
            elif service._delayed:
                wait = min(r.not_before for r in service._delayed) - \
                    service.clock()
                if wait <= 0:
                    service.pump()
                    await asyncio.sleep(0)
                else:
                    await asyncio.sleep(min(wait, max(self.idle_sleep,
                                                      0.001)))
            else:
                await asyncio.sleep(self.idle_sleep)

    def stop(self):
        self._stop = True
