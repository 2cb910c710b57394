"""Per-tenant admission control: token buckets, bounded queues, fairness.

The fleet engine happily queues unbounded work — which means one
aggressive tenant can buffer minutes of backlog and every other tenant's
requests age behind it. Admission control moves the rejection to the
EDGE, typed, before any resources are committed:

- a GLOBAL ceiling on queued requests (``max_queued``) — past it the
  service is ``Overloaded`` for everyone, which is the signal the
  brownout ladder (service/brownout.py) consumes;
- a per-tenant token bucket (``rate``/``burst``) — a flooding tenant
  runs itself dry and gets ``TenantThrottled`` with a ``retry_after``
  hint while other tenants' buckets stay full;
- a per-tenant bounded queue (``queue_limit``) — even a tenant inside
  its rate cannot buffer unbounded latency; the queue bound converts
  backlog into typed pushback.

Dequeue order is round-robin ACROSS tenants, FIFO within one — an
N-request flood from tenant A delays tenant B by at most B's own queue
depth, not A's. All clocks are injected monotonic seconds so tests and
the loadgen drive time explicitly.
"""

from ..errors import Overloaded, TenantThrottled

__all__ = ['TokenBucket', 'AdmissionController']


class TokenBucket:
    """Classic token bucket: ``take(now)`` spends one token if available,
    else returns the seconds until one refills (0 never happens: a
    refusal always names a positive wait)."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = None

    def _refill(self, now):
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, now):
        """None = token granted; float = retry_after seconds refused."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        if self.rate <= 0:
            return float('inf')
        return (1.0 - self.tokens) / self.rate


class _Tenant:
    __slots__ = ('name', 'bucket', 'queue', 'admitted', 'throttled')

    def __init__(self, name, rate, burst):
        self.name = name
        self.bucket = TokenBucket(rate, burst)
        self.queue = []            # FIFO of admitted-but-unserved requests
        self.admitted = 0
        self.throttled = 0


class AdmissionController:
    """Admission + fair dequeue over tenant queues.

    ``admit(tenant, request, now)`` raises ``Overloaded`` /
    ``TenantThrottled`` (typed, with ``retry_after``) or enqueues.
    ``drain(limit)`` pops up to `limit` requests round-robin across
    tenants (FIFO within each) — the service tick's fair work source.
    ``pressure()`` is queued/global-capacity in [0, 1], the brownout
    ladder's primary signal."""

    def __init__(self, rate=200.0, burst=50.0, queue_limit=64,
                 max_queued=10_000):
        self.rate = float(rate)
        self.burst = float(burst)
        self.queue_limit = int(queue_limit)
        self.max_queued = int(max_queued)
        self.tenants = {}
        self.queued = 0
        self._rr = []              # round-robin tenant order
        self._rr_pos = 0
        self.stats = {'admitted': 0, 'rejected_overloaded': 0,
                      'rejected_throttled': 0}

    def tenant(self, name):
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = _Tenant(name, self.rate, self.burst)
            self._rr.append(t)
        return t

    def admit(self, tenant, request, now):
        """Admit or raise. The global check runs FIRST: an overloaded
        service refuses everyone identically rather than letting quiet
        tenants in while the backlog drains (predictable pushback beats
        admission roulette under overload)."""
        if self.queued >= self.max_queued:
            self.stats['rejected_overloaded'] += 1
            raise Overloaded(
                f'service overloaded: {self.queued} requests queued '
                f'(ceiling {self.max_queued})', retry_after=0.05,
                shed=False, stage=None)
        t = self.tenant(tenant)
        retry_after = t.bucket.take(now)
        if retry_after is not None:
            t.throttled += 1
            self.stats['rejected_throttled'] += 1
            raise TenantThrottled(
                f'tenant {tenant!r} throttled: token bucket dry '
                f'(rate {t.bucket.rate}/s)', tenant=tenant,
                retry_after=retry_after)
        if len(t.queue) >= self.queue_limit:
            t.bucket.tokens += 1.0       # the refused request spent none
            t.throttled += 1
            self.stats['rejected_throttled'] += 1
            raise TenantThrottled(
                f'tenant {tenant!r} throttled: queue full '
                f'({self.queue_limit})', tenant=tenant,
                retry_after=1.0 / t.bucket.rate if t.bucket.rate > 0
                else None)
        t.queue.append(request)
        t.admitted += 1
        self.queued += 1
        self.stats['admitted'] += 1

    def set_tenant_rate(self, name, rate=None, burst=None):
        """Retarget one tenant's token-bucket refill ``rate`` (and/or
        ``burst``) in place — the control plane's actuator. The bucket
        object survives, so tokens already accrued are kept (clamped to
        the new burst) and the next ``_refill`` accrues at the new rate
        mid-flight. Returns the bucket."""
        bucket = self.tenant(name).bucket
        if rate is not None:
            bucket.rate = float(rate)
        if burst is not None:
            bucket.burst = float(burst)
            bucket.tokens = min(bucket.tokens, bucket.burst)
        return bucket

    def requeue_front(self, tenant, requests):
        """Push unserved requests back at the FRONT of their tenant's
        queue (a batch aborted before its dispatch — deadline raced, the
        work was not done). Exempt from the admission checks: these were
        already admitted and never served."""
        t = self.tenant(tenant)
        t.queue[:0] = requests
        self.queued += len(requests)

    def drain(self, limit):
        """Up to `limit` requests, round-robin across tenants with
        non-empty queues, FIFO within a tenant."""
        out = []
        if not self._rr or limit <= 0:
            return out
        n = len(self._rr)
        idle = 0
        while len(out) < limit and idle < n:
            t = self._rr[self._rr_pos % n]
            self._rr_pos += 1
            if t.queue:
                out.append(t.queue.pop(0))
                self.queued -= 1
                idle = 0
            else:
                idle += 1
        return out

    def pressure(self):
        """Queued fraction of the global ceiling, in [0, 1]."""
        if self.max_queued <= 0:
            return 0.0
        return min(1.0, self.queued / self.max_queued)
