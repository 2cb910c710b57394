"""Overload-safe multi-tenant serving core (the ROADMAP serving front).

``DocService`` multiplexes tenant sessions onto a ``DocFleet`` through
the batched seams, with per-tenant token-bucket admission control and
bounded queues (typed ``TenantThrottled``/``Overloaded`` rejection),
request deadlines honored all-or-nothing at the fused-dispatch boundary
(typed ``DeadlineExceeded``), jittered-backoff retries under per-tenant
budgets (typed ``RetriesExhausted``), and a three-stage brownout ladder
(widen fsync batching -> defer compaction -> shed background sync).
``tools/loadgen.py`` is the standing scenario testbed; bench.py's
``service`` section reports p99 request latency and sustained rounds/s.

Layering note: ``core`` is loaded lazily (PEP 562) so the light policy
modules (``backoff``, ``admission``, ``deadline``, ``brownout``) stay
importable from ``fleet/`` without a cycle — ``fleet/faults.py`` reuses
``service.backoff`` for its reconnect schedule.
"""

from .admission import AdmissionController, TokenBucket
from .backoff import Backoff, RetryBudget
from .brownout import BrownoutController, brownout_stats
from .deadline import Deadline

__all__ = [
    'DocService', 'AsyncDocService', 'Session', 'Ticket', 'service_stats',
    'AdmissionController', 'TokenBucket', 'Backoff', 'RetryBudget',
    'BrownoutController', 'brownout_stats', 'Deadline',
]

_CORE = ('DocService', 'AsyncDocService', 'Session', 'Ticket',
         'service_stats')


def __getattr__(name):
    if name in _CORE:
        from . import core
        return getattr(core, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
