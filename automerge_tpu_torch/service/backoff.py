"""Bounded jittered backoff + retry budgets — the shared retry policy.

Two failure-amplification patterns kill overloaded systems: synchronized
retries (every client retrying on the same fixed cadence turns one blip
into a standing wave) and unbounded retries (a persistent fault times N
retrying callers multiplies the outage by N). This module is the one
policy object both the service retry path (service/core.py) and the
sync-stall reconnect (fleet/faults.py) draw from, so every retry in the
system is jittered, capped, and budgeted:

- ``Backoff`` — a deterministic-given-its-seed schedule of exponentially
  growing, jitter-spread delays with a hard try ceiling. Delays are unit
  agnostic: the service interprets them as seconds (wall-clock
  ``not_before``), the lockstep sync driver as ROUNDS — same curve, same
  code.
- ``RetryBudget`` — a token bucket over retries (not requests): each
  retry spends a token, tokens refill at a bounded rate. When the bucket
  is dry the caller must fail typed (``RetriesExhausted``) instead of
  retrying, so a tenant's retries can never exceed ``rate`` per second
  no matter how many of its requests are failing.
"""

import random

__all__ = ['Backoff', 'RetryBudget', 'RetryBudgetPool']


class Backoff:
    """Jittered exponential backoff schedule: attempt k (0-based) waits
    ``min(cap, base * factor**k)`` scaled by a random factor in
    ``[1 - jitter, 1]``. ``delay(k)`` is the wait before retry k;
    ``exhausted(k)`` is True once k reaches ``retries`` (the caller
    should give up typed). Seeded: a seed fully determines the schedule,
    so chaos tests replay identical retry traces."""

    def __init__(self, base=0.05, factor=2.0, cap=5.0, retries=6,
                 jitter=0.5, seed=0):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f'jitter must be in [0, 1], got {jitter}')
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.retries = int(retries)
        self.jitter = float(jitter)
        self.rng = random.Random(seed)

    def delay(self, attempt):
        """Wait before retry `attempt` (0-based). Draws from the
        schedule's PRNG — one draw per call, so identical call sequences
        replay identical delays."""
        raw = min(self.cap, self.base * self.factor ** attempt)
        return raw * (1.0 - self.jitter * self.rng.random())

    def exhausted(self, attempt):
        """True once `attempt` retries have been spent."""
        return attempt >= self.retries


class RetryBudget:
    """Token bucket over RETRIES: ``spend(now)`` returns True and takes a
    token when one is available, False when the budget is dry (fail
    typed, do not retry). Tokens refill at ``rate``/sec up to ``burst``.
    The clock is passed in (monotonic seconds) so tests and the lockstep
    drivers control time."""

    def __init__(self, rate=10.0, burst=20.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = None
        self.spent = 0            # lifetime retries granted
        self.denied = 0           # lifetime retries refused

    def _refill(self, now):
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now

    def spend(self, now):
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self.spent += 1
            return True
        self.denied += 1
        return False

    def available(self, now):
        self._refill(now)
        return self.tokens


class RetryBudgetPool:
    """Lazy per-tenant ``RetryBudget`` map with one shared rate/burst
    config — the memoization both ``DocService`` and ``ShardRouter``
    need, kept in ONE place so budget semantics can't diverge."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self._budgets = {}

    def get(self, tenant):
        b = self._budgets.get(tenant)
        if b is None:
            b = self._budgets[tenant] = RetryBudget(rate=self.rate,
                                                    burst=self.burst)
        return b
