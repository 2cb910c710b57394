"""Brownout ladder: graceful degradation under sustained pressure.

Overload is not binary. Between "healthy" and "shedding everything"
there is a ladder of cheap capacity the service can reclaim by spending
explicitly-bounded guarantees, in order of how much each costs the user
(SynchroStore's cost-deferral argument, PAPERS.md — background cost
should yield to the request path under pressure, not compete with it):

- **Stage 1 — widen durability batching.** The journal's
  ``fsync_bytes`` threshold rises to a configured ceiling, so group
  commits amortize across more bytes. The cost is a WIDER loss window
  (``pending_fsync_bytes``) — still bounded by the stage-1 ceiling, and
  visible as a registered health counter (fleet/durability.py).
- **Stage 2 — defer compaction/checkpoints.** Replay debt grows
  (recovery gets slower) but the request path stops paying snapshot
  cost. Deferred, not cancelled: de-escalation triggers a compaction
  check immediately.
- **Stage 3 — shed lowest-priority sync rounds.** Background
  anti-entropy (priority < ``shed_priority``) is rejected typed
  (``Overloaded`` with ``shed=True``); interactive work keeps flowing.
  CRDT sync is idempotent and delay-tolerant, so a shed round costs
  staleness, never correctness.

Transitions are hysteretic — pressure must hold above ``high`` for
``up_ticks`` service ticks to climb, below ``low`` for ``down_ticks``
to descend, one stage per transition — and every transition lands in a
health counter and a flight-recorder event, so an incident's ladder
history is in the forensic dump.
"""

from ..observability import recorder as _flight
from ..observability.metrics import Counters, register_health_source

__all__ = ['BrownoutController', 'brownout_stats']

_stats = Counters({
    'brownout_escalations': 0,     # stage climbs (monotonic)
    'brownout_deescalations': 0,   # stage descents (monotonic)
    'brownout_stage': 0,           # current stage across controllers (gauge)
    'shed_sync_rounds': 0,         # stage-3 typed sheds (monotonic)
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def brownout_stats():
    return dict(_stats)


class BrownoutController:
    """Pressure-driven stage machine (0 = healthy .. 3 = max brownout).

    ``observe(pressure)`` is called once per service tick with the
    admission pressure in [0, 1]; it returns the (possibly new) stage.
    The service consults ``stage`` (and helpers ``defer_compaction`` /
    ``shed_below``) when scheduling work. ``attach_journal`` points
    stage 1 at a journal whose ``fsync_bytes`` it may widen; the
    original value is restored on de-escalation below 1."""

    def __init__(self, high=0.75, low=0.35, up_ticks=3, down_ticks=8,
                 fsync_widen_bytes=4 << 20, shed_priority=1):
        self.high = float(high)
        self.low = float(low)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.fsync_widen_bytes = int(fsync_widen_bytes)
        self.shed_priority = int(shed_priority)
        self.stage = 0
        self._above = 0
        self._below = 0
        self._journal = None
        self._journal_fsync_restore = None
        self.transitions = []       # (stage_from, stage_to, pressure) log

    # -- wiring ---------------------------------------------------------

    def attach_journal(self, journal):
        """The journal whose group-commit batching stage 1 widens. Safe
        to re-attach after rotation (checkpoint swaps journal objects):
        a new journal inherits the current stage's policy."""
        self._journal = journal
        if journal is not None:
            self._journal_fsync_restore = journal.fsync_bytes
            if self.stage >= 1:
                journal.fsync_bytes = max(journal.fsync_bytes,
                                          self.fsync_widen_bytes)

    # -- the ladder -----------------------------------------------------

    def observe(self, pressure):
        """One tick's pressure sample -> (possibly new) stage, with
        hysteresis so a flapping signal cannot thrash the ladder."""
        if pressure >= self.high:
            self._above += 1
            self._below = 0
        elif pressure <= self.low:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
        if self._above >= self.up_ticks and self.stage < 3:
            self._transition(self.stage + 1, pressure)
            self._above = 0
        elif self._below >= self.down_ticks and self.stage > 0:
            self._transition(self.stage - 1, pressure)
            self._below = 0
        return self.stage

    def _transition(self, new_stage, pressure):
        old = self.stage
        self.stage = new_stage
        if new_stage > old:
            _stats.inc('brownout_escalations')
        else:
            _stats.inc('brownout_deescalations')
        _stats['brownout_stage'] = new_stage
        self.transitions.append((old, new_stage, pressure))
        self._apply_stage(old)
        _flight.record_event('brownout', stage_from=old,
                             stage_to=new_stage,
                             pressure=round(pressure, 4))

    def _apply_stage(self, old):
        j = self._journal
        if j is None:
            return
        if self.stage >= 1 and old < 1:
            self._journal_fsync_restore = j.fsync_bytes
            j.fsync_bytes = max(j.fsync_bytes, self.fsync_widen_bytes)
        elif self.stage < 1 and old >= 1:
            j.fsync_bytes = self._journal_fsync_restore or 0
            # the widened loss window closes NOW, not at the next
            # naturally-large commit
            j.sync()

    # -- what the service consults per tick -----------------------------

    @property
    def defer_compaction(self):
        """Stage >= 2: skip cost-based compaction checks this tick."""
        return self.stage >= 2

    def shed_below(self):
        """Priority floor below which sync work is shed (None = no
        shedding this tick)."""
        return self.shed_priority if self.stage >= 3 else None

    def count_shed(self, n=1):
        _stats.inc('shed_sync_rounds', n)
