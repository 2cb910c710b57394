"""The feedback controller: sample -> decide -> actuate -> ledger.

``Controller.tick()`` rides the owning pump (``DocService.pump`` or
``ShardRouter.pump`` calls it once per tick when attached); off-window
ticks cost one integer increment and a modulo. Every ``window`` ticks
it takes one SignalBus sample, runs each policy over it, and commits
the resulting decisions:

- **actuate** (mode='active'): route the action through an existing
  seam — ``AdmissionController.set_tenant_rate``, the ``ClockDemote``
  pin lane / ``pressure_factor``, ``ShardRouter.rehome_tenant`` (the
  same migration machinery ``rebalance`` uses). Mode='shadow' runs the
  IDENTICAL decision path and records "would have acted" without
  touching anything — the parity the bench section pins.
- **ledger**: every decision (applied or shadow) lands in the bounded
  in-memory decision ledger AND the flight recorder, stamped with the
  input signal snapshot that justified it and the trace ids of affected
  in-flight requests, so ``obs_report --control`` can answer
  why-did-it-act from a dump alone.
- **reversals**: an up following a down (or a move undoing the previous
  move) on the same (policy, target) counts a reversal — the
  anti-oscillation number the chaos leg bounds.

Snapshot contract: ``gauges()`` returns plain copies taken under the
controller lock; the pump thread mutates the same state under that
lock, so a concurrent Prometheus scrape can never see a torn map
(pinned by the hammer test in tests/test_export.py).
"""

import collections
import json
import threading
import time

from ..observability import recorder as _flight
from ..observability.metrics import Counters, register_health_source
from .policies import (AdmissionRatePolicy, PinResidentPolicy,
                       ShardBalancePolicy)
from .signals import SignalBus

__all__ = ['Controller']

_stats = Counters({
    'control_windows': 0,        # decision windows evaluated
    'control_decisions': 0,      # decisions committed (both modes)
    'control_actuations': 0,     # decisions actually applied
    'control_shadow_decisions': 0,   # would-have-acted entries
    'control_reversals': 0,      # direction flips per (policy, target)
    'control_apply_failures': 0,     # actuations the seam refused
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def control_stats():
    return dict(_stats)


class Controller:
    """See the module docstring. Construct first, then hand it to the
    pump owner (``DocService(control=...)`` / ``ShardRouter(control=
    ...)``), which binds itself via ``attach``."""

    def __init__(self, *, mode='active', window=10, policies=None,
                 service=None, router=None, tiering=None, demote=None,
                 ledger_cap=512, trace_cap=8):
        if mode not in ('active', 'shadow'):
            raise ValueError(f"mode must be 'active' or 'shadow', "
                             f'got {mode!r}')
        self.mode = mode
        self.window = max(1, int(window))
        self.policies = list(policies) if policies is not None else [
            AdmissionRatePolicy(), PinResidentPolicy(),
            ShardBalancePolicy()]
        self.service = service
        self.router = router
        self.tiering = tiering
        self.demote = demote
        self.trace_cap = int(trace_cap)
        self.ledger = collections.deque(maxlen=int(ledger_cap))
        self._lock = threading.Lock()
        self._ticks = 0
        self._windows = 0
        self._decisions = {}         # (policy, action, mode) -> count
        self._reversals = {}         # policy -> count
        self._last_dir = {}          # (policy, target) -> direction
        self._last_decision_tick = None
        self._decide_s_last = 0.0
        self._decide_s_max = 0.0
        self._active = {}            # (policy, target) -> value
        self.bus = None
        self._rebind()

    # -- wiring ----------------------------------------------------------

    def attach(self, service=None, router=None, tiering=None,
               demote=None):
        """Bind the controller to its pump owner (idempotent; the owner
        calls this from its constructor)."""
        if service is not None:
            self.service = service
        if router is not None:
            self.router = router
        if tiering is not None:
            self.tiering = tiering
        if demote is not None:
            self.demote = demote
        self._rebind()
        return self

    def _rebind(self):
        tiering = self.tiering if self.tiering is not None else \
            getattr(self.service, 'tiering', None)
        self.bus = SignalBus(service=self.service, router=self.router,
                             tiering=tiering, demote=self.demote)

    def _demote_clock(self):
        if self.demote is not None:
            return self.demote
        return getattr(self.bus, 'demote', None)

    # -- the tick --------------------------------------------------------

    def tick(self, now=None):
        """One pump tick. Returns the window's decision list when a
        decision window closed, else None."""
        self._ticks += 1
        if self._ticks % self.window:
            return None
        start = time.perf_counter()
        sig = self.bus.sample(self._ticks)
        decisions = []
        for policy in self.policies:
            decisions.extend(policy.decide(sig))
        entries = [self._commit(d, sig) for d in decisions]
        if self.mode == 'active':
            self.reassert_pins()
        elapsed = time.perf_counter() - start
        active = {}
        for policy in self.policies:
            for target, value in policy.active().items():
                active[(policy.name, target)] = value
        with self._lock:
            self._windows += 1
            self._decide_s_last = elapsed
            self._decide_s_max = max(self._decide_s_max, elapsed)
            self._active = active
            if entries:
                self._last_decision_tick = self._ticks
        _stats.inc('control_windows')
        return entries

    def _commit(self, d, sig):
        applied = False
        if self.mode == 'active':
            applied = self._apply(d)
        target = d.get('target', '')
        direction = d.get('direction', '')
        prev = self._last_dir.get((d['policy'], target))
        reversal = _is_reversal(prev, direction)
        self._last_dir[(d['policy'], target)] = direction
        traces = self._traces_for(d.get('tenant'))
        entry = {k: v for k, v in d.items()}
        entry.update(tick=self._ticks, mode=self.mode, applied=applied,
                     reversal=reversal, traces=traces,
                     signals=self._signal_slice(sig, d))
        with self._lock:
            key = (d['policy'], d['action'], self.mode)
            self._decisions[key] = self._decisions.get(key, 0) + 1
            if reversal:
                self._reversals[d['policy']] = \
                    self._reversals.get(d['policy'], 0) + 1
            self.ledger.append(entry)
        _stats.inc('control_decisions')
        if self.mode == 'shadow':
            _stats.inc('control_shadow_decisions')
        elif applied:
            _stats.inc('control_actuations')
        else:
            _stats.inc('control_apply_failures')
        if reversal:
            _stats.inc('control_reversals')
        _flight.record_event('control_decision', policy=d['policy'],
                             action=d['action'], target=target,
                             direction=direction, mode=self.mode,
                             applied=applied, reversal=reversal,
                             tick=self._ticks,
                             signals=entry['signals'], traces=traces,
                             detail=d.get('detail'))
        return entry

    @staticmethod
    def _signal_slice(sig, d):
        """The input snapshot that justified this decision: the global
        planes plus the affected tenant/shard rows — small enough for
        the flight ring, complete enough for a forensic why."""
        out = {'tick': sig['tick'], 'admission': dict(sig['admission']),
               'watermark': dict(sig['watermark']),
               'perf': dict(sig['perf']), 'tiering': dict(sig['tiering'])}
        tenant = d.get('tenant')
        if tenant is not None and tenant in sig['tenants']:
            out['tenant'] = dict(sig['tenants'][tenant])
        if 'shards' in sig:
            out['pump_mean_s'] = sig.get('pump_mean_s', 0.0)
            out['misplaced'] = list(sig.get('misplaced', ()))
        return out

    def _traces_for(self, tenant):
        """Trace ids of in-flight requests the decision touches (the
        affected tenant's queued work; every pending request when the
        decision is tenant-less). Best-effort and bounded."""
        out = []
        if self.router is not None:
            for req in self.router._pending:
                if len(out) >= self.trace_cap:
                    return out
                if tenant is not None and req.tenant != tenant:
                    continue
                sub = req.sub
                trace = getattr(sub, 'trace', None) if sub is not None \
                    else None
                if trace is not None:
                    out.append(trace.trace_id)
        for _sid, svc in self.bus.services():
            if len(out) >= self.trace_cap:
                return out
            for t in list(svc.admission.tenants.values()):
                if tenant is not None and t.name != tenant:
                    continue
                for req in t.queue[:self.trace_cap]:
                    trace = getattr(req.ticket, 'trace', None)
                    if trace is not None:
                        out.append(trace.trace_id)
                    if len(out) >= self.trace_cap:
                        return out
        return out

    # -- actuators (existing seams only) ---------------------------------

    def _apply(self, d):
        action = d['action']
        if action == 'set_rate':
            applied = False
            for _sid, svc in self.bus.services():
                if d['tenant'] in svc.admission.tenants:
                    svc.admission.set_tenant_rate(d['tenant'],
                                                  rate=d['rate'])
                    applied = True
            return applied
        if action in ('pin', 'unpin'):
            demote = self._demote_clock()
            if demote is None:
                return False
            handles = self._tenant_handles(d['tenant'])
            if action == 'pin':
                demote.pin(handles)
                return bool(handles)
            demote.unpin(handles)
            return True
        if action == 'pressure_factor':
            demote = self._demote_clock()
            if demote is None:
                return False
            demote.pressure_factor = float(d['value'])
            return True
        if action == 'rehome':
            if self.router is None:
                return False
            dst = d.get('dst')
            if dst is None:
                dst = self.router.ring.primary(
                    d['tenant'], alive=self.router.alive)
                d['dst'] = dst
            if dst is None:
                return False
            return self.router.rehome_tenant(d['tenant'], dst)
        return False

    def _tenant_handles(self, tenant):
        out = []
        for _sid, svc in self.bus.services():
            out.extend(s.handle for s in list(svc.sessions.values())
                       if s.tenant == tenant and not s.closed)
        return out

    def reassert_pins(self):
        """Re-pin the CURRENT handles of every pinned tenant. The apply
        seam freezes old handle dicts, so a pinned doc's live handle
        churns; the demote clock prunes frozen pins and this re-asserts
        the fresh ones. The pump owner may call it on any cadence; the
        controller also runs it once per decision window."""
        demote = self._demote_clock()
        if demote is None:
            return
        for policy in self.policies:
            for tenant in getattr(policy, 'pinned', ()):
                demote.pin(self._tenant_handles(tenant))

    # -- read surfaces ---------------------------------------------------

    def gauges(self):
        """Plain-data snapshot for export (torn-read-proof: the same
        lock brackets every writer)."""
        with self._lock:
            return {
                'mode': self.mode,
                'window': self.window,
                'ticks': self._ticks,
                'windows': self._windows,
                'decisions': dict(self._decisions),
                'reversals': dict(self._reversals),
                'active': dict(self._active),
                'last_decision_tick': self._last_decision_tick,
                'decide_s_last': self._decide_s_last,
                'decide_s_max': self._decide_s_max,
            }

    def decision_log(self, n=None):
        """The newest `n` ledger entries (all when n is None), oldest
        first, as plain copies."""
        with self._lock:
            entries = list(self.ledger)
        entries = entries if n is None else entries[-n:]
        return [dict(e) for e in entries]

    def dump_decisions(self, path=None):
        """The decision ledger as one JSON-ready report (the
        ``obs_report --control`` input). Written to ``path`` when
        given; always returned."""
        gauges = self.gauges()
        # the in-memory gauges are tuple-keyed for the exporter; JSON
        # wants strings
        gauges['decisions'] = {'/'.join(k): v for k, v
                               in gauges['decisions'].items()}
        gauges['active'] = {f'{p}/{t}': v for (p, t), v
                            in gauges['active'].items()}
        report = {'kind': 'control_ledger', 'mode': self.mode,
                  'window': self.window, 'gauges': gauges,
                  'decisions': self.decision_log()}
        if path is not None:
            with open(path, 'w') as f:
                json.dump(report, f, indent=1, default=repr)
            report['path'] = path
        return report


def _is_reversal(prev, cur):
    """An up after a down (or vice versa), or a move undoing the
    previous move, on the same (policy, target)."""
    if prev is None or prev == cur:
        return False
    if {prev, cur} == {'up', 'down'}:
        return True
    if '->' in prev and '->' in cur:
        ps, _, pd = prev.partition('->')
        cs, _, cd = cur.partition('->')
        return ps == cd and pd == cs
    return False
