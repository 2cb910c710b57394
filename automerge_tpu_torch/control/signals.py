"""SignalBus: one incremental sample of the whole observatory.

The controller (control/controller.py) decides on WINDOWS, not ticks,
and every window it needs the same cross-cutting read the dashboards
get — but as plain deltas, not rendered pages. The bus keeps the
previous window's monotonic counters and hands back per-window
movement, mirroring the ``_adm_counts`` idiom the service pump already
uses for its brownout inputs: snapshot the counters, diff against the
stash, never rescan history.

What a sample carries (every field plain data, JSON-friendly):

- ``admission``: admitted/throttled/overloaded deltas since the last
  sample, the rejected fraction, and the queued-backlog pressure —
  summed across every live service (one service standalone, one per
  live shard under a router).
- ``tenants``: per-tenant admitted/throttled deltas and the current
  token-bucket rate beside the service's base rate, plus the tenant's
  SLO reads (max availability-throttled and freshness fast-burn across
  request kinds, freshness alert state, worst cursor lag).
- ``shards`` (router mode): per-shard liveness, last pump seconds and
  its EWMA, slipped-tick delta, and homed-tenant count; ``pump_mean_s``
  is the mean EWMA across live shards.
- ``misplaced`` (router mode): tenants whose live ring-primary differs
  from their current home and who are not already migrating — the
  post-revive healing signal.
- ``perf``: max drift ratio and active-alert count from the seam
  baselines (empty observatory reads as 0/0).
- ``watermark``: the demote clock's budget pressure when a ``ClockDemote``
  is attached (None otherwise).
- ``tiering``: fire/defer verdict counts from the cost-model ledger.

The bus holds no locks: it runs on the pump thread (single writer) and
reads the same retry-guarded snapshot surfaces the Prometheus exporter
uses (``SloRegistry.gauges`` et al are torn-read-proof by contract).
"""

__all__ = ['SignalBus']


class SignalBus:
    """See the module docstring. Attach exactly one of ``service`` /
    ``router`` (a router implies its shards' services)."""

    def __init__(self, service=None, router=None, tiering=None,
                 demote=None, pump_alpha=0.3):
        self.service = service
        self.router = router
        self.tiering = tiering if tiering is not None else \
            getattr(service, 'tiering', None)
        self.demote = demote if demote is not None else \
            getattr(self.tiering, 'demote', None)
        self.pump_alpha = float(pump_alpha)
        self._prev_tenant = {}       # tenant -> (admitted, throttled)
        self._prev_adm = (0, 0, 0)   # summed (admitted, ovl, thr)
        self._prev_slips = {}        # shard id -> ticks_slipped
        self._pump_ewma = {}         # shard id -> EWMA pump seconds

    def services(self):
        """[(shard_id_or_None, DocService)] for every live service."""
        if self.router is not None:
            return [(sid, shard.service)
                    for sid, shard in self.router.shards.items()
                    if shard.alive]
        if self.service is not None:
            return [(None, self.service)]
        return []

    # -- the sample ------------------------------------------------------

    def sample(self, tick):
        services = self.services()
        sig = {'tick': tick}
        sig['admission'] = self._sample_admission(services)
        sig['tenants'] = self._sample_tenants(services)
        sig['perf'] = self._sample_perf()
        sig['watermark'] = {
            'pressure': None if self.demote is None
            else float(self.demote.pressure())}
        sig['tiering'] = self._sample_tiering()
        if self.router is not None:
            self._sample_router(sig)
        return sig

    def _sample_admission(self, services):
        admitted = overloaded = throttled = 0
        queued = capacity = 0
        for _sid, svc in services:
            adm = svc.admission
            stats = adm.stats
            admitted += stats['admitted']
            overloaded += stats['rejected_overloaded']
            throttled += stats['rejected_throttled']
            queued += adm.queued
            capacity += adm.max_queued
        counts = (admitted, overloaded, throttled)
        prev = self._prev_adm
        self._prev_adm = counts
        # deltas clamp at 0: a dead shard takes its monotonic counters
        # out of the sum, which must read as "no events", not negative
        admitted_d = max(0, counts[0] - prev[0])
        overloaded_d = max(0, counts[1] - prev[1])
        throttled_d = max(0, counts[2] - prev[2])
        rejected_d = overloaded_d + throttled_d
        seen = admitted_d + rejected_d
        return {'admitted_d': admitted_d, 'overloaded_d': overloaded_d,
                'throttled_d': throttled_d,
                'reject_frac': rejected_d / seen if seen else 0.0,
                'queue_pressure': min(1.0, queued / capacity)
                if capacity else 0.0}

    def _sample_tenants(self, services):
        # monotonic per-tenant counters summed across services (a
        # rehomed tenant's book may briefly exist on two admission
        # controllers; the sum stays monotonic while both live)
        counts = {}
        rates = {}
        base_rate = None
        for _sid, svc in services:
            adm = svc.admission
            if base_rate is None:
                base_rate = adm.rate
            for name, t in list(adm.tenants.items()):
                a, th = counts.get(name, (0, 0))
                counts[name] = (a + t.admitted, th + t.throttled)
                rates[name] = t.bucket.rate
        gauges, lags = self._slo_reads(services)
        out = {}
        for name, (admitted, throttled) in counts.items():
            pa, pt = self._prev_tenant.get(name, (0, 0))
            g = gauges.get(name, {})
            out[name] = {
                'admitted_d': max(0, admitted - pa),
                'throttled_d': max(0, throttled - pt),
                'rate': rates.get(name, base_rate or 0.0),
                'base_rate': base_rate or 0.0,
                'throttled_burn': g.get('throttled_burn', 0.0),
                'fresh_burn': g.get('fresh_burn', 0.0),
                'fresh_alert': g.get('fresh_alert', 0),
                'lag': lags.get(name, 0),
            }
            self._prev_tenant[name] = (admitted, throttled)
        return out

    @staticmethod
    def _slo_reads(services):
        """Per-tenant max burn reads folded across kinds and services."""
        gauges = {}
        lags = {}
        for _sid, svc in services:
            slo = getattr(svc, 'slo', None)
            if not slo:
                continue
            for (tenant, _kind, sli), gauge in slo.gauges().items():
                g = gauges.setdefault(tenant, {})
                fast = gauge.get('fast_burn', 0.0)
                if sli == 'avail_throttled':
                    g['throttled_burn'] = max(
                        g.get('throttled_burn', 0.0), fast)
                elif sli == 'freshness':
                    g['fresh_burn'] = max(g.get('fresh_burn', 0.0), fast)
                    g['fresh_alert'] = max(
                        g.get('fresh_alert', 0),
                        gauge.get('alert_fast', 0),
                        gauge.get('alert_slow', 0))
            for (tenant, _kind), lag in slo.lag_gauges().items():
                lags[tenant] = max(lags.get(tenant, 0), lag)
        return gauges, lags

    def _sample_perf(self):
        from ..observability.perf import baseline_gauges
        max_drift = 0.0
        alerts = 0
        for gauge in baseline_gauges().values():
            max_drift = max(max_drift, float(gauge.get('drift') or 0.0))
            alerts += int(bool(gauge.get('alert')))
        return {'max_drift': max_drift, 'alerts': alerts}

    def _sample_tiering(self):
        model = getattr(self.tiering, 'model', None)
        if model is None:
            return {'fire': 0, 'defer': 0}
        verdicts = list(model._verdicts.values())
        return {'fire': verdicts.count('fire'),
                'defer': verdicts.count('defer')}

    def _sample_router(self, sig):
        router = self.router
        alpha = self.pump_alpha
        homed = {}
        misplaced = []
        shard_tenants = {}
        for rec in router._tenants.values():
            if rec.home is None:
                continue
            homed[rec.home] = homed.get(rec.home, 0) + 1
            shard_tenants.setdefault(rec.home, []).append(rec.name)
            if rec.migrating is None:
                want = router.ring.primary(rec.name, alive=router.alive)
                if want is not None and want != rec.home:
                    misplaced.append(rec.name)
        shards = {}
        ewma_sum = 0.0
        live = 0
        for sid, shard in router.shards.items():
            prev = self._pump_ewma.get(sid, shard.last_pump_s)
            ewma = prev + alpha * (shard.last_pump_s - prev)
            self._pump_ewma[sid] = ewma
            slipped_prev = self._prev_slips.get(sid, 0)
            self._prev_slips[sid] = shard.ticks_slipped
            shards[sid] = {
                'alive': shard.alive and sid in router.alive,
                'last_pump_s': shard.last_pump_s,
                'pump_ewma_s': ewma,
                'slipped_d': max(0, shard.ticks_slipped - slipped_prev),
                'tenants': homed.get(sid, 0),
            }
            if shards[sid]['alive']:
                ewma_sum += ewma
                live += 1
        sig['shards'] = shards
        sig['shard_tenants'] = shard_tenants
        sig['pump_mean_s'] = ewma_sum / live if live else 0.0
        sig['misplaced'] = sorted(misplaced)
        sig['migrating'] = len(router.migrating())
