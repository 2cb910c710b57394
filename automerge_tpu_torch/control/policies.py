"""Hysteretic control policies: signal windows in, declarative actions out.

Each policy is a pure decision function over one SignalBus sample plus
its own hysteresis state — the same ``_Alert`` edge machinery the SLO
burn alerts and the brownout ladder run on (threshold to arm, half the
threshold to disarm, N consecutive windows either way), so a noisy
signal hovering at a boundary cannot flap an actuator. Policies never
touch the system: they return plain action dicts and the controller's
actuator layer routes them through existing seams (admission bucket
rates, ``ClockDemote`` pin lane, ``ShardRouter`` migration machinery).
That split is what makes shadow mode exact — the decision path is
byte-for-byte the active path, minus the final apply.

Every action carries a ``direction`` ('up'/'down', or 'src->dst' for a
move) so the controller can count REVERSALS — the anti-oscillation
number the chaos leg pins (<= 2 per policy per episode).
"""

from ..observability.slo import _Alert

__all__ = ['AdmissionRatePolicy', 'PinResidentPolicy',
           'ShardBalancePolicy']


class AdmissionRatePolicy:
    """Adapt per-tenant token-bucket rates from observed pushback.

    Raise lane: a tenant whose throttled fraction (typed
    ``TenantThrottled`` rejections over its admission attempts) holds
    above ``throttle_frac`` for ``up_windows`` consecutive windows —
    while the service has headroom (queue pressure under ``queue_low``,
    no overload rejections) — gets its bucket rate raised by
    ``raise_factor``, capped at ``max_mult`` x the service base rate.

    Cut lane: sustained overload (global ``Overloaded`` rejections or
    queue pressure over ``queue_high``) walks every boosted tenant back
    toward the base rate by ``cut_factor`` per window. Boosts never go
    below base — the base rate is the operator's floor, and a policy
    that can starve a quiet tenant is a worse outage than the one it
    heals.
    """

    name = 'admission_rate'

    def __init__(self, *, throttle_frac=0.15, raise_factor=1.5,
                 cut_factor=0.5, max_mult=4.0, queue_low=0.3,
                 queue_high=0.7, up_windows=2, down_windows=2,
                 max_actions=4):
        self.throttle_frac = float(throttle_frac)
        self.raise_factor = float(raise_factor)
        self.cut_factor = float(cut_factor)
        self.max_mult = float(max_mult)
        self.queue_low = float(queue_low)
        self.queue_high = float(queue_high)
        self.up_windows = int(up_windows)
        self.down_windows = int(down_windows)
        self.max_actions = int(max_actions)
        self._raise = {}             # tenant -> _Alert
        self._overload = _Alert()
        self.mult = {}               # tenant -> applied rate multiplier

    def decide(self, sig):
        adm = sig['admission']
        out = []
        overloaded = adm['overloaded_d'] > 0 or \
            adm['queue_pressure'] >= self.queue_high
        self._overload.observe(1.0 if overloaded else 0.0, 1.0,
                               self.up_windows, self.down_windows)
        if self._overload.active:
            # walk every boost back toward base while overload persists
            for tenant in sorted(self.mult):
                mult = self.mult[tenant]
                info = sig['tenants'].get(tenant)
                if info is None or mult <= 1.0:
                    continue
                new = max(1.0, mult * self.cut_factor)
                self.mult[tenant] = new
                if new <= 1.0:
                    del self.mult[tenant]
                out.append({
                    'policy': self.name, 'action': 'set_rate',
                    'direction': 'down', 'tenant': tenant,
                    'target': f'tenant:{tenant}',
                    'rate': info['base_rate'] * new, 'mult': new,
                    'detail': {'queue_pressure': adm['queue_pressure'],
                               'overloaded_d': adm['overloaded_d']}})
            return out
        candidates = []
        for tenant, info in sig['tenants'].items():
            seen = info['admitted_d'] + info['throttled_d']
            frac = info['throttled_d'] / seen if seen else 0.0
            alert = self._raise.get(tenant)
            if alert is None:
                if frac < self.throttle_frac:
                    continue
                alert = self._raise[tenant] = _Alert()
            alert.observe(frac, self.throttle_frac, self.up_windows,
                          self.down_windows)
            if not alert.active and not alert.above:
                del self._raise[tenant]
                continue
            if alert.active and adm['queue_pressure'] < self.queue_low:
                mult = self.mult.get(tenant, 1.0)
                if mult < self.max_mult:
                    candidates.append((frac, tenant, info, mult))
        for frac, tenant, info, mult in sorted(candidates,
                                               reverse=True)[
                                                   :self.max_actions]:
            new = min(self.max_mult, mult * self.raise_factor)
            self.mult[tenant] = new
            out.append({
                'policy': self.name, 'action': 'set_rate',
                'direction': 'up', 'tenant': tenant,
                'target': f'tenant:{tenant}',
                'rate': info['base_rate'] * new, 'mult': new,
                'detail': {'throttled_frac': round(frac, 4),
                           'queue_pressure': adm['queue_pressure']}})
        return out

    def active(self):
        return {f'tenant:{t}': round(m, 3)
                for t, m in self.mult.items() if m > 1.0}


class PinResidentPolicy:
    """Pin an SLO-freshness-lagging tenant's docs resident.

    A tenant burning its freshness budget (fast burn >= ``burn``, or
    its freshness alert already firing) for ``up_windows`` windows gets
    its docs PINNED in the demote clock — the tiering plane stops
    parking exactly the docs whose staleness is burning budget. The pin
    lifts on the hysteretic clear (burn <= half threshold for
    ``down_windows`` windows).

    Watermark lane: sustained clock pressure above ``wm_high`` tightens
    the demote budget (``pressure_factor`` -> ``factor_low``) so the
    UNPINNED population demotes harder — the memory the pins hold
    resident has to come from somewhere; the factor relaxes to 1.0 on
    clear.
    """

    name = 'pin_resident'

    def __init__(self, *, burn=1.0, up_windows=2, down_windows=2,
                 wm_high=1.2, factor_low=0.75):
        self.burn = float(burn)
        self.up_windows = int(up_windows)
        self.down_windows = int(down_windows)
        self.wm_high = float(wm_high)
        self.factor_low = float(factor_low)
        self._alerts = {}            # tenant -> _Alert
        self._wm = _Alert()
        self.pinned = set()

    def decide(self, sig):
        out = []
        for tenant, info in sig['tenants'].items():
            burn = max(info['fresh_burn'],
                       self.burn if info['fresh_alert'] else 0.0)
            alert = self._alerts.get(tenant)
            if alert is None:
                if burn < self.burn and tenant not in self.pinned:
                    continue
                alert = self._alerts[tenant] = _Alert()
            edge = alert.observe(burn, self.burn, self.up_windows,
                                 self.down_windows)
            if edge == 'fire' and tenant not in self.pinned:
                self.pinned.add(tenant)
                out.append({
                    'policy': self.name, 'action': 'pin',
                    'direction': 'up', 'tenant': tenant,
                    'target': f'tenant:{tenant}',
                    'detail': {'fresh_burn': round(burn, 4),
                               'lag': info['lag']}})
            elif edge == 'clear' and tenant in self.pinned:
                self.pinned.discard(tenant)
                del self._alerts[tenant]
                out.append({
                    'policy': self.name, 'action': 'unpin',
                    'direction': 'down', 'tenant': tenant,
                    'target': f'tenant:{tenant}',
                    'detail': {'fresh_burn': round(burn, 4)}})
            elif not alert.active and not alert.above and \
                    tenant not in self.pinned:
                del self._alerts[tenant]
        pressure = sig['watermark']['pressure']
        if pressure is not None:
            edge = self._wm.observe(pressure, self.wm_high,
                                    self.up_windows, self.down_windows)
            if edge == 'fire':
                out.append({
                    'policy': self.name, 'action': 'pressure_factor',
                    'direction': 'down', 'target': 'demote_clock',
                    'value': self.factor_low,
                    'detail': {'pressure': round(pressure, 4)}})
            elif edge == 'clear':
                out.append({
                    'policy': self.name, 'action': 'pressure_factor',
                    'direction': 'up', 'target': 'demote_clock',
                    'value': 1.0,
                    'detail': {'pressure': round(pressure, 4)}})
        return out

    def active(self):
        out = {f'tenant:{t}': 1 for t in self.pinned}
        if self._wm.active:
            out['demote_clock'] = 1
        return out


class ShardBalancePolicy:
    """Placement healing + hot-shard relief through the migration seam.

    Heal lane: tenants whose live ring-primary differs from their home
    (the post-failover/revive displacement) sustained for
    ``up_windows`` windows are re-homed BACK to their ring primary, up
    to ``heal_per_window`` per window — the controller-driven
    replacement for loadgen's hardcoded rebalance-after-revive call.

    Relief lane: a live shard whose pump-seconds EWMA holds at
    ``hot_ratio`` x the live-shard mean moves ONE tenant per window to
    the coolest live shard. Tenants the relief lane moved are owned by
    the controller — the heal lane stops counting them as misplaced, so
    the two lanes cannot tug one tenant in a loop.
    """

    name = 'shard_balance'

    def __init__(self, *, hot_ratio=2.0, up_windows=3, down_windows=2,
                 heal_up_windows=2, heal_per_window=4,
                 min_pump_s=0.0005):
        self.hot_ratio = float(hot_ratio)
        self.up_windows = int(up_windows)
        self.down_windows = int(down_windows)
        self.heal_up_windows = int(heal_up_windows)
        self.heal_per_window = int(heal_per_window)
        self.min_pump_s = float(min_pump_s)
        self._heal = _Alert()
        self._hot = {}               # shard id -> _Alert
        self.owned = set()           # tenants the relief lane placed

    def decide(self, sig):
        out = []
        shards = sig.get('shards')
        if not shards:
            return out
        misplaced = [t for t in sig.get('misplaced', ())
                     if t not in self.owned]
        self._heal.observe(1.0 if misplaced else 0.0, 1.0,
                           self.heal_up_windows, 1)
        if self._heal.active and misplaced:
            for tenant in misplaced[:self.heal_per_window]:
                out.append({
                    'policy': self.name, 'action': 'rehome',
                    'direction': 'heal', 'tenant': tenant,
                    'dst': None,     # resolved to the ring primary
                    'target': f'tenant:{tenant}',
                    'detail': {'misplaced': len(misplaced)}})
        live = {sid: s for sid, s in shards.items() if s['alive']}
        mean = sig.get('pump_mean_s', 0.0)
        if len(live) < 2 or mean < self.min_pump_s:
            return out
        moved = False
        for sid in sorted(live, key=lambda s: -live[s]['pump_ewma_s']):
            ratio = live[sid]['pump_ewma_s'] / mean if mean else 0.0
            alert = self._hot.get(sid)
            if alert is None:
                if ratio < self.hot_ratio:
                    continue
                alert = self._hot[sid] = _Alert()
            alert.observe(ratio, self.hot_ratio, self.up_windows,
                          self.down_windows)
            if not alert.active:
                if not alert.above:
                    del self._hot[sid]
                continue
            if moved or live[sid]['tenants'] <= 1:
                continue
            tenants = sig.get('shard_tenants', {}).get(sid, ())
            coolest = min(live, key=lambda s: live[s]['pump_ewma_s'])
            if not tenants or coolest == sid:
                continue
            tenant = tenants[0]
            self.owned.add(tenant)
            moved = True
            out.append({
                'policy': self.name, 'action': 'rehome',
                'direction': f'{sid}->{coolest}', 'tenant': tenant,
                'dst': coolest, 'target': f'tenant:{tenant}',
                'detail': {'pump_ratio': round(ratio, 3),
                           'pump_mean_s': round(mean, 6)}})
        return out

    def active(self):
        out = {f'shard:{sid}': 1 for sid, a in self._hot.items()
               if a.active}
        if self._heal.active:
            out['heal'] = 1
        return out
