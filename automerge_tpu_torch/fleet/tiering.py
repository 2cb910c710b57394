"""Cost-based tiering: when to demote, when to compact, what pressure defers.

The storage engine's maintenance decisions used to be fixed byte
thresholds: ``vacuum_dead_fraction=0.5``, the journal's
``compact_bytes`` floor, manual ``park`` calls, and brownout stage 2 as
a hard compaction override. This module replaces them with one explicit
cost model in the spirit of SynchroStore (PAPERS.md): every background
action is a trade of WRITE AMPLIFICATION (bytes rewritten now, stealing
request-path bandwidth) against READ LATENCY (arena garbage polluting
the page cache, longer recovery scans) and RECOVERY-REPLAY DEBT (journal
bytes/records a crash would replay). Admission pressure — the brownout
stage — enters the model as a multiplier on write cost, so "defer
compaction under pressure" (brownout stage 2) emerges from the ledger
instead of being a switch: background work still fires under pressure
when the debt side grows large enough to justify it, and every
defer/fire verdict flip is flight-recorded for the forensic dump.

Three pieces:

- ``CostModel`` — the ledger. ``vacuum_due(main_store, stage)`` weighs
  arena garbage against a live-byte rewrite; ``compact_due(durable,
  stage)`` weighs replay debt against the incremental snapshot cost.
- ``ClockDemote`` — a second-chance clock over live fleet docs feeding
  ``StorageEngine.park`` automatically: docs touched since the hand
  last passed survive; cold docs demote in batches whenever the
  resident-bytes source (fed by the round-17 memory watermarks) sits
  above budget. Zero manual ``park`` calls.
- ``TieringController`` — one ``tick(stage)`` gluing the three planes
  together for the service loop (service/core.py calls it per pump when
  attached): demote under watermark pressure, vacuum when the model says
  the garbage pays for the rewrite, compact when replay debt beats
  snapshot cost.
"""

from ..observability import recorder as _flight
from ..observability.metrics import Counters, register_health_source

__all__ = ['CostModel', 'ClockDemote', 'TieringController']

_stats = Counters({
    'tiering_demoted_docs': 0,      # docs auto-parked by the clock
    'tiering_vacuums': 0,           # cost-model vacuums fired
    'tiering_compactions': 0,       # cost-model journal compactions
    'tiering_deferred': 0,          # verdicts flipped to defer by pressure
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def tiering_stats():
    return dict(_stats)


class CostModel:
    """The write-amp vs read-latency vs replay-debt ledger.

    Costs are in abstract byte-units: a byte REWRITTEN costs
    ``write_byte_cost`` (times the brownout pressure multiplier — under
    admission pressure, background writes compete with the request
    path); a byte of arena GARBAGE costs ``garbage_byte_cost`` per
    decision window (page-cache pollution + recovery-scan debt); a byte
    of journal replay debt costs ``replay_byte_cost`` and a record
    ``replay_record_cost`` (replay is decode+apply, far pricier than a
    sequential rewrite). An action fires when its debt side outweighs
    its rewrite side; pressure raises the bar rather than closing the
    gate."""

    def __init__(self, write_byte_cost=1.0, garbage_byte_cost=2.0,
                 replay_byte_cost=3.0, replay_record_cost=256.0,
                 stage_write_penalty=7.0, min_garbage_bytes=256 << 10,
                 min_replay_bytes=64 << 10, segment_stitch_cost=64 << 10):
        self.write_byte_cost = float(write_byte_cost)
        self.garbage_byte_cost = float(garbage_byte_cost)
        self.replay_byte_cost = float(replay_byte_cost)
        self.replay_record_cost = float(replay_record_cost)
        self.stage_write_penalty = float(stage_write_penalty)
        self.min_garbage_bytes = int(min_garbage_bytes)
        self.min_replay_bytes = int(min_replay_bytes)
        # per-segment recovery overhead (file open + frame validation)
        # in byte-units: many tiny segments can justify an escalation
        # even when their summed bytes look cheap
        self.segment_stitch_cost = float(segment_stitch_cost)
        self._verdicts = {}          # (kind, target id) -> last verdict

    def _pressure_mult(self, stage):
        """Brownout stage -> write-cost multiplier. Stage 2+ is the old
        'defer compaction' stage: instead of a hard override it makes
        background rewrites ~(1+penalty)x as expensive, so they still
        fire when debt overwhelms."""
        return 1.0 + (self.stage_write_penalty if stage >= 2 else 0.0)

    def _note(self, kind, target, fire, deferred_by_stage, stage):
        """Flight-record verdict FLIPS (not every tick) so an incident
        dump shows when pressure started deferring maintenance."""
        key = (kind, id(target))
        verdict = 'fire' if fire else ('defer' if deferred_by_stage
                                       else 'idle')
        if self._verdicts.get(key) != verdict:
            self._verdicts[key] = verdict
            if verdict != 'idle':
                _flight.record_event('tiering', action=kind,
                                     verdict=verdict, stage=stage)
            if verdict == 'defer':
                _stats.inc('tiering_deferred')

    def vacuum_due(self, main, stage=0):
        """Should this MainStore compact now? Benefit: reclaiming arena
        garbage (dead chunks, tombstones, stale epochs' scan debt) AND
        the RAM-resident lane bytes dead rows pin (``dead_lane_bytes``
        — RSS, weighted double: it is the very ceiling the tier
        budgets). Cost: rewriting the live bytes, scaled by pressure.
        Backstop: a store ≥90% dead rows fires regardless of byte
        ratios — row-id space and resident lanes must not leak just
        because the dead chunks were small."""
        garbage = main.garbage_bytes + 2 * main.dead_lane_bytes
        if main.dead_fraction >= 0.9 and main.n_rows >= 4096:
            self._note('vacuum', main, True, False, stage)
            return True
        if garbage < self.min_garbage_bytes and main.dead_fraction < 0.5:
            self._note('vacuum', main, False, False, stage)
            return False
        benefit = garbage * self.garbage_byte_cost
        base_cost = max(main.chunk_bytes, 1) * self.write_byte_cost
        fire = benefit > base_cost * self._pressure_mult(stage)
        deferred = (not fire) and benefit > base_cost
        self._note('vacuum', main, fire, deferred, stage)
        return fire

    def compact_due(self, durable, stage=0):
        """Should this DurableFleet compact its journal now? Benefit:
        replay debt retired (bytes re-decoded + records re-applied at
        recovery). Cost: the incremental snapshot rewrite (~the
        journaled bytes re-persisted), scaled by pressure."""
        debt = durable.replay_debt()
        if debt['bytes'] < self.min_replay_bytes:
            self._note('compact', durable, False, False, stage)
            return False
        benefit = debt['bytes'] * self.replay_byte_cost + \
            debt['records'] * self.replay_record_cost
        base_cost = debt['bytes'] * self.write_byte_cost
        fire = benefit > base_cost * self._pressure_mult(stage)
        deferred = (not fire) and benefit > base_cost
        self._note('compact', durable, fire, deferred, stage)
        return fire

    def chain_escalate_due(self, durable, stage=0):
        """Should the next incremental compaction escalate to a FULL
        checkpoint? Benefit: retiring the chain's stitch debt — the
        tail segment bytes recovery re-reads on top of the base (mostly
        superseded doc copies, i.e. disk amplification) plus a
        per-segment open/validate overhead. Cost: rewriting every live
        doc (~base + tail bytes), scaled by pressure. This replaces the
        bare ``len(chain) >= max_chain`` count as the DECIDING rule —
        ``max_chain`` survives in DurableFleet.compact as the hard
        ceiling bounding stitch work absolutely; the ledger only moves
        the escalation EARLIER when the debt pays for it. Verdict flips
        are flight-recorded like vacuum/compact."""
        debt = durable.chain_debt()
        if debt['segments'] == 0:
            self._note('chain', durable, False, False, stage)
            return False
        benefit = debt['bytes'] * self.garbage_byte_cost + \
            debt['segments'] * self.segment_stitch_cost
        base_cost = (durable.base_bytes() + debt['bytes']) * \
            self.write_byte_cost
        fire = benefit > base_cost * self._pressure_mult(stage)
        deferred = (not fire) and benefit > base_cost
        self._note('chain', durable, fire, deferred, stage)
        return fire


class ClockDemote:
    """Second-chance clock over live fleet docs feeding ``park``.

    ``register`` admits handles to the ring; ``touch`` gives a doc a
    second chance (the request path calls it on every read/write/sync
    that serves the doc). ``tick`` demotes cold docs in batches while
    the resident-bytes ``source`` reads above ``budget_bytes`` — the
    watermark feed (observability/perf.py ``sample_watermarks`` tiers,
    or process RSS by default). Docs the engine refuses to park (queued
    changes, frozen) stay in the ring for the next pass.

    Two control-plane levers (control/): ``pin``/``unpin`` exempt
    specific handles from demotion (an SLO-freshness-lagging tenant's
    docs stay resident however cold they look), and ``pressure_factor``
    scales the effective budget (<1.0 demotes the unpinned population
    harder — the memory the pins hold has to come from somewhere)."""

    def __init__(self, engine, budget_bytes, source=None, batch=128):
        self.engine = engine
        self.budget_bytes = int(budget_bytes)
        self.pressure_factor = 1.0
        if source is None:
            from ..observability.perf import rss_bytes
            source = lambda: rss_bytes()[0]      # noqa: E731
        self.source = source
        self.batch = int(batch)
        self._ring = []              # [handle, ref_bit]
        self._by_handle = {}         # id(handle) -> ring index
        self._hand = 0
        self._pinned = {}            # id(handle) -> handle (strong ref)
        self.last_parked = []        # (handle, doc_id) pairs, last tick

    def __len__(self):
        return len(self._ring)

    def register(self, handles):
        for handle in handles:
            if id(handle) in self._by_handle:
                continue
            self._by_handle[id(handle)] = len(self._ring)
            self._ring.append([handle, True])

    def touch(self, handles):
        for handle in handles:
            idx = self._by_handle.get(id(handle))
            if idx is not None:
                self._ring[idx][1] = True

    def pin(self, handles):
        """Exempt these handles from demotion (idempotent). The pin
        holds a strong ref so a pinned doc's handle id cannot be
        recycled out from under the exemption; stale (frozen/parked)
        pins drop at the next prune."""
        for handle in handles:
            self._pinned[id(handle)] = handle

    def unpin(self, handles):
        for handle in handles:
            self._pinned.pop(id(handle), None)

    def pinned_count(self):
        return len(self._pinned)

    def pressure(self):
        budget = self.budget_bytes * self.pressure_factor
        if budget <= 0:
            return 0.0
        return self.source() / budget

    def _prune(self):
        """Drop parked/frozen/dead entries, reindex, and KEEP the hand
        pointing at the same logical position (so a mid-tick prune never
        rewinds it over entries it already gave their second chance)."""
        from .backend import FleetDoc
        fresh = []
        new_hand = 0
        for idx, (handle, ref) in enumerate(self._ring):
            state = handle.get('state')
            if handle.get('frozen') or not isinstance(state, FleetDoc) \
                    or not state.is_fleet:
                continue
            if idx < self._hand:
                new_hand += 1
            fresh.append([handle, ref])
        self._ring = fresh
        self._by_handle = {id(h): i for i, (h, _r) in enumerate(fresh)}
        self._hand = new_hand % len(fresh) if fresh else 0
        if self._pinned:
            # pins on handles the seam has since frozen (each apply
            # freezes the old handle dict) are stale: drop them so the
            # pin set stays bounded by the live pinned population
            self._pinned = {
                hid: h for hid, h in self._pinned.items()
                if not h.get('frozen') and
                isinstance(h.get('state'), FleetDoc) and
                h.get('state').is_fleet}

    def _sweep(self, budget):
        """Advance the hand up to `budget` steps collecting at most
        `batch` cold candidates, clearing ref bits as it moves (second
        chance). Returns (candidates, steps consumed)."""
        out = []
        n = len(self._ring)
        steps = 0
        while steps < budget and len(out) < self.batch:
            entry = self._ring[self._hand]
            self._hand = (self._hand + 1) % n
            steps += 1
            if entry[1]:
                entry[1] = False
            elif not entry[0].get('frozen') and \
                    id(entry[0]) not in self._pinned:
                out.append(entry[0])
        return out, steps

    def tick(self, stage=0):
        """Demote while over budget, at most ONE full clock revolution
        per tick — a doc touched since the hand last passed always
        survives the tick (the second chance is per-revolution, and a
        tick never laps itself). Returns the parked doc ids."""
        parked = []
        self.last_parked = []
        if not self._ring:
            return parked
        # prune EVERY tick, not just over budget: the seam freezes the
        # old handle dict on each apply, so an under-budget service
        # would otherwise grow the ring by one stale entry per write
        # round forever
        self._prune()
        if not self._ring or self.pressure() <= 1.0:
            return parked
        budget = len(self._ring)
        while self._ring and budget > 0 and self.pressure() > 1.0:
            batch, steps = self._sweep(budget)
            budget -= steps
            if not batch:
                break
            pairs = [(h, i) for h, i in zip(batch, self.engine.park(batch))
                     if i is not None]
            self._prune()
            if not pairs:
                break               # nothing parkable left this tick
            self.last_parked.extend(pairs)
            parked.extend(i for _h, i in pairs)
        if parked:
            _stats.inc('tiering_demoted_docs', len(parked))
            _flight.record_event('tiering', action='demote',
                                 docs=len(parked), stage=stage)
        return parked


class TieringController:
    """One tick for the whole tiering plane (see module docstring).

    Attach to a service (``DocService(..., tiering=...)``) and the pump
    calls ``tick(stage=brownout.stage)`` once per service tick; or drive
    it from any loop. Attaching a controller REPLACES the engine's
    ``dead_fraction`` threshold with the cost model (the model also
    covers discard-churn vacuums between ticks)."""

    def __init__(self, engine=None, demote=None, model=None, durable=None):
        self.model = model if model is not None else CostModel()
        self.engine = engine
        self.demote = demote
        self.durable = durable
        if engine is not None:
            engine.cost_model = self.model
            engine.vacuum_dead_fraction = None
        if durable is not None:
            # chain-escalation verdicts route through the same ledger
            durable.cost_model = self.model

    def tick(self, stage=0, durable=None):
        """Returns {'demoted': n, 'vacuumed': bool, 'compacted': bool}."""
        out = {'demoted': 0, 'vacuumed': False, 'compacted': False}
        if self.engine is not None:
            # discard-churn vacuums between ticks see this stage too
            self.engine.pressure_stage = stage
        if self.demote is not None:
            out['demoted'] = len(self.demote.tick(stage=stage))
        eng = self.engine
        if eng is not None and eng.main.n_rows >= eng.VACUUM_MIN_ROWS and \
                self.model.vacuum_due(eng.main, stage=stage):
            eng.vacuum_now()
            _stats.inc('tiering_vacuums')
            out['vacuumed'] = True
        dur = durable if durable is not None else self.durable
        if dur is not None:
            # compact() consults the model for chain escalation and the
            # stage for its pressure multiplier
            dur.cost_model = self.model
            dur.pressure_stage = stage
            if self.model.compact_due(dur, stage=stage) and \
                    dur.maybe_compact(force=True):
                _stats.inc('tiering_compactions')
                out['compacted'] = True
        return out
