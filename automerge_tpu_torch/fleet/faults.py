"""Seeded fault-injection wire for the sync protocol.

The sync drivers treat the transport as a reliable in-order byte pipe —
which the all_to_all collective is, but the "millions of users" north star
(ROADMAP.md) is served over networks that drop, duplicate, reorder,
truncate, and bit-flip. `LossyLink` is the adversarial wire: a seeded
per-message fault injector that wraps any generate/receive message flow and
applies exactly one fault class per message draw, so chaos tests can prove
two containment properties of the Bloom-based protocol
(backend/sync.py):

- LOSS IS SURVIVABLE: a peer that misses a message keeps generating
  (its view of the remote heads stays stale, so `generate_sync_message`
  never goes quiet while heads genuinely differ), and the handshake
  self-heals once the wire delivers again — convergence needs no
  retransmit layer.
- CORRUPTION IS CONTAINED, NEVER PROPAGATED: a truncated/flipped message
  either fails `decode_sync_message` (typed `MalformedSyncMessage`) or
  carries a change whose checksum fails at apply (typed
  `MalformedChange`) — both are equivalent to a drop at the receiver;
  garbage that decodes (flipped hash bytes, corrupt Bloom filters) only
  ever costs extra sends (the lenient filter probe) and repairs through
  the protocol's own need/dependents machinery. No fault class can make
  a healthy replica commit corrupt state, because every change re-hashes
  before it lands.

Faults draw from a dedicated PRNG so a seed fully determines the fault
trace, and an optional `budget` bounds the total faults injected — the
transient-fault network model under which convergence is guaranteed, and
what lets chaos tests assert a hard post-quiet equality instead of a
probabilistic one. Injected-fault totals land in the 'wire_faults' health
counter (observability.health_counts)."""

import random

from ..errors import AutomergeError, SyncStalled
from ..observability import register_health_source
# the light policy module only — service/__init__ loads its core lazily,
# so this import cannot cycle back into fleet/
from ..service.backoff import Backoff

__all__ = ['LossyLink', 'sync_until_quiet']

_FAULT_KINDS = ('dropped', 'duplicated', 'reordered', 'truncated', 'flipped')

_fault_totals = {'injected': 0, 'stall_resets': 0}
register_health_source('wire_faults', lambda: _fault_totals['injected'])
register_health_source('sync_stall_resets',
                       lambda: _fault_totals['stall_resets'])


class LossyLink:
    """One direction of a lossy wire. `transmit(payload)` returns the list
    of payloads the receiver actually sees for this send (possibly empty,
    possibly two, possibly corrupted); `flush()` releases any message still
    held back by an in-flight reorder. Stats count per fault class plus
    sent/delivered totals.

    Beyond the five PER-MESSAGE fault kinds, the link models two
    STATEFUL faults — a peer going dark for K ticks and then healing —
    because a dead peer is a different failure class from per-message
    loss: every message in the window vanishes (no lucky deliveries for
    a retry to ride), and chaos tests of failover need exactly that
    shape. ``tick()`` is the link's clock (drivers call it once per
    sync round); ``partition(k)`` darkens the wire for k ticks (the
    peer is fine, the network is not); ``crash(k)`` darkens it AND
    drops any reorder-held in-flight message (the peer process died —
    everything in its buffers died with it; the caller models the rest
    of a crash by resetting the peer's sync state). ``p_partition``
    draws partitions randomly at transmit time, each lasting
    ``partition_ticks``. One dark WINDOW counts as one injected fault
    (one budget token) in its own stats bucket; the messages it
    swallows are consequences, tallied under ``dark_dropped``."""

    def __init__(self, seed=0, p_drop=0.0, p_dup=0.0, p_reorder=0.0,
                 p_truncate=0.0, p_flip=0.0, budget=None,
                 p_partition=0.0, partition_ticks=8):
        self.rng = random.Random(seed)
        self.p = {'dropped': p_drop, 'duplicated': p_dup,
                  'reordered': p_reorder, 'truncated': p_truncate,
                  'flipped': p_flip}
        self.budget = budget          # None = unbounded fault injection
        self.p_partition = float(p_partition)
        self.partition_ticks = int(partition_ticks)
        self.stats = dict.fromkeys(
            _FAULT_KINDS + ('partitioned', 'crashed', 'dark_dropped',
                            'sent', 'delivered'), 0)
        self._held = None             # message delayed by a reorder fault
        self._ticks = 0               # the link clock (tick())
        self._dark_until = 0          # ticks < this = peer dark

    # -- stateful faults ------------------------------------------------

    @property
    def dark(self):
        """True while a partition/crash window is open."""
        return self._ticks < self._dark_until

    def tick(self):
        """Advance the link clock one round; dark windows heal when the
        clock reaches their end."""
        self._ticks += 1

    def _spend_budget(self):
        if self.budget is not None:
            if self.budget <= 0:
                return False
            self.budget -= 1
        return True

    def _darken(self, ticks, kind):
        if not self._spend_budget():
            return False
        self._dark_until = max(self._dark_until, self._ticks + int(ticks))
        self.stats[kind] += 1
        _fault_totals['injected'] += 1
        return True

    def partition(self, ticks=None):
        """Open (or extend) a partition: the wire is dark for `ticks`
        link ticks, then heals. Returns False when the fault budget is
        dry (no window opened)."""
        return self._darken(ticks if ticks is not None
                            else self.partition_ticks, 'partitioned')

    def crash(self, ticks=None):
        """The peer process dies for `ticks` link ticks: dark wire AND
        any reorder-held in-flight message is lost with the process.
        The caller completes the crash model by resetting the peer's
        sync state when it 'restarts'."""
        ok = self._darken(ticks if ticks is not None
                          else self.partition_ticks, 'crashed')
        if ok:
            self._held = None
        return ok

    def _draw_fault(self):
        """Pick at most one fault class for this message. The PRNG draw
        happens even with an exhausted budget, so the same seed walks the
        same random sequence whatever the budget — traces stay comparable
        across budget settings."""
        roll = self.rng.random()
        acc = 0.0
        for kind in _FAULT_KINDS:
            acc += self.p[kind]
            if roll < acc:
                if not self._spend_budget():
                    return None
                self.stats[kind] += 1
                _fault_totals['injected'] += 1
                return kind
        return None

    def _corrupt(self, payload, kind):
        if kind == 'truncated':
            return payload[:self.rng.randrange(len(payload))] \
                if payload else payload
        # flipped: xor one random bit
        if not payload:
            return payload
        pos = self.rng.randrange(len(payload))
        out = bytearray(payload)
        out[pos] ^= 1 << self.rng.randrange(8)
        return bytes(out)

    def transmit(self, payload):
        """Send one message (None = nothing to send this tick). Returns
        the payloads delivered to the receiver, in arrival order."""
        deliveries = []
        if payload is not None and self.p_partition > 0.0 and \
                not self.dark and self.rng.random() < self.p_partition:
            # a randomly-drawn dark window (the PRNG draw happens only
            # on real sends, so seeded traces stay send-aligned)
            self.partition()
        if payload is not None and self.dark:
            # the peer is dark: the whole send vanishes — no dup, no
            # corruption, no reorder hold, just silence
            self.stats['sent'] += 1
            self.stats['dark_dropped'] += 1
            return []
        if payload is not None:
            payload = bytes(payload)
            self.stats['sent'] += 1
            kind = self._draw_fault()
            if kind == 'dropped':
                payload = None
            elif kind == 'duplicated':
                deliveries.append(payload)
            elif kind in ('truncated', 'flipped'):
                payload = self._corrupt(payload, kind)
            elif kind == 'reordered':
                # hold this message one tick; it arrives AFTER the next
                # send (a delayed packet overtaken by its successor)
                if self._held is None:
                    self._held = payload
                    payload = None
                # a second reorder while one is held releases both swapped
        if payload is not None:
            deliveries.append(payload)
        if self._held is not None and deliveries:
            deliveries.append(self._held)
            self._held = None
        self.stats['delivered'] += len(deliveries)
        return deliveries

    def flush(self):
        """Deliver any message still held by an in-flight reorder (the
        wire draining at end of test)."""
        if self._held is None:
            return []
        out = [self._held]
        self._held = None
        self.stats['delivered'] += 1
        return out


def _deliver(receiver, payloads, quarantined):
    """Feed delivered payloads to a receive callback, treating typed
    failures as drops (containment: the doc-scoped error already rolled
    back whatever the bad bytes touched). Returns True if any payload
    was processed (delivered or quarantined)."""
    progressed = False
    for payload in payloads:
        progressed = True
        try:
            receiver(payload)
        except AutomergeError:
            quarantined[0] += 1
    return progressed


def sync_until_quiet(doc_a, doc_b, backend_a, backend_b, link_ab=None,
                     link_ba=None, max_rounds=256, stall_reset=8,
                     backoff=None):
    """Drive the two-peer sync handshake (the sync_test.js loop) over lossy
    links until both directions go quiet, corruption quarantining as drops.
    `backend_*` follow the Backend contract (generate_sync_message /
    receive_sync_message / init_sync_state).

    Stall recovery: the reference protocol assumes a reliable in-order
    channel — a DROPPED message poisons `sentHashes` (the sender filters
    out changes it believes delivered and never resends them), which
    livelocks the handshake: both sides keep generating forever while
    heads stay split. Real deployments recover by reconnecting with fresh
    sync state, which is safe because change delivery is idempotent; this
    driver models exactly that: `stall_reset` consecutive rounds with
    traffic but no head movement on either side trigger a sync-state
    reset (only `sharedHeads` survives a real reconnect via
    encode_sync_state, and even that is an optimization — the reset here
    drops everything, the worst case). Convergence under loss therefore
    means: protocol + reconnect policy, which is the deployable unit.

    Reconnects follow a bounded JITTERED BACKOFF (`backoff`, a
    service.backoff.Backoff in ROUND units — the same schedule object the
    service retry path uses): reset k+1 requires `stall_reset` plus the
    schedule's (growing, jittered) delay in stalled rounds, so a fleet of
    drivers sharing a flapping wire cannot re-handshake in lockstep.
    Once the schedule is exhausted — or `max_rounds` elapse — the driver
    gives up with a TYPED ``SyncStalled`` (carrying `rounds`, `resets`,
    and the link stats in `detail`): with a fault budget that means a
    real protocol bug, not bad luck.

    Returns (doc_a, doc_b, rounds, stats) with stats carrying
    'quarantined' (corrupt messages contained at the receiver) and
    'resets' (stall recoveries)."""
    if backoff is None:
        # round units: first re-reset after ~stall_reset extra rounds,
        # growing 2x (capped at 8x) — generous retries so bounded-budget
        # fault traces always converge before the typed give-up
        backoff = Backoff(base=stall_reset, factor=2.0,
                          cap=8.0 * stall_reset, retries=16, jitter=0.5,
                          seed=0)
    quarantined = [0]
    resets = 0
    stalled = 0
    reset_wait = stall_reset      # rounds of stall before the next reset
    last_heads = None
    box = {'a': doc_a, 'b': doc_b,
           'sa': backend_a.init_sync_state(),
           'sb': backend_b.init_sync_state()}

    def recv_b(payload):
        box['b'], box['sb'], _ = backend_b.receive_sync_message(
            box['b'], box['sb'], payload)

    def recv_a(payload):
        box['a'], box['sa'], _ = backend_a.receive_sync_message(
            box['a'], box['sa'], payload)

    for rounds in range(1, max_rounds + 1):
        # Duplex round: BOTH sides generate from their current state, then
        # both deliveries land. Generating before delivering matters after
        # a reset — with alternating turns, the second peer would see the
        # first's fresh handshake advertising equal heads and short-circuit
        # its own reply (`lastSentHeads = message.heads`), leaving the
        # first soliciting forever; simultaneous handshakes (what a real
        # reconnect does) cannot interleave that way.
        box['sa'], msg_ab = backend_a.generate_sync_message(box['a'],
                                                            box['sa'])
        box['sb'], msg_ba = backend_b.generate_sync_message(box['b'],
                                                            box['sb'])
        out_ab = link_ab.transmit(msg_ab) if link_ab is not None else \
            ([msg_ab] if msg_ab is not None else [])
        out_ba = link_ba.transmit(msg_ba) if link_ba is not None else \
            ([msg_ba] if msg_ba is not None else [])
        _deliver(recv_b, out_ab, quarantined)
        _deliver(recv_a, out_ba, quarantined)
        # the round IS the link clock: stateful dark windows
        # (partition/crash) heal after their K rounds
        if link_ab is not None:
            link_ab.tick()
        if link_ba is not None:
            link_ba.tick()

        if msg_ab is None and msg_ba is None:
            # quiet — but drain any reorder-held messages first: a held
            # message may reopen the handshake
            drained = False
            if link_ab is not None:
                drained |= _deliver(recv_b, link_ab.flush(), quarantined)
            if link_ba is not None:
                drained |= _deliver(recv_a, link_ba.flush(), quarantined)
            if not drained:
                return box['a'], box['b'], rounds, {
                    'quarantined': quarantined[0], 'resets': resets}
            continue

        heads = (tuple(backend_a.get_heads(box['a'])),
                 tuple(backend_b.get_heads(box['b'])))
        if heads == last_heads:
            stalled += 1
        else:
            stalled = 0
        last_heads = heads
        if stalled >= reset_wait:
            if backoff.exhausted(resets):
                raise SyncStalled(
                    f'sync stalled: no head progress through {resets} '
                    f'reconnects over {rounds} rounds', rounds=rounds,
                    resets=resets,
                    detail={'ab': link_ab.stats if link_ab else None,
                            'ba': link_ba.stats if link_ba else None})
            box['sa'] = backend_a.init_sync_state()
            box['sb'] = backend_b.init_sync_state()
            # next reset waits longer, jittered — no lockstep re-handshake
            reset_wait = max(1, round(stall_reset + backoff.delay(resets)))
            resets += 1
            _fault_totals['stall_resets'] += 1
            stalled = 0
    raise SyncStalled(
        f'sync not quiet after {max_rounds} rounds ({resets} reconnects)',
        rounds=max_rounds, resets=resets,
        detail={'ab': link_ab.stats if link_ab else None,
                'ba': link_ba.stats if link_ba else None})
