"""Typed failure taxonomy for the batched seam and the sync wire.

The reference backend reports every failure as a bare ``ValueError`` (or
lets decoder ``IndexError``/``KeyError`` escape), which is survivable when
one document fails one call — but the fleet engine applies N documents per
fused dispatch and a whole shard's sync round per collective, so callers
need to know three things a bare exception cannot tell them: WHICH
document's input was bad, WHAT CLASS of input it was (malformed bytes vs a
well-formed but causally-invalid change vs an oversized payload), and
whether the failure is CONTAINED (the other N-1 documents committed) or
batch-fatal. This module is that contract:

- Wire-corruption errors (``MalformedChange``, ``MalformedDocument``,
  ``MalformedSyncMessage``) mean the bytes themselves cannot be decoded —
  checksum mismatch, truncation, garbage columns. Decoder entry points
  convert whatever the parser tripped over (IndexError, struct noise,
  UnicodeDecodeError, zlib errors) into these, so "only typed errors
  escape a decoder" is an invariant the wire fuzzer
  (tools/fuzz_wire.py) can enforce.
- Validity errors (``InvalidChange``, ``DanglingPred``,
  ``DuplicateOpId``) mean the bytes decoded fine but the change violates
  the causal/structural rules the apply gate checks.
- ``SyncOverflow`` means a sync payload exceeded the multihost wire's
  hard ceiling (exchange.py) — raised identically on every controller so
  no peer blocks inside a collective.
- Durability-layer corruption (``MalformedJournal``, ``TornTail``,
  ``MalformedSnapshot``) means bytes ON DISK — change-journal frames,
  fleet snapshots, the checkpoint manifest — failed their CRC framing
  (fleet/durability.py). They are ``WireCorruption`` too: disk is just a
  wire with a longer flight time, and recovery gives rotted disk bytes
  the same one-doc blast radius the sync wire gets.
- Load-shedding rejections (``Overloaded``, ``TenantThrottled``,
  ``DeadlineExceeded``, ``RetriesExhausted``, ``SyncStalled``,
  ``ShardUnavailable``) mean the
  INPUT was fine but the system declined the work: global or per-tenant
  admission control refused it, its deadline passed before the fused
  dispatch, or its retry/reconnect budget ran dry (service/ and
  fleet/faults.py). They join the taxonomy so shedding is never an
  untyped escape — a client can always distinguish "your bytes are bad"
  from "come back later" (``retry_after``) from "too late". A shed
  request is all-or-nothing: these errors are only ever raised BEFORE
  the request's batch commits, never after a partial apply.
- Query-engine rejections (``InvalidCursor``, ``UnknownHeads``) scope
  the time-travel/subscription surface (automerge_tpu/query/):
  ``InvalidCursor`` is wire corruption at the subscription-cursor
  decode boundary (hostile cursor bytes fail typed, like every other
  decoder); ``UnknownHeads`` means the cursor/frontier DECODED fine but
  names hashes outside the document's causal history — a stale, bogus,
  or cross-document cursor. A subscriber presenting one is resynced or
  rejected typed; it is never sent a wrong patch.

Every class subclasses ``ValueError`` (the reference's error type), so
existing ``except ValueError`` / ``pytest.raises(ValueError)`` call sites
keep working; new code catches ``AutomergeError`` (or a subclass) and
reads ``doc_index`` to scope the blast radius. ``DocError`` is the
structured per-document rejection record the quarantining batch APIs
(``apply_changes_docs(..., on_error='quarantine')``,
``receive_sync_messages_docs(..., on_error='quarantine')``) return for
rejected slots while the healthy documents commit in the same fused
dispatch.
"""

__all__ = [
    'AutomergeError', 'WireCorruption', 'MalformedChange',
    'MalformedDocument', 'MalformedSyncMessage', 'MalformedJournal',
    'TornTail', 'MalformedSnapshot', 'InvalidChange',
    'DanglingPred', 'DuplicateOpId', 'SyncOverflow', 'DocError',
    'Overloaded', 'TenantThrottled', 'DeadlineExceeded',
    'RetriesExhausted', 'SyncStalled', 'SessionClosed',
    'ShardUnavailable',
    'InvalidCursor', 'UnknownHeads',
    'as_wire_error',
]


class AutomergeError(Exception):
    """Base of every typed failure. `doc_index` scopes the error to one
    slot of a batched call (None = not doc-scoped / unknown).

    `budget` is the SLO error-budget class the failure burns (None =
    burns no availability budget): the shedding classes each carry
    their own so the telemetry plane (observability/slo.py) can hold
    TenantThrottled, Overloaded, and DeadlineExceeded against DIFFERENT
    objectives — a tenant flooding itself dry must not spend the budget
    that pages when the service starts shedding everyone."""

    budget = None

    def __init__(self, *args, doc_index=None, **attrs):
        super().__init__(*args)
        self.doc_index = doc_index
        for name, value in attrs.items():
            setattr(self, name, value)


class WireCorruption(AutomergeError, ValueError):
    """Bytes off the wire (or disk) that cannot be decoded at all."""


class MalformedChange(WireCorruption):
    """A binary change chunk that fails to decode: bad magic/checksum,
    truncated columns, out-of-range LEBs, invalid UTF-8."""


class MalformedDocument(WireCorruption):
    """A saved document chunk that fails to decode or whose recomputed
    heads do not reproduce the header."""


class MalformedSyncMessage(WireCorruption):
    """A sync-protocol message that fails to decode (wrong type byte,
    truncated hash runs, bad filter framing)."""


class MalformedJournal(WireCorruption):
    """A change-journal frame that fails its CRC framing: rotted header
    or payload bytes, garbage between frames (fleet/durability.py)."""


class TornTail(MalformedJournal):
    """A journal whose final frame runs past end-of-file or whose tail
    is garbage with no later valid frame — the signature of a crash
    mid-write. Recovery truncates at the first bad CRC frame."""


class MalformedSnapshot(WireCorruption):
    """A fleet snapshot or checkpoint manifest that fails to decode:
    bad magic, missing END terminator, rotted per-doc frames."""


class InvalidChange(AutomergeError, ValueError):
    """A change that decoded fine but violates the apply gate's rules
    (sequence reuse/skip, unresolvable structure)."""


class DanglingPred(InvalidChange):
    """A change whose pred names no existing operation — the reference
    rejects invalid op references during the merge (new.js:1219-1220)."""


class DuplicateOpId(InvalidChange):
    """Two operations in one document claim the same opId."""


class SyncOverflow(AutomergeError, ValueError):
    """A sync payload exceeded the multihost wire's hard ceiling. Carries
    `global_max` (largest payload anywhere this round), `max_msg` (the
    per-sub-round wire width), `max_chunks` (how many sub-rounds the wire
    will chunk across), and `pairs` (locally-observed offending
    (src, dst) shard pairs — each controller sees only its own)."""


class Overloaded(AutomergeError, ValueError):
    """The service's global admission ceiling (queued + in-flight work)
    is full, or a brownout stage shed this request class. Carries
    `retry_after` (seconds the client should wait, None = unknown) and,
    for brownout sheds, `shed=True` + `stage`."""

    budget = 'overloaded'


class TenantThrottled(Overloaded):
    """THIS tenant exhausted its token bucket or bounded queue — other
    tenants are unaffected (per-tenant isolation is the point). Carries
    `tenant` and `retry_after`."""

    budget = 'throttled'


class SessionClosed(Overloaded):
    """The request's session was closed before it could be served (the
    client disconnected, or kept a dead handle after a failover or
    migration moved its tenant). Burns the 'throttled' budget — the
    CLIENT's fault, not the service shedding. A dedicated type so the
    shard router can recognize 'this session moved out from under a
    queued request' structurally and retry on the new home, instead of
    matching message text."""

    budget = 'throttled'


class ShardUnavailable(Overloaded):
    """The tenant's home shard is dead or unreachable (crashed, lease
    expired, or not yet failed over) — the request never reached a
    serving shard. Carries `shard` (the unavailable shard id, when
    known), `tenant`, and `retry_after`: the router's failover machinery
    re-homes the tenant within the lease window, so a budgeted jittered
    retry normally lands on the replica. Burns the 'overloaded'
    availability budget — a dead shard is the SERVICE's fault, never
    the tenant's."""


class DeadlineExceeded(AutomergeError, ValueError):
    """The request's deadline passed before its batch's fused dispatch.
    All-or-nothing: raised only while the request is still entirely
    unapplied — a deadline NEVER fires after a partial commit. Carries
    `deadline` (the absolute clock value) and `late_by` (seconds)."""

    budget = 'deadline'


class RetriesExhausted(AutomergeError, ValueError):
    """A transient fault persisted past the bounded jittered-backoff
    schedule or the per-tenant retry budget — retrying further would
    amplify the outage. Carries `attempts` and (when tenant-scoped)
    `tenant`; `__cause__` is the last underlying typed failure."""


class SyncStalled(RetriesExhausted):
    """The two-peer sync handshake kept traffic flowing but made no head
    progress through the whole reconnect-with-backoff schedule
    (fleet/faults.py sync_until_quiet) — a protocol bug or a dead wire,
    not bad luck. Carries `rounds` and `resets`."""


class InvalidCursor(WireCorruption):
    """Subscription-cursor bytes that cannot be decoded: bad magic,
    truncated hash runs, count bombs, trailing garbage
    (automerge_tpu/query/subscriptions.py decode_cursor)."""


class UnknownHeads(AutomergeError, ValueError):
    """A time-travel frontier or subscription cursor that decoded fine
    but names change hashes outside the document's history (stale after
    a history the server never had, bogus, or aimed at the wrong doc).
    Carries `missing` (the unknown hex hashes). The query engine answers
    with a typed rejection or a full resync — never a wrong patch."""


class DocError:
    """Structured per-document rejection record from a quarantining batch
    call: `index` (slot in the batch), `stage` ('decode' | 'apply' |
    'sync'), `error` (the typed exception). Healthy docs in the same call
    carry None in the errors vector."""

    __slots__ = ('index', 'stage', 'error')

    def __init__(self, index, stage, error):
        self.index = index
        self.stage = stage
        self.error = error

    def __repr__(self):
        return (f'DocError(index={self.index}, stage={self.stage!r}, '
                f'error={type(self.error).__name__}: {self.error})')

    def describe(self, durable_id=None):
        """JSON-friendly record for forensic flight-recorder dumps: slot
        index, stage, typed error name, truncated message, and (when the
        caller knows it) the document's durable journal id."""
        return {'doc': self.index, 'stage': self.stage,
                'error': type(self.error).__name__,
                'message': str(self.error)[:200],
                'durable_id': durable_id}


def as_wire_error(exc, err_cls, what, doc_index=None):
    """Normalize an arbitrary decoder exception into the typed class:
    already-typed errors pass through (gaining a doc_index if they lack
    one), everything else wraps with the original as __cause__."""
    if isinstance(exc, AutomergeError):
        if doc_index is not None and exc.doc_index is None:
            exc.doc_index = doc_index
        return exc
    err = err_cls(f'{what}: {type(exc).__name__}: {exc}',
                  doc_index=doc_index)
    err.__cause__ = exc
    return err
