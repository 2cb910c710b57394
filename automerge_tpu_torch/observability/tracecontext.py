"""Cross-peer trace stitching: one trace id from submit to sync reply.

A request that fans out through a fused batch and a sync exchange
leaves span fragments in several rings — the submitting service's tick
spans, the fused dispatch that carried N requests at once, and the
REMOTE peer's generate/receive spans — with nothing tying them
together. This module is the thread:

- ``TraceContext`` is (trace_id, span_id): 16 hex chars each, minted
  from a per-process random prefix + a counter (two peers can never
  collide; minting is one string format, cheap enough for every
  ``DocService.submit``).
- ``use(ctx)`` / ``current()``: a thread-local ambient context.
  Instrumented seams (sync generate/receive) attach
  ``trace=<trace_id>`` to their span attrs when a context is ambient —
  the attr rides the ordinary span ring into the Chrome-trace export,
  where ``tools/obs_report.py --stitch`` groups spans from MULTIPLE
  peers' exports by shared trace id.
- ``wrap(payload, ctx)`` / ``unwrap(data)``: the wire envelope — one
  magic byte (0x54, 'T'; sync messages start 0x42, cursors 0x51, so
  the namespaces cannot collide) + 8-byte trace id + 8-byte span id,
  prepended to an otherwise-unchanged payload. Enveloping is OPT-IN
  per message (a peer that never wraps produces byte-identical wire
  traffic to a build without this module); ``unwrap`` passes
  non-enveloped bytes through untouched, so a receiver can always
  probe. The service wraps a sync reply iff the request arrived
  wrapped — a tracing client opts its own requests in, and plain
  clients never see an envelope.

Batch attribution: the fused service batches record their member
requests' trace ids as a ``links`` span attr (one dispatch span →
N request traces), the span-link idiom of the OpenTelemetry data
model without the dependency.
"""

import contextlib
import itertools
import os
import threading

__all__ = ['TraceContext', 'TRACE_MAGIC', 'mint', 'current', 'use',
           'wrap', 'unwrap', 'trace_attr']

TRACE_MAGIC = 0x54           # 'T': a trace-envelope frame
_ENVELOPE_LEN = 1 + 8 + 8    # magic + trace id + span id

# per-process uniqueness: 4 random bytes + a counter; two peers minting
# concurrently diverge in the prefix, one peer's mints in the counter
_prefix = os.urandom(4).hex()
_counter = itertools.count(1)
_local = threading.local()


class TraceContext:
    """One request's identity across peers: ``trace_id`` names the whole
    request tree, ``span_id`` the minting site (the parent of whatever
    the receiving side records)."""

    __slots__ = ('trace_id', 'span_id')

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self):
        """Same trace, fresh span id — what a peer continuing the trace
        stamps on its own side of the exchange."""
        return TraceContext(self.trace_id,
                            f'{_prefix}{next(_counter):08x}')

    def __eq__(self, other):
        return isinstance(other, TraceContext) and \
            self.trace_id == other.trace_id and \
            self.span_id == other.span_id

    def __repr__(self):
        return f'TraceContext({self.trace_id}, span={self.span_id})'


def mint():
    """A fresh context (new trace id). One string format + counter —
    the root span id IS the trace id (the minting site is the tree's
    root), so the format is not paid twice."""
    sid = f'{_prefix}{next(_counter):08x}'
    return TraceContext(sid, sid)


def current():
    """The ambient context set by ``use`` (None outside any block)."""
    return getattr(_local, 'ctx', None)


@contextlib.contextmanager
def use(ctx):
    """Make ``ctx`` ambient for the block: instrumented seams inside it
    attach the trace id to their spans, and a None ctx is allowed (the
    block then just restores whatever was ambient before)."""
    prev = getattr(_local, 'ctx', None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def trace_attr(ctx=None):
    """{'trace': id} for the given (or ambient) context, {} when there
    is none — the kwargs splat for span attrs at instrumented seams."""
    if ctx is None:
        ctx = getattr(_local, 'ctx', None)
    return {} if ctx is None else {'trace': ctx.trace_id}


def wrap(payload, ctx):
    """Prepend the trace envelope to a wire payload. A None ctx returns
    the payload untouched (callers can wrap unconditionally). The ids
    must be 16 hex chars (what mint/child/unwrap produce) — a
    hand-built context with short ids would emit an envelope whose
    fixed-offset unwrap on the peer silently eats payload bytes, so
    the length is enforced at this encode boundary."""
    if ctx is None:
        return payload
    trace_id = bytes.fromhex(ctx.trace_id)
    span_id = bytes.fromhex(ctx.span_id)
    if len(trace_id) != 8 or len(span_id) != 8:
        raise ValueError('trace/span ids must be 16 hex chars, got '
                         f'{ctx.trace_id!r}/{ctx.span_id!r}')
    return bytes([TRACE_MAGIC]) + trace_id + span_id + bytes(payload)


def unwrap(data):
    """(ctx, payload): strip the envelope when present, else
    (None, data) untouched. Never raises on short/foreign bytes — the
    envelope namespace is disjoint from every other frame magic, so a
    leading 0x54 with enough bytes IS an envelope."""
    if data is None or len(data) < _ENVELOPE_LEN or data[0] != TRACE_MAGIC:
        return None, data
    body = bytes(data[1:_ENVELOPE_LEN])
    return (TraceContext(body[:8].hex(), body[8:].hex()),
            bytes(data[_ENVELOPE_LEN:]))
