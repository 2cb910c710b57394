"""The query engine: time-travel reads and incremental patch subscriptions.

The change journal + hash graph make every historical version of every
document addressable, and the delta+main storage engine answers causal
questions straight off compressed chunks — this package SERVES that
history (the ROADMAP's scenario-diversity step):

- **Time-travel reads** (timetravel.py): ``materialize_at(source,
  heads)`` reconstructs a document at any historical heads frontier —
  ancestor-closure selection over the hash graph / extractor change-meta
  lanes (no op columns inflated to decide WHAT to replay), then one
  batched replay through the ordinary fused apply seam.
  ``materialize_at_docs`` runs N audit reads as ONE fused dispatch.
  Works against live fleet docs AND parked ``MainStore`` rows without
  reviving them.
- **Patch subscriptions** (subscriptions.py): ``SubscriptionHub`` tracks
  per-subscriber cursor heads and pushes, per tick, only the changes
  past each cursor — one diff per (doc, cursor-frontier) equivalence
  class, zero device dispatches per tick. Cursors cross the wire via
  ``encode_cursor``/``decode_cursor`` (hostile bytes fail typed
  ``InvalidCursor``); cursors naming unknown history resync typed
  (``UnknownHeads``) — never a wrong patch.
- **History selection** (history.py): the shared ancestor-closure /
  frontier machinery over live hash graphs and parked chunks.

Both families ride ``service.DocService`` as the 'materialize_at' and
'subscribe' request kinds (admission, deadlines, brownout; subscription
pushes are the first work shed under pressure). Observability:
``materialize_at_s`` / ``subscription_diff_s`` histograms, spans
(``materialize_at``, ``subscription_tick``), the health counters below,
and forensic flight-recorder dumps on invalid cursors / unknown heads.
BASELINE.md "Query contract" states the full semantics.
"""

from ..observability.metrics import Counters, register_health_source

_stats = Counters({
    'timetravel_reads': 0,         # materialized historical reads
    'subscription_pushes': 0,      # patch/resync events pushed
    'subscription_resyncs': 0,     # invalid-cursor full resyncs
    'subscription_diff_reuse': 0,  # diffs served from an equivalence class
    'unknown_heads': 0,            # typed UnknownHeads rejections
    'invalid_cursors': 0,          # typed InvalidCursor rejections
})
for _key in _stats:
    register_health_source(_key, lambda k=_key: _stats[k])


def query_stats():
    return dict(_stats)


from .history import (ChunkHistory, frontier_of, history_of,  # noqa: E402
                      select_ancestors, select_descendants)
from .subscriptions import (Subscription, SubscriptionHub,  # noqa: E402
                            decode_cursor, diff_since, encode_cursor)
from .timetravel import materialize_at, materialize_at_docs  # noqa: E402

__all__ = [
    'materialize_at', 'materialize_at_docs',
    'SubscriptionHub', 'Subscription',
    'encode_cursor', 'decode_cursor', 'diff_since',
    'ChunkHistory', 'history_of', 'select_ancestors',
    'select_descendants', 'frontier_of',
    'query_stats',
]
