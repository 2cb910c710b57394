"""Shard-per-core scale-out: consistent-hash routing, replica sync,
kill-driven failover (the ROADMAP's horizontal-scale frontier).

``HashRing`` (ring.py) owns placement; ``Shard`` / ``ShardRouter``
(cluster.py) own serving, inter-shard replication over the existing
sync wire protocol, lease-based failure detection, replica promotion,
and chunk-transfer rebalance. ``tools/loadgen.py``'s ``run_shard_leg``
is the kill-and-recover chaos harness; bench.py's ``shards`` section
reports aggregate req/s scaling and failover MTTR.
"""

from .cluster import RouterTicket, Shard, ShardRouter, shard_stats
from .ring import HashRing

__all__ = ['HashRing', 'Shard', 'ShardRouter', 'RouterTicket',
           'shard_stats']
