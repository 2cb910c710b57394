"""Consistent-hash ring: stable tenant -> shard placement.

The router's placement problem is the classic one: N shards come and go
(kills, revives, scale-out) and tenant -> shard assignment must move as
LITTLE as possible when membership changes — a modulo hash reshuffles
almost every tenant on every membership event, which would turn one
shard failure into a fleet-wide cold-cache migration storm. The ring
fixes the placement of every shard's virtual nodes on a 64-bit circle
(SHA-256 of ``"{shard}#{vnode}"``) and homes a tenant on the first
vnode clockwise of its own hash, so removing one shard only re-homes
the tenants that shard owned, and re-adding it restores exactly the old
placement (kill -> revive -> rebalance round-trips to the original
topology).

Membership is SPLIT from liveness on purpose: the ring always contains
every configured shard (stable hashing), and lookups take an ``alive``
filter — a dead shard's tenants resolve to the next live shard on the
ring (which is exactly where the router placed their replicas), without
mutating the ring itself.
"""

import bisect
import hashlib

__all__ = ['HashRing']


def _point(key):
    """A stable 64-bit position on the circle."""
    return int.from_bytes(
        hashlib.sha256(key.encode('utf-8')).digest()[:8], 'big')


class HashRing:
    """Consistent-hash ring over shard ids (see the module docstring).

    ``vnodes`` virtual nodes per shard smooth the partition sizes — at
    the default 64, per-shard tenant share is within a few tens of
    percent of uniform for realistic shard counts, and placement stays
    deterministic across processes (pure SHA-256, no process seed)."""

    def __init__(self, shard_ids=(), vnodes=64):
        self.vnodes = int(vnodes)
        self._points = []            # sorted (position, shard_id)
        self._ids = []               # insertion order, for stable iteration
        for shard_id in shard_ids:
            self.add(shard_id)

    def __contains__(self, shard_id):
        return shard_id in self._ids

    def __len__(self):
        return len(self._ids)

    def shard_ids(self):
        return list(self._ids)

    def add(self, shard_id):
        if shard_id in self._ids:
            return
        self._ids.append(shard_id)
        for v in range(self.vnodes):
            self._points.append((_point(f'{shard_id}#{v}'), shard_id))
        self._points.sort()

    def remove(self, shard_id):
        """Drop a shard from the ring entirely (decommission — NOT the
        liveness path; a dead-but-configured shard stays on the ring and
        is skipped via the ``alive`` filter, so its revival restores the
        original placement)."""
        if shard_id not in self._ids:
            return
        self._ids.remove(shard_id)
        self._points = [(p, s) for p, s in self._points if s != shard_id]

    def preference(self, key, n=None, alive=None):
        """The first ``n`` DISTINCT shards clockwise of ``key``'s hash,
        optionally filtered to ``alive`` (a container or predicate).
        This is the tenant's preference list: element 0 is its home,
        element 1 its replica, and a failover simply advances down the
        list."""
        if not self._points:
            return []
        if alive is None:
            ok = lambda s: True                              # noqa: E731
        elif callable(alive):
            ok = alive
        else:
            ok = alive.__contains__
        want = len(self._ids) if n is None else int(n)
        out = []
        start = bisect.bisect_right(self._points, (_point(key), ''))
        for i in range(len(self._points)):
            shard_id = self._points[(start + i) % len(self._points)][1]
            if shard_id in out or not ok(shard_id):
                continue
            out.append(shard_id)
            if len(out) >= want:
                break
        return out

    def primary(self, key, alive=None):
        """The key's home shard (None when no shard qualifies)."""
        got = self.preference(key, n=1, alive=alive)
        return got[0] if got else None

    def replica(self, key, alive=None):
        """The next distinct shard after the key's home — the replica
        placement (None with fewer than two qualifying shards)."""
        got = self.preference(key, n=2, alive=alive)
        return got[1] if len(got) > 1 else None
