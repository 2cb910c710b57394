"""The hub's reply to a peer that reconnects with a fresh sync state, as
Automerge's sync protocol (sync.js receiveSyncMessage, then
generateSyncMessage) answers it when the hub holds every change the
peer names:

- heads: the hub's heads; need: none (the peer's heads are known);
- have: one entry whose lastSync is the peer's heads (they become the
  shared heads) and whose Bloom filter holds the hub's changes since
  them;
- changes: of the changes since the peer's lastSync, those the peer's
  filter does not hold, and every change that depends on one of them,
  in the hub's order.

The filter and the message bytes use the benchmark's frozen codec."""

from ..wire.sync_wire import BloomFilter, encode_sync_message


def _since(hashes, deps, heads):
    """Indexes of the changes that are not ancestors of `heads` (all of
    them for no heads)."""
    index = {h: i for i, h in enumerate(hashes)}
    seen, stack = set(), [index[h] for h in heads]
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        stack.extend(index[d] for d in deps[i])
    return [i for i in range(len(hashes)) if i not in seen]


def reply(hashes, deps, changes, hub_heads, peer_heads, peer_last_sync,
          peer_bloom, use_filter=True):
    """The reply's bytes. `hashes`, `deps`, `changes`: the hub doc's
    changes in its order. `use_filter=False` ignores the peer's filter
    (the control: a full resend of the changes since lastSync)."""
    since_shared = _since(hashes, deps, peer_heads)
    our_bloom = BloomFilter([hashes[i] for i in since_shared]).bytes
    candidates = _since(hashes, deps, peer_last_sync)
    theirs = BloomFilter(peer_bloom)
    send = {i for i in candidates
            if not use_filter or not theirs.contains_hash(hashes[i])}
    grew = True
    while grew:
        grew = False
        for i in candidates:
            if i not in send and any(
                    d in {hashes[j] for j in send} for d in deps[i]):
                send.add(i)
                grew = True
    return encode_sync_message({
        'heads': sorted(hub_heads), 'need': [],
        'have': [{'lastSync': sorted(peer_heads), 'bloom': our_bloom}],
        'changes': [changes[i] for i in candidates if i in send]})
