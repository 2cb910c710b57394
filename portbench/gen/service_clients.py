"""The service's clients and their tenants, from a seed.

Adapted from automerge_tpu_torch/service_cases.py:63-78 (`ZipfSampler`),
:137-226 (`_EditSession`, `_SyncSession`), the port's copy of
tools/loadgen.py's service legs. Differences: an edit client's change
sets one of the configuration's keys to an int in [1, 2**20) and is
encoded by the benchmark's frozen codec, and the client keeps the
logical op the reference replays; the sync client, a replica that edits
locally and reconciles through the sync protocol, runs the port's host
backend as its Automerge library.
"""

import bisect

from ..wire.columnar import decode_change, encode_change
from ..wire.sync_wire import decode_sync_message

VALUE_LIMIT = 1 << 20


class ZipfSampler:
    """Zipf(s) over n tenants: weight(k) ~ 1/k^s, sampled via one
    bisect on the cumulative table."""

    def __init__(self, n, s=1.2):
        weights = [1.0 / (k + 1) ** s for k in range(n)]
        total = sum(weights)
        self.cum = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self.cum.append(acc)

    def draw(self, rng):
        return min(bisect.bisect_left(self.cum, rng.random()),
                   len(self.cum) - 1)


class EditClient:
    """An apply-only client: seq-consecutive one-set changes from one
    actor. `inflight`: (ticket, op); `committed`: the ops whose tickets
    resolved ok, as (counter, 0, key, value)."""

    __slots__ = ('session', 'actor', 'seq', 'n_keys', 'committed',
                 'inflight')

    def __init__(self, session, actor, n_keys):
        self.session = session
        self.actor = actor
        self.seq = 0
        self.n_keys = n_keys
        self.committed = []
        self.inflight = []

    def next_payload(self, rng):
        self.seq += 1
        key = f'k{rng.randrange(self.n_keys)}'
        value = rng.randrange(1, VALUE_LIMIT)
        buf = encode_change({
            'actor': self.actor, 'seq': self.seq, 'startOp': self.seq,
            'time': 0, 'message': '', 'deps': [],
            'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                     'value': value, 'datatype': 'int', 'pred': []}]})
        return [buf], (self.seq, 0, key, value)


class SyncClient:
    """A sync client: a host-backend replica editing locally and
    reconciling with its service doc through the sync protocol."""

    __slots__ = ('session', 'actor', 'doc', 'state', 'seq', '_prev_state',
                 'host', 'committed')

    def __init__(self, session, actor):
        from automerge_tpu_torch import backend as host
        self.host = host
        self.session = session
        self.actor = actor
        self.doc = host.init()
        self.state = host.init_sync_state()
        self.seq = 0
        self._prev_state = None
        self.committed = []        # ops of the changes acked messages bore

    def edit(self, rng):
        """One local change on the replica (seq-consecutive, one op,
        deps = the replica's heads)."""
        self.seq += 1
        change = encode_change({
            'actor': self.actor, 'seq': self.seq, 'startOp': self.seq,
            'time': 0, 'message': '', 'deps': self.host.get_heads(self.doc),
            'ops': [{'action': 'set', 'obj': '_root',
                     'key': f's{rng.randrange(4)}',
                     'value': rng.randrange(10_000), 'datatype': 'int',
                     'pred': []}]})
        self.doc, _ = self.host.apply_changes(self.doc, [change])

    def generate(self):
        self._prev_state = self.state
        self.state, message = self.host.generate_sync_message(
            self.doc, self.state)
        return message

    def rollback(self):
        """The message never left the client (refused at admission)."""
        if self._prev_state is not None:
            self.state = self._prev_state

    def acked(self, message):
        """The service took `message`: keep the ops of the changes it
        carried, as (counter, 0, key, value), decoded by the frozen
        codec."""
        if message is None:
            return
        for buf in decode_sync_message(message)['changes']:
            change = decode_change(buf)
            for i, op in enumerate(change['ops']):
                self.committed.append((change['startOp'] + i, 0, op['key'],
                                       op['value']))

    def receive(self, reply):
        if reply is None:
            return
        self.doc, self.state, _ = self.host.receive_sync_message(
            self.doc, self.state, bytes(reply))
