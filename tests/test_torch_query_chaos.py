# The port's copy of tests/test_query_chaos.py, imports re-pointed at
# automerge_tpu_torch and the fleets on the CPU (device='cpu').
"""Seeded chaos universe for the query engine: a
population of documents under random edits, park/revive churn, and
poisoned-change quarantines, followed by subscribers presenting honest,
stale, replayed, bogus, and cross-document cursors.

THE AUDIT, held after every push: the patch sequence folded onto the
subscriber's shadow copy is byte-identical to the server document
materialized at the pushed heads — across the host backend and both
fleet device modes. Stale/bogus cursors are rejected or resynced typed;
a subscriber is NEVER sent a wrong patch (the fold either reproduces the
server state exactly or the event was a typed resync that does).
"""

import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import automerge_tpu_torch.backend as host_backend                     # noqa: E402
from automerge_tpu_torch.columnar import (                             # noqa: E402
    decode_change_meta, encode_change)
from automerge_tpu_torch.fleet import backend as fleet_backend         # noqa: E402
from automerge_tpu_torch.fleet.backend import DocFleet, init_docs      # noqa: E402
from automerge_tpu_torch.fleet.storage import StorageEngine            # noqa: E402
from automerge_tpu_torch.query import SubscriptionHub, materialize_at  # noqa: E402

N_SEEDS = int(os.environ.get('QUERY_CHAOS_SEEDS', '2'))
N_STEPS = int(os.environ.get('QUERY_CHAOS_STEPS', '25'))
N_DOCS = 4
SUBS_PER_DOC = 3


class _Shadow:
    """A subscriber's client-side replica: fold patches, rebuild on
    resync."""

    def __init__(self):
        self.doc = host_backend.init()

    def fold(self, event):
        if event['kind'] == 'resync':
            self.doc = host_backend.init()
        if event['changes']:
            self.doc, _ = host_backend.apply_changes(
                self.doc, [bytes(c) for c in event['changes']])
        assert host_backend.get_heads(self.doc) == \
            sorted(event['heads']), 'fold did not reach the pushed heads'

    def save(self):
        return bytes(host_backend.save(self.doc))


class _Universe:
    """One backend mode's server-side population."""

    def __init__(self, mode, rng):
        self.mode = mode
        self.rng = rng
        if mode == 'host':
            self.fleet = DocFleet(device='cpu')   # replay target for audits
            self.docs = [host_backend.init() for _ in range(N_DOCS)]
        else:
            self.fleet = DocFleet(exact_device=(mode == 'exact'),
                                  device='cpu')
            self.docs = init_docs(N_DOCS, self.fleet)
        self.engine = StorageEngine(self.fleet)
        self.parked = {}                     # doc index -> parked id
        self.seq = [0] * N_DOCS
        self.frontier_log = [[[]] for _ in range(N_DOCS)]
        self.quarantines = 0

    def source(self, d):
        if d in self.parked:
            return (self.engine, self.parked[d])
        return self.docs[d]

    def heads(self, d):
        if d in self.parked:
            return self.engine.heads(self.parked[d])
        return sorted(self.docs[d]['state'].heads)

    def _revive(self, d):
        if d in self.parked:
            self.docs[d] = self.engine.revive([self.parked.pop(d)])[0]

    def edit(self, d):
        self._revive(d)
        state = self.docs[d]['state']
        self.seq[d] += 1
        buf = encode_change({
            'actor': f'{d:02x}' * 16, 'seq': self.seq[d],
            'startOp': state.max_op + 1, 'time': 0, 'message': '',
            'deps': sorted(state.heads),
            'ops': [{'action': 'set', 'obj': '_root',
                     'key': f'k{self.rng.randrange(6)}',
                     'value': self.rng.randrange(1000),
                     'datatype': 'int', 'pred': []}]})
        if self.mode == 'host':
            self.docs[d], _ = host_backend.apply_changes(self.docs[d],
                                                         [buf])
        else:
            out, _ = fleet_backend.apply_changes_docs(
                [self.docs[d]], [[buf]], mirror=False)
            self.docs[d] = out[0]
        self.frontier_log[d].append(self.heads(d))

    def poison(self, d):
        """A corrupt change mid-subscription: quarantined typed, the doc
        (and every subscriber's view of it) untouched."""
        self._revive(d)
        mutant = bytearray(encode_change({
            'actor': 'dd' * 16, 'seq': 1, 'startOp': 999, 'time': 0,
            'message': '', 'deps': [],
            'ops': [{'action': 'set', 'obj': '_root', 'key': 'x',
                     'value': 1, 'datatype': 'int', 'pred': []}]}))
        mutant[self.rng.randrange(8, len(mutant))] ^= \
            1 << self.rng.randrange(8)
        mutant = bytes(mutant)
        before = self.heads(d)
        if self.mode == 'host':
            try:
                self.docs[d], _ = host_backend.apply_changes(
                    self.docs[d], [mutant])
            except ValueError:
                self.quarantines += 1
        else:
            out, _patches, errors = fleet_backend.apply_changes_docs(
                [self.docs[d]], [[mutant]], mirror=False,
                on_error='quarantine')
            self.docs[d] = out[0]
            if errors[0] is not None:
                self.quarantines += 1
        assert self.heads(d) == before, 'poison must not corrupt the doc'

    def park(self, d):
        if self.mode == 'host' or d in self.parked:
            return False
        ids = self.engine.park([self.docs[d]])
        if ids[0] is None:
            return False
        self.parked[d] = ids[0]
        return True


def _run_universe(mod, mode, seed, log=None, steps=N_STEPS):
    """One seed of the chaos universe on the package that test module
    `mod` imports (this one, or tests/test_query_chaos.py for the
    reference), audited after every push. Appends every tick's events to
    `log`; returns (resyncs, quarantines)."""
    rng = random.Random(1000 + seed)
    universe = mod._Universe(mode, rng)
    hub = mod.SubscriptionHub(**({'device': 'cpu'} if mod is _THIS else {}))
    shadows = {}
    for d in range(N_DOCS):
        hub.register(d, universe.source(d))
        for _ in range(SUBS_PER_DOC):
            sub = hub.subscribe(d)
            shadows[sub.id] = (mod._Shadow(), sub)

    def rebind():
        for d in range(N_DOCS):
            hub.update_source(d, universe.source(d))

    resyncs = 0
    for _step in range(steps):
        roll = rng.random()
        d = rng.randrange(N_DOCS)
        if roll < 0.45:
            universe.edit(d)
        elif roll < 0.55:
            universe.poison(d)
        elif roll < 0.65:
            universe.park(d)
        elif roll < 0.75:
            universe._revive(d)
        elif roll < 0.85 and shadows:
            # cursor tampering: bogus, cross-doc, or replayed-stale
            shadow, sub = rng.choice(list(shadows.values()))
            tamper = rng.random()
            if tamper < 0.4:
                hub.resubscribe(sub, [bytes(rng.randrange(256)
                                            for _ in range(32)).hex()])
            elif tamper < 0.7:
                other = (sub.key + 1) % N_DOCS
                frontiers = universe.frontier_log[other]
                hub.resubscribe(sub, rng.choice(frontiers))
            else:
                frontiers = universe.frontier_log[sub.key]
                hub.resubscribe(sub, rng.choice(frontiers))
        rebind()
        events = hub.tick()
        if log is not None:
            log.append(_plain_events(events))
        for sid, event in events.items():
            if event['kind'] == 'closed':
                continue
            if event['kind'] == 'resync':
                resyncs += 1
            shadow, sub = shadows[sid]
            shadow.fold(event)
            # THE AUDIT: the folded shadow is byte-identical to the
            # server doc materialized at the pushed heads
            at_heads = mod.materialize_at(universe.source(sub.key),
                                          event['heads'],
                                          fleet=universe.fleet)
            assert shadow.save() == bytes(at_heads['state'].save()), \
                f'seed {seed} step {_step} sub {sid}'
            mod.fleet_backend.free_docs([at_heads])
            if event['heads'] == universe.heads(sub.key):
                # ...and to the live server doc when fully caught up
                src = universe.source(sub.key)
                server = src[0].chunk(src[1]) if isinstance(src, tuple) \
                    else src['state'].save()
                assert shadow.save() == bytes(server)

    # drain: one final quiet round leaves every subscriber at the
    # server frontier with a byte-identical shadow
    rebind()
    for event_round in range(2):
        events = hub.tick()
        if log is not None:
            log.append(_plain_events(events))
        for sid, event in events.items():
            if event['kind'] != 'closed':
                shadows[sid][0].fold(event)
    for sid, (shadow, sub) in shadows.items():
        assert mod.host_backend.get_heads(shadow.doc) == \
            universe.heads(sub.key)
    if log is not None:
        log.append(dict(hub.stats))
        log.append([universe.heads(d) for d in range(N_DOCS)])
    return resyncs, universe.quarantines


def _plain_events(events):
    return {sid: {k: ([bytes(c) for c in v] if k == 'changes' else v)
                  for k, v in ev.items()} for sid, ev in events.items()}


_THIS = sys.modules[__name__]


@pytest.mark.parametrize('mode', ['host', 'lww', 'exact'])
def test_subscription_chaos_universe(mode):
    total_resyncs = 0
    total_quarantines = 0
    for seed in range(N_SEEDS):
        resyncs, quarantines = _run_universe(_THIS, mode, seed)
        total_resyncs += resyncs
        total_quarantines += quarantines
    # the hostile legs must actually have run: bogus/cross-doc cursors
    # hit the typed resync path, poisoned changes were quarantined
    assert total_resyncs >= 1
    assert total_quarantines >= 1


def _matches_reference(mode, seed, steps=N_STEPS):
    """The same seed through both packages: every tick's events (change
    bytes, heads, kinds), the hub's stats and the final heads are equal,
    and both pass their own audits on the way."""
    import tests.test_query_chaos as ref_mod
    ref_log, port_log = [], []
    ref_counts = _run_universe(ref_mod, mode, seed, ref_log, steps)
    port_counts = _run_universe(_THIS, mode, seed, port_log, steps)
    assert port_counts == ref_counts
    assert port_log == ref_log
    return port_counts


def test_chaos_matches_reference_host():
    resyncs, quarantines = _matches_reference('host', 1)
    assert resyncs >= 1 and quarantines >= 1


def test_chaos_matches_reference_lww():
    _matches_reference('lww', 1)


def test_chaos_matches_reference_exact():
    # fewer steps: each new batch shape costs the reference's exact
    # fleet a JAX compile
    _matches_reference('exact', 1, steps=10)
