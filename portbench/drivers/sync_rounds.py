"""Reconnect rounds at a sync hub (BASELINE config 4, automerge-classic's
test/sync_test.js, at `peers_per_doc` peers a document). Every peer holds
the first `peer_changes` changes of its document's history. Every round
each link's hub-side sync state starts fresh and the peer's reconnect
message arrives: its heads and a Bloom filter of its changes. One
`receive_sync_messages_docs` and one `generate_sync_messages_docs` over
every link answer them; the hub sends each peer what it lacks. The next
round repeats the same reconnect.

Work is links answered (a reply generated) over the whole window.
"""

import time

import numpy as np

from ..kinds.map import Groups
from ..reference.sync_reply import reply
from ..trace import step_range
from ..wire.sync_wire import BloomFilter, encode_sync_message
from .batch_loop import _saved_doc

SAMPLE_LINKS = 256            # links whose every reply is kept and checked


def make(cfg, traffic, seed, device, log):
    return SyncRounds(cfg, traffic, seed, device, log)


class SyncRounds:

    def __init__(self, cfg, traffic, seed, device, log):
        self.cfg, self.traffic, self.device, self.log = \
            cfg, traffic, device, log
        self.rng = np.random.default_rng(seed)
        self.groups = Groups(cfg, self.rng)
        n, g = cfg['docs'], cfg['groups']
        self.doc_group = self.rng.permutation(np.arange(n) % g)
        k = traffic['peers_per_doc']
        self.link_doc = np.repeat(np.arange(n), k)
        self.sample = np.sort(self.rng.choice(
            len(self.link_doc), size=min(SAMPLE_LINKS, len(self.link_doc)),
            replace=False))
        self.kept = []            # per round: replies of the sampled links
        self.last = None          # the last round's replies
        self.step_counts = []
        self.failed = 0

    def setup(self, phases):
        t = time.perf_counter()
        history = self.groups.make_history()
        saved = [_saved_doc(h) for h in history]
        p = self.traffic['peer_changes']
        self.peer_msg, self.want, self.control = [], [], []
        for s, h in zip(self.groups.streams, history):
            peer_heads = [s.hashes[p - 1]]
            bloom = BloomFilter(s.hashes[:p]).bytes
            self.peer_msg.append(encode_sync_message({
                'heads': peer_heads, 'need': [],
                'have': [{'lastSync': [], 'bloom': bloom}],
                'changes': []}))
            args = (s.hashes, s.deps, h, s.heads, peer_heads, [], bloom)
            self.want.append(reply(*args))
            self.control.append(reply(*args, use_filter=False))
        self.msgs = [self.peer_msg[self.doc_group[d]] for d in self.link_doc]
        counts = {'links': len(self.link_doc),
                  'filter_bytes': sum(len(self.peer_msg[self.doc_group[d]])
                                      for d in self.link_doc),
                  'candidates': len(self.link_doc) *
                  self.cfg['history_changes'],
                  'sent_hashes': len(self.link_doc) *
                  (self.cfg['history_changes'] - p)}
        self.counts = counts
        phases['generate_s'] = time.perf_counter() - t

        t = time.perf_counter()
        from automerge_tpu_torch.fleet.backend import DocFleet
        from automerge_tpu_torch.fleet import load_docs
        self.fleet = DocFleet(doc_capacity=self.cfg['docs'],
                              key_capacity=self.cfg['key_capacity'],
                              device=self.device)
        self.fleet.frontier_index()
        docs = load_docs([saved[g] for g in self.doc_group], self.fleet)
        self.links = [docs[d] for d in self.link_doc]
        self._sync()
        phases['load_s'] = time.perf_counter() - t

        t = time.perf_counter()
        for r in range(self.traffic['warm_rounds']):
            t1 = time.perf_counter()
            self._round()
            self._sync()
            phases[f'warm_round{r}_s'] = time.perf_counter() - t1
        phases['warm_s'] = time.perf_counter() - t

    def _sync(self):
        if self.device != 'cpu':
            import torch
            torch.cuda.synchronize()

    def _round(self):
        from automerge_tpu_torch.backend import init_sync_state
        from automerge_tpu_torch.fleet.sync_driver import (
            generate_sync_messages_docs, receive_sync_messages_docs)
        states = [init_sync_state() for _ in self.links]
        self.links, states, _ = receive_sync_messages_docs(
            self.links, states, self.msgs, mirror=False)
        _states, replies = generate_sync_messages_docs(self.links, states)
        return replies

    def window(self, seconds):
        done = attempted = steps = 0
        n = len(self.links)
        t0 = time.perf_counter()
        marks = []
        while True:
            marks.append(time.perf_counter())
            attempted += n
            try:
                with step_range():
                    replies = self._round()
            except Exception as exc:          # counted, then the run ends
                self.failed += n
                self.log(f'round failed: {type(exc).__name__}: {exc}')
                break
            answered = sum(r is not None for r in replies)
            done += answered
            self.failed += n - answered
            self.kept.append([replies[i] for i in self.sample])
            self.last = replies
            self.step_counts.append(self.counts)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        marks.append(t0 + elapsed)
        self.log(f'rounds: {steps} in {elapsed:.3f} s: ' + ' '.join(
            f'{b - a:.3f}' for a, b in zip(marks, marks[1:])))
        return done, attempted, elapsed, steps

    def answers(self):
        self.links = self.fleet = None
        return {'last': self.last, 'kept': self.kept}

    def checks(self, got, control=False):
        """Every link's reply in the last round, and the sampled links'
        replies in every round, against the reference's bytes (the
        control puts the reference that ignores the peers' filters in
        the program's place)."""
        of_link = [self.doc_group[d] for d in self.link_doc]
        if control:
            got = {'last': [self.control[g] for g in of_link],
                   'kept': [[self.control[of_link[i]] for i in self.sample]
                            for _ in got['kept']]}
        ref = [self.want[g] for g in of_link]
        last = got['last'] or []
        wrong = sum(r is None or bytes(r) != w for r, w in zip(last, ref))
        wrong += len(ref) - len(last)
        sampled = sum(r is None or bytes(r) != ref[i]
                      for kept in got['kept']
                      for r, i in zip(kept, self.sample))
        return [('replies_wrong', int(wrong), 0),
                ('sampled_replies_wrong', int(sampled), 0),
                ('links_failed', int(self.failed), 0)]
