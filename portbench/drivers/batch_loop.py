"""Closed loop of batches at a hub: one `apply_changes_docs(handles,
batch, mirror=False)` after another on a standing fleet, every doc
taking `changes_per_doc` changes (or `ops_per_doc` ops) a batch,
continuing its group's history.

Document turnover: a doc that has taken `epoch_batches` batches since
it was loaded is freed and loaded again from the set-up's saved bytes
(`free_docs`, then `load_docs` into the freed slots) before the next
batch, and starts its group's batches again. The docs' epochs are
staggered evenly from the seed, so that after set-up's first epoch
every batch carries the same share of reloads (1 / `epoch_batches` of
the docs) and the same spread of doc positions: every step of the
window is the same mix of work. Turnover bounds the rows' growth, the
host's memory and the inputs set-up generates.

Work is counted in the kind's unit (changes, or sequence ops) over the
whole window, the reloads' time included.
"""

import importlib
import time

import numpy as np

from ..trace import step_range


def make(cfg, traffic, seed, device, log):
    return BatchLoop(cfg, traffic, seed, device, log)


def _saved_doc(changes):
    """A document of `changes`, saved by the port's host backend: the
    bytes a hub holds for a document at rest."""
    from automerge_tpu_torch import backend as host
    return bytes(host.save(host.apply_changes(host.init(), changes)[0]))


class BatchLoop:

    def __init__(self, cfg, traffic, seed, device, log):
        self.cfg, self.traffic, self.device, self.log = \
            cfg, traffic, device, log
        self.rng = np.random.default_rng(seed)
        kind = importlib.import_module(f'portbench.kinds.{cfg["kind"]}')
        self.groups = kind.Groups(cfg, self.rng)
        n, g = cfg['docs'], cfg['groups']
        e = traffic['epoch_batches']
        # every group holds docs // groups docs or one more, in seeded
        # places; so does every phase of the turnover
        self.doc_group = self.rng.permutation(np.arange(n) % g)
        # a doc's first epoch ends after 1..e batches, evenly
        self.limit = self.rng.permutation(np.arange(n) % e) + 1
        self.pos = np.zeros(n, dtype=np.int64)   # batches since its load
        self.handles = None
        self.fleet = None
        self.step_counts = []     # per timed step: what its data holds
        self.failed = 0

    # ---- set-up ---------------------------------------------------------

    def setup(self, phases):
        t = time.perf_counter()
        history = self.groups.make_history()
        self.saved = [_saved_doc(h) for h in history]
        self.hist_heads = [list(h) for h in self.groups.heads()]
        self.batches, self.heads_after = [], []
        for _ in range(self.traffic['epoch_batches']):
            self.batches.append(self.groups.make_batch(self.traffic))
            self.heads_after.append([list(h) for h in self.groups.heads()])
        n_groups = self.cfg['groups']
        # [batch][group] -> change bytes, work, data counts
        self.bytes_of = [[b[g][0] for g in range(n_groups)]
                         for b in self.batches]
        self.work_of = np.array([[self.groups.work(b[g])
                                  for g in range(n_groups)]
                                 for b in self.batches], dtype=np.int64)
        self.counts_of = [[self.groups.step_counts(b, g) for g in
                           range(n_groups)] for b in self.batches]
        phases['generate_s'] = time.perf_counter() - t

        t = time.perf_counter()
        from automerge_tpu_torch.fleet.backend import DocFleet
        from automerge_tpu_torch.fleet import load_docs
        self._load_docs = load_docs
        self.fleet = DocFleet(doc_capacity=self.cfg['docs'],
                              key_capacity=self.cfg['key_capacity'],
                              device=self.device)
        self.handles = load_docs([self.saved[g] for g in self.doc_group],
                                 self.fleet)
        self._sync()
        phases['load_s'] = time.perf_counter() - t

        # warm one epoch: every shape of the cell's batches and reloads,
        # and the docs' positions spread evenly over the epoch, as they
        # stay from then on (a window that started with every doc at its
        # first batch would see each batch slower than the last)
        t = time.perf_counter()
        for _ in range(self.traffic['epoch_batches']):
            self._reload_due()
            self._step()
        self._sync()
        phases['warm_s'] = time.perf_counter() - t

    def _sync(self):
        if self.device != 'cpu':
            import torch
            torch.cuda.synchronize()

    def _reload_due(self):
        """Free and load again the docs whose epoch is over."""
        import torch
        from automerge_tpu_torch.fleet.backend import free_docs
        due = np.flatnonzero(self.pos >= self.limit)
        if not len(due):
            return
        with torch.profiler.record_function('pb.reload'):
            free_docs([self.handles[i] for i in due])
            fresh = self._load_docs([self.saved[self.doc_group[i]]
                                     for i in due], self.fleet)
        for i, h in zip(due, fresh):
            self.handles[i] = h
        self.pos[due] = 0
        self.limit[due] = self.traffic['epoch_batches']

    def _batch(self):
        """This step's per-doc change lists, work and data counts."""
        pos, grp = self.pos, self.doc_group
        per_doc = [self.bytes_of[p][g] for p, g in zip(pos.tolist(),
                                                       grp.tolist())]
        work = int(self.work_of[pos, grp].sum())
        return per_doc, work

    def _counts(self):
        pairs, n = np.unique(self.pos * self.cfg['groups'] + self.doc_group,
                             return_counts=True)
        total = {}
        for pg, k in zip(pairs.tolist(), n.tolist()):
            c = self.counts_of[pg // self.cfg['groups']][pg %
                                                        self.cfg['groups']]
            for key, v in c.items():
                total[key] = total.get(key, 0) + v * k
        return total

    def _step(self):
        from automerge_tpu_torch.fleet.backend import apply_changes_docs
        per_doc, work = self._batch()
        self.handles, _ = apply_changes_docs(self.handles, per_doc,
                                             mirror=False)
        self.pos += 1
        return work

    # ---- the window -----------------------------------------------------

    def window(self, seconds):
        """Batches until `seconds` have passed; returns (work done, work
        attempted, elapsed seconds, steps)."""
        done = attempted = steps = 0
        t0 = time.perf_counter()
        marks = []
        while True:
            marks.append(time.perf_counter())
            self._reload_due()
            counts = self._counts()
            _per_doc, work = self._batch()
            attempted += work
            try:
                with step_range():
                    self._step()
            except Exception as exc:          # counted, then the run ends
                self.failed += work
                self.log(f'batch failed: {type(exc).__name__}: {exc}')
                break
            done += work
            self.step_counts.append(counts)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        marks.append(t0 + elapsed)
        self.log('steps (s): ' + ' '.join(
            f'{b - a:.3f}' for a, b in zip(marks, marks[1:])))
        return done, attempted, elapsed, steps

    # ---- what the window produced ----------------------------------------

    def answers(self):
        """The program's answers (read back from the card) and heads, then
        the program's state freed."""
        docs = self.groups.read(self.handles)
        heads = [sorted(h['heads']) for h in self.handles]
        self.handles = self.fleet = None
        return {'docs': docs, 'heads': heads}

    def checks(self, got, control=False):
        """[(name, value, limit)]: every doc's state and heads against the
        reference's replay of its group's changes up to its position (the
        control puts the reference with its broken guarantee in the
        program's place)."""
        want, bad = {}, {}
        for g, p in set(zip(self.doc_group.tolist(), self.pos.tolist())):
            want[g, p] = self.groups.reference(g, self.batches[:p])
            if control:
                bad[g, p] = self.groups.reference(g, self.batches[:p],
                                                  control=True)
        keys = list(zip(self.doc_group.tolist(), self.pos.tolist()))
        heads = [sorted(self.heads_after[p - 1][g] if p else
                        self.hist_heads[g]) for g, p in keys]
        docs = [bad[k] for k in keys] if control else got['docs']
        docs_wrong = sum(d != want[k] for d, k in zip(docs, keys))
        heads_wrong = sum(h != w for h, w in zip(got['heads'], heads))
        missing = len(keys) - len(got['docs'])
        return [('docs_wrong', int(docs_wrong) + missing, 0),
                ('heads_wrong', int(heads_wrong), 0),
                ('work_failed', int(self.failed), 0)]
