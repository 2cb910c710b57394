"""Open loop on the wall clock at a multi-tenant service: a `DocService`
over a fleet of the configuration's capacity, one session (one doc) per
client, tenants drawn Zipf(`zipf_s`). Requests arrive as a Poisson
process at `rate_per_s`, drawn from the seed, whatever the service is
doing; each goes out at its due time or, if the loop is busy, as soon as
it can, and is timed from its due time to the moment the harness sees
its ticket resolve. An edit client's request is one change with one
`set`; a sync client edits its replica and sends its next sync message,
and takes the reply. A request that admission refuses, or whose ticket
fails or never resolves, counts as an infinite latency.

Adapted from automerge_tpu_torch/service_cases.py:228-560 (`run_leg`,
clean leg), whose arrivals were tied to the service's ticks.
"""

import math
import random
import time

import numpy as np

from ..gen.service_clients import EditClient, SyncClient, ZipfSampler
from ..reference.map_lww import lww_state
from ..trace import step_range

DRAIN_S = 60.0                # how long the window's requests may finish


def make(cfg, traffic, seed, device, log):
    return ServiceOpen(cfg, traffic, seed, device, log)


def percentile(values, q):
    """The q-th percentile (0-100) by the nearest-rank rule; infinite
    values sort last."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


class ServiceOpen:

    def __init__(self, cfg, traffic, seed, device, log):
        self.cfg, self.traffic, self.device, self.log = \
            cfg, traffic, device, log
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.rate = float(traffic['rate_per_s'])
        self.step_counts = []
        self.failed = 0
        self.lat = []             # per window request: seconds or inf
        self.late = []            # per window request: submit - due
        self.client_s = 0.0       # harness time minting and receiving
        self.sync_errors = 0
        self.refused = {}         # refusals at submit, by type

    def setup(self, phases):
        from automerge_tpu_torch.fleet.backend import DocFleet
        from automerge_tpu_torch.service import DocService
        t = time.perf_counter()
        n = self.cfg['docs']
        tenants = self.traffic['tenants']
        zipf = ZipfSampler(tenants, self.traffic['zipf_s'])
        self.zipf = zipf
        self.fleet = DocFleet(doc_capacity=n,
                              key_capacity=self.cfg['key_capacity'],
                              device=self.device)
        self.service = DocService(fleet=self.fleet,
                                  **self.traffic['service'])
        tenant_of = [zipf.draw(self.rng) for _ in range(n)]
        sessions = self.service.open_sessions(
            [f'tenant{t}' for t in tenant_of])
        self.clients, self.by_tenant = [], {}
        for i, (session, tn) in enumerate(zip(sessions, tenant_of)):
            actor = f'{i % 192:08x}' + 'ab' * 12
            if self.rng.random() < self.traffic['sync_fraction']:
                c = SyncClient(session, actor)
            else:
                c = EditClient(session, actor, self.cfg['keys'])
            self.clients.append(c)
            self.by_tenant.setdefault(tn, []).append(c)
        phases['sessions_s'] = time.perf_counter() - t
        t = time.perf_counter()
        self._loop(self.traffic['warm_s'], record=False)
        self._sync()
        phases['warm_s'] = time.perf_counter() - t

    def _sync(self):
        if self.device != 'cpu':
            import torch
            torch.cuda.synchronize()

    def _arrivals(self, seconds):
        """Due times in [0, seconds): Poisson at the cell's rate."""
        gaps = self.np_rng.exponential(1.0 / self.rate,
                                       size=int(self.rate * seconds * 1.5)
                                       + 16)
        due = np.cumsum(gaps)
        return due[due < seconds].tolist()

    def _submit(self):
        """One arrival: (ticket or None, client, op or sync message)."""
        t = time.perf_counter()
        pool = self.by_tenant.get(self.zipf.draw(self.rng))
        while not pool:
            pool = self.by_tenant.get(self.zipf.draw(self.rng))
        client = pool[self.rng.randrange(len(pool))]
        op = None
        if isinstance(client, EditClient):
            payload, op = client.next_payload(self.rng)
            kind = 'apply'
        else:
            client.edit(self.rng)
            payload = op = client.generate()
            kind = 'sync'
        self.client_s += time.perf_counter() - t
        try:
            ticket = self.service.submit(client.session, kind, payload)
        except Exception as exc:               # refused: counted below
            self.refused[type(exc).__name__] = \
                self.refused.get(type(exc).__name__, 0) + 1
            if isinstance(client, EditClient):
                client.seq -= 1
            else:
                client.rollback()
            return None, client, op
        return ticket, client, op

    def _loop(self, seconds, record):
        """Arrivals due over `seconds`, then until they resolve (at most
        DRAIN_S more). Returns (resolved ok, attempted, elapsed, ticks)."""
        due = self._arrivals(seconds)
        pending = []              # (due, ticket, client, op)
        lat, late = [], []
        i = ticks = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while i < len(due) and due[i] <= now:
                ticket, client, op = self._submit()
                late.append(time.perf_counter() - t0 - due[i])
                if ticket is None:
                    lat.append(math.inf)
                else:
                    pending.append((due[i], ticket, client, op))
                i += 1
            if i == len(due) and not pending:
                break
            if now > seconds + DRAIN_S:
                lat.extend(math.inf for _ in pending)
                break
            if not pending and i < len(due):
                time.sleep(max(0.0, min(due[i] - now, 0.001)))
                continue
            with step_range():
                self.service.pump()
            ticks += 1
            seen = time.perf_counter() - t0
            still = []
            for rec in pending:
                d, ticket, client, op = rec
                if not ticket.done:
                    still.append(rec)
                    continue
                if ticket.status != 'ok':
                    lat.append(math.inf)
                    continue
                lat.append(seen - d)
                t = time.perf_counter()
                if isinstance(client, EditClient):
                    client.committed.append(op)
                else:
                    client.acked(op)
                    try:
                        client.receive(ticket.result)
                    except Exception:          # a reply that does not parse
                        self.sync_errors += 1
                self.client_s += time.perf_counter() - t
            pending = still
        elapsed = time.perf_counter() - t0
        if record:
            self.lat, self.late = lat, late
        return sum(x != math.inf for x in lat), len(lat), elapsed, ticks

    def window(self, seconds):
        self.client_s = 0.0
        done, attempted, elapsed, ticks = self._loop(seconds, record=True)
        self.failed = attempted - done
        self.window_s = seconds
        self.step_counts = [{}] * ticks
        finite = [x for x in self.lat if x != math.inf]
        self.log(f'requests {attempted} ({attempted / seconds:.1f}/s '
                 f'offered at {self.rate}), failed {self.failed}, p50 '
                 f'{percentile(finite, 50)}, lateness p99 '
                 f'{percentile(self.late, 99)} s max {max(self.late or [0])}'
                 f' s, {ticks} ticks, drained in {elapsed - seconds:.3f} s, '
                 f'refused {self.refused}')
        return done, attempted, elapsed, ticks

    def end_to_end(self, done, elapsed):
        """The tail over every request due in the window; where more
        than 1 % failed it is infinite and goes unreported."""
        p99 = percentile(self.lat, 99)
        if p99 is None or p99 == math.inf:
            self.log(f'{self.traffic["tail_metric"]}: infinite '
                     f'({self.failed} of {len(self.lat)} failed)')
            return {}
        return {self.traffic['tail_metric']: p99 * 1e3}

    def answers(self):
        """Every session's doc, read back from the card, and the ops its
        client's acknowledged requests carried."""
        from automerge_tpu_torch.fleet.backend import materialize_docs
        docs = materialize_docs([c.session.handle for c in self.clients])
        out = {'docs': docs,
               'committed': [list(c.committed) for c in self.clients]}
        self.service = self.fleet = self.clients = self.by_tenant = None
        return out

    def checks(self, got, control=False):
        """Every session's doc, read back from the card, against the
        reference's replay of the changes its client's acknowledged
        requests carried: an edit's change, or the changes a sync
        message bore (the control: values one integer width below)."""
        dtype = np.int16 if control else None
        wrong = 0
        for doc, ops in zip(got['docs'], got['committed']):
            want = lww_state(ops)
            if control:
                doc = lww_state(ops, dtype)
            wrong += doc != want
        return [('docs_wrong', int(wrong), 0),
                ('sync_replies_unreadable', int(self.sync_errors), 0)]
