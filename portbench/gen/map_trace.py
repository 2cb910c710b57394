"""The map hub's editing streams, from a seed.

Generalises chip_smoke.py:787-811 `seam_workload` (bench.py
bench_backend_pipeline's workload: one chain of single-set changes by two
alternating actors, a key drawn uniformly from the doc's keys, an int
value in [1, 2**20)). A `MapStream` continues one such chain batch after
batch; a batch may instead be two concurrent branches, one per actor,
which the next batch's first change merges. Each change's bytes come from
the benchmark's frozen codec (portbench/wire); beside them the stream
keeps the logical ops, (counter, actor index, key, value), that the
reference replays.
"""

from ..wire.columnar import decode_change_meta, encode_change

ACTORS = ('aa' * 16, 'bb' * 16)     # hex order == index order
VALUE_LIMIT = 1 << 20


def _set_change(actor, seq, start, deps, key, value):
    buf = encode_change({
        'actor': actor, 'seq': seq, 'startOp': start, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': value, 'datatype': 'int', 'pred': []}]})
    return buf, decode_change_meta(buf, True)['hash']


class MapStream:
    """One document group's chain. `rng` draws keys and values."""

    def __init__(self, rng, n_keys):
        self.rng = rng
        self.n_keys = n_keys
        self.heads = []
        self.seqs = [0, 0]
        self.max_op = 0
        self.turn = 0
        self.hashes = []          # every change hash, in delivery order
        self.deps = []            # deps of each, in delivery order

    def _next_op(self):
        key = f'k{int(self.rng.integers(0, self.n_keys))}'
        return key, int(self.rng.integers(1, VALUE_LIMIT))

    def _emit(self, a, start, deps, ops_out):
        key, value = self._next_op()
        self.seqs[a] += 1
        buf, h = _set_change(ACTORS[a], self.seqs[a], start, deps, key,
                             value)
        ops_out.append((start, a, key, value))
        self.hashes.append(h)
        self.deps.append(sorted(deps))
        return buf, h

    def chain(self, n):
        """`n` changes on one chain, the two actors in turn. Returns
        (change bytes, ops)."""
        bufs, ops = [], []
        for _ in range(n):
            a = self.turn % 2
            self.turn += 1
            buf, h = self._emit(a, self.max_op + 1, self.heads, ops)
            self.max_op += 1
            self.heads = [h]
            bufs.append(buf)
        return bufs, ops

    def branches(self, n):
        """Two concurrent branches of n // 2 changes, one per actor, both
        from the current heads; the heads become both branch tips."""
        bufs, ops, tips = [], [], []
        base, half = self.max_op, n // 2
        for a in (0, 1):
            deps = list(self.heads)
            for i in range(half):
                buf, h = self._emit(a, base + i + 1, deps, ops)
                deps = [h]
                bufs.append(buf)
            tips.append(deps[0])
        self.max_op = base + half
        self.heads = sorted(tips)
        return bufs, ops
