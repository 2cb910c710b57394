"""determinism: replicas must not read wall clocks or roll free dice.

Two replicas applying the same changes must converge byte-identically
(the differential suites pin this dynamically); statically that means
the fleet/backend/service/shard/query paths may not read wall-clock
time (`time.time()`, `datetime.now()` — clocks are injected, round 6)
or call the unseeded module-level `random`/`np.random` API (seeded
`random.Random(seed)` instances are the sanctioned idiom, see
fleet/faults.py). Third check: a wire encode that iterates an unsorted
dict and appends is iteration-order-dependent output — the reference
format is canonical, so encode loops sort first (encode_cursor's
`sorted(heads)` is the idiom).
"""

import ast

from .. import scopes
from ..astutil import dotted
from ..core import Rule

WALL_CLOCK = frozenset({
    'time.time', 'datetime.now', 'datetime.utcnow', 'datetime.today',
    'datetime.datetime.now', 'datetime.datetime.utcnow', 'date.today',
    'datetime.date.today',
})

UNSEEDED_RANDOM = frozenset({
    'random.random', 'random.randint', 'random.randrange',
    'random.choice', 'random.choices', 'random.shuffle', 'random.sample',
    'random.uniform', 'random.getrandbits', 'random.seed',
})

DICT_ITER_METHODS = frozenset({'items', 'keys', 'values'})
ORDER_SINKS = frozenset({'append', 'extend', 'write'})


class DeterminismRule(Rule):
    rule_id = 'determinism'
    doc = ('no wall-clock or unseeded random on deterministic replica '
           'paths; no dict-iteration-order-dependent wire encodes')

    def check(self, module):
        if scopes.deterministic_scope(module.path):
            yield from self._clock_and_random(module)
        if scopes.encode_scope(module.path):
            yield from self._encode_order(module)

    def _clock_and_random(self, module):
        for node in module.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is None:
                continue
            if name in WALL_CLOCK:
                yield module.finding(
                    self.rule_id, node,
                    f'{name}() on a deterministic path — clocks are '
                    f'injected here (round-6 rule); take the tick/clock '
                    f'as a parameter')
            elif name in UNSEEDED_RANDOM:
                yield module.finding(
                    self.rule_id, node,
                    f'unseeded {name}() on a deterministic path — use '
                    f'a seeded random.Random(seed) instance')
            elif name.startswith(('np.random.', 'numpy.random.')) and \
                    not name.endswith(('.default_rng', '.Generator',
                                       '.RandomState')):
                yield module.finding(
                    self.rule_id, node,
                    f'global {name}() on a deterministic path — use a '
                    f'seeded np.random.default_rng(seed) generator')

    def _encode_order(self, module):
        for fn in module.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not scopes.ENCODE_NAME_RE.search(fn.name):
                continue
            for loop in ast.walk(fn):
                if not isinstance(loop, ast.For):
                    continue
                if not self._unsorted_dict_iter(loop.iter):
                    continue
                if not self._has_order_sink(loop):
                    continue
                yield module.finding(
                    self.rule_id, loop,
                    f'{fn.name}() iterates an unsorted dict and emits '
                    f'per-entry output — wire encodes must be '
                    f'canonical; wrap the iterable in sorted(...)')

    @staticmethod
    def _unsorted_dict_iter(iter_node):
        return isinstance(iter_node, ast.Call) and \
            isinstance(iter_node.func, ast.Attribute) and \
            iter_node.func.attr in DICT_ITER_METHODS

    @staticmethod
    def _has_order_sink(loop):
        for node in ast.walk(loop):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ORDER_SINKS:
                return True
            if isinstance(node, ast.AugAssign) and \
                    isinstance(node.op, ast.Add):
                return True
        return False
