"""counter-discipline: stats/health state is Counters, names stay legal.

Round 13 retired torn raw-dict `_stats` counters across 15 files (the
GIL does not make `d[k] += 1` atomic across the native pool's callback
threads); observability.Counters is the replacement — it locks inside
`inc()` and exports atomically. This rule keeps raw dicts from creeping
back, and blocks registration of the reserved exposition names
(`total`, `fleet<N>`) that the metrics exporter synthesizes itself —
a source registered under one would silently shadow the synthesized
rollup (the runtime guard in _check_source_name becomes a parse-time
failure here).
"""

import ast

from .. import scopes
from ..astutil import call_name, const_str
from ..core import Rule

DICT_FACTORIES = frozenset({
    'dict', 'collections.defaultdict', 'defaultdict',
    'collections.OrderedDict', 'OrderedDict', 'collections.Counter',
})

REGISTER_FNS = frozenset({
    'register_dispatch_source', 'register_health_source',
})


class CounterDisciplineRule(Rule):
    rule_id = 'counter-discipline'
    doc = ('module-level stats/health counters must be '
           'observability.Counters, and reserved exposition names '
           '(total, fleet<N>) must not be registered as sources')

    def check(self, module):
        if not scopes.counter_scope(module.path):
            return
        yield from self._raw_dict_counters(module)
        yield from self._reserved_registrations(module)

    def _raw_dict_counters(self, module):
        for stmt in module.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = [t for t in stmt.targets
                           if isinstance(t, ast.Name)]
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and stmt.value:
                targets = [stmt.target]
                value = stmt.value
            else:
                continue
            stats_targets = [t for t in targets
                             if scopes.STATS_NAME_RE.search(t.id)]
            if not stats_targets:
                continue
            if not self._is_raw_dict(value):
                continue
            names = ', '.join(t.id for t in stats_targets)
            yield module.finding(
                self.rule_id, stmt,
                f'module-level counter {names} is a plain dict — use '
                f'observability.Counters (torn raw-dict increments are '
                f'the round-13 bug class)')

    @staticmethod
    def _is_raw_dict(value):
        if isinstance(value, ast.Dict):
            return True
        if isinstance(value, ast.DictComp):
            return True
        name = call_name(value)
        return name in DICT_FACTORIES

    def _reserved_registrations(self, module):
        for node in module.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if name.split('.')[-1] not in REGISTER_FNS:
                continue
            if not node.args:
                continue
            arg = const_str(node.args[0])
            if arg is None:
                continue
            if scopes.RESERVED_SOURCE_RE.fullmatch(arg):
                yield module.finding(
                    self.rule_id, node,
                    f'registers reserved source name {arg!r} — the '
                    f'exporter synthesizes total/fleet<N> rollups '
                    f'itself; pick a non-reserved name')
