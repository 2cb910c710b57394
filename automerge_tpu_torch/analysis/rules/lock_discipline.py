"""lock-discipline: shared module state mutates under a lock, or not at
all.

The threaded surfaces (native pool completion callbacks, service pump
threads, the Prometheus exporter's scrape thread, the recorder ring,
the kernel-ledger wrapper) all reach module-level containers. A
mutation of one outside a `with <lock>` block — and outside Counters,
which locks internally — is reported as a static race candidate. The
rule does not try to prove a race (no static tool here can); it
enumerates the candidates so each is either fixed or carries a written
justification in the baseline (e.g. import-time-only registration).
"""

import ast

from .. import scopes
from ..astutil import call_name, dotted
from ..core import Rule

CONTAINER_FACTORIES = frozenset({
    'dict', 'list', 'set', 'collections.defaultdict', 'defaultdict',
    'collections.OrderedDict', 'OrderedDict', 'collections.deque',
    'deque',
})

MUTATORS = frozenset({
    'append', 'appendleft', 'add', 'update', 'pop', 'popleft', 'popitem',
    'setdefault', 'clear', 'extend', 'remove', 'discard', 'insert',
})


class LockDisciplineRule(Rule):
    rule_id = 'lock-discipline'
    doc = ('module-level mutable state on threaded surfaces is mutated '
           'under a lock or is a Counters instance (static race '
           'candidates)')

    def check(self, module):
        if not scopes.threaded_scope(module.path):
            return
        state = self._module_state(module)
        if not state:
            return
        for fn in module.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                name = self._mutated_state(node, state)
                if name is None:
                    continue
                if self._under_lock(module, node):
                    continue
                yield module.finding(
                    self.rule_id, node,
                    f'static race candidate: module state {name!r} '
                    f'mutated outside a lock on a threaded surface — '
                    f'hold the module lock, use Counters, or justify '
                    f'(e.g. import-time-only) in the baseline')

    @staticmethod
    def _module_state(module):
        names = set()
        for stmt in module.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            value = stmt.value
            is_container = isinstance(
                value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                        ast.ListComp, ast.SetComp)) or \
                call_name(value) in CONTAINER_FACTORIES
            if not is_container:
                continue
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        return names

    @staticmethod
    def _mutated_state(node, state):
        # container[key] = ... / del container[key] / container[k] += ...
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = node.targets if isinstance(node, (ast.Assign,
                                                        ast.Delete)) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in state:
                    return t.value.id
        # container.append(...) etc.
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in state:
            return node.func.value.id
        return None

    @staticmethod
    def _under_lock(module, node):
        for anc in module.ancestors(node):
            if not isinstance(anc, ast.With):
                continue
            for item in anc.items:
                text = dotted(item.context_expr) or \
                    dotted(getattr(item.context_expr, 'func', None)) or ''
                if 'lock' in text.lower():
                    return True
        return False
