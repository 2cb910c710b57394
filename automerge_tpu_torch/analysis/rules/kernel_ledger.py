"""kernel-ledger: every kernel entry point is costed; no per-doc dispatch.

The torch form of automerge_tpu/analysis/rules/kernel_ledger.py. The
port's cost ledger (observability/perf.py) only sees a kernel entry
point that passes through `instrument_kernel`, rebound at the module's
top as ``name = instrument_kernel(kind, _impl)`` — the idiom of every
entry point in fleet/. Two checks:

1. ledger coverage: `instrument_kernel` used as a decorator
   (``@instrument_kernel``, ``@functools.partial(instrument_kernel,
   ...)``) is a violation, as is an `instrument_kernel(...)` call whose
   result is not bound by an assignment (a ledger entry registered and
   then lost), and a compiled torch callable (``torch.compile(...)``,
   ``torch.jit.script(...)`` / ``trace(...)``) that is not the direct
   argument of `instrument_kernel` — a kernel the ledger cannot see.
2. per-doc dispatch (the O(1)-dispatch contract): a `torch.` use inside
   a `for` loop whose iterable is doc-shaped (docs, handles, peers,
   subscribers, n_docs, ...) in a host-path module dispatches one
   kernel per document. Per-class pool loops and fixed array-tuple
   grows don't match the iterable pattern and stay legal.
"""

import ast

from .. import scopes
from ..astutil import dotted
from ..core import Rule

WRAPPER_NAMES = frozenset({'instrument_kernel'})
COMPILE_NAMES = frozenset({'torch.compile', 'torch.jit.script',
                           'torch.jit.trace'})


def _is_wrapper(node):
    return (dotted(node) or '').split('.')[-1] in WRAPPER_NAMES


def _is_partial_of_wrapper(node):
    if not isinstance(node, ast.Call):
        return False
    if dotted(node.func) not in ('functools.partial', 'partial'):
        return False
    return any(_is_wrapper(a) for a in node.args)


class KernelLedgerRule(Rule):
    rule_id = 'kernel-ledger'
    doc = ('kernel entry points must be rebound as name = '
           'instrument_kernel(kind, fn); no torch dispatch inside per-doc '
           'loops in host-path modules')

    def check(self, module):
        if scopes.kernel_scope(module.path):
            yield from self._ledger_coverage(module)
        if scopes.host_loop_scope(module.path):
            yield from self._per_doc_dispatch(module)

    def _ledger_coverage(self, module):
        decorators = set()
        for fn in module.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in fn.decorator_list:
                decorators.add(id(dec))
                target = dec.func if isinstance(dec, ast.Call) and \
                    not _is_partial_of_wrapper(dec) else dec
                if _is_wrapper(target) or _is_partial_of_wrapper(dec):
                    yield module.finding(
                        self.rule_id, dec,
                        f'instrument_kernel as a decorator on {fn.name}() '
                        f'— rebind as name = instrument_kernel(kind, '
                        f'_impl), the idiom of every entry point')
        for node in module.nodes:
            if not isinstance(node, ast.Call) or id(node) in decorators:
                continue
            name = dotted(node.func)
            parent = module.parent_of(node)
            if _is_wrapper(node.func):
                if not isinstance(parent, (ast.Assign, ast.AnnAssign)):
                    yield module.finding(
                        self.rule_id, node,
                        'instrument_kernel(...) result is not bound by an '
                        'assignment — rebind the entry point as name = '
                        'instrument_kernel(kind, _impl)')
            elif name in COMPILE_NAMES:
                if isinstance(parent, ast.Call) and \
                        _is_wrapper(parent.func):
                    continue
                yield module.finding(
                    self.rule_id, node,
                    f'{name}(...) result is not instrument_kernel-wrapped '
                    f'— the kernel is invisible to the cost ledger')

    def _per_doc_dispatch(self, module):
        for loop in module.nodes:
            if not isinstance(loop, ast.For):
                continue
            iter_text = module.text(loop.iter)
            if not scopes.PER_DOC_ITER_RE.search(iter_text):
                continue
            for node in ast.walk(loop):
                if isinstance(node, ast.Attribute) and \
                        (dotted(node) or '').startswith('torch.'):
                    yield module.finding(
                        self.rule_id, node,
                        f'torch dispatch inside a per-doc loop (iterating '
                        f'{iter_text.strip()[:60]!r}) — batch it into '
                        f'one fused dispatch (the O(1)-dispatch '
                        f'contract)')
                    break  # one finding per loop is enough
