"""typed-errors: only automerge_tpu_torch.errors classes escape a decoder.

Three checks, each a past bug class:

1. Decode-surface raises (fuzz rounds 2/3): a public function whose
   name marks it a decode surface (decode_/parse_/read_/split_/inflate)
   may not raise a bare builtin exception — hostile bytes reach these,
   and the containment contract promises callers a typed error carrying
   doc_index. A raise is exempt when it sits inside a try whose handler
   converts (raises a typed class or routes through as_wire_error): that
   is exactly the guarded-boundary idiom decode_cursor uses.
2. `except Exception: pass` (and bare `except: pass`) anywhere: the
   silent swallow that turns corruption into later mystery state.
3. Exception-message string matching (round 11's 'session closed' bug):
   comparing/searching str(exc) or exc.args[...] against a literal
   inside an except handler — the reason SessionClosed exists as a type.
"""

import ast

from .. import scopes
from ..astutil import (
    contains_within, const_str, dotted, error_names, raises_typed)
from ..core import Rule

# Builtin exception names a decode surface may not let escape.
# TypeError is absent on purpose: argument-type guards on decode
# helpers are API validation (caller bugs), not wire corruption.
UNTYPED = frozenset({
    'ValueError', 'KeyError', 'IndexError', 'RuntimeError', 'Exception',
    'OSError', 'IOError', 'EOFError', 'AssertionError',
    'NotImplementedError', 'UnicodeDecodeError', 'OverflowError',
})

BROAD_HANDLERS = frozenset({'Exception', 'BaseException'})


class TypedErrorsRule(Rule):
    rule_id = 'typed-errors'
    doc = ('decode surfaces raise automerge_tpu_torch.errors only; no '
           'except-pass swallows; no exception-message string matching')

    def check(self, module):
        if not scopes.lintable(module.path):
            return
        yield from self._except_pass(module)
        yield from self._message_matching(module)
        if scopes.typed_raise_scope(module.path):
            yield from self._decode_raises(module)

    # -- check 1 -------------------------------------------------------
    def _decode_raises(self, module):
        typed_names, error_modules = error_names(module.tree)
        for fn in module.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name.startswith('_'):
                continue
            if not scopes.DECODE_NAME_RE.match(fn.name):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                target = node.exc.func if isinstance(node.exc, ast.Call) \
                    else node.exc
                name = dotted(target)
                if name not in UNTYPED:
                    continue
                if self._converted_downstream(module, fn, node,
                                              typed_names, error_modules):
                    continue
                yield module.finding(
                    self.rule_id, node,
                    f'decode surface {fn.name}() raises bare {name} — '
                    f'hostile bytes reach this function, raise an '
                    f'automerge_tpu_torch.errors class (or convert via '
                    f'as_wire_error at the boundary)')

    def _converted_downstream(self, module, fn, raise_node, typed_names,
                              error_modules):
        """Is the raise inside a try (within this function) whose
        handler converts to a typed error?"""
        for anc in module.ancestors(raise_node):
            if anc is fn:
                return False
            if not isinstance(anc, ast.Try):
                continue
            if not contains_within(module, anc.body, raise_node):
                continue  # raise lives in the handler/else, not the body
            for handler in anc.handlers:
                for sub in ast.walk(handler):
                    if isinstance(sub, ast.Raise) and sub.exc is not None \
                            and raises_typed(sub.exc, typed_names,
                                             error_modules):
                        return True
                    if isinstance(sub, ast.Call) and raises_typed(
                            sub, typed_names, error_modules):
                        return True
        return False

    # -- check 2 -------------------------------------------------------
    def _except_pass(self, module):
        for node in module.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is not None and \
                    dotted(node.type) not in BROAD_HANDLERS:
                continue
            if all(isinstance(stmt, (ast.Pass, ast.Continue))
                   for stmt in node.body):
                caught = dotted(node.type) if node.type is not None \
                    else 'everything'
                yield module.finding(
                    self.rule_id, node,
                    f'except {caught}: pass swallows failures silently '
                    f'— narrow the exception types or handle/log it')

    # -- check 3 -------------------------------------------------------
    def _message_matching(self, module):
        for handler in module.nodes:
            if not isinstance(handler, ast.ExceptHandler) or \
                    handler.name is None:
                continue
            var = handler.name
            for node in ast.walk(handler):
                if isinstance(node, ast.Compare) and \
                        self._compares_message(node, var):
                    yield module.finding(
                        self.rule_id, node,
                        f'string-matching on the message of caught '
                        f'exception {var!r} — add/raise a dedicated '
                        f'typed class instead (the SessionClosed '
                        f'lesson)')
                elif isinstance(node, ast.Call) and \
                        self._prefix_matches_message(node, var):
                    yield module.finding(
                        self.rule_id, node,
                        f'startswith/endswith on str({var}) — match the '
                        f'exception TYPE, not its message text')

    @staticmethod
    def _is_message_expr(node, var):
        """str(var) or var.args[...]"""
        if isinstance(node, ast.Call) and dotted(node.func) == 'str' and \
                len(node.args) == 1 and \
                isinstance(node.args[0], ast.Name) and \
                node.args[0].id == var:
            return True
        if isinstance(node, ast.Subscript) and \
                dotted(node.value) == f'{var}.args':
            return True
        return False

    def _compares_message(self, node, var):
        sides = [node.left] + list(node.comparators)
        if not any(self._is_message_expr(s, var) for s in sides):
            return False
        if not any(const_str(s) is not None for s in sides):
            return False
        return any(isinstance(op, (ast.In, ast.NotIn, ast.Eq, ast.NotEq))
                   for op in node.ops)

    def _prefix_matches_message(self, node, var):
        return isinstance(node.func, ast.Attribute) and \
            node.func.attr in ('startswith', 'endswith', 'find') and \
            self._is_message_expr(node.func.value, var)
