"""Small shared AST helpers for the rule modules."""

import ast


def dotted(node):
    """'jax.jit' for a Name/Attribute chain, None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


def call_name(node):
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return None


def const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def error_names(tree):
    """Names this module binds to automerge_tpu_torch.errors classes (via any
    `from ...errors import X [as Y]` form), plus the module aliases
    (`from automerge_tpu_torch import errors`) so `errors.X` resolves too."""
    names, modules = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ''
            if mod == 'errors' or mod.endswith('.errors'):
                for alias in node.names:
                    names.add(alias.asname or alias.name)
            elif mod in ('automerge_tpu_torch', '..', '.'):
                for alias in node.names:
                    if alias.name == 'errors':
                        modules.add(alias.asname or 'errors')
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith('errors'):
                    modules.add(alias.asname or alias.name)
    return names, modules


def raises_typed(node, typed_names, error_modules):
    """Does this expression construct/reference a typed error class?"""
    target = node.func if isinstance(node, ast.Call) else node
    name = dotted(target)
    if name is None:
        return False
    if name in typed_names or name == 'as_wire_error' or \
            name.endswith('.as_wire_error'):
        return True
    head = name.split('.', 1)[0]
    return head in error_modules


def contains_within(module, container_stmts, node):
    """Is `node` lexically inside one of `container_stmts`?"""
    chain = {node}
    chain.update(module.ancestors(node))
    return any(stmt in chain for stmt in container_stmts)


def enclosing_function(module, node):
    for anc in module.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None
