"""Static contract linter of the torch port (the port's copy of
automerge_tpu/analysis, "archlint").

The invariants past PRs learned at runtime, enforced at parse time over
`automerge_tpu_torch/`: an AST rule framework (`core`, a copy), the
per-surface scope tables (`scopes`, naming the port's paths), and one
module per rule under `rules/`. Four rules are copies with re-pointed
scopes (typed-errors, counter-discipline, determinism,
lock-discipline); kernel-ledger has a torch form (every kernel entry
point rebound as ``name = instrument_kernel(kind, fn)``; no `torch.`
dispatch inside a per-doc loop). The CLI is
``python -m automerge_tpu_torch.analysis`` (`__main__.py`) with the
checked-in baseline `automerge_tpu_torch/analysis/baseline.json`;
tests/test_torch_archlint.py pins every rule with fixtures and runs the
gate over the port's tree.

Suppression contract: a violation may be silenced ONLY by an inline
justification comment (`# archlint: ok[rule-id] why this is safe`) whose
fingerprint is recorded in the checked-in baseline. `--check` fails on
any NEW violation, any suppression missing from the baseline (so
suppressions always show up in review), and any stale baseline entry
(so the baseline can only shrink silently, never grow).
"""

from .core import (
    Finding, Module, Rule, BaselineError, check_findings, lint_paths,
    lint_source, load_baseline, write_baseline, iter_py_files,
)
from .rules import ALL_RULES, get_rules

__all__ = [
    'Finding', 'Module', 'Rule', 'BaselineError', 'ALL_RULES',
    'get_rules', 'check_findings', 'lint_paths', 'lint_source',
    'load_baseline', 'write_baseline', 'iter_py_files',
]
