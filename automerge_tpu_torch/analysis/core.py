"""Rule framework: parsed modules, findings, suppressions, baseline.

Everything here is stdlib-only and torch-free on purpose: the linter
reads source, it never imports the code it checks.

A `Module` is one parsed file handed to every rule: source, AST with
parent links (`parent_of`), the repo-relative posix path the scope
tables key on, and the file's inline suppressions. A `Finding` is one
(rule, path, line, message) with a line-number-independent fingerprint
(rule + path + stripped source text), so baseline entries survive
unrelated edits above them but die when the flagged line itself changes.
"""

import ast
import hashlib
import json
import os
import re

# `# archlint: ok[rule-id] justification` on the flagged line or the
# line directly above. The justification is REQUIRED: a bare ok-marker
# does not suppress, it converts the finding into "suppression without
# justification" — an empty excuse is not an excuse.
SUPPRESS_RE = re.compile(
    r'#\s*archlint:\s*ok\[([A-Za-z0-9_*-]+)\]\s*(.*)')

BASELINE_VERSION = 1


class BaselineError(RuntimeError):
    """The baseline file is unreadable or structurally wrong."""


class Finding:
    __slots__ = ('rule', 'path', 'line', 'message', 'snippet',
                 'suppressed', 'justification')

    def __init__(self, rule, path, line, message, snippet=''):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message
        self.snippet = snippet
        self.suppressed = False
        self.justification = None

    @property
    def fingerprint(self):
        key = f'{self.rule}|{self.path}|{self.snippet.strip()}'
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def as_dict(self):
        return {'rule': self.rule, 'path': self.path, 'line': self.line,
                'message': self.message, 'snippet': self.snippet.strip(),
                'suppressed': self.suppressed,
                'justification': self.justification,
                'fingerprint': self.fingerprint}

    def __repr__(self):
        mark = ' [suppressed]' if self.suppressed else ''
        return f'{self.path}:{self.line}: [{self.rule}]{mark} {self.message}'


class Module:
    """One parsed source file, shared by every rule."""

    def __init__(self, path, source):
        self.path = path.replace(os.sep, '/')
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self._parents = {}
        # one walk builds both the parent map and the flat node list the
        # rules iterate — per-rule ast.walk() re-traversals dominated the
        # CLI profile before this (it must stay fast enough for tier-1)
        self.nodes = [self.tree]
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
                self.nodes.append(child)
        # line -> (rule-pattern, justification)
        self.suppressions = {}
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if m:
                self.suppressions[i] = (m.group(1), m.group(2).strip())

    def parent_of(self, node):
        return self._parents.get(node)

    def ancestors(self, node):
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def text(self, node):
        # like ast.get_source_segment, but sliced out of the pre-split
        # line list — get_source_segment re-splits the whole file per
        # call, which made it the top profile entry over the real tree
        line = getattr(node, 'lineno', 0)
        end = getattr(node, 'end_lineno', None)
        if not 1 <= line <= len(self.lines):
            return ''
        col = getattr(node, 'col_offset', 0) or 0
        end_col = getattr(node, 'end_col_offset', None)
        if end is None or end_col is None or not line <= end <= len(self.lines):
            return self.lines[line - 1]
        if end == line:
            return self.lines[line - 1][col:end_col]
        parts = [self.lines[line - 1][col:]]
        parts.extend(self.lines[line:end - 1])
        parts.append(self.lines[end - 1][:end_col])
        return '\n'.join(parts)

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ''

    def finding(self, rule_id, node, message):
        line = getattr(node, 'lineno', 0)
        return Finding(rule_id, self.path, line, message,
                       snippet=self.line_text(line))

    def suppression_for(self, lineno, rule_id):
        """The (pattern, justification) covering `lineno` for `rule_id`:
        same line first, then the dedicated comment line directly above."""
        for cand in (lineno, lineno - 1):
            entry = self.suppressions.get(cand)
            if entry is None:
                continue
            if cand != lineno:
                # the line above only counts if it is a pure comment line
                # (otherwise it is some other statement's suppression)
                if not self.line_text(cand).lstrip().startswith('#'):
                    continue
            pattern, justification = entry
            if pattern == '*' or pattern == rule_id:
                return pattern, justification
        return None


class Rule:
    """Base class. Subclasses set `rule_id`/`doc` and yield Findings
    from `check(module)`; scoping (which paths the rule looks at) is the
    rule's own job via the tables in `scopes`."""

    rule_id = None
    doc = ''

    def check(self, module):
        raise NotImplementedError
        yield  # pragma: no cover


def apply_suppressions(module, findings):
    for f in findings:
        hit = module.suppression_for(f.line, f.rule)
        if hit is None:
            continue
        _pattern, justification = hit
        if not justification:
            f.message += (' (archlint ok-marker present but has no '
                          'justification text — an empty excuse does '
                          'not suppress)')
            continue
        f.suppressed = True
        f.justification = justification
    return findings


def lint_module(module, rules):
    findings = []
    for rule in rules:
        findings.extend(rule.check(module))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return apply_suppressions(module, findings)


def lint_source(source, path, rules):
    """Lint one in-memory source blob as if it lived at `path` (the
    path picks the rule scopes) — the fixture-test entry point."""
    return lint_module(Module(path, source), rules)


def iter_py_files(paths, root=None):
    """Expand files/dirs into sorted repo-relative .py paths."""
    root = os.path.abspath(root or os.getcwd())
    out = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ('__pycache__', '.git'))
            for name in sorted(filenames):
                if name.endswith('.py'):
                    out.append(os.path.join(dirpath, name))
    rel = [os.path.relpath(f, root).replace(os.sep, '/') for f in out]
    return sorted(set(rel)), root


def lint_paths(paths, rules, root=None):
    """Lint every .py under `paths`. Returns (findings, files, errors)
    where errors are (path, message) for unparseable files — a syntax
    error in the tree is a loud failure, not a silent skip."""
    files, root = iter_py_files(paths, root)
    findings, errors = [], []
    for rel in files:
        full = os.path.join(root, rel)
        try:
            with open(full, 'r', encoding='utf-8') as fh:
                source = fh.read()
            module = Module(rel, source)
        except (OSError, SyntaxError, ValueError) as exc:
            errors.append((rel, f'{type(exc).__name__}: {exc}'))
            continue
        findings.extend(lint_module(module, rules))
    return findings, files, errors


# --------------------------------------------------------------------------
# Baseline: the checked-in record of every inline suppression. --check
# fails when a suppression is missing from it (new suppressions must
# show up in review as a baseline diff) and when an entry no longer
# matches anything (stale entries must be deleted, keeping the file
# honest about how many exemptions actually exist).
# --------------------------------------------------------------------------

def load_baseline(path):
    if not os.path.exists(path):
        return {}
    try:
        with open(path, 'r', encoding='utf-8') as fh:
            data = json.load(fh)
    except (OSError, ValueError) as exc:
        raise BaselineError(f'unreadable baseline {path}: {exc}')
    if not isinstance(data, dict) or data.get('version') != BASELINE_VERSION:
        raise BaselineError(f'baseline {path}: unsupported format')
    entries = {}
    for e in data.get('entries', []):
        entries[e['fingerprint']] = e
    return entries


def write_baseline(path, findings):
    entries = [
        {'fingerprint': f.fingerprint, 'rule': f.rule, 'path': f.path,
         'snippet': f.snippet.strip(), 'justification': f.justification}
        for f in findings if f.suppressed]
    entries.sort(key=lambda e: (e['path'], e['rule'], e['fingerprint']))
    data = {'version': BASELINE_VERSION, 'entries': entries}
    with open(path, 'w', encoding='utf-8') as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write('\n')
    return entries


def check_findings(findings, baseline):
    """Split findings against the baseline. Returns a dict:
    violations (unsuppressed), unlisted (suppressed inline but missing
    from the baseline file), stale (baseline entries matching nothing).
    Clean == all three empty."""
    violations = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    seen = {f.fingerprint for f in suppressed}
    unlisted = [f for f in suppressed if f.fingerprint not in baseline]
    stale = [e for fp, e in sorted(baseline.items()) if fp not in seen]
    return {'violations': violations, 'suppressed': suppressed,
            'unlisted': unlisted, 'stale': stale}
