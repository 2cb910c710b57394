"""archlint for the torch port: the contract linter's CLI.

Usage (from the repository's root):
  python -m automerge_tpu_torch.analysis --check [paths...]     gate mode
  python -m automerge_tpu_torch.analysis --baseline [paths...]  rewrite the
                                        baseline from current inline
                                        suppressions
  python -m automerge_tpu_torch.analysis --json [FILE|-]        machine
                                        output
  python -m automerge_tpu_torch.analysis --list-rules           the rules

Default paths: automerge_tpu_torch (the port's package).

--check exits non-zero on: any unsuppressed violation, any inline
suppression not recorded in automerge_tpu_torch/analysis/baseline.json,
any stale baseline entry. Suppress a line only with
`# archlint: ok[rule-id] <why this is safe>` and re-run --baseline so
the exemption shows up in review as a baseline diff.
"""

import argparse
import json
import os
import sys

from automerge_tpu_torch import analysis

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATHS = ('automerge_tpu_torch',)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'baseline.json')


def run(paths, baseline_path, root=None):
    """Lint + baseline check; returns the result dict tests and bench
    consume (counts, findings, stale entries, parse errors)."""
    rules = analysis.get_rules()
    findings, files, errors = analysis.lint_paths(paths, rules, root=root)
    baseline = analysis.load_baseline(baseline_path)
    checked = analysis.check_findings(findings, baseline)
    checked.update({
        'files': files, 'errors': errors, 'findings': findings,
        'baseline_path': baseline_path, 'baseline_size': len(baseline),
        'rules': [{'id': r.rule_id, 'doc': r.doc} for r in rules],
    })
    return checked


def as_json(result):
    return {
        'version': 1,
        'files': len(result['files']),
        'rules': result['rules'],
        'findings': [f.as_dict() for f in result['findings']],
        'violations': len(result['violations']),
        'suppressed': len(result['suppressed']),
        'unlisted': len(result['unlisted']),
        'stale': result['stale'],
        'errors': [{'path': p, 'message': m} for p, m in result['errors']],
        'baseline_size': result['baseline_size'],
    }


def _report(result, out=sys.stdout):
    for f in result['violations']:
        print(f'{f.path}:{f.line}: [{f.rule}] {f.message}', file=out)
    for f in result['unlisted']:
        print(f'{f.path}:{f.line}: [{f.rule}] suppressed inline but '
              f'missing from the baseline — run --baseline and commit '
              f'the diff', file=out)
    for e in result['stale']:
        print(f'{e["path"]}: stale baseline entry {e["fingerprint"]} '
              f'[{e["rule"]}] matches nothing — delete it '
              f'(was: {e["snippet"][:60]!r})', file=out)
    for path, msg in result['errors']:
        print(f'{path}: unparseable: {msg}', file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python -m automerge_tpu_torch.analysis',
                                 add_help=True)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument('--check', action='store_true',
                      help='gate mode: fail on any new/unlisted/stale')
    mode.add_argument('--baseline', action='store_true',
                      help='rewrite the baseline from inline suppressions')
    mode.add_argument('--list-rules', action='store_true')
    ap.add_argument('--json', metavar='FILE', default=None,
                    help="write machine-readable results ('-' = stdout)")
    ap.add_argument('--baseline-file', default=DEFAULT_BASELINE)
    ap.add_argument('paths', nargs='*', default=None)
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in analysis.get_rules():
            print(f'{rule.rule_id:20s} {rule.doc}')
        return 0

    paths = args.paths or list(DEFAULT_PATHS)
    result = run(paths, args.baseline_file, root=REPO_ROOT)

    if args.baseline:
        entries = analysis.write_baseline(args.baseline_file,
                                          result['findings'])
        print(f'wrote {len(entries)} baseline entries to '
              f'{os.path.relpath(args.baseline_file, REPO_ROOT)}')
        # violations still fail: --baseline records suppressions, it
        # does not absolve unsuppressed findings
        _report({**result, 'unlisted': [], 'stale': []})
        return 1 if (result['violations'] or result['errors']) else 0

    # with --json -, stdout is RESERVED for the payload (pipeable into
    # `obs_report --archlint -`); the human report moves to stderr
    human = sys.stderr if args.json == '-' else sys.stdout
    if args.json:
        payload = json.dumps(as_json(result), indent=1, sort_keys=True)
        if args.json == '-':
            print(payload)
        else:
            with open(args.json, 'w', encoding='utf-8') as fh:
                fh.write(payload + '\n')

    _report(result, out=human)
    bad = bool(result['violations'] or result['unlisted'] or
               result['stale'] or result['errors'])
    n_v, n_s = len(result['violations']), len(result['suppressed'])
    print(f'archlint: {len(result["files"])} files, {n_v} violations, '
          f'{n_s} suppressed ({len(result["unlisted"])} unlisted, '
          f'{len(result["stale"])} stale baseline entries)', file=human)
    if args.check:
        return 1 if bad else 0
    return 1 if result['violations'] or result['errors'] else 0


if __name__ == '__main__':
    sys.exit(main())
