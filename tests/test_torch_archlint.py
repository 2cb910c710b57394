"""The port's contract linter (automerge_tpu_torch/analysis): the rule
fixtures of tests/test_archlint.py at the port's paths (torch forms for
kernel-ledger), the suppression-baseline round trip, the tier-1 gate
over `automerge_tpu_torch/`, the scope tables, the mesh kinds in the
ledger, and a differential: on the same fixture sources the four
framework-neutral rules find what the reference's rules find."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from automerge_tpu import analysis as ref_analysis
from automerge_tpu_torch import analysis
from automerge_tpu_torch.analysis import scopes
from automerge_tpu_torch.fleet import exchange, registers, sharding
from automerge_tpu_torch.observability import perf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = 'automerge_tpu_torch'


def lint(src, path, rule_ids=None, pkg=analysis):
    return pkg.lint_source(textwrap.dedent(src), path,
                           pkg.get_rules(rule_ids))


def violations(src, path, rule_ids=None, pkg=analysis):
    return [f for f in lint(src, path, rule_ids, pkg) if not f.suppressed]


# ---------------------------------------------------------------------------
# the framework-neutral rules: (rule, source, module path under the
# package, expected violation lines). Each runs through the port's rule
# at automerge_tpu_torch/<path> and the reference's at
# automerge_tpu/<path>, and the findings must agree.
# ---------------------------------------------------------------------------

NEUTRAL = {
    'decode_bare_raise': ('typed-errors', '''\
        from automerge_tpu_torch.errors import MalformedChange


        def decode_frame(buf):
            if not buf:
                raise ValueError('empty frame')
            return buf
        ''', 'backend/wire.py', [6]),
    'guarded_boundary': ('typed-errors', '''\
        from automerge_tpu_torch.errors import MalformedChange, as_wire_error


        def decode_frame(buf):
            try:
                if not buf:
                    raise ValueError('empty frame')
                if buf[0] != 7:
                    raise MalformedChange('bad magic')
                return buf
            except Exception as exc:
                raise as_wire_error(exc, MalformedChange, 'decode_frame')
        ''', 'backend/wire.py', []),
    'funnel_exempt': ('typed-errors', '''\
        def decode_column(buf):
            raise ValueError('internal funnel style')
        ''', 'columnar.py', []),
    'except_pass': ('typed-errors', '''\
        def f():
            try:
                g()
            except Exception:
                pass
        ''', 'fleet/anything.py', [4]),
    'narrowed_except_pass': ('typed-errors', '''\
        def f():
            try:
                g()
            except (OSError, KeyError):
                pass
        ''', 'fleet/anything.py', []),
    'message_match': ('typed-errors', '''\
        def f():
            try:
                g()
            except ValueError as exc:
                if 'session closed' in str(exc):
                    return None
                raise
        ''', 'shard/router.py', [5]),
    'isinstance_dispatch': ('typed-errors', '''\
        from automerge_tpu_torch.errors import SessionClosed


        def f():
            try:
                g()
            except ValueError as exc:
                if isinstance(exc, SessionClosed):
                    return None
                raise
        ''', 'shard/router.py', []),
    'raw_dict_stats': ('counter-discipline', '''\
        _stats = {'decoded': 0, 'rejected': 0}
        ''', 'fleet/newmod.py', [1]),
    'reserved_source': ('counter-discipline', '''\
        from automerge_tpu_torch.observability import register_health_source

        register_health_source('fleet3', lambda: 0)
        ''', 'fleet/newmod.py', [3]),
    'counters_pass': ('counter-discipline', '''\
        from automerge_tpu_torch.observability.metrics import Counters

        _stats = Counters({'decoded': 0})


        def summarize():
            link_stats = {}
            link_stats['x'] = 1
            return link_stats
        ''', 'fleet/newmod.py', []),
    'clock_and_random': ('determinism', '''\
        import random
        import time


        def tick():
            return time.time()


        def jitter():
            return random.random()
        ''', 'fleet/clock.py', [6, 10]),
    'seeded_rng': ('determinism', '''\
        import random
        import time


        def jitter(seed):
            return random.Random(seed).random()


        def stamp():
            return time.time()
        ''', 'fleet/clock.py', [10]),
    'clock_out_of_scope': ('determinism', '''\
        import time


        def stamp():
            return time.time()
        ''', 'observability/x.py', []),
    'unsorted_encode': ('determinism', '''\
        def encode_row(d, out):
            for k, v in d.items():
                out.append(k)
        ''', 'backend/enc.py', [2]),
    'sorted_encode': ('determinism', '''\
        def encode_row(d, out):
            for k, v in sorted(d.items()):
                out.append(k)
            all_ids = set()
            for inner in d.values():
                all_ids |= inner
        ''', 'backend/enc.py', []),
    'unlocked_state': ('lock-discipline', '''\
        _tbl = {}


        def put(k, v):
            _tbl[k] = v
        ''', 'observability/export.py', [5]),
    'locked_state': ('lock-discipline', '''\
        import threading

        from automerge_tpu_torch.observability.metrics import Counters

        _tbl = {}
        _LOCK = threading.Lock()
        _stats = Counters({'hits': 0})


        def put(k, v):
            with _LOCK:
                _tbl[k] = v
            _stats.inc('hits')
        ''', 'observability/export.py', []),
    'lock_rule_scope': ('lock-discipline', '''\
        _tbl = {}


        def put(k, v):
            _tbl[k] = v
        ''', 'frontend/views2.py', []),
}


def _as_ref(src):
    return src.replace('automerge_tpu_torch', 'automerge_tpu')


@pytest.mark.parametrize('case', sorted(NEUTRAL))
def test_neutral_rule_fixture(case):
    """Each fixture flags exactly the expected lines at the port's path,
    and the reference's rule on the reference's path finds the same
    lines with the same messages (the package name aside)."""
    rule, src, path, lines = NEUTRAL[case]
    found = violations(src, f'{PKG}/{path}', [rule])
    assert [f.line for f in found] == lines
    assert all(f.path == f'{PKG}/{path}' for f in found)
    ref = violations(_as_ref(src), f'automerge_tpu/{path}', [rule],
                     pkg=ref_analysis)
    assert [(f.line, f.rule, _as_ref(f.message)) for f in found] == \
        [(f.line, f.rule, f.message) for f in ref]


def test_neutral_fixture_messages():
    found = violations(NEUTRAL['decode_bare_raise'][1],
                       f'{PKG}/backend/wire.py', ['typed-errors'])
    assert 'decode_frame' in found[0].message
    assert 'automerge_tpu_torch.errors' in found[0].message
    found = violations(NEUTRAL['message_match'][1],
                       f'{PKG}/shard/router.py', ['typed-errors'])
    assert 'typed class' in found[0].message
    found = violations(NEUTRAL['raw_dict_stats'][1],
                       f'{PKG}/fleet/newmod.py', ['counter-discipline'])
    assert 'Counters' in found[0].message
    found = violations(NEUTRAL['unsorted_encode'][1],
                       f'{PKG}/backend/enc.py', ['determinism'])
    assert 'sorted' in found[0].message
    found = violations(NEUTRAL['unlocked_state'][1],
                       f'{PKG}/observability/export.py',
                       ['lock-discipline'])
    assert 'race candidate' in found[0].message


# ---------------------------------------------------------------------------
# rule: kernel-ledger (the torch form)
# ---------------------------------------------------------------------------

class TestKernelLedger:
    def test_unbound_wrappers_and_decorators_detected(self):
        src = '''\
        import functools

        import torch

        from automerge_tpu_torch.observability.perf import instrument_kernel


        @instrument_kernel
        def f(x):
            return x


        def g(x):
            return instrument_kernel('g', f)(x)


        @functools.partial(instrument_kernel, 'h')
        def h(x):
            return x


        k = torch.compile(f)
        '''
        found = violations(src, f'{PKG}/fleet/newkern.py',
                           ['kernel-ledger'])
        assert [f.line for f in found] == [8, 14, 17, 22]

    def test_rebound_entry_points_pass(self):
        src = '''\
        import torch

        from automerge_tpu_torch.observability.perf import instrument_kernel


        def _impl(state, ops):
            return state


        apply_k = instrument_kernel('apply_k', _impl)
        fast_k = instrument_kernel('fast_k', torch.compile(_impl))
        '''
        assert violations(src, f'{PKG}/fleet/newkern.py',
                          ['kernel-ledger']) == []

    def test_per_doc_torch_loop_detected(self):
        src = '''\
        import torch


        def pump(docs):
            out = []
            for d in docs:
                out.append(torch.as_tensor(d))
            return out
        '''
        found = violations(src, f'{PKG}/service/pump.py', ['kernel-ledger'])
        assert len(found) == 1 and found[0].line == 7
        assert 'per-doc loop' in found[0].message

    def test_per_class_pool_loop_passes(self):
        src = '''\
        import torch


        def grow(pools):
            for cls, st in pools.items():
                pools[cls] = torch.zeros(st)
        '''
        assert violations(src, f'{PKG}/fleet/loader2.py',
                          ['kernel-ledger']) == []

    def test_jnp_is_not_a_torch_dispatch(self):
        """The reference's per-doc jnp fixture flags there, not here."""
        src = '''\
        import jax.numpy as jnp


        def pump(docs):
            return [jnp.asarray(d) for d in docs] + \\
                [jnp.asarray(d) for d in range(1)]
        '''
        loop = '''\
        import jax.numpy as jnp


        def pump(docs):
            out = []
            for d in docs:
                out.append(jnp.asarray(d))
            return out
        '''
        assert violations(src, f'{PKG}/service/pump.py',
                          ['kernel-ledger']) == []
        assert violations(loop, f'{PKG}/service/pump.py',
                          ['kernel-ledger']) == []
        assert len(violations(loop, 'automerge_tpu/service/pump.py',
                              ['kernel-ledger'], pkg=ref_analysis)) == 1


# ---------------------------------------------------------------------------
# suppression + baseline round-trip
# ---------------------------------------------------------------------------

VIOLATING = '''_tbl = {}


def put(k, v):
    # archlint: ok[lock-discipline] fixture: registration is import-time only
    _tbl[k] = v
'''


class TestSuppressionBaseline:
    def _write(self, root, body):
        mod = os.path.join(root, PKG, 'observability')
        os.makedirs(mod, exist_ok=True)
        path = os.path.join(mod, 'export.py')
        with open(path, 'w') as fh:
            fh.write(body)
        return path

    def test_round_trip(self, tmp_path):
        root = str(tmp_path)
        self._write(root, VIOLATING)
        bl = os.path.join(root, 'baseline.json')
        rules = analysis.get_rules(['lock-discipline'])
        findings, _, _ = analysis.lint_paths([PKG], rules, root=root)
        assert len(findings) == 1 and findings[0].suppressed
        checked = analysis.check_findings(findings,
                                          analysis.load_baseline(bl))
        assert not checked['violations'] and len(checked['unlisted']) == 1
        entries = analysis.write_baseline(bl, findings)
        assert entries[0]['justification'].startswith('fixture:')
        checked = analysis.check_findings(findings,
                                          analysis.load_baseline(bl))
        assert not (checked['violations'] or checked['unlisted'] or
                    checked['stale'])
        self._write(root, VIOLATING.replace(
            '    # archlint: ok[lock-discipline] fixture: registration '
            'is import-time only\n', ''))
        findings, _, _ = analysis.lint_paths([PKG], rules, root=root)
        checked = analysis.check_findings(findings,
                                          analysis.load_baseline(bl))
        assert len(checked['violations']) == 1
        assert len(checked['stale']) == 1

    @pytest.mark.parametrize('marker,suppressed', [
        ('ok[lock-discipline]', False), ('ok[determinism]', False)],
        ids=['unjustified', 'wrong-rule'])
    def test_bad_markers_do_not_suppress(self, tmp_path, marker,
                                         suppressed):
        body = VIOLATING.replace('ok[lock-discipline]', marker)
        if marker == 'ok[lock-discipline]':
            body = body.replace('fixture: registration is import-time '
                                'only', '')
        self._write(str(tmp_path), body)
        findings, _, _ = analysis.lint_paths(
            [PKG], analysis.get_rules(['lock-discipline']),
            root=str(tmp_path))
        assert len(findings) == 1 and findings[0].suppressed == suppressed
        if marker == 'ok[lock-discipline]':
            assert 'no justification' in findings[0].message


# ---------------------------------------------------------------------------
# the tier-1 gate: the port's tree is clean under its checked-in baseline
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_checked_in_baseline():
    proc = subprocess.run(
        [sys.executable, '-m', 'automerge_tpu_torch.analysis', '--check',
         '--json', '-'],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload['violations'] == 0
    assert payload['unlisted'] == 0 and payload['stale'] == []
    assert len(payload['rules']) == 5
    assert payload['files'] > 80
    assert payload['baseline_size'] <= 10
    assert all(f['justification'] for f in payload['findings']
               if f['suppressed'])


def test_list_rules():
    proc = subprocess.run(
        [sys.executable, '-m', 'automerge_tpu_torch.analysis',
         '--list-rules'], cwd=REPO, capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0
    assert [line.split()[0] for line in proc.stdout.splitlines()] == \
        [cls.rule_id for cls in analysis.ALL_RULES]


def test_scope_tables_name_real_files():
    # a scope table pointing at renamed/deleted modules checks nothing
    for rel in sorted(scopes.FUNNEL_MODULES | scopes.THREADED_MODULES):
        assert os.path.exists(os.path.join(REPO, rel)), rel
    # every threaded module of the reference has its port counterpart
    from automerge_tpu.analysis import scopes as ref_scopes
    assert {p.replace('automerge_tpu/', f'{PKG}/', 1)
            for p in ref_scopes.THREADED_MODULES} <= scopes.THREADED_MODULES
    assert {p.replace('automerge_tpu/', f'{PKG}/', 1)
            for p in ref_scopes.FUNNEL_MODULES} == scopes.FUNNEL_MODULES


def test_fixed_jit_entry_points_are_in_the_ledger():
    """The mesh kinds and the kernels of the reference's pin carry their
    ledger kinds, and the kinds are registered at import."""
    assert registers.visible_registers.kernel_kind == 'visible_registers'
    mesh = sharding.fleet_mesh(['cpu'])
    for factory, kind in (
            (sharding.sharded_seq_apply, 'sharded_seq_apply'),
            (sharding.sharded_long_seq_apply, 'sharded_long_seq_apply'),
            (sharding.sharded_long_seq_materialize,
             'sharded_long_seq_materialize'),
            (sharding.sharded_apply, 'sharded_apply')):
        assert factory(mesh).kernel_kind == kind
    assert exchange.exchange_changes.kernel_kind == 'exchange_all_to_all'
    kinds = set(perf.kernel_kinds())
    assert {'visible_registers', 'sharded_apply', 'sharded_seq_apply',
            'sharded_long_seq_apply', 'sharded_long_seq_materialize',
            'exchange_all_to_all'} <= kinds
    assert 'pallas_apply_op_batch' not in kinds
