"""The run's last line and its refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run
from helpers import run_tiny

ROOT = run.ROOT


def test_last_line_shape():
    result, checks = run_tiny('map-batch-10k')
    keys = list(result)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics',
                        'device']
    assert keys[-1] == 'checks'
    assert set(result['device']) == {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    for m in result['metrics'].values():
        assert set(m) == {'value', 'unit'}
    assert result['checks'] == {n: {'value': v, 'limit': lim}
                                for n, v, lim in checks}
    json.dumps(result)


def test_traced_line_has_the_device_window_and_breakdown():
    result, _ = run_tiny('text-batch-1k', trace=True)
    assert list(result)[-2:] == ['breakdown', 'checks']
    assert {'busy_s', 'window_s'} <= set(result['device'])
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    names = set(result['metrics'])
    assert names <= {m['name'] for m in json.load(
        open(os.path.join(ROOT, 'BENCHMARK.json')))['per_layer']}
    assert 'turbo_host_ms.text_ops' in names


def _run_script(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', **(extra_env or {}))
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'text-batch-1k',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run_script(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(os.path.join(ROOT, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_forbidden_names_compare_whole():
    mods = {'automerge_tpu_torch': 1, 'automerge_tpu_torch.fleet': 1,
            'jaxtyping': 1, 'numpy': 1}
    assert run.forbidden_modules(mods) == []
    mods.update({'jax': 1, 'jax.numpy': 1, 'automerge_tpu.fleet': 1,
                 'jaxlib': 1, 'flax': 1})
    assert run.forbidden_modules(mods) == [
        'automerge_tpu.fleet', 'flax', 'jax', 'jax.numpy', 'jaxlib']


def test_a_run_loads_no_jax():
    """A fresh interpreter that runs a tiny cell on the CPU has loaded
    nothing whose top-level name is jax, jaxlib, flax or automerge_tpu."""
    code = ('import sys; sys.path[:0] = [%r, %r]\n'
            'import helpers\n'
            'from portbench import run\n'
            'helpers.run_tiny("map-sync-20k", trace=True)\n'
            'helpers.run_tiny("text-batch-1k")\n'
            'print(run.forbidden_modules())\n') % (
                ROOT, os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != 'JAX_PLATFORMS'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    for cell in [w['name'] for w in bench['workloads']]:
        out = subprocess.run(
            [sys.executable, 'portbench/run.py', '--workload', cell,
             '--seed', str(2 ** 32 + 77), '--seconds', '3', '--trace', '0'],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])['correct']
