"""The torch port stands alone: importing it pulls in neither jax nor
the JAX package, no source file of the port (or chip_smoke.py) imports
them, and a fleet built without a device on a CUDA-less machine raises
instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'automerge_tpu_torch')


def _sources():
    out = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _dirs, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _forbidden(module):
    top = module.split('.')[0]
    return top in ('jax', 'jaxlib') or top == 'automerge_tpu'


def test_import_leaves_jax_and_reference_out():
    code = ('import sys\n'
            'import automerge_tpu_torch, automerge_tpu_torch.fleet.backend\n'
            'import automerge_tpu_torch.fleet.seq_cases\n'
            'import automerge_tpu_torch.fleet.durability, '
            'automerge_tpu_torch.fleet.storage\n'
            'import automerge_tpu_torch.fleet.tiering, '
            'automerge_tpu_torch.fleet.crash_cases\n'
            'import automerge_tpu_torch.frontend, automerge_tpu_torch.query\n'
            'import automerge_tpu_torch.api_cases\n'
            'import automerge_tpu_torch.query.subscriptions, '
            'automerge_tpu_torch.query.timetravel\n'
            'import automerge_tpu_torch.fleet.faults\n'
            'import automerge_tpu_torch.observability.perf, '
            'automerge_tpu_torch.observability.slo, '
            'automerge_tpu_torch.observability.export\n'
            # the service's core loads lazily: the fleet (faults.py takes
            # service.backoff) must not pull it in
            'assert "automerge_tpu_torch.service.core" not in sys.modules\n'
            'import automerge_tpu_torch.service, '
            'automerge_tpu_torch.service.core\n'
            'import automerge_tpu_torch.service_cases\n'
            'import automerge_tpu_torch.shard, '
            'automerge_tpu_torch.shard.cluster, '
            'automerge_tpu_torch.shard.ring\n'
            'import automerge_tpu_torch.control, '
            'automerge_tpu_torch.control.controller, '
            'automerge_tpu_torch.control.policies, '
            'automerge_tpu_torch.control.signals\n'
            'import automerge_tpu_torch.shard_cases\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "automerge_tpu")]\n'
            'assert not bad, bad\n'
            'print("ISOLATED")\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'ISOLATED' in proc.stdout


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{path}:{node.lineno} imports {bad}'


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from automerge_tpu_torch.fleet.backend import DocFleet, default_fleet
    with pytest.raises(RuntimeError, match='CUDA'):
        DocFleet()
    with pytest.raises(RuntimeError, match='CUDA'):
        default_fleet()
    assert DocFleet(device='cpu').device == torch.device('cpu')
