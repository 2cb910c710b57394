"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and entries only."""

import json
import os
import shutil

from portbench import run
from helpers import SEED

ROOT = run.ROOT


def test_a_new_cell_from_new_files_only(tmp_path):
    shutil.copytree(os.path.join(ROOT, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    before = {p: open(os.path.join(dp, p), 'rb').read()
              for dp, _d, fs in os.walk(tmp_path / 'portbench')
              for p in fs}
    pb = tmp_path / 'portbench'
    cfg = json.load(open(pb / 'configs' / 'hub-map-10k.json'))
    cfg.update(name='hub-map-wide', docs=24, keys=64, key_capacity=65,
               groups=4)
    (pb / 'configs' / 'hub-map-wide.json').write_text(json.dumps(cfg))
    (pb / 'traffic' / 'map-burst.json').write_text(json.dumps({
        'driver': 'batch_loop', 'unit': 'changes',
        'rate_metric': 'changes_per_s', 'changes_per_doc': 6,
        'concurrent_share': 0.5, 'epoch_batches': 3}))
    (pb / 'metrics' / 'steps_seen.py').write_text(
        'def read(ctx, name):\n    return float(ctx["steps"]) or None\n')
    bench['configs'].append({'name': 'hub-map-wide', 'source': 'x',
                             'file': 'portbench/configs/hub-map-wide.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'map-burst', 'config': 'hub-map-wide',
                               'traffic': 'map-burst', 'chips': 1,
                               'why': 'a test'})
    bench['end_to_end'].append({'name': 'changes_per_s',
                                'unit': 'changes/s', 'better': 'higher',
                                'bound': 0.25, 'source': 'host_clock',
                                'workloads': ['map-burst']})
    bench['per_layer'].append({'name': 'steps_seen', 'unit': 'steps',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'harness', 'moves': 'changes_per_s',
                               'workloads': ['map-burst']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    for trace in (False, True):
        b, cell, c, traffic = run.load_cell('map-burst', str(tmp_path))
        result, checks = run.run_cell(b, cell, c, traffic, SEED, 0.3, trace,
                                      device='cpu', root=str(tmp_path))
        assert result['correct'], checks
        assert set(result['metrics']) == (
            {'steps_seen'} if trace else {'setup_s', 'changes_per_s'})
    after = {p: open(os.path.join(dp, p), 'rb').read()
             for dp, _d, fs in os.walk(pb) for p in fs
             if p in before and '__pycache__' not in dp}
    assert after == {p: v for p, v in before.items() if p in after}
