"""Tiny versions of the cells, on the CPU, for the benchmark's tests."""

import json
import os
import shutil
import tempfile

from portbench import run

SEED = 2 ** 33 + 12345        # larger than 32 signed bits hold
CELLS = ('map-batch-10k', 'text-batch-1k', 'map-sync-20k',
         'map-service-10k')


# the cells built but not in BENCHMARK.json yet (PERF.md, Open
# questions): their drivers are kept and tested here
def _metric(name, unit, source, layer, moves, cell):
    return {'name': name, 'unit': unit, 'better': 'lower', 'source': source,
            'layer': layer, 'moves': moves, 'workloads': [cell]}


HUB_MAP = {'name': 'hub-map-10k',
           'source': 'https://github.com/automerge/automerge-classic/blob/'
                     'main/test/backend_test.js',
           'file': 'portbench/configs/hub-map-10k.json', 'reduced': [],
           'why': 'BASELINE configs 1 and 4: 10,000 two-actor map docs'}

EXTRA = {
    'map-batch-10k': {
        'workload': {'name': 'map-batch-10k', 'config': 'hub-map-10k',
                     'traffic': 'map-batch', 'chips': 1},
        'end_to_end': {'name': 'changes_per_s', 'unit': 'changes/s',
                       'better': 'higher', 'source': 'host_clock',
                       'workloads': ['map-batch-10k']},
        'per_layer': [
            _metric(n, u, s, layer, 'changes_per_s', 'map-batch-10k')
            for n, u, s, layer in (
                ('turbo_host_ms.changes', 'ms', 'program_span',
                 'batch entry'),
                ('dispatch_ms.changes', 'ms', 'program_span', 'dispatch'),
                ('merge_roofline.changes', '%', 'device_trace', 'kernels'),
                ('device_idle.changes', 'fraction', 'device_trace',
                 'device'),
                ('gc_share.changes', 'fraction', 'host_clock',
                 'interpreter'))]},
    'map-sync-20k': {
        'workload': {'name': 'map-sync-20k', 'config': 'hub-map-10k',
                     'traffic': 'reconnect', 'chips': 1},
        'end_to_end': {'name': 'links_per_s', 'unit': 'links/s',
                       'better': 'higher', 'source': 'host_clock',
                       'workloads': ['map-sync-20k']},
        'per_layer': [
            _metric(n, u, s, layer, 'links_per_s', 'map-sync-20k')
            for n, u, s, layer in (
                ('sync_host_ms.links', 'ms', 'program_span', 'sync round'),
                ('sync_kernels_roofline.links', '%', 'device_trace',
                 'kernels'),
                ('device_idle.links', 'fraction', 'device_trace', 'device'),
                ('gc_share.links', 'fraction', 'host_clock',
                 'interpreter'))]},
    'map-service-10k': {
        'workload': {'name': 'map-service-10k', 'config': 'hub-map-10k',
                     'traffic': 'service-open', 'chips': 1},
        'end_to_end': {'name': 'req_p99_ms', 'unit': 'ms',
                       'better': 'lower', 'source': 'host_clock',
                       'workloads': ['map-service-10k']},
        'per_layer': [
            _metric(n, u, s, layer, 'req_p99_ms', 'map-service-10k')
            for n, u, s, layer in (
                ('service_tick_ms.req', 'ms', 'program_span', 'service'),
                ('client_share.req', 'fraction', 'host_clock',
                 'load generator'),
                ('device_idle.req', 'fraction', 'device_trace', 'device'),
                ('gc_share.req', 'fraction', 'host_clock',
                 'interpreter'))]}}


def _load(cell, root):
    if cell not in EXTRA:
        return run.load_cell(cell, root)
    bench = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    if all(c['name'] != HUB_MAP['name'] for c in bench['configs']):
        bench['configs'].append(HUB_MAP)
    bench['workloads'].append(EXTRA[cell]['workload'])
    bench['end_to_end'].append(EXTRA[cell]['end_to_end'])
    bench['per_layer'] += EXTRA[cell]['per_layer']
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ('configs', 'traffic'):
            shutil.copytree(os.path.join(root, 'portbench', sub),
                            os.path.join(tmp, 'portbench', sub))
        with open(os.path.join(tmp, 'BENCHMARK.json'), 'w') as fh:
            json.dump(bench, fh)
        return run.load_cell(cell, tmp)


def tiny(cell, root=run.ROOT, docs=32):
    """(bench, cell, cfg, traffic) of `cell` cut to `docs` docs and short
    epochs."""
    bench, c, cfg, traffic = _load(cell, root)
    cfg = dict(cfg, docs=docs)
    if cfg['kind'] == 'text':
        cfg['history_ops'] = 400
        traffic = dict(traffic, epoch_batches=3)
    elif traffic['driver'] == 'batch_loop':
        traffic = dict(traffic, epoch_batches=4)
    elif traffic['driver'] == 'service_open':
        traffic = dict(traffic, rate_per_s=150.0, warm_s=0.3)
    return bench, c, cfg, traffic


def run_tiny(cell, seconds=0.3, trace=False, control=False, root=run.ROOT,
             seed=SEED):
    bench, c, cfg, traffic = tiny(cell, root)
    return run.run_cell(bench, c, cfg, traffic, seed, seconds, trace,
                        device='cpu', control=control, root=root)
