#!/usr/bin/env python3
"""The benchmark of automerge_tpu_torch, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json, its configuration from the file
that names, its traffic from portbench/traffic/<traffic>.json and the
driver that traffic names from portbench/drivers/<driver>.py. Set-up
builds the documents from the seed, loads them onto the card and warms
the cell's own shapes; then the window runs for `--seconds`; then the
program's answers are read back from the card, its state is freed and
the answers are held to the plain reference (portbench/reference/).
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics, each read by
portbench/metrics/<name>.py), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number with its limit. The same checks
end standard error.

`--control 1` (never part of a measured run) puts the reference with
one broken guarantee in the program's place after the window: the run
must come out not correct.
"""

import os
import sys
import time

# one hash seed for every run: the program's sets and dicts then iterate
# alike from run to run (the interpreter fixes it only at start-up)
if __name__ == '__main__' and os.environ.get('PYTHONHASHSEED') != '0':
    os.execve(sys.executable,
              [sys.executable, os.path.abspath(__file__)] + sys.argv[1:],
              dict(os.environ, PYTHONHASHSEED='0'))

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'portbench')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'automerge_tpu')
# run as a script, the script's own folder would come first on the path
# and its modules would shadow top-level ones: put the checkout there
if sys.path and os.path.abspath(sys.path[0] or '.') == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `automerge_tpu_torch` is not
    `automerge_tpu`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split('.', 1)[0] in FORBIDDEN)


def load_cell(name, root=ROOT):
    """(benchmark, cell, configuration, traffic) for workload `name`."""
    with open(os.path.join(root, 'BENCHMARK.json')) as fh:
        bench = json.load(fh)
    cell = next((w for w in bench['workloads'] if w['name'] == name), None)
    if cell is None:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    entry = next(c for c in bench['configs'] if c['name'] == cell['config'])
    with open(os.path.join(root, entry['file'])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, 'portbench', 'traffic',
                           cell['traffic'] + '.json')) as fh:
        traffic = json.load(fh)
    return bench, cell, cfg, traffic


def cell_metrics(bench, cell, trace):
    """The metrics this cell reports: its end-to-end ones, or with
    `trace` its per-layer ones."""
    e2e = [m for m in bench['end_to_end']
           if cell['name'] in m.get('workloads', [cell['name']])]
    if not trace:
        return e2e
    moved = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if (cell['name'] in m['workloads'] if 'workloads' in m
                else m['moves'] in moved)]


def reader(name, root=ROOT):
    """The reader of per-layer metric `name`: metrics/<name>.py, else
    metrics/<name up to its first dot>.py."""
    importlib.import_module('portbench.metrics')
    for stem in (name, name.split('.', 1)[0]):
        path = os.path.join(root, 'portbench', 'metrics', stem + '.py')
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                'portbench.metrics.' + stem.replace('.', '_'), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f'no reader for metric {name!r}')


def card_line():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi: not available'


def run_cell(bench, cell, cfg, traffic, seed, seconds, trace,
             device='cuda', control=False, root=ROOT):
    """One run; returns (result dict, checks [(name, value, limit)])."""
    import torch
    from portbench import trace as tr
    phases = {}
    t = time.perf_counter()
    if device != 'cpu':
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    phases['cuda_init_s'] = time.perf_counter() - t
    t = time.perf_counter()
    from automerge_tpu_torch import native
    from automerge_tpu_torch.fleet import backend as _backend  # noqa: F401
    native.available()
    phases['library_s'] = time.perf_counter() - t
    drive = importlib.import_module(f'portbench.drivers.{traffic["driver"]}')
    driver = drive.make(cfg, traffic, seed, device, log)
    driver.setup(phases)
    # every window starts from an empty collector: its collections then
    # fall at the same points of the same work from run to run
    gc.collect()
    if device != 'cpu':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    log('setup: ' + ', '.join(f'{k} {v:.3f}' for k, v in phases.items()) +
        f', setup_s {setup_s:.3f}')

    with tr.Window(trace, device) as win:
        done, attempted, elapsed, steps = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated() if device != 'cpu' else 0
    summary = tr.summarize(win.events, win.spans, win.align_ns) \
        if trace else None
    log(f'window: {steps} steps, {done} {traffic["unit"]} done of '
        f'{attempted}, {elapsed:.3f} s, memory peak {peak} B')

    got = driver.answers()
    gc.collect()
    if device != 'cpu':
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = driver.checks(got, control=control)
    log(f'check: {time.perf_counter() - t:.3f} s')

    metrics = {}
    if not trace:
        values = {'setup_s': setup_s}
        if hasattr(driver, 'end_to_end'):
            values.update(driver.end_to_end(done, elapsed))
        else:
            values[traffic['rate_metric']] = done / elapsed
        for m in cell_metrics(bench, cell, False):
            if m['name'] in values:
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}
    else:
        ctx = dict(steps=steps, step_counts=driver.step_counts,
                   summary=summary, spans=win.spans, window_s=win.wall_s,
                   gc_s=win.gc_s, cfg=cfg, traffic=traffic,
                   client_s=getattr(driver, 'client_s', None))
        for m in cell_metrics(bench, cell, True):
            value = reader(m['name'], root)(ctx, m['name'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {
        'correct': all(v <= lim for _n, v, lim in checks),
        'attempted': attempted, 'failed': driver.failed,
        'metrics': metrics,
        'device': {'platform': 'gpu' if device != 'cpu' else 'cpu',
                   'kind': torch.cuda.get_device_name(0)
                   if device != 'cpu' else 'cpu',
                   'count': cell['chips'], 'memory_peak_bytes': peak}}
    if trace:
        result['device'].update(busy_s=summary['busy_us'] / 1e6,
                                window_s=win.wall_s)
        result['breakdown'] = {
            'device_ops': [[n, us / 1e6] for n, us in summary['ops']],
            'idle_gaps': [[n, us / 1e6] for n, us in summary['idle_by_span']]}
    result['checks'] = {n: {'value': v, 'limit': lim}
                        for n, v, lim in checks}
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', type=int, choices=(0, 1), default=0)
    ap.add_argument('--rate', type=float, default=None,
                    help='offered rate for a sweep of an open-loop cell '
                    '(never part of a measured run)')
    args = ap.parse_args(argv)
    bench, cell, cfg, traffic = load_cell(args.workload)
    if args.rate is not None:
        traffic = dict(traffic, rate_per_s=args.rate)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        log(f'portbench: {args.workload} needs {cell["chips"]} CUDA '
            f'device(s); this machine has '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 3
    log(f'card: {card_line()}')
    result, checks = run_cell(bench, cell, cfg, traffic, args.seed,
                              args.seconds, bool(args.trace),
                              control=bool(args.control))
    found = forbidden_modules()
    if found:
        log(f'portbench: forbidden modules loaded: {found}')
        return 4
    for name, value, limit in checks:
        log(f'check {name} {value} limit {limit}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
