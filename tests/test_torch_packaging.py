"""tests/test_packaging.py's zip scenario for the torch port: imported
from a zip archive, the port's C++ codec cannot build next to its source,
so `native.available()` is False and the pure-Python codecs carry the
public API; the fleet backend (on the CPU) and the query engine run
there too."""

import os
import subprocess
import sys
import zipfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCENARIO = r"""
import sys
zip_path, = sys.argv[1:]
sys.path.insert(0, zip_path)
import automerge_tpu_torch as am
from automerge_tpu_torch import native
assert __import__('automerge_tpu_torch').__file__.startswith(zip_path), \
    'loaded from the wrong place'
assert not native.available(), 'zip import must not see a native codec'
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'automerge_tpu')]
assert not bad, bad

# end-to-end: concurrent edits, merge convergence, save/load, sync round
d1 = am.init('aa' * 4)
d1 = am.change(d1, lambda d: d.update(
    {'rows': [{'n': 1}], 't': am.Text('hi'), 'c': am.Counter(2)}))
d2 = am.merge(am.init('bb' * 4), d1)
d1 = am.change(d1, lambda d: d['c'].increment(3))
d2 = am.change(d2, lambda d: d['rows'][0].update({'n': 9}))
m1, m2 = am.merge(am.clone(d1), d2), am.merge(am.clone(d2), d1)
assert int(m1['c']) == int(m2['c']) == 5
assert m1['rows'][0]['n'] == m2['rows'][0]['n'] == 9
loaded = am.load(am.save(m1))
assert str(loaded['t']) == 'hi'

s1, s2 = am.init_sync_state(), am.init_sync_state()
peer = am.init('cc' * 4)
for _ in range(10):
    s1, msg = am.generate_sync_message(m1, s1)
    if msg is not None:
        peer, s2, _ = am.receive_sync_message(peer, s2, msg)
    s2, msg2 = am.generate_sync_message(peer, s2)
    if msg2 is not None:
        m1, s1, _ = am.receive_sync_message(m1, s1, msg2)
    if msg is None and msg2 is None:
        break
assert peer['rows'][0]['n'] == 9

# the fleet backend on the CPU, then a time-travel read and a quiet tick
from automerge_tpu_torch.fleet.backend import DocFleet, FleetBackend
from automerge_tpu_torch.query import SubscriptionHub, materialize_at
fleet = DocFleet(doc_capacity=4, key_capacity=8, device='cpu')
am.set_default_backend(FleetBackend(fleet))
try:
    f1 = am.load(am.save(m1))
    f1 = am.change(f1, {'time': 0}, lambda d: d['c'].increment(1))
    assert int(f1['c']) == 6 and f1['rows'][0]['n'] == 9
    handle = am.Frontend.get_backend_state(f1)
    old = materialize_at(handle, am.Backend().get_heads(
        am.Frontend.get_backend_state(m1)), fleet=fleet)
    assert bytes(old['state'].save()) == bytes(am.save(m1))
    hub = SubscriptionHub()
    hub.register('d', handle)
    sub = hub.subscribe('d')
    assert hub.tick()[sub.id]['kind'] == 'patch'
    assert hub.tick() == {}
finally:
    am.set_default_backend(am.backend)
print('ZIP-PACKAGED OK')
"""


def test_port_runs_from_zip_without_native_codec(tmp_path):
    zip_path = str(tmp_path / 'automerge_tpu_torch.zip')
    pkg = os.path.join(ROOT, 'automerge_tpu_torch')
    with zipfile.ZipFile(zip_path, 'w') as zf:
        for dirpath, _dirs, files in os.walk(pkg):
            for name in files:
                if name.endswith(('.py', '.cpp', '.cu', '.h')):
                    full = os.path.join(dirpath, name)
                    zf.write(full, os.path.relpath(full, ROOT))
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    scenario = str(tmp_path / 'scenario.py')
    with open(scenario, 'w') as f:
        f.write(_SCENARIO)
    proc = subprocess.run(
        [sys.executable, scenario, zip_path],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert 'ZIP-PACKAGED OK' in proc.stdout
