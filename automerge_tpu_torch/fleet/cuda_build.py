"""Build and load the port's CUDA sources (fleet/csrc/*.cu).

Each source is a plain C interface over its kernels, compiled by nvcc
for sm_90a into a shared library and bound with ctypes (no PyTorch
headers, so a build takes seconds). `load(name, declare)` compiles
csrc/<name>.cu once per source content and flags into the package's
git-ignored `_build/` directory, loads it, lets `declare(lib)` set the
argument types, and caches the library for the process. Concurrent
builds (threads, or processes sharing the checkout) publish
atomically: an exclusive lock per source on the build directory, a
temporary name, then os.replace. A missing nvcc or a failed build
raises; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_libs = {}
_locks = {}
_locks_lock = threading.Lock()


def nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    if os.path.exists(cuda):
        return cuda
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built '
                       '(set CUDA_HOME or put nvcc on PATH)')


def library_path(name):
    """Where csrc/<name>.cu builds to: keyed by its content and flags."""
    src = os.path.join(CSRC, f'{name}.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f'lib{name}_{digest}.so')


def _compile(name):
    import fcntl
    src, path = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f'.{name}.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f'{path}.{os.getpid()}.tmp'
            proc = subprocess.run([nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed building {src}:\n'
                                   f'{proc.stderr}')
            os.replace(tmp, path)
    return path


def load(name, declare):
    """The ctypes library of csrc/<name>.cu, built on first use."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_compile(name))
            declare(lib)
            _libs[name] = lib
        return lib
