"""Build and load the port's hand-written CUDA kernels.

Each source under tensoflow_tpu_torch/csrc/ is compiled by ``nvcc`` for
sm_90a into its own shared library with a plain C interface (bound with
ctypes), at first use.  Libraries go to ``build/kernels/`` at the repo
root (listed in .gitignore), named by a hash of their sources, so a
changed source is rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent code only calls nvcc when a kernel is first needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# extra -D flags (measurement builds, see bench/stencil_phases.py): part of
# a library's name, so such a build never stands in for the real one
DEFINES: Tuple[str, ...] = ()

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which('nvcc')
    if path is None:
        cand = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                            'bin', 'nvcc')
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return path


def _lib_path(name: str, defines: Sequence[str] | None = None) -> str:
    h = hashlib.sha256(' '.join(DEFINES if defines is None
                                else defines).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith(('.cu', '.cuh')):
            with open(os.path.join(CSRC, fn), 'rb') as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f'lib{name}_{h.hexdigest()[:12]}.so')


def build(names: Sequence[str],
          variants: Sequence[Sequence[str]] | None = None):
    """Compile csrc/<name>.cu for every name not yet built, one nvcc per
    source (and per set of -D flags in `variants`, default: DEFINES alone),
    all started together; nvcc's output goes to build/kernels/<name>.log
    (<name>.<flags>.log for a measurement build).  Raises with that output
    on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for defines in (variants if variants is not None else [DEFINES]):
        for name in names:
            out = _lib_path(name, defines)
            if os.path.exists(out):
                continue
            cmd = [_nvcc(), *NVCC_FLAGS, *defines, '-o', out + '.tmp',
                   os.path.join(CSRC, name + '.cu')]
            tag = '.'.join([name] + [d[2:] if d.startswith('-D') else d
                                     for d in defines])
            procs[tag] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for name, (out, p) in procs.items():
        log, _ = p.communicate()
        with open(os.path.join(BUILD_DIR, name + '.log'), 'wb') as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f'{name}: nvcc exit {p.returncode}\n'
                          + log.decode(errors='replace')[-4000:])
            continue
        os.replace(out + '.tmp', out)
    if errors:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))


def build_host(src: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the host C++ source ``src`` (a plain C interface) with g++
    into ``build_dir`` unless a library of the same source is already
    there; returns its path.  A failed build raises."""
    with open(src, 'rb') as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    name = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(build_dir, f'lib{name}_{tag}.so')
    if not os.path.exists(out):
        os.makedirs(build_dir, exist_ok=True)
        subprocess.check_call(['g++', '-O3', '-shared', '-fPIC',
                               '-std=c++17', src, '-o', out + '.tmp'])
        os.replace(out + '.tmp', out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get((name, DEFINES))
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[(name, DEFINES)] = lib
    return lib


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch wrapper."""
    if err != 0:
        hint = (' (cudaErrorInvalidValue: also returned for a shape the '
                'kernel does not take)' if err == 1 else '')
        raise RuntimeError(f'{what}: CUDA error {err}{hint}')
