"""Build and load the port's native libraries.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled with nvcc into `posenet_tpu_torch/_build/<name>-<hash>.so`, keyed
by a hash of the source and the flags, and loaded with ctypes; later calls
in the process reuse the loaded library. What the compiler printed (with
`-Xptxas -v`: each kernel's registers, stack frame and spills) is kept
beside it as `<name>-<hash>.log` (`build_log`). Host C++ sources (the repo's
`native/preprocess.cpp`) are built the same way with the host compiler
(`build_host`), keyed also by the CPU target that `-march=native` resolves
to. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR / '_build'

# -fmad=false: no a*b+c contraction, so every product and sum rounds as in
# the plain PyTorch versions (the decoder's cell math is bit-exact; the
# sepconv kernel's explicit fused multiply-adds are exact-product ones).
# Division stays IEEE (nvcc's default -prec-div=true; no fast math).
# -Xptxas -v: ptxas reports each kernel's registers, stack frame and spills.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')
# The flags of native/Makefile (CXXFLAGS, then LDFLAGS). -march=native ties
# a build to the CPU it was made on, so the key of a host build also holds
# what it resolves to (`host_target`).
HOST_CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall',
                  '-shared', '-pthread')

_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME, else the toolkit's default
    install location. Raises if there is none."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    candidate = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        'nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA '
        'kernels are built from source at first use')


def cxx_path() -> str:
    """The host C++ compiler (g++, else c++) from PATH. Raises if there is
    none."""
    found = shutil.which('g++') or shutil.which('c++')
    if found:
        return found
    raise RuntimeError('no host C++ compiler (g++ or c++) on PATH: the native '
                       'host library is built from source at first use')


@functools.lru_cache(maxsize=None)
def host_target(compiler: str) -> str:
    """The target options `-march=native` resolves to on this machine, as
    the compiler reports them (`-Q --help=target`, GCC's query)."""
    done = subprocess.run([compiler, '-march=native', '-Q', '--help=target'],
                          capture_output=True, text=True)
    return done.stdout + done.stderr


def _compile(src: Path, name: str, compiler: str, flags: Sequence[str],
             target: str = '') -> Path:
    """Compile `src` into `_build/<name>-<hash>.so` unless the build of this
    source with these flags for this `target` is already there; returns the
    library's path; the compiler's output goes to the same path with the
    suffix `.log`. Raises RuntimeError, with that output, if the compile
    fails."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(' '.join(flags).encode())
    digest.update(target.encode())
    out = BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
        done = subprocess.run([compiler, *flags, '-o', str(tmp), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f'{os.path.basename(compiler)} failed on {src.name} '
                               f'(exit {done.returncode}):\n{done.stdout}{done.stderr}')
        out.with_suffix('.log').write_text(done.stdout + done.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` with nvcc (see `_compile`)."""
    return _compile(_SRC_DIR / f'{name}.cu', name, nvcc_path(), NVCC_FLAGS)


def build_log(name: str) -> str:
    """What nvcc printed when it built `csrc/<name>.cu` (see `build`)."""
    return build(name).with_suffix('.log').read_text()


def build_host(src: Path) -> Path:
    """Compile the host C++ source `src` with `HOST_CXX_FLAGS` for this
    machine's CPU (see `_compile`, `host_target`); the library is named
    after the source's stem."""
    cxx = cxx_path()
    return _compile(src, src.stem, cxx, HOST_CXX_FLAGS, host_target(cxx))


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """`build` for each name, one nvcc process each, all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
