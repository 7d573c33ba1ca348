"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled with nvcc into `posenet_tpu_torch/_build/<name>-<hash>.so`, keyed
by a hash of the source and the flags, and loaded with ctypes; later calls
in the process reuse the loaded library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC')

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


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless the build of this source with these
    flags is already there; returns the library's path. Raises
    RuntimeError, with nvcc's output, if the compile fails."""
    src = _SRC_DIR / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        done = subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src.name} (exit {done.returncode}):\n'
                               f'{done.stdout}{done.stderr}')
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


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
