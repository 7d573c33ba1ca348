"""ctypes binding for the native C++ host preprocessing library.

The counterpart of `posenet_tpu.native_preprocess`, over the same source,
the repository's `native/preprocess.cpp`: fixed-point bilinear resize
(cv2.INTER_LINEAR convention) with a fused BGR -> RGB swap and a
thread-pool batch path. Where the JAX package loads a library that
`make -C native` built, the port builds it itself at first use, with the
host C++ compiler and the flags of `native/Makefile`, into
`posenet_tpu_torch/_build/` (`ops._build.build_host`); a failed build
raises with the compiler's output.

The native resize agrees with cv2 within +-1 uint8 LSB, not bitwise: its
vertical pass keeps the full intermediate precision where cv2's SIMD path
truncates to 16 bits (see the header of preprocess.cpp). On a host
without cv2 (the card's machine has none) it is the only host resize.

This is the host half of the serving data path: it emits uint8 RGB frames
at the model resolution, and normalization runs on the device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from posenet_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent.parent / 'native' / 'preprocess.cpp'

_U8P = ctypes.POINTER(ctypes.c_uint8)
_lib: Optional[ctypes.CDLL] = None
# Why the library could not be built, once `native_available()` said so.
build_error: Optional[str] = None


def _load() -> ctypes.CDLL:
    """The library, built from `SOURCE` and bound at first use."""
    global _lib
    if _lib is None:
        if not SOURCE.exists():
            raise RuntimeError(f'{SOURCE} not found: the native host library '
                               f'is built from the repository\'s source')
        lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
        lib.posenet_resize_bilinear.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.posenet_resize_bilinear.restype = None
        lib.posenet_resize_batch.argtypes = [
            ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.posenet_resize_batch.restype = None
        lib.posenet_resize_normalize.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.posenet_resize_normalize.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native library is built and loaded, building it at the
    first call; when it is not, `build_error` says why."""
    global build_error
    try:
        _load()
    except (RuntimeError, OSError) as e:   # no source or compiler, a failed build or load
        build_error = str(e)
        return False
    build_error = None
    return True


def _frame(img: np.ndarray) -> np.ndarray:
    """A C-contiguous uint8 (H, W, 3) array, or ValueError."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected a uint8 (H, W, 3) frame, got {img.dtype} {img.shape}')
    return img


def resize_rgb(frame_bgr: np.ndarray, dst_hw: Tuple[int, int],
               backend: str = 'auto') -> np.ndarray:
    """uint8 BGR HWC -> uint8 RGB (dst_h, dst_w, 3): the serving request
    threads' resize.

    backend:
      'auto'   - cv2 resize + cvtColor when cv2 is importable (faster than
                 the native library where cv2 exists, in the JAX package's
                 measurements), else the native library;
      'native' - the native library;
      'cv2'    - cv2 (raises ImportError if it is not importable).
    """
    dh, dw = dst_hw
    if backend not in ('auto', 'native', 'cv2'):
        raise ValueError(f'unknown resize backend {backend!r}')
    if backend != 'native':
        try:
            import cv2
        except ImportError:
            if backend == 'cv2':
                raise
        else:
            resized = cv2.resize(frame_bgr, (dw, dh), interpolation=cv2.INTER_LINEAR)
            return cv2.cvtColor(resized, cv2.COLOR_BGR2RGB)
    return resize_bilinear(frame_bgr, dst_hw, swap_rb=True)


def resize_bilinear(img: np.ndarray, dst_hw: Tuple[int, int],
                    swap_rb: bool = False) -> np.ndarray:
    """uint8 HWC (H, W, 3) -> (dst_h, dst_w, 3), optionally BGR -> RGB, in
    the native library."""
    lib = _load()
    img = _frame(img)
    dh, dw = dst_hw
    out = np.empty((dh, dw, 3), np.uint8)
    lib.posenet_resize_bilinear(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1],
                                out.ctypes.data_as(_U8P), dh, dw, int(swap_rb))
    return out


def resize_batch(images: List[np.ndarray], dst_hw: Tuple[int, int],
                 swap_rb: bool = True) -> np.ndarray:
    """uint8 HWC frames of any sizes -> (N, dst_h, dst_w, 3), on the native
    library's thread pool. swap_rb=True by default: BGR files in, an RGB
    batch out."""
    lib = _load()
    images = [_frame(im) for im in images]
    n = len(images)
    dh, dw = dst_hw
    out = np.empty((n, dh, dw, 3), np.uint8)
    src_ptrs = (_U8P * n)(*[im.ctypes.data_as(_U8P) for im in images])
    src_hs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    src_ws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    lib.posenet_resize_batch(ctypes.cast(src_ptrs, ctypes.POINTER(_U8P)), src_hs, src_ws,
                             out.ctypes.data_as(_U8P), n, dh, dw, int(swap_rb))
    return out


def resize_normalize(img: np.ndarray, dst_hw: Tuple[int, int],
                     swap_rb: bool = True) -> np.ndarray:
    """uint8 HWC -> float32 (dst_h, dst_w, 3) in [-1, 1], in the native
    library (host-side normalization)."""
    lib = _load()
    img = _frame(img)
    dh, dw = dst_hw
    out = np.empty((dh, dw, 3), np.float32)
    lib.posenet_resize_normalize(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1],
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 dh, dw, int(swap_rb))
    return out
