"""The port's host preprocessing: `preprocess.process_input`,
`process_input_fixed`, `read_imgfile` and `read_cap` against the JAX
package's functions (bit for bit: both are the same cv2 and numpy
operations), and `native_preprocess`, built from native/preprocess.cpp at
first use, against cv2 (within +-1 uint8 LSB, the documented bound of the
fixed-point resize) and against the JAX package's binding of the same
source (bit for bit)."""

import os

import numpy as np
import pytest

from posenet_tpu import native_preprocess as jax_npp
from posenet_tpu import preprocess as jax_pre

from posenet_tpu_torch import native_preprocess as npp
from posenet_tpu_torch import preprocess
from posenet_tpu_torch.ops import _build

cv2 = pytest.importorskip("cv2")


def _bgr(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _assert_same(ours, ref):
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("hw,scale_factor,stride", [
    ((240, 320), 1.0, 16), ((240, 320), 0.5, 16), ((97, 161), 1.0, 8),
    ((480, 640), 0.7125, 32)])
def test_process_input_matches_jax(hw, scale_factor, stride):
    img = _bgr(*hw)
    _assert_same(preprocess.process_input(img, scale_factor, stride),
                 jax_pre.process_input(img, scale_factor, stride))


@pytest.mark.parametrize("target_hw", [(257, 257), (200, 300)])
def test_process_input_fixed_matches_jax(target_hw):
    img = _bgr(180, 260, seed=1)
    ours = preprocess.process_input_fixed(img, target_hw, 16)
    _assert_same(ours, jax_pre.process_input_fixed(img, target_hw, 16))
    th, tw = ours[0].shape[2:]
    assert (th - 1) % 16 == 0 and (tw - 1) % 16 == 0


@pytest.mark.parametrize("target_hw", [None, (129, 129)])
def test_read_imgfile_matches_jax(tmp_path, target_hw):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, _bgr(150, 210, seed=2))
    _assert_same(preprocess.read_imgfile(path, 0.8, 16, target_hw),
                 jax_pre.read_imgfile(path, 0.8, 16, target_hw))
    with pytest.raises(IOError, match="could not read"):
        preprocess.read_imgfile(str(tmp_path / "missing.png"))


class _Cap:
    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return (True, self.frames.pop(0)) if self.frames else (False, None)


def test_read_cap_matches_jax():
    frame = _bgr(120, 200, seed=3)
    _assert_same(preprocess.read_cap(_Cap([frame]), 1.0, 16),
                 jax_pre.read_cap(_Cap([frame]), 1.0, 16))
    with pytest.raises(IOError, match="webcam failure"):
        preprocess.read_cap(_Cap([]))


RESIZES = [((720, 1280), (513, 513)), ((130, 260), (65, 65)), ((33, 47), (65, 97)),
           ((480, 640), (353, 481)), ((2, 3), (17, 17))]


@pytest.mark.parametrize("src_hw,dst_hw", RESIZES)
def test_native_resize_within_one_lsb_of_cv2(src_hw, dst_hw):
    img = _bgr(*src_hw, seed=4)
    ours = npp.resize_rgb(img, dst_hw, backend="native")
    ref = cv2.cvtColor(cv2.resize(img, (dst_hw[1], dst_hw[0]),
                                  interpolation=cv2.INTER_LINEAR), cv2.COLOR_BGR2RGB)
    assert ours.shape == (*dst_hw, 3) and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("src_hw,dst_hw", RESIZES)
def test_native_build_matches_jax_binding(src_hw, dst_hw):
    """The port's build of native/preprocess.cpp against the JAX package's
    binding of the `make -C native` build (tests/conftest.py makes it)."""
    if not jax_npp.native_available():
        pytest.skip("native/libposenet_preprocess.so was not built")
    img = _bgr(*src_hw, seed=5)
    for swap in (False, True):
        np.testing.assert_array_equal(npp.resize_bilinear(img, dst_hw, swap),
                                      jax_npp.resize_bilinear(img, dst_hw, swap))
    np.testing.assert_array_equal(npp.resize_normalize(img, dst_hw),
                                  jax_npp.resize_normalize(img, dst_hw))
    batch = [img, _bgr(src_hw[0] + 7, src_hw[1] + 3, seed=6)]
    np.testing.assert_array_equal(npp.resize_batch(batch, dst_hw),
                                  jax_npp.resize_batch(batch, dst_hw))


def test_resize_backends(monkeypatch):
    img = _bgr(100, 150, seed=7)
    via_cv2 = cv2.cvtColor(cv2.resize(img, (81, 49), interpolation=cv2.INTER_LINEAR),
                           cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(npp.resize_rgb(img, (49, 81)), via_cv2)
    np.testing.assert_array_equal(npp.resize_rgb(img, (49, 81), "cv2"), via_cv2)
    native = npp.resize_rgb(img, (49, 81), "native")
    np.testing.assert_array_equal(native, npp.resize_bilinear(img, (49, 81), swap_rb=True))
    np.testing.assert_array_equal(native[..., ::-1], npp.resize_bilinear(img, (49, 81)))
    with pytest.raises(ValueError, match="unknown resize backend"):
        npp.resize_rgb(img, (49, 81), "gpu")
    with pytest.raises(ValueError, match="uint8"):
        npp.resize_bilinear(img.astype(np.float32), (49, 81))
    # a host without cv2, as the card's machine: 'auto' takes the library
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    np.testing.assert_array_equal(npp.resize_rgb(img, (49, 81)), native)
    with pytest.raises(ImportError):
        npp.resize_rgb(img, (49, 81), "cv2")


def test_host_build_is_keyed_and_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int posenet_answer() { return 42; }\n')
    first = _build.build_host(good)
    assert first.parent == tmp_path / "_build" and first.name.startswith("good-")
    assert _build.build_host(good) == first                # cached by hash
    monkeypatch.setattr(_build, "HOST_CXX_FLAGS", _build.HOST_CXX_FLAGS + ("-DX=1",))
    assert _build.build_host(good) != first                # the flags are in the key
    monkeypatch.setattr(_build, "host_target", lambda cxx: "-march=another-cpu")
    assert _build.build_host(good) != first                # so is the CPU's target
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match=r"(?s)failed on bad\.cpp.*error: "):
        _build.build_host(bad)
    assert not [p for p in os.listdir(tmp_path / "_build") if p.startswith("bad")]


def test_missing_source_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(npp, "SOURCE", tmp_path / "preprocess.cpp")
    monkeypatch.setattr(npp, "_lib", None)
    with pytest.raises(RuntimeError, match="not found"):
        npp.resize_bilinear(_bgr(4, 4), (2, 2))
