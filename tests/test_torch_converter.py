"""The port's tfjs converter and download (`posenet_tpu_torch.converter`)
against the JAX package's, and `load_model`'s cold start, on the CPU.

The checkpoint is tests/tfjs_fixture.py's, in the tfjs on-disk format, in
a temporary download cache. No test reaches the network: `download._fetch`
is stubbed in every test (`tests.torch_offline`, or a stub of the test's
own), and the cache directory is the test's. Tolerances: the variables,
the pytree and the `.npz` files bitwise; the cold-started model's float32
heads within 1e-4 of each head's scale of JAX's forward on the same
checkpoint (tests/test_torch_mobilenet.py's bar).
"""

import importlib
import json
import os
import tempfile
import urllib.error

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet_v1

from posenet_tpu_torch.converter import tfjs2torch, weights
from posenet_tpu_torch.models import MobileNetV1, load_model
from posenet_tpu_torch.pipeline import normalize

from tests import torch_tfjs_fixture
from tests.tfjs_fixture import synth_photo, write_tfjs_checkpoint
from tests.torch_offline import offline_download  # noqa: F401 (autouse)

# The modules: each converter package exports its function `download` under the name.
download = importlib.import_module('posenet_tpu_torch.converter.download')
jax_download = importlib.import_module('posenet_tpu.converter.download')
PORT_BASE_DIR = download.BASE_DIR   # before any test points it elsewhere
CHECKPOINT = 'mobilenet_v1_050'
HEADS = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')


@pytest.fixture(scope='module')
def tfjs_cache(tmp_path_factory):
    """A download cache holding the m50 fixture checkpoint."""
    root = str(tmp_path_factory.mktemp('tfjs'))
    write_tfjs_checkpoint(root, CHECKPOINT, model_id=50)
    return root


def _assert_trees_equal(got, ref):
    assert len(got['backbone']) == len(ref['backbone'])
    for g, r in zip(got['backbone'], ref['backbone']):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k])
    assert set(got['heads']) == set(ref['heads'])
    for name, r in ref['heads'].items():
        for k in r:
            np.testing.assert_array_equal(got['heads'][name][k], r[k])


def test_download_matches_the_jax_package():
    """The same bucket, and the same cache directory, as the JAX package's."""
    assert download.GOOGLE_CLOUD_STORAGE_DIR == jax_download.GOOGLE_CLOUD_STORAGE_DIR
    assert PORT_BASE_DIR == jax_download.BASE_DIR == os.path.join(
        tempfile.gettempdir(), '_posenet_weights')


def test_variables_and_pytree_bitwise_equal_to_tfjs2jax(tfjs_cache):
    ours = tfjs2torch.load_tfjs_variables(CHECKPOINT, base_dir=tfjs_cache)
    ref = tfjs2jax.load_tfjs_variables(CHECKPOINT, base_dir=tfjs_cache)
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name].dtype == ref[name].dtype and ours[name].shape == ref[name].shape
        np.testing.assert_array_equal(ours[name], ref[name])
    _assert_trees_equal(tfjs2torch.variables_to_pytree(ours, 50),
                        tfjs2jax.variables_to_pytree(ref, 50))


@pytest.mark.parametrize("model_id", [50, 75])
def test_jax_free_fixture_writes_the_same_checkpoint(tmp_path, model_id):
    """tests/torch_tfjs_fixture.py (for chip_smoke.py, no JAX) writes the
    bytes tests/tfjs_fixture.py writes."""
    name = f'mobilenet_v1_0{model_id}'
    a = write_tfjs_checkpoint(str(tmp_path / 'a'), name, model_id=model_id)
    b = torch_tfjs_fixture.write_tfjs_checkpoint(str(tmp_path / 'b'), name, model_id=model_id)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), 'rb') as fa, open(os.path.join(b, f), 'rb') as fb:
            assert fa.read() == fb.read(), f


def test_npz_is_read_bitwise_by_both_packages(tfjs_cache, tmp_path, monkeypatch):
    """The port's `.npz` read by both packages' `load_params_npz`, and the
    JAX package's read by the port's, equal to the converted pytree."""
    monkeypatch.chdir(tmp_path)   # no ./images/tennis_in_crowd.jpg: no self-check
    path = tfjs2torch.convert(50, str(tmp_path / 'models'), base_dir=tfjs_cache,
                              device='cpu')
    assert path == str(tmp_path / 'models' / (CHECKPOINT + '.npz'))
    assert os.listdir(tmp_path / 'models') == [CHECKPOINT + '.npz']   # no .tmp left
    ref = tfjs2jax.variables_to_pytree(
        tfjs2jax.load_tfjs_variables(CHECKPOINT, base_dir=tfjs_cache), 50)
    _assert_trees_equal(tfjs2jax.load_params_npz(path), ref)
    _assert_trees_equal(weights.load_params_npz(path), ref)

    jax_path = str(tmp_path / 'jax.npz')
    tfjs2jax.save_params_npz(jax_path, ref)
    _assert_trees_equal(weights.load_params_npz(jax_path), ref)


@pytest.mark.parametrize("drop,match", [
    ('MobilenetV1/Conv2d_3_pointwise/biases', "backbone layer 3 missing variables: {'pw_b'}"),
    ('MobilenetV1/Conv2d_0/weights', "backbone layer 0 missing variables: {'w'}"),
    ('MobilenetV1/offset_2/weights', "head offset missing variables"),
])
def test_extra_variables_skipped_and_a_missing_one_named(tfjs_cache, drop, match):
    variables = tfjs2torch.load_tfjs_variables(CHECKPOINT, base_dir=tfjs_cache)
    assert any('part_heatmap' in k for k in variables)
    params = tfjs2torch.variables_to_pytree(variables, 50)   # extras skipped
    assert set(params['heads']) == set(HEADS)
    del variables[drop]
    with pytest.raises(ValueError, match=match):
        tfjs2torch.variables_to_pytree(variables, 50)
    with pytest.raises(ValueError, match=match):
        tfjs2jax.variables_to_pytree(variables, 50)


def _bucket(ckpt_dir, fail_at=None):
    """A `_fetch` stand-in serving the files of `ckpt_dir` as the bucket
    would, raising URLError at the request for the shard `fail_at`; it
    records the URLs asked for."""
    asked = []

    def fetch(url):
        asked.append(url)
        name = url.rsplit('/', 1)[1]
        if name == fail_at:
            raise urllib.error.URLError('connection reset')
        with open(os.path.join(ckpt_dir, name), 'rb') as f:
            return f.read()
    return fetch, asked


def test_download_cut_mid_shard_leaves_no_manifest(tfjs_cache, tmp_path, monkeypatch, capsys):
    """A download that fails after some shards leaves no manifest.json, so
    the next load downloads again instead of trusting a partial cache; a
    whole one then reads bitwise as the original."""
    src = os.path.join(tfjs_cache, CHECKPOINT)
    with open(os.path.join(src, 'manifest.json')) as f:
        shards = [v['filename'] for v in json.load(f).values()]
    cache = str(tmp_path / 'cache')
    fetch, asked = _bucket(src, fail_at=shards[3])
    monkeypatch.setattr(download, '_fetch', fetch)
    with pytest.raises(urllib.error.URLError):
        download.download(CHECKPOINT, cache)
    save_dir = os.path.join(cache, CHECKPOINT)
    assert len(asked) == 5 and asked[0] == (download.GOOGLE_CLOUD_STORAGE_DIR + CHECKPOINT
                                            + '/manifest.json')
    assert sorted(os.listdir(save_dir)) == sorted(shards[:3])

    fetch, asked = _bucket(src)
    monkeypatch.setattr(download, '_fetch', fetch)
    monkeypatch.setattr(download, 'BASE_DIR', cache)
    got = tfjs2torch.load_tfjs_variables(CHECKPOINT)   # the manifest is missing: downloads
    assert len(asked) == 1 + len(shards)
    assert 'Downloading' in capsys.readouterr().out
    ref = tfjs2jax.load_tfjs_variables(CHECKPOINT, base_dir=tfjs_cache)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name])


def test_cold_start_converts_and_matches_jax(tfjs_cache, tmp_path, monkeypatch, capsys):
    """`load_model` with no `.npz` converts from the download cache (no
    fetch: the checkpoint is there), runs the converter's self-check on
    ./images/tennis_in_crowd.jpg on the CPU, and its float32 heads match
    JAX's forward on the same checkpoint."""
    cv2 = pytest.importorskip('cv2')

    def fetch(url):
        raise AssertionError(f'fetched {url} though the cache holds the checkpoint')

    monkeypatch.setattr(download, '_fetch', fetch)
    monkeypatch.setattr(download, 'BASE_DIR', tfjs_cache)
    monkeypatch.chdir(tmp_path)
    os.makedirs('images')
    cv2.imwrite('images/tennis_in_crowd.jpg', synth_photo(120, 160))
    model = load_model(50, 16, model_dir=str(tmp_path / 'models'), device='cpu')
    out = capsys.readouterr().out
    assert 'converting from tfjs' in out and 'Heatmaps' in out and '(1, 33, 33, 17)' in out
    assert os.path.exists(tmp_path / 'models' / (CHECKPOINT + '.npz'))

    params = tfjs2jax.variables_to_pytree(
        tfjs2jax.load_tfjs_variables(CHECKPOINT, base_dir=tfjs_cache), 50)
    frames = np.stack([synth_photo(seed=100 + i)[..., ::-1] for i in range(2)])
    x = normalize(torch.from_numpy(frames.copy()), torch.float32)
    ref = jax_mobilenet_v1.forward(params, jnp.asarray(x.numpy()),
                                   JaxModelConfig(model_id=50, output_stride=16))
    got = model.forward_nhwc(x)
    for k in HEADS:
        r = np.asarray(ref[k])
        gap = float(np.abs(got[k].numpy() - r).max()) / max(1.0, float(np.abs(r).max()))
        print(f'{k}: {gap:.3g} of scale')
        assert gap <= 1e-4, (k, gap)
    # a second load reads the .npz, converting nothing
    again = load_model(50, 16, model_dir=str(tmp_path / 'models'), device='cpu')
    assert 'converting' not in capsys.readouterr().out
    assert torch.equal(again.params['backbone'][3]['pw_w'], model.params['backbone'][3]['pw_w'])


def test_load_model_resolves_the_device_first(tmp_path, monkeypatch):
    """On a host without a card the default device raises before anything
    is downloaded or written."""
    fetch, asked = _bucket(str(tmp_path))
    monkeypatch.setattr(download, '_fetch', fetch)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='needs a CUDA device'):
        load_model(50, 16, model_dir=str(tmp_path / 'models'), allow_random_init=True)
    assert asked == [] and not os.path.exists(tmp_path / 'models')


@pytest.mark.parametrize("error", [urllib.error.URLError('no route to host'),
                                   TimeoutError('read timed out')])
def test_network_errors_fall_back_only_when_allowed(tmp_path, monkeypatch, error):
    def fetch(url):
        raise error

    monkeypatch.setattr(download, '_fetch', fetch)
    model_dir = str(tmp_path / 'models')
    with pytest.raises(type(error)):
        load_model(50, 16, model_dir=model_dir, device='cpu')
    model = load_model(50, 16, model_dir=model_dir, allow_random_init=True, seed=3,
                       device='cpu')
    ref = MobileNetV1(50, 16, seed=3, device='cpu')
    for a, b in zip(model.params['backbone'], ref.params['backbone']):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert not os.path.exists(model_dir)   # nothing converted, no directory made


@pytest.mark.parametrize("allow_random_init", [False, True])
@pytest.mark.parametrize("error", [PermissionError(13, 'Permission denied'),
                                   OSError(28, 'No space left on device')])
def test_other_os_errors_raise(tmp_path, monkeypatch, error, allow_random_init):
    """An error that is not the network's (a cache it cannot write, a full
    disk) is raised even with `allow_random_init`."""
    def fetch(url):
        raise error

    monkeypatch.setattr(download, '_fetch', fetch)
    with pytest.raises(type(error)):
        load_model(50, 16, model_dir=str(tmp_path / 'models'),
                   allow_random_init=allow_random_init, device='cpu')
    assert not os.path.exists(tmp_path / 'models')
