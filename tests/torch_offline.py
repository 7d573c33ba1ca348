"""Keep the port's checkpoint download off the network in the tests.

`posenet_tpu_torch`'s `load_model` downloads and converts the tfjs
checkpoint when `<model_dir>/<checkpoint>.npz` is missing, and falls back
to random weights on a network error when `allow_random_init` is set.
A test module that builds a model without a checkpoint imports the
autouse fixture `offline_download`:

    from tests.torch_offline import offline_download  # noqa: F401 (autouse)

Its `download._fetch` raises `URLError` as a host without egress would,
and the shard cache is a fresh temporary directory, so nothing is fetched
and nothing is written to the shared `<tmp>/_posenet_weights`. Processes
that a test spawns import the package afresh and keep no stub: give them
a checkpoint instead (`write_random_checkpoint`).
"""

import importlib
import os
import urllib.error

import pytest

download = importlib.import_module('posenet_tpu_torch.converter.download')


def no_network(url):
    raise urllib.error.URLError(f'the tests run offline: {url}')


@pytest.fixture(autouse=True)
def offline_download(monkeypatch, tmp_path_factory):
    monkeypatch.setattr(download, '_fetch', no_network)
    monkeypatch.setattr(download, 'BASE_DIR',
                        str(tmp_path_factory.mktemp('posenet_weights')))


def write_random_checkpoint(model_dir, model_id: int) -> str:
    """`MobileNetV1(model_id, seed=0)`'s weights, what `load_model(...,
    allow_random_init=True)` draws offline, as `<model_dir>/<checkpoint>.npz`
    (HWIO, the JAX package's layout); returns its path."""
    from posenet_tpu_torch.converter import weights
    from posenet_tpu_torch.models import MOBILENET_V1_CHECKPOINTS, MobileNetV1

    def hwio(layer):
        return {k: (v.permute(2, 3, 1, 0) if v.ndim == 4 else v).numpy()
                for k, v in layer.items()}

    params = MobileNetV1(model_id, 16, device='cpu').params
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, MOBILENET_V1_CHECKPOINTS[model_id] + '.npz')
    weights.save_params_npz(path, {
        'backbone': [hwio(layer) for layer in params['backbone']],
        'heads': {name: hwio(p) for name, p in params['heads'].items()}})
    return path
