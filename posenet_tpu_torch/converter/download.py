"""tfjs PoseNet checkpoint downloader, the counterpart of
`posenet_tpu.converter.download`.

Fetches `manifest.json` and every weight shard of a checkpoint from the
public tfjs-models bucket into a cache directory, with the standard
library's urllib. The cache is the JAX package's (`<tmp>/_posenet_weights`),
so a checkpoint downloaded by either package serves both.
"""

from __future__ import annotations

import json
import os
import posixpath
import tempfile
import urllib.request

GOOGLE_CLOUD_STORAGE_DIR = 'https://storage.googleapis.com/tfjs-models/weights/posenet/'

# The shard cache. The converter reads this attribute when it is called,
# so a caller may point it elsewhere.
BASE_DIR = os.path.join(tempfile.gettempdir(), '_posenet_weights')


def _fetch(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def download(checkpoint: str, base_dir: str | None = None) -> str:
    """Download the manifest and every weight shard of `checkpoint` into
    `<base_dir>/<checkpoint>` (base_dir None: `BASE_DIR`); returns that
    directory.

    Without network egress it raises `urllib.error.URLError`, or
    `TimeoutError` where a read stalls; `models.model_factory.load_model`
    falls back to random weights on those two alone, when asked to."""
    save_dir = os.path.join(BASE_DIR if base_dir is None else base_dir, checkpoint)
    os.makedirs(save_dir, exist_ok=True)

    manifest = json.loads(_fetch(posixpath.join(GOOGLE_CLOUD_STORAGE_DIR, checkpoint,
                                                'manifest.json')))
    for entry in manifest.values():
        filename = entry['filename']
        print('Downloading', filename)
        blob = _fetch(posixpath.join(GOOGLE_CLOUD_STORAGE_DIR, checkpoint, filename))
        with open(os.path.join(save_dir, filename), 'wb') as f:
            f.write(blob)
    # The manifest goes last: its presence tells the converter that the
    # checkpoint is downloaded, so a shard loop cut short must not leave one.
    with open(os.path.join(save_dir, 'manifest.json'), 'w') as f:
        json.dump(manifest, f)
    return save_dir
