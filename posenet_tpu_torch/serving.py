"""Serving artifacts: the fused uint8 -> poses program as `torch.export`
programs, with the weights baked in.

The counterpart of `posenet_tpu.serving`. One artifact holds the whole
normalize -> backbone -> multi-pose decode pipeline, one exported program
per batch size and platform, loadable without the checkpoint:

    posenet-export-torch --model 101 --batch_sizes 1,8 --output m101.posenet
    art = load_serving_artifact('m101.posenet')
    poses = art(frames_u8)          # (B, H, W, 3) uint8 RGB -> DecodedPoses

Design notes:
- Weights are the program's buffers, in the model's compute dtype
  (`mobilenet_v1.cast_params`).
- Shapes are static, so there is one program per batch size; a server
  calls the one that matches its batch (`server.PoseServer` coalesces).
- A deliberate difference from the JAX package: its artifact exports the
  XLA decode, because Mosaic custom calls are pinned to the libtpu that
  compiled them. A `cuda` program here keeps the kernels K1 and K2 as the
  custom ops `posenet_tpu_torch::traverse_all_candidates` and
  `posenet_tpu_torch::sepconv`, because their plain versions are over 100x
  (K1) and 9x (K2) slower on an H100 (PERF.md). Loading a `cuda` program therefore needs
  `posenet_tpu_torch` importable, which registers the ops (this module
  imports them). A `cpu` program holds only aten ops (the plain versions).
- The exported program returns `DecodedPoses.as_tuple()`: `torch.export`
  saves no NamedTuple; the loader rebuilds `DecodedPoses`.
- Data parallel (`data_parallel_devices=N`): each program is exported at
  the SHARD's batch, B / N for a served batch B, and the loader splits a
  batch over its N devices, runs one copy of the program on each and
  gathers the poses on the first (the pipeline's data partition).

Artifact layout (a zip, conventional suffix `.posenet`):
    meta.json                    format, version, model + decode config, shapes
    program_b{N}_{platform}.pt2  torch.export.save of the program for batch N
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from posenet_tpu_torch.config import DecodeConfig, ModelConfig, TrainConfig
from posenet_tpu_torch.decode import DecodedPoses
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import PoseNet, resolve_device
from posenet_tpu_torch.parallel.mesh import make_mesh, shard_batch
from posenet_tpu_torch.pipeline import gather, infer, to_device

# `format` tells this package's artifacts from the JAX package's, whose
# meta.json has no such key.
FORMAT = 'posenet_tpu_torch.export'
# 2: the tree walk's op takes the heads as four row tensors (scores,
# offsets, dfwd, dbwd) where version 1 took three packed tables, so a
# version-1 `cuda` program cannot run here and must be exported again.
# 3: `data_parallel_devices` may be set, and then a program runs on one
# shard of the batch (a version-2 loader would feed it the whole batch).
# Version 2 artifacts are version 3 ones without it.
FORMAT_VERSION = 3
_READABLE_VERSIONS = (2, 3)
PLATFORMS = ('cuda', 'cpu')


def _validate_input_hw(input_hw: Tuple[int, int], output_stride: int):
    h, w = input_hw
    if (h - 1) % output_stride or (w - 1) % output_stride:
        raise ValueError(
            f"input_hw {input_hw} is not stride-valid for stride "
            f"{output_stride}: each side must be {output_stride}*n+1 "
            f"(preprocess.valid_resolution computes the nearest)")


def _platform_device(platform: str) -> torch.device:
    """The device a platform runs on; 'cuda' raises on a host without one."""
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; the port exports for {PLATFORMS}")
    if resolve_device(platform).type == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', torch.cuda.current_device())


class _Program(nn.Module):
    """The exported function: uint8 frames -> `DecodedPoses.as_tuple()`,
    over parameters held as buffers."""

    def __init__(self, params, cfg: ModelConfig, decode_cfg: DecodeConfig):
        super().__init__()
        self.weights = PoseNet(params, cfg)
        self.cfg = cfg
        self.decode_cfg = decode_cfg

    def forward(self, frames_u8: torch.Tensor):
        return infer(self.weights.params, frames_u8, self.cfg, self.decode_cfg).as_tuple()


def save_serving_artifact(
        model: PoseNet, path: str, *,
        decode_cfg: DecodeConfig = DecodeConfig(min_pose_score=0.25),
        batch_sizes: Sequence[int] = (1,),
        input_hw: Tuple[int, int] = (513, 513),
        platforms: Sequence[str] = ('cuda',),
        data_parallel_devices: Optional[int] = None) -> Dict:
    """Export `model`'s fused inference pipeline to a serving artifact.

    `platforms`: any of 'cuda' and 'cpu'. A platform is exported on its own
    device, so 'cuda' (the default) needs one, and raises without. Returns
    the metadata dict written to the artifact. The artifact is written to
    a temporary file and renamed, so a failed export leaves nothing at
    `path`.

    `data_parallel_devices=N` records N: every batch size must divide by
    it, each program is exported at B / N, and the loader runs a batch
    over N devices (`ServingArtifact`).

    A quantized model is refused (NotImplementedError), as the JAX
    package refuses it: serve it through `server.LivePipelineBackend`. So
    is ResNet50, whose artifact (programs and metadata) is not ported."""
    import posenet_tpu_torch

    cfg = model.cfg
    if cfg.quantized:
        raise NotImplementedError(
            "serving export of the int8 trunk is not supported; serve a quantized "
            "model through server.LivePipelineBackend")
    if cfg.architecture == 'resnet50':
        raise NotImplementedError(
            "serving export of ResNet50 is not ported (the artifact's programs and "
            "metadata are MobileNetV1's); serve it through server.LivePipelineBackend")
    _validate_input_hw(tuple(input_hw), cfg.output_stride)
    platforms = list(platforms)
    if not platforms:
        raise ValueError('platforms names no platform to export for')
    batches = sorted(set(int(b) for b in batch_sizes))
    if not batches or batches[0] < 1:
        raise ValueError(f'bad batch_sizes {batch_sizes}')
    n = None
    if data_parallel_devices is not None:
        n = int(data_parallel_devices)
        if n < 1:
            raise ValueError(f"data_parallel_devices must be >= 1, got {n}")
        bad = [b for b in batches if b % n]
        if bad:
            raise ValueError(
                f"data_parallel_devices={n} must divide every batch size; "
                f"got {bad}")
    devices = {p: _platform_device(p) for p in platforms}

    meta = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "model_id": cfg.model_id,
        "output_stride": cfg.output_stride,
        "compute_dtype": str(cfg.compute_dtype).removeprefix('torch.'),
        "input_hw": [int(v) for v in input_hw],
        "input_dtype": "uint8",
        "input_layout": "NHWC, RGB",
        "batch_sizes": batches,
        "platforms": platforms,
        "decode": dataclasses.asdict(decode_cfg),
        "torch_version": torch.__version__,
        "framework_version": posenet_tpu_torch.__version__,
        "outputs": list(DecodedPoses._fields),
        "data_parallel_devices": n,
    }
    # Write-to-temp + atomic rename: ZipFile.__exit__ finalizes the central
    # directory even on an exception, so writing `path` directly would leave
    # a loadable zip whose meta lists programs it lacks.
    tmp_path = path + '.tmp'
    try:
        with zipfile.ZipFile(tmp_path, 'w', compression=zipfile.ZIP_DEFLATED) as zf:
            zf.writestr('meta.json', json.dumps(meta, indent=2))
            for platform, device in devices.items():
                program = _Program(mobilenet_v1.cast_params(
                    model.params, cfg.compute_dtype, device), cfg, decode_cfg)
                for b in batches:
                    example = torch.zeros((b // (n or 1), *meta['input_hw'], 3),
                                          dtype=torch.uint8, device=device)
                    exported = torch.export.export(program, (example,), strict=False)
                    blob = io.BytesIO()
                    torch.export.save(exported, blob)
                    zf.writestr(f'program_b{b}_{platform}.pt2', blob.getvalue())
        os.replace(tmp_path, path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return meta


class ServingArtifact:
    """A loaded serving artifact: call it with (B, H, W, 3) uint8 RGB
    frames (numpy or a tensor; a tensor already on the device is used as it
    is) and get `DecodedPoses` on the artifact's device.

    `device`: where the programs run: the card unless the caller names the
    CPU; 'cuda' raises on a host without a CUDA device. Programs load once
    per batch size, at first use, and are cached.

    A data-parallel artifact (`data_parallel_devices=N`) runs over N
    devices: `devices`, a list of N (a device may repeat), or else the
    first N cards, which must exist. Its `device` is the first, where the
    poses come back."""

    def __init__(self, path: str, device: torch.device | str = 'cuda',
                 devices: Optional[Sequence] = None):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            self.meta = json.loads(zf.read('meta.json'))
        fmt = self.meta.get('format')
        if fmt != FORMAT:
            hint = (' (a JAX artifact from posenet-export: load it with '
                    'posenet_tpu.serving)' if fmt is None and 'jax_version' in self.meta
                    else '')
            raise ValueError(f'{path} is not a posenet_tpu_torch serving artifact: format '
                             f'{fmt!r}, expected {FORMAT!r}{hint}')
        if self.meta.get('format_version') not in _READABLE_VERSIONS:
            raise ValueError(
                f"artifact {path} has format_version {self.meta.get('format_version')}; "
                f"this loader reads versions "
                f"{' and '.join(map(str, _READABLE_VERSIONS))}")
        self.batch_sizes = list(self.meta['batch_sizes'])
        self.input_hw = tuple(self.meta['input_hw'])
        self.data_parallel_devices = self.meta.get('data_parallel_devices')
        self.mesh = None
        if self.data_parallel_devices is None:
            if devices is not None:
                raise ValueError(f'{path} is not a data-parallel artifact: it runs on one '
                                 f'device, not on {list(devices)}')
            self.device = _platform_device(torch.device(device).type)
        else:
            n = self.data_parallel_devices
            if devices is not None and len(devices) != n:
                raise ValueError(f'artifact {path} (exported data-parallel) needs {n} '
                                 f'devices, got {list(devices)}')
            self.mesh = make_mesh(n, devices=devices,
                                  device_type=torch.device(device).type)
            if len({d.type for d in self.mesh.devices}) != 1:
                raise ValueError(f'devices of two platforms: {list(self.mesh.devices)}')
            self.device = self.mesh.devices[0]
        self._programs: Dict[int, list] = {}

    def _program(self, batch: int) -> nn.Module:
        """The program for `batch` on the artifact's device (the first
        device of a data-parallel artifact)."""
        return self._copies(batch)[0]

    def _copies(self, batch: int) -> list:
        """The program for `batch`, one copy for each device it runs on."""
        if batch not in self._programs:
            if batch not in self.batch_sizes:
                raise ValueError(
                    f"artifact {self.path} has no program for batch size {batch}; "
                    f"available: {self.batch_sizes} (re-export with batch_sizes "
                    f"including {batch})")
            with zipfile.ZipFile(self.path) as zf:
                blob = zf.read(f'program_b{batch}_{self.device.type}.pt2')
            devices = (self.device,) if self.mesh is None else self.mesh.devices
            copies = {}
            for d in devices:
                if d not in copies:
                    copies[d] = _load_program(blob, d)
            self._programs[batch] = [copies[d] for d in devices]
        return self._programs[batch]

    def __call__(self, frames_u8) -> DecodedPoses:
        # Validate from .shape/.dtype: a tensor already on the device passes
        # through without a host round trip, and a non-uint8 batch raises
        # rather than being cast into garbage poses.
        frames = frames_u8 if isinstance(frames_u8, torch.Tensor) else np.asarray(frames_u8)
        if frames.ndim != 4 or tuple(frames.shape[1:3]) != self.input_hw \
                or frames.shape[3] != 3:
            raise ValueError(
                f"expected (B, {self.input_hw[0]}, {self.input_hw[1]}, 3) uint8 "
                f"frames, got {tuple(frames.shape)}")
        if frames.dtype not in (np.uint8, torch.uint8):
            raise ValueError(
                f"expected uint8 frames, got {frames.dtype} (scale/round to 0..255 "
                f"uint8 first: an implicit cast would wrap float/negative values "
                f"into garbage)")
        platform = self.device.type
        if platform not in self.meta['platforms']:
            raise ValueError(
                f"artifact {self.path} was exported for platforms "
                f"{self.meta['platforms']} but runs on '{platform}' here; re-export "
                f"with --platforms including it")
        programs = self._copies(frames.shape[0])   # batch validated after the rest
        if self.mesh is None:
            return DecodedPoses.from_tuple(programs[0](to_device(frames, self.device)))
        shards = shard_batch(frames, self.mesh)
        return gather([DecodedPoses.from_tuple(p(x)) for p, x in zip(programs, shards)],
                      self.device, frames.shape[0])


def _load_program(blob: bytes, device: torch.device) -> nn.Module:
    """A saved program as a module on `device`: moved there when it was
    exported on another device (a data-parallel artifact's copies)."""
    exported = torch.export.load(io.BytesIO(blob))
    saved = {t.device for t in list(exported.state_dict.values())
             + list(exported.constants.values()) if isinstance(t, torch.Tensor)}
    if saved != {device}:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, device)
    return exported.module()


def load_serving_artifact(path: str, device: torch.device | str = 'cuda',
                          devices: Optional[Sequence] = None) -> ServingArtifact:
    return ServingArtifact(path, device, devices)


def main(argv: Optional[Sequence[str]] = None):
    """`posenet-export-torch`: write a serving artifact for a model."""
    import argparse

    from posenet_tpu_torch.models.model_factory import load_model
    from posenet_tpu_torch.preprocess import valid_resolution

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--model', type=int, default=101, choices=(50, 75, 100, 101))
    p.add_argument('--output_stride', type=int, default=16, choices=(8, 16, 32))
    p.add_argument('--size', type=int, nargs=2, default=(513, 513), metavar=('H', 'W'),
                   help='input resolution; snapped stride-valid')
    p.add_argument('--batch_sizes', type=str, default='1',
                   help='comma-separated, e.g. 1,8,128')
    p.add_argument('--platforms', type=str, default='cuda',
                   help="comma-separated of 'cuda' and 'cpu'; the model is "
                        "loaded on the first one's device")
    p.add_argument('--compute_dtype', default='bfloat16', choices=('bfloat16', 'float32'),
                   help='bf16 is the inference mode (K2 runs only in bf16)')
    p.add_argument('--min_pose_score', type=float, default=0.25)
    p.add_argument('--output', type=str, required=True,
                   help='artifact path (conventionally *.posenet)')
    p.add_argument('--data_parallel_devices', type=int, default=None,
                   help='export for serving each batch over N devices (N must '
                        'divide every batch size); the loader needs N devices')
    p.add_argument('--from_checkpoint', type=str, default='',
                   help='checkpoint dir written by posenet-train-torch: export '
                        'its latest (= best) step instead of ./_models weights. '
                        '--model/--output_stride must match the training run')
    p.add_argument('--random_init_ok', action='store_true',
                   help='export random weights if the checkpoint is missing '
                        '(testing only)')
    args = p.parse_args(argv)

    platforms = [s for s in args.platforms.split(',') if s]
    if not platforms:
        p.error('--platforms names no platform')
    device = _platform_device(platforms[0])
    compute_dtype = getattr(torch, args.compute_dtype)
    if args.from_checkpoint:
        from posenet_tpu_torch.training import train_step as ts
        from posenet_tpu_torch.training.trainer import restore_checkpoint

        # The training CLI always trains with TrainConfig's optimizer
        # defaults (heads-only Adam), so a default-config template matches
        # any of its checkpoints.
        train_cfg = TrainConfig(model_id=args.model, output_stride=args.output_stride)
        init = mobilenet_v1.init_params(torch.Generator().manual_seed(0),
                                        ModelConfig(args.model, args.output_stride))
        restored = restore_checkpoint(args.from_checkpoint,
                                      ts.init_train_state(init, train_cfg, device))
        if restored is None:
            raise SystemExit(f'no checkpoint found in {args.from_checkpoint}')
        model = PoseNet(ts.tree_map(torch.Tensor.detach, restored.params),
                        ModelConfig(args.model, args.output_stride, compute_dtype))
    else:
        model = load_model(args.model, args.output_stride, compute_dtype=compute_dtype,
                           allow_random_init=args.random_init_ok, device=device)
    # valid_resolution takes (width, height) and returns (w, h)
    vw, vh = valid_resolution(args.size[1], args.size[0], args.output_stride)
    meta = save_serving_artifact(
        model, args.output,
        decode_cfg=DecodeConfig(min_pose_score=args.min_pose_score),
        batch_sizes=[int(b) for b in args.batch_sizes.split(',')],
        input_hw=(vh, vw),
        platforms=platforms,
        data_parallel_devices=args.data_parallel_devices)
    print(f"wrote {args.output}: model {meta['model_id']} s{meta['output_stride']} "
          f"{meta['input_hw']} batches {meta['batch_sizes']} platforms {meta['platforms']}")
    return meta


if __name__ == '__main__':
    main()
