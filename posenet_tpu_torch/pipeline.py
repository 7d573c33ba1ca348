"""Fused inference: uint8 frames -> normalize -> backbone -> decode.

The counterpart of `posenet_tpu.pipeline` on one device. A call queues the
whole program on the device and returns `DecodedPoses` tensors there; the
host waits only when the caller reads them. Two entries: `infer` takes RGB
frames at the model resolution, `infer_raw` BGR frames at the source
resolution, which it resizes on the device. Over a mesh
(`parallel.mesh.make_mesh`) the pipeline runs the data partition, one
program per shard of the batch, or the spatial partition, the image
height sharded (`parallel.spatial`). With `ModelConfig.quantized` the
trunk is the int8 one (`models.quantized`), its weights folded once when
the pipeline is built; it runs `infer` and the data partition, and refuses
the spatial partition and `device_resize_to`, as the JAX package's does.
With `ModelConfig.architecture='resnet50'` the model is PoseNet ResNet50
(`models.resnet50`), on `infer` and the data partition; `infer_raw`
(`device_resize_to`), the spatial partition and the int8 trunk are
MobileNetV1's alone and refuse it.

Each call is a `profiling.span`, `pipeline.call`, around the spans of its
stages: `pipeline.to_device`, `pipeline.preprocess` (`infer_raw`),
`pipeline.forward` and `pipeline.decode`; ResNet50's forward holds
`resnet.stem` and `resnet.block1` ... `resnet.block4`. They record
nothing unless a profiler or `profiling.recording()` is on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from posenet_tpu_torch import profiling
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.decode import DecodedPoses, decode_batch
from posenet_tpu_torch.models import mobilenet_v1, quantized
from posenet_tpu_torch.models.model_factory import ARCHITECTURE_MODULES, PoseNet
from posenet_tpu_torch.parallel import mesh as mesh_lib
from posenet_tpu_torch.parallel import spatial
from posenet_tpu_torch.preprocess import preprocess_on_device


def normalize(frames_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> [-1, 1] in `dtype`: MobileNetV1's input (`mobilenet_v1.normalize`)."""
    return mobilenet_v1.normalize(frames_u8, None, dtype)


def to_device(frames_u8, device: torch.device) -> torch.Tensor:
    """A frame batch (numpy array or tensor) as a tensor on `device`.

    A host batch bound for a CUDA device is staged in pinned memory (unless
    it is pinned already) and copied with `non_blocking=True`. A copy from
    pageable memory would make the host wait until the stream reaches it,
    that is, until the device has finished the work queued before it, so a
    server could not queue batch N+1 while batch N runs. PyTorch's pinned
    allocator keeps the staging buffer from reuse until the copy is done.
    A copy between two cards is queued in order with the work on both."""
    with profiling.span('pipeline.to_device', device):
        frames = torch.as_tensor(frames_u8)
        if frames.device == device:
            return frames
        if device.type == 'cuda' and frames.device.type == 'cpu':
            if not frames.is_pinned():
                frames = torch.empty(frames.shape, dtype=frames.dtype,
                                     pin_memory=True).copy_(frames)
            return frames.to(device, non_blocking=True)
        return frames.to(device, non_blocking=device.type == frames.device.type == 'cuda')


def infer(params: Dict[str, Any], frames_u8: torch.Tensor, cfg: ModelConfig,
          decode_cfg: DecodeConfig) -> DecodedPoses:
    """(B, H, W, 3) uint8 RGB frames -> DecodedPoses (B, P, ...), on the
    frames' device. `params` must be on that device, cast as the
    architecture's `cast_params` does for `cfg.compute_dtype`, or, with
    `cfg.quantized`, folded by `quantized.quantize_params`."""
    arch = ARCHITECTURE_MODULES[cfg.architecture]
    forward = quantized.forward_quantized if cfg.quantized else arch.forward
    with profiling.span('pipeline.forward', frames_u8.device):
        heads = forward(params, arch.normalize(frames_u8, params, cfg.compute_dtype), cfg)
    return _decode(heads, cfg, decode_cfg)


def infer_raw(params: Dict[str, Any], frames_bgr_u8: torch.Tensor,
              target_hw: Tuple[int, int], cfg: ModelConfig,
              decode_cfg: DecodeConfig) -> DecodedPoses:
    """(B, Hs, Ws, 3) uint8 BGR frames at the source resolution ->
    DecodedPoses, with coordinates at `target_hw` (th, tw), stride-valid.

    `preprocess_on_device` (BGR -> RGB, float32 bilinear resize, normalize
    in float32), then `forward`, whose trunk casts to the compute dtype,
    then `decode_batch`, on the frames' device; the same calls made one by
    one give the same bits. (`infer` normalizes in the compute dtype
    instead, as the JAX package's `_infer` does.) MobileNetV1 only."""
    if cfg.architecture != 'mobilenet_v1':
        raise NotImplementedError(_RAW_RESNET50)
    device = frames_bgr_u8.device
    with profiling.span('pipeline.preprocess', device):
        x = preprocess_on_device(frames_bgr_u8, target_hw)
    with profiling.span('pipeline.forward', device):
        heads = mobilenet_v1.forward(params, x, cfg)
    return _decode(heads, cfg, decode_cfg)


_RAW_RESNET50 = (
    "device_resize_to (infer_raw) + ResNet50: the device preprocess scales to [-1, 1] for "
    "MobileNetV1, and no ResNet50 form of it (RGB plus the ImageNet mean) is ported; "
    "resize on the host and call infer")


def infer_spatial(replicas, frames_u8: torch.Tensor, cfg: ModelConfig,
                  decode_cfg: DecodeConfig, devices) -> DecodedPoses:
    """`infer` with the image height sharded over `devices` (`replicas[i]`
    the cast parameters on `devices[i]`, frames on `devices[0]`): the trunk
    and heads by `parallel.spatial.forward`, the decode of the gathered
    heads on `devices[0]`."""
    with profiling.span('pipeline.forward', frames_u8.device):
        heads = mobilenet_v1.split_heads(spatial.forward(
            replicas, normalize(frames_u8, cfg.compute_dtype), cfg, devices))
    return _decode(heads, cfg, decode_cfg)


def _decode(heads: Dict[str, torch.Tensor], cfg: ModelConfig,
            decode_cfg: DecodeConfig) -> DecodedPoses:
    """`decode_batch` of the four NHWC heads, in the span `pipeline.decode`."""
    with profiling.span('pipeline.decode', heads['heatmap'].device):
        return decode_batch(
            heads['heatmap'], heads['offset'], heads['displacement_fwd'],
            heads['displacement_bwd'], cfg.output_stride, decode_cfg)


def gather(outputs, device: torch.device, n: int) -> DecodedPoses:
    """The shards' DecodedPoses concatenated on `device`, the first `n`
    items kept (the rest pad an uneven batch)."""
    return DecodedPoses(*(torch.cat([t.to(device, non_blocking=True) for t in field])[:n]
                          for field in zip(*outputs)))


class PoseNetPipeline:
    """The fused program on one device.

    Usage:
        model = load_model(101, 16, allow_random_init=True, device='cuda',
                           compute_dtype=torch.bfloat16)
        pipe = PoseNetPipeline(model)
        poses = pipe(frames_u8)   # (B, H, W, 3) uint8 RGB, H, W = stride*n + 1

        raw = PoseNetPipeline(model, device_resize_to=(513, 513))
        poses = raw(frames_bgr)   # (B, Hs, Ws, 3) uint8 BGR, any source size
    """

    def __init__(self, model: PoseNet,
                 decode_cfg: DecodeConfig = DecodeConfig(min_pose_score=0.25),
                 device: torch.device | str | None = None,
                 device_resize_to: Optional[Tuple[int, int]] = None,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 partition: str = 'data'):
        """`device`: where the program runs (None: the model's device). The
        kernels are cast once here to the model's compute dtype, or, for a
        quantized model, folded into the int8 layout.

        `device_resize_to`: (th, tw) stride-valid processing resolution.
        When set, a call takes uint8 BGR frames at the SOURCE resolution and
        the program flips them to RGB, resizes and normalizes them on the
        device (`infer_raw`). Decoded coordinates are at (th, tw).

        `mesh`: a local mesh (`make_mesh`, one process) to run over, in
        place of `device`; the parameters are cast once and replicated on
        its devices, and outputs come back on its first device.
        `partition` spreads the work:
          'data': the batch. An uneven batch is zero-padded to a multiple
            of the mesh and the outputs sliced back; each shard runs the
            whole program on its device (K2 in its bf16 trunk, K1 in its
            decode), queued without waiting on the host.
          'spatial': the image height (`parallel.spatial`), for one
            frame's latency over several devices; the decode runs on the
            gathered heads. Not with `device_resize_to`, nor with a
            quantized model, nor with ResNet50."""
        if partition not in ('data', 'spatial'):
            raise ValueError(f"partition must be 'data' or 'spatial', got {partition!r}")
        if model.cfg.quantized and device_resize_to is not None:
            raise NotImplementedError(
                "device_resize_to + quantized: infer_raw routes through the float "
                "forward, which cannot read the folded int8 parameters; resize on the "
                "host for the quantized trunk")
        if model.cfg.architecture == 'resnet50' and device_resize_to is not None:
            raise NotImplementedError(_RAW_RESNET50)
        self.cfg = model.cfg
        self.decode_cfg = decode_cfg
        self.device_resize_to = (tuple(device_resize_to)
                                 if device_resize_to is not None else None)
        self.mesh = mesh
        self.partition = partition
        if mesh is None:
            self.device = torch.device(device) if device is not None else model.device
            self.params = self._fold(model, self.device)
            return
        if device is not None:
            raise ValueError('give the pipeline a device or a mesh, not both')
        if mesh.group is not None:
            raise ValueError('a pipeline runs over the devices of one process: give it a '
                             'local mesh (make_mesh outside a torch.distributed world)')
        if partition == 'spatial' and self.device_resize_to is not None:
            raise NotImplementedError(
                "device_resize_to + spatial partition: the height shards are rows "
                "of the input at the processing resolution; use partition='data'")
        if partition == 'spatial' and model.cfg.quantized:
            raise NotImplementedError(
                "quantized + spatial partition: the int8 trunk has no height-sharded "
                "form (parallel.spatial runs the float layers, as the JAX package's "
                "int8 trunk has no valid_h pad-row masking); use partition='data'")
        if partition == 'spatial' and model.cfg.architecture == 'resnet50':
            raise NotImplementedError(
                "ResNet50 + spatial partition: parallel.spatial shards MobileNetV1's layers "
                "and no height-sharded ResNet50 trunk is ported; use partition='data'")
        self.device = mesh.devices[0]
        self.replicas = mesh_lib.replicate(self._fold(model, self.device), mesh)
        self.params = self.replicas[0]

    @staticmethod
    def _fold(model: PoseNet, device: torch.device) -> Dict[str, Any]:
        """The model's parameters on `device` as `infer` reads them."""
        if model.cfg.quantized:
            return quantized.quantize_params(model.params, device)
        return ARCHITECTURE_MODULES[model.cfg.architecture].cast_params(
            model.params, model.cfg.compute_dtype, device)

    def __call__(self, frames_u8) -> DecodedPoses:
        """Run forward + decode on a uint8 frame batch (B, H, W, 3). Frames
        on another device are copied (`to_device`: host frames for a CUDA
        device without waiting for the device).

        The input colour order flips with `device_resize_to`:
          * default: RGB frames at the model resolution (what host
            preprocessing produces);
          * `device_resize_to` set: BGR frames at the source resolution, as
            a capture gives them; the program swaps BGR -> RGB on the
            device.
        Frames in the wrong order raise no error but lower the pose scores.
        """
        frames = torch.as_tensor(frames_u8)
        if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f'expected (B, H, W, 3) uint8 frames, got '
                             f'{tuple(frames.shape)} {frames.dtype}')
        with profiling.span('pipeline.call', self.device):
            if self.mesh is None:
                return self._run(self.params, to_device(frames, self.device))
            if self.partition == 'spatial':
                return infer_spatial(self.replicas, to_device(frames, self.device), self.cfg,
                                     self.decode_cfg, self.mesh.devices)
            shards = mesh_lib.shard_batch(mesh_lib.pad_batch(frames, self.mesh), self.mesh)
            return gather([self._run(p, x) for p, x in zip(self.replicas, shards)],
                          self.device, frames.shape[0])

    def _run(self, params, frames: torch.Tensor) -> DecodedPoses:
        if self.device_resize_to is not None:
            return infer_raw(params, frames, self.device_resize_to, self.cfg,
                             self.decode_cfg)
        return infer(params, frames, self.cfg, self.decode_cfg)

    def warmup(self, input_hw: Tuple[int, int], batch: int = 1):
        """Run one batch of zeros (builds the CUDA kernels on first use) and
        wait for it. `input_hw` is the frames' (H, W): the model resolution,
        or the source resolution with `device_resize_to`."""
        dummy = torch.zeros((batch, *input_hw, 3), dtype=torch.uint8,
                            device=self.device)
        self(dummy).pose_scores.cpu()
