"""Model, decoder and training configuration, mirroring `posenet_tpu.config`.

Same fields and defaults as the JAX package, with `compute_dtype` as a
`torch.dtype`. The JAX package's TPU-only knobs (the Pallas switch, the
two-stage top-K and the packed stem) have no counterpart: the port has one
route for each of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + heads configuration."""

    model_id: int = 101            # one of {50, 75, 100, 101}
    output_stride: int = 16        # one of {8, 16, 32}
    # Trunk activation dtype. float32 is the parity mode; bfloat16 is the
    # inference mode. The heads accumulate in float32 in both.
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.model_id not in (50, 75, 100, 101):
            raise ValueError(f"model_id must be in {{50,75,100,101}}, got {self.model_id}")
        if self.output_stride not in (8, 16, 32):
            raise ValueError(f"output_stride must be in {{8,16,32}}, got {self.output_stride}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype}")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Multi-pose decoder knobs; defaults match the JAX package.

    `max_candidates` bounds the candidate list statically: the decoder keeps
    the top-K score-ranked local maxima.
    """

    max_pose_detections: int = 10
    score_threshold: float = 0.5
    nms_radius: int = 20
    min_pose_score: float = 0.5
    max_candidates: int = 128


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Fine-tuning hyperparameters."""

    model_id: int = 101
    output_stride: int = 16
    batch_size: int = 2
    learning_rate: float = 1e-4
    num_epochs: int = 100
    heatmap_loss_weight: float = 4.0   # the 4:1 heatmap:offset combination
    offset_loss_weight: float = 1.0
    early_stop_patience: int = 10
    heads_only: bool = True            # freeze the trunk, train the four heads
    checkpoint_dir: str = "./_train_ckpt"
    keypoint_dir: str = "./keypoints_updated"
    # Visual diagnostics: every `visual_every` epochs, dump predicted
    # heatmap channels + keypoint overlays for the first eval batch under
    # `output_dir` (0 = never).
    output_dir: str = "./output"
    visual_every: int = 0
    # Data-parallel ranks, one process per device (None: one device, or
    # the world's size inside a torch.distributed world). train() starts
    # them when the process is in no world.
    num_devices: Optional[int] = None
    seed: int = 0
    # Trunk compute dtype of the training forward. bfloat16 is mixed
    # precision: the FROZEN trunk (heads_only) runs bf16, through the fused
    # sepconv kernel on its stride-1 rate-1 layers, while master params,
    # the heads, the loss and Adam's state stay float32.
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.num_devices is not None and self.num_devices < 1:
            raise ValueError(f"num_devices must be None or >= 1, got {self.num_devices}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype}")


# Default on-disk model directory.
MODEL_DIR = "./_models"
