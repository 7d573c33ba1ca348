"""posenet-tpu-torch: the PyTorch + CUDA port of posenet_tpu.

Multi-person pose estimation (MobileNetV1 PoseNet, and PoseNet ResNet50 on
the fused pipeline, with the on-device multi-pose decoder) for NVIDIA
GPUs, beside the JAX package it is held equal to. It imports torch and
never jax.
"""

from posenet_tpu_torch.constants import *  # noqa: F401,F403
from posenet_tpu_torch import constants, decode, decode_multi  # noqa: F401
from posenet_tpu_torch.config import DecodeConfig, ModelConfig, TrainConfig  # noqa: F401
from posenet_tpu_torch.decode import (DecodedPoses, decode_batch,  # noqa: F401
                                      build_part_with_score_single_pose,
                                      decode_pose, decode_single_pose, find_root)
from posenet_tpu_torch.decode_multi import (decode_multiple_poses,  # noqa: F401
                                            decode_multiple_poses_batch)
from posenet_tpu_torch.draw import (draw_keypoints, draw_skel_and_kp,  # noqa: F401
                                    draw_skeleton, get_adjacent_keypoints)
from posenet_tpu_torch.models.model_factory import (MobileNetV1, PoseNet,  # noqa: F401
                                                    ResNet50, load_model)
from posenet_tpu_torch.models.mobilenet_v1 import MOBILENET_V1_CHECKPOINTS  # noqa: F401
from posenet_tpu_torch.pipeline import (PoseNetPipeline, infer,  # noqa: F401
                                        infer_raw, to_device)
from posenet_tpu_torch.preprocess import (preprocess_on_device,  # noqa: F401
                                          process_input, process_input_fixed,
                                          read_cap, read_imgfile,
                                          valid_resolution)
from posenet_tpu_torch.server import LivePipelineBackend, PoseServer  # noqa: F401
from posenet_tpu_torch.serving import (ServingArtifact,  # noqa: F401
                                       load_serving_artifact,
                                       save_serving_artifact)

# The reference exposes its preprocessor as `_process_input`; keep the alias.
_process_input = process_input

__version__ = "0.1.0"
