from posenet_tpu_torch.models.mobilenet_v1 import (ARCHS, HEAD_CHANNELS,  # noqa: F401
                                                   MOBILENET_V1_CHECKPOINTS,
                                                   forward, init_params,
                                                   stride_plan)
from posenet_tpu_torch.models.model_factory import (MobileNetV1, PoseNet,  # noqa: F401
                                                    load_model)
