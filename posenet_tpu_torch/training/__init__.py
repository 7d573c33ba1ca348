from posenet_tpu_torch.training.loss import (batched_loss, binary_disk_targets,  # noqa: F401
                                             heatmap_offset_loss,
                                             offset_targets_and_mask)
from posenet_tpu_torch.training.train_step import (TrainState,  # noqa: F401
                                                   init_train_state, make_eval_step,
                                                   make_train_step)
