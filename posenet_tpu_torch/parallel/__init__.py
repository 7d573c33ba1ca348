from posenet_tpu_torch.parallel.mesh import (Mesh,  # noqa: F401
                                             initialize_distributed, launch, make_mesh,
                                             pad_batch, replicate, shard_batch)
