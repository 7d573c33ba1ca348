"""One rank of the port's data-parallel step checks
(tests/test_torch_multiprocess_dp.py), run as its own process.

    python tests/torch_dp_worker.py <coordinator host:port> <rank> <world> <dir>

Joins the world at the coordinator over gloo, on the CPU, through the
explicit-argument path of `initialize_distributed`; reads the float32
m50 parameters (`<dir>/params.pt`) and the global batches
(`<dir>/batches.npz`: image<i>, keypoints<i> and pad<i>, the size each is
padded to with zero-weight items); runs, from a fresh state for each
batch, one `make_train_step(..., mesh=make_mesh())` step and the per-item
`make_eval_step` over the mesh; and writes `<dir>/rank<r>.pt`: the loss
and metrics, the heads' gradients and the heads after Adam, and the eval
vectors, for each batch.

Not a test module itself (no test_ prefix): pytest does not collect it.
"""

import os
import sys


def main():
    coord, rank, world, root = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)

    import numpy as np
    import torch

    from posenet_tpu_torch.config import ModelConfig, TrainConfig
    from posenet_tpu_torch.parallel import mesh as mesh_lib
    from posenet_tpu_torch.training import train_step as ts

    assert mesh_lib.initialize_distributed(coord, world, rank, backend='gloo') == rank
    assert mesh_lib.initialize_distributed() == rank   # idempotent
    mesh = mesh_lib.make_mesh()
    assert mesh.size == world and mesh.devices == (torch.device('cpu'),)

    params = torch.load(os.path.join(root, 'params.pt'), weights_only=True)
    batches = np.load(os.path.join(root, 'batches.npz'))
    cfg = TrainConfig(model_id=50)
    mcfg = ModelConfig(model_id=50, output_stride=16)
    out = []
    for i in range(len([k for k in batches if k.startswith('image')])):
        batch = ts.pad_batch_to({'image': batches[f'image{i}'],
                                 'keypoints': batches[f'keypoints{i}']},
                                int(batches[f'pad{i}']))
        state = ts.init_train_state(params, cfg, 'cpu')
        state, metrics = ts.make_train_step(mcfg, cfg, mesh=mesh)(state, batch)
        per_item = ts.make_eval_step(mcfg, cfg, mesh=mesh, per_item=True)(state.params, batch)
        out.append({
            'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': {(n, k): t.grad.clone() for n in ts.HEAD_NAMES
                      for k, t in state.params['heads'][n].items()},
            'heads': {(n, k): t.detach().clone() for n in ts.HEAD_NAMES
                      for k, t in state.params['heads'][n].items()},
            'per_item': {k: v.clone() for k, v in per_item.items()},
        })
    torch.save(out, os.path.join(root, f'rank{rank}.pt'))
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
