"""Show that the port's trainer moves ACCURACY, not just the loss: the
counterpart of `tools/train_accuracy_delta.py`.

Synthesizes the blob-keypoint Dataloop dataset of the lifecycle soak
(`tools.tpu_lifecycle_soak.synthesize`), evaluates OKS/mAP on the
held-out split BEFORE any training (seeded random weights: the tool never
downloads a checkpoint), fine-tunes with the port's `trainer.train`,
restores the best checkpoint, evaluates again, and prints ONE JSON line
with before / after / delta and the device.

    python3 tools/train_accuracy_delta_torch.py                 # on the card
    python3 tools/train_accuracy_delta_torch.py --device cpu --epochs 40

Exit code 0 when training improved held-out OKS or mAP, 1 when not.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from posenet_tpu_torch.config import TrainConfig  # noqa: E402
from posenet_tpu_torch.models.model_factory import MobileNetV1, resolve_device  # noqa: E402
from posenet_tpu_torch.training import train_step as ts  # noqa: E402
from posenet_tpu_torch.training.dataset import PosenetDataset  # noqa: E402
from posenet_tpu_torch.training.ground_truth import prepare_ground_truth_data  # noqa: E402
from posenet_tpu_torch.training.trainer import (evaluate, restore_checkpoint,  # noqa: E402
                                                train)
from tools.tpu_lifecycle_soak import synthesize  # noqa: E402


def device_name(device) -> str:
    """The card's `name, power.limit` as nvidia-smi gives them, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                     "acc_delta_torch"))
    p.add_argument("--model", type=int, default=50)
    p.add_argument("--image_size", type=int, default=129)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--n_train", type=int, default=16)
    p.add_argument("--n_test", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--heads_only", action="store_true", default=True)
    p.add_argument("--full", dest="heads_only", action="store_false",
                   help="fine-tune the trunk too (slower, moves further)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a CUDA device) "
                        "or 'cpu'")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """The tool's work; returns the printed result."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir)
    labels = synthesize(args.workdir, n_train=args.n_train, n_test=args.n_test,
                        size=args.image_size, rng=np.random.RandomState(0))
    kp_dir = os.path.join(args.workdir, "keypoints")
    for split in ("train", "test"):
        prepare_ground_truth_data(os.path.join(args.workdir, f"images_{split}"), labels,
                                  keypoints_updated_dir=kp_dir)

    cfg = TrainConfig(model_id=args.model, output_stride=16, batch_size=args.batch_size,
                      learning_rate=args.lr, num_epochs=args.epochs,
                      heads_only=args.heads_only,
                      early_stop_patience=max(10, args.epochs),
                      checkpoint_dir=os.path.join(args.workdir, "ckpt"),
                      keypoint_dir=kp_dir, output_dir=os.path.join(args.workdir, "out"))

    model = MobileNetV1(args.model, 16, device=device)
    train_ds = PosenetDataset(os.path.join(args.workdir, "images_train"), kp_dir,
                              image_size=args.image_size, output_stride=16)
    test_ds = PosenetDataset(os.path.join(args.workdir, "images_test"), kp_dir,
                             image_size=args.image_size, output_stride=16)

    before = evaluate(test_ds, cfg, model.params, device=device)
    print(f"before: {json.dumps(before)}", flush=True)

    state = train(train_ds, test_ds, cfg, params=model.params, resume=False,
                  eval_pose_metrics=False, device=device)

    # Evaluate the BEST checkpoint (train saves on eval-loss improvement),
    # falling back to the final state if nothing was written.
    best = restore_checkpoint(cfg.checkpoint_dir, ts.init_train_state(model.params, cfg))
    after_params = best.params if best is not None else state.params
    after = evaluate(test_ds, cfg, after_params, device=device)
    print(f"after:  {json.dumps(after)}", flush=True)

    result = {
        "device": device_name(device),
        "model": args.model, "image_size": args.image_size,
        "epochs": args.epochs, "heads_only": args.heads_only,
        "n_train": args.n_train, "n_test": args.n_test,
        "before": {k: before.get(k) for k in ("loss", "oks", "mAP")},
        "after": {k: after.get(k) for k in ("loss", "oks", "mAP")},
        "delta_oks": after.get("oks", 0.0) - before.get("oks", 0.0),
        "delta_map": after.get("mAP", 0.0) - before.get("mAP", 0.0),
    }
    print("ACCURACY_DELTA " + json.dumps(result))
    # The point of the tool: training must IMPROVE held-out accuracy. A
    # mean summed in another order moves by ~1e-17, which is no change.
    result["improved"] = result["delta_oks"] > 1e-9 or result["delta_map"] > 1e-9
    print("VERDICT:", "IMPROVED" if result["improved"] else "NO IMPROVEMENT")
    return result


def main(argv=None) -> int:
    return 0 if run(argv)["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
