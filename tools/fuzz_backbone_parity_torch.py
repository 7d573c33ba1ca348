"""Offline sweep: randomized backbone parity, the JAX package against the
port, on the CPU.

The cases are `tools/fuzz_backbone_parity.py`'s (the same draws and
seeds): random model_id x output_stride x stride-valid (H, W), fresh JAX
`init_params` per case, carried to the port by
`converter.weights.params_from_jax`. JAX's `forward(precision=HIGHEST)`
against the port's float32 forward (TF32 off, as on a card): all four
heads within 1e-4 of each head's scale, max(1, max |head|), the bound the
port's tests hold (PARITY.md "Validation depth"). The dilated asymmetric
padding is the subtlest part of the model; this sweeps it far beyond the
committed shapes. The first mismatch exits non-zero with a repro line.

Usage:
    python tools/fuzz_backbone_parity_torch.py --count 25
"""

import argparse
import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from posenet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet  # noqa: E402

from posenet_tpu_torch.apps import full_float32  # noqa: E402
from posenet_tpu_torch.config import ModelConfig  # noqa: E402
from posenet_tpu_torch.converter import weights  # noqa: E402
from posenet_tpu_torch.models import mobilenet_v1  # noqa: E402

HEADS = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')


def run_case(seed: int) -> str:
    """Returns '' on parity, else a description of the mismatch."""
    rng = np.random.RandomState(seed)
    model_id = int(rng.choice([50, 75, 100, 101]))
    stride = int(rng.choice([8, 16, 32]))
    h = stride * rng.randint(2, 13) + 1
    w = stride * rng.randint(2, 13) + 1
    jcfg = JaxModelConfig(model_id=model_id, output_stride=stride)
    params = jax_mobilenet.init_params(jax.random.PRNGKey(seed), jcfg)
    x_nchw = rng.uniform(-1, 1, size=(1, 3, h, w)).astype(np.float32)
    x_nhwc = np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))

    ref = jax_mobilenet.forward(params, jnp.asarray(x_nhwc), jcfg,
                                precision=jax.lax.Precision.HIGHEST)
    full_float32()
    ours = mobilenet_v1.forward(
        weights.params_from_jax(jax.tree.map(np.asarray, params)),
        torch.from_numpy(x_nhwc), ModelConfig(model_id=model_id, output_stride=stride))
    ctx = f"seed={seed} m{model_id} s{stride} {h}x{w}"
    for name in HEADS:
        r = np.asarray(ref[name])
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(ours[name].numpy() - r).max())
        if ours[name].shape != r.shape or err > 1e-4 * scale:
            return (f"{name} max abs err {err:.3g} (scale {scale:.3g}), shapes "
                    f"{tuple(ours[name].shape)} {r.shape} [{ctx}]")
    return ""


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--count", type=int, default=25)
    p.add_argument("--seed_base", type=int, default=550_000)
    args = p.parse_args()

    for n, i in enumerate(range(args.start, args.start + args.count)):
        if n and n % 8 == 0:
            jax.clear_caches()  # fresh shapes every case (the JAX tool's note)
        seed = args.seed_base + i * 13
        msg = run_case(seed)
        if msg:
            print(f"FAIL case {i}: {msg}\nrepro: run_case({seed})")
            sys.exit(1)
        print(f"ok case {i}", flush=True)
    print(f"done: {args.count} cases, 0 failures")


if __name__ == "__main__":
    main()
