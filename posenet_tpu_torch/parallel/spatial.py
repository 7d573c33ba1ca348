"""Spatial-partition inference: the image height sharded over a mesh's
devices, with the result of the unsharded forward.

The counterpart of the JAX package's `partition='spatial'`, where GSPMD
inserts the convolutions' halo exchanges on equal shards of a zero-padded
height and `valid_h` re-zeroes the pad rows before every 3x3 conv. Here
the exchange is explicit and the shards are row ranges, uneven where the
height does not divide: each layer's OUTPUT rows are split as evenly as
they go over the devices (`split_rows`), and each device fetches the
input rows its output rows read, o*s - p ... o*s - p + 2r for a 3x3 conv
at stride s, rate r and padding p, from whichever devices hold them
(`_slab`). Rows beyond the image are zeros, as the conv's own padding is,
so no shard ever computes a row outside the image and no pad row needs
masking. The convs then pad the width only (`mobilenet_v1.run_layer(...,
row_halo=True)`); the fused sepconv block (K2), which pads every side of
what it is given by the layer's rate, runs on the slab with its
`rate`-row halo and has its first and last `rate` output rows cut (at
stride 2, one zero row above the slab and the one output row it adds).
The 1x1 convs and the heads need no halo.

The heads' 115 channels are gathered onto the first device as one tensor
and split there (`mobilenet_v1.split_heads`), so that the decode, K1
included, reads them in place as it does unsharded.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.models import mobilenet_v1


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) row ranges of n rows over `parts` shards, as even as they
    go: the first n % parts get one row more. A shard may get none."""
    per, extra = divmod(n, parts)
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + per + (i < extra))
    return list(zip(bounds[:-1], bounds[1:]))


def input_rows(a: int, b: int, layer: Dict[str, Any]) -> Tuple[int, int]:
    """The input rows [lo, hi) that a 3x3 layer's output rows [a, b) read,
    padding rows (lo < 0, or hi past the image) included."""
    s, r = layer['stride'], layer['rate']
    p = mobilenet_v1.torch_same_padding(3, s, r)
    return a * s - p, (b - 1) * s - p + 2 * r + 1


def output_height(h: int, layer: Dict[str, Any]) -> int:
    s, r = layer['stride'], layer['rate']
    p = mobilenet_v1.torch_same_padding(3, s, r)
    return (h + 2 * p - 2 * r - 1) // s + 1


def _slab(shards: Sequence[Optional[torch.Tensor]], ranges: Sequence[Tuple[int, int]],
          lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of a row-sharded NCHW (channels_last) tensor, on
    `device`, channels_last; rows outside the image are zeros. Copies
    between devices are queued (`non_blocking`), so no host waits."""
    ref = next(t for t in shards if t is not None)
    b, c, _, w = ref.shape
    height = ranges[-1][1]
    slab = torch.empty((b, c, hi - lo, w), dtype=ref.dtype, device=device,
                       memory_format=torch.channels_last)
    if lo < 0:
        slab[:, :, :-lo].zero_()
    if hi > height:
        slab[:, :, height - lo:].zero_()
    for t, (a, e) in zip(shards, ranges):
        x0, x1 = max(a, lo), min(e, hi)
        if x0 < x1:
            slab[:, :, x0 - lo:x1 - lo].copy_(t[:, :, x0 - a:x1 - a], non_blocking=True)
    return slab


def forward(replicas: Sequence[Dict[str, Any]], x_nhwc: torch.Tensor, cfg: ModelConfig,
            devices: Sequence[torch.device]) -> torch.Tensor:
    """The trunk and heads over the rows of `x_nhwc` (B, H, W, 3), in
    [-1, 1], sharded over `devices` (`replicas[i]`: the parameters cast
    for the compute dtype, on `devices[i]`). Returns `head_conv`'s
    (B, R, R', 115) float32 heads on `devices[0]`, equal to the unsharded
    forward's up to the convolutions' own rounding."""
    x = x_nhwc.to(cfg.compute_dtype).permute(0, 3, 1, 2)
    ranges = split_rows(x.shape[2], len(devices))
    shards = [x[:, :, a:b] if a < b else None for a, b in ranges]
    plan = mobilenet_v1.stride_plan(cfg.model_id, cfg.output_stride)
    for i, layer in enumerate(plan):
        out_ranges = split_rows(output_height(ranges[-1][1], layer), len(devices))
        out = []
        for (a, b), d, params in zip(out_ranges, devices, replicas):
            if a == b:
                out.append(None)
                continue
            slab = _slab(shards, ranges, *input_rows(a, b, layer), d)
            out.append(mobilenet_v1.run_layer(layer, params['backbone'][i], slab, cfg,
                                              row_halo=True))
        shards, ranges = out, out_ranges
    heads = [mobilenet_v1.head_conv(params['heads'], t).to(devices[0], non_blocking=True)
             for t, params in zip(shards, replicas) if t is not None]
    return torch.cat(heads, dim=1)
