#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, check it, and time
its hand-written kernels alone at the benchmark's shapes.

    python3 chip_smoke.py             # every phase: what a run must pass
    python3 chip_smoke.py --only k1   # device, build, K1's checks and timing
    python3 chip_smoke.py --only k2   # device, build, K2's checks and timing
    python3 chip_smoke.py --only stem # device, build, the ResNet50 stem's checks and timing
    python3 chip_smoke.py --only apps # device, build, phase 8
    python3 chip_smoke.py --only train # device, build, phase 9
    python3 chip_smoke.py --only parallel # device, build, phase 10
    python3 chip_smoke.py --only multicard # phase 10's layouts across several cards
    python3 chip_smoke.py --only int8 # device, build, phase 11
    python3 chip_smoke.py --only tools # device, build, phase 12

Phases, each printing its own line; any failure exits nonzero and prints
no result:
1. device: needs CUDA; prints the card's `name, power.limit` (nvidia-smi)
   and the torch / CUDA versions. TF32 is turned off (f32 parity mode).
2. build: compiles the traversal kernel K1 (csrc/traversal.cu), the
   fused sepconv kernel K2 (csrc/sepconv.cu) and ResNet50's fused stem
   (csrc/stem.cu), one nvcc each, in parallel; prints what ptxas says of
   K1's walk and of the stem (registers, stack frame, spills) and fails
   unless K1's state stays in registers (0-byte stack frame, no spills).
3. K1 against its plain PyTorch version on the card, bit for bit, at the
   main path's 33x33 stride-16 grid (B=8, K=128), at 91x161 stride 8 on
   views of one 115-channel heads tensor (as `run_heads` writes them), and
   where the first backward hop to the nose lands on a zero score.
   K2 against its plain version at B=2 at every (H, W, C_in, C_out) that
   a K2 layer of the four models has at 513x513 (17x17 1024->1024, m101
   s32's last, is the BM = 64 path), and at B=1 9x9 512->512 (one block,
   a ragged pixel tile); then the dilated layers: m101
   s16's layer 13 (33x33 1024->1024 at rate 2) and m101 s8 720p's layers
   7-13 (91x161, 512->512 and 512->1024 at rate 2, 1024->1024 at rate 4)
   at B=2, the rest of the four models' s8 layers at 513x513, a ragged
   one-block tile at rate 2 and a 5x5 map at rate 4; then the stride-2
   layers of the four models at 513x513 (`K2_STRIDED`), a ragged one-block
   tile, even sides and each stride-2 BN = 16 fallback: each element within
   one bf16 ulp, or 2^-16. K2's
   pointwise alone (identity depthwise) on one 64x128x64 product against
   torch.matmul, to the same tolerance. ResNet50's fused stem against its
   plain version at B=1, 3 and 256 513x513, 33x33, 17x49, 2x257x449 and
   2x7x7: within one bf16 ulp (with a floor of 2^-16 of the output's
   scale); its launches in a ResNet50 s16 2x129x129 forward (1 in bf16,
   0 in float32, 53 convs each) and in an m101 bf16 forward (0).
4. float32 parity on the card, fixture m50 s16 weights, synthesized photos:
   CUDA heads against CPU heads within 1e-4 of each head's scale; CUDA
   decode_batch (through K1) against CPU decode_batch (plain version) on
   the same heads: coordinates and keypoint scores bitwise, pose scores
   within 2 ulp; the whole slice, and the raw-frame slice (480x640 BGR
   resized on the device to 353x481), on the card against the CPU.
   bf16 m101 s16 heads at 65x65 B=2, trunk through K2 on the card and
   through its plain version on the CPU, within 2e-3.
5. the main path: PoseNetPipeline over load_model(101, 16, bf16, random
   init) on 8 uint8 513x513 frames, then decode_batch on peaked heads.
   Shapes, finite values, >=1 pose per peaked image, K1's launch count and
   K2's (13, one forward, 3 of them at stride 2) over exactly this run.
   Then the raw-frame path
   (device_resize_to=(513, 513)) on 16 BGR 720x1280 frames, with its own
   counts: shapes, finite values, equal to preprocess -> forward -> decode
   chained by hand. Then the ResNet50 main path: PoseNetPipeline over
   ResNet50(16, bf16, random init) on 8 uint8 513x513 frames, the stem's
   launches (1) and the trunk's convs (53) counted over exactly that call.
6. serving, m101 s16 bf16 513x513, min_pose_score 0 so that poses come
   out: (a) export a `cuda` artifact at batch sizes (1, 8) with
   `torch.export`, load it, and hold it bitwise to PoseNetPipeline on 8
   frames, with K2 launched 13 times and K1 at least once by the loaded
   program, every K2 input a view of the previous layer, no copy, and
   K1's row inputs views of the heads tensor (the scores of its sigmoid);
   (b) PoseServer over the artifact and over LivePipelineBackend on
   127.0.0.1, 16 raw frames posted concurrently, each reply equal to the
   in-process result for its frame at a served batch size, /healthz and
   /statsz; (c) 720x1280 BGR frames resized on the host by
   native_preprocess.resize_rgb (the native library where cv2 is absent;
   within 1 LSB of cv2's where cv2 is present), posted raw and checked the
   same way (the server's JPEG/PNG path needs cv2 and then resizes with
   it, so it never reaches the native library); (d) tools/serve_loadgen.py
   unchanged against the live server (batch sizes (1, 8, 32)) with 32
   clients for 3 s, at pipeline_depth 2 and 1: exit 0, replies, no error.
7. the kernels alone at the benchmark's shapes: each launch of K1, K2 and
   the stem in one call of each cell of BENCHMARK.json
   (`cell_kernel_shapes`: K2's layers of an m101 forward, the stem of a
   ResNet50 forward, K1 in the decode, at the cell's batch and frame
   size), held to its plain version, then timed by CUDA events in turns
   against it and against the library calls it replaces, beside its bound
   at the yardstick's peaks (`benchmarks/yardstick.py`): K2 against the
   cuDNN depthwise + pointwise pair the trunk ran before (dilated or
   strided as the layer is, with its bias and ReLU6 passes), bound
   `k2_launch_bound_ms` (at stride 1 `yardstick.k2_bound_ms`, the bound
   `k2_roofline.offline` divides by; at stride 2 the input read at its
   own size);
   the stem against cuDNN's fused conv-bias-ReLU + F.max_pool2d, bound
   `stem_bound_ms`; K1 on peaked heads at the cell's grid and decode
   config, by CUDA graph replay (the device alone) and per call by CUDA
   events (host dispatch included), bound `k1_bound_ms` (the hops that
   fetch in this run's walk), beside its latency floor (one candidate
   alone).
8. the single pose and the apps, in float32 as the JAX apps run. (1)
   `decode_single_pose` on the card against the same call on the CPU,
   bitwise with the same root and one K1 launch a call, on synthesized
   heads at 33x33 s16 and 91x161 s8, the fixture m50 s16's heads of a
   synthesized photo and a heatmap with nothing above the threshold; K1 at
   that B = K = 1 shape held to its plain version. Where cv2 imports (else
   one line says so): (2) each app's `main(argv)` in-process with its
   default device, m101 s16 random weights, float32 with TF32 off (each
   app turns it off), inputs written with numpy and cv2 into a temporary
   directory (the working directory meanwhile): image_demo on 4 photos
   720x1280, cold and then warm (the second run at a shape in the
   process), benchmark per frame (20 frames; again with --profile) and at
   --batch_size 128 --image_size 513 with --profile, webcam_demo on a
   stand-in capture of 8 frames cold and 24 warm, video_demo on a 40-frame
   720x1280 mp4 at 513x513 batch 16, with the host resize and with
   --device_preprocess; outputs and K1's launches over each run. Then the
   per-frame decode at the per-frame apps' grids (46x81 and 33x58 from
   one 720x1280 frame's m101 heads): `decode_batch` on the card against
   the CPU, and K1 on its recorded arguments against its plain version.
   (3) video_demo --poses_out with the fixture m50 s16 weights (./_models)
   on the card against --device cpu: equal pose counts, coordinates within
   1e-3 px.
9. heads-only fine-tuning, m101 s16 at 513x513 (published widths and
   depth, seeded random weights), on 16 synthesized photos with Dataloop
   annotations of their two figures, prepared by the port's
   `prepare_ground_truth_data` (needs cv2). (1) One float32 step at b2
   (TF32 off) on the card against the same step on the CPU: the loss
   within 1e-5 relative, each head tensor's gradient within 1e-4 of its
   max |grad| (the displacement heads, which the loss does not read,
   exactly 0), no K2 launch. (2) The same in bf16, K2 on the card against
   its plain version on the CPU: the heads of the forward within 2e-3,
   the loss gap and the gradient gap printed, 13 K2 launches. (3) `train()`
   on the card, float32 (with visual dumps) and bf16, b16, 2 epochs, lr
   1e-4, eval with pose metrics on the same 16 images: finite losses, the
   trunk bitwise unchanged, the heads moved, the eval loss lower after
   than before and the second epoch's train loss (the same 16 images)
   below the first's, the latest checkpoint restored bitwise with its Adam
   moments; K2 launched 13 times for each bf16 forward (a step, an eval
   loss, an eval decode an epoch), none in float32; K1 once for each eval
   batch and visual dump. (4) `posenet-export-torch --from_checkpoint` of
   the bf16 run's checkpoint to a `cuda` artifact, bitwise equal to
   PoseNetPipeline over the restored params.
10. multi-device on the one card, m101 s16 513x513 bf16 (published widths
   and depth, seeded random weights), every shard on cuda:0 through a
   device list that repeats it. (a) The data partition of 128 synth_photo
   frames over 2 shards and over every visible card, and of an uneven 129
   over 2: per shard its heads against the unsharded forward's rows,
   bitwise or within the bf16 bar 2e-3 (which held is printed), and its
   poses bitwise wherever its heads are; K2 launched 13 times and K1 once
   a shard. (b) The spatial partition of one frame, trunk biases + 1.0,
   over 2 and 4 shards, bf16 and float32: the gathered heads against the
   unsharded heads (2e-3; 1e-4 of each head's scale in float32), the
   poses bitwise where the heads are; K2 13 times a shard, K1 once. (c)
   The data-parallel train step at b16 on phase 9's dataset, world size 1
   over NCCL, against the single-device step, float32 and bf16: loss,
   head gradients and heads after Adam bitwise; then 2 gloo ranks on the
   one card (8 images each) against one device, or why gloo refused.
   (d) `LivePipelineBackend(num_devices=1)` and an artifact exported with
   `data_parallel_devices=1`, served, each reply equal to the in-process
   result; the artifact bitwise equal to the pipeline.
11. the int8 trunk (`models/quantized.py`), m101 s16 513x513 (published
   widths and depth, seeded random weights). (1) `quantize_params` on the
   card bitwise equal to the CPU's; at every (M, K, N) of the b128 trunk's
   pointwise products, at M = 9 (padded to 17 rows) and at m50's K = 16:
   `torch._int_mm` equal to the exact float64 product, and `_pw_int8`
   bitwise equal to the CPU's on the same rows. (2) The trunk at 2x65x65
   on the card against the CPU: the share of differing int8 levels at each
   quantize, printed; the heads within 2e-3, or else within the JAX
   package's int8 envelope (heatmap 0.02, offsets 0.1), which of the two
   printed. (3) `PoseNetPipeline` with `quantized=True` on 8 synth_photo
   frames, then the decode on peaked heads: shapes, finite values, >= 1
   pose per peaked image, K1 once a batch, K2 never. (4) The data
   partition over 2 shards of cuda:0 bitwise equal to the unsharded run;
   the spatial partition, `device_resize_to` and serving export refused.
   (5) A tfjs m101 checkpoint at published widths
   (tests/torch_tfjs_fixture.py) converted by `load_model`'s cold start on
   the card, no fetch: float32 heads card against CPU within 1e-4 of each
   head's scale.
12. the tools on the card, each through its own entry point. (a)
   `decode.decode_single` on the card against the CPU, bitwise, one K1
   launch a call, at 33x33 s16 and 91x161 s8;
   `mobilenet_v1.backbone_features` m101 s16 bf16 at 1x257x257 through K2
   (13 launches) against its plain version on the CPU, within 2e-3 of the
   features' scale, max(1, max |feature|), NHWC. (b) `infer` in bf16 at
   m50 s16 1x513x513, m101 s16 16x513x513, m101 s8 4x721x1281 and m101
   s16 1x721x1281, and `decode_batch` on peaked b4 heads at the s8 1080p
   grid (136x241): the launches of one call, K1 once and K2 once for each
   fused layer (none in the decode), shapes and finite values, the
   decode's poses equal to the CPU's. (c)
   `tools/verify_spatial_large_torch.py`: the spatial partition at 513x513
   s16 and 721x1281 s8 over ['cuda:0'] * 8 (every card in turn on a host
   with several), bitwise equal to the unsharded pipeline. (d)
   `tools/train_accuracy_delta_torch.py` at its defaults (m50 129x129, 40
   epochs, 16 + 4 synthesized images; needs cv2): held-out OKS and mAP
   before and after.
Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Each kernel's entry has its `name`,
`route`, `source` and `replaces`; its `launches` on the main path (the
stem's from phase 5's ResNet50 call) or, under an `--only` mode that
runs no main path, over the run `launches_from` names; `launches_by_path`
(phases 5, 8, 9, 10, 11 and 12, the stem's own forwards); `max_abs_err`
from its plain version; and, where phase 7 ran, `cells`: {cell: phase
7's sums over the cell's launches}. A cell's sums hold `launches`, `ms`,
`plain_ms`, `library_ms` (null for K1, which replaces no library call),
`bound_ms` and `err`; K2's add `dilated_ms`, `strided_ms`,
`strided_bound_ms` and `strided_library_ms`, the stem's `bound_by`, and
K1's `call_ms`, `floor_ms` and `dead_ms`; a cell whose launches equal an
earlier cell's copies its sums and names that cell in `timed_in`. K1's
`ms` is CUDA graph replay, the device alone, because its per-call time
is the host's; its `call_ms` is the per-call time, the method of its
`plain_ms` (the plain version cannot be captured in a graph: it copies
its stride to the card).

`--only k1` runs phases 1, 2, K1's part of 3 and K1's timing of 7;
`--only k2` runs phases 1, 2, K2's part of 3, the bf16 trunk check of 4
and K2's timing of 7; `--only stem` runs phases 1, 2, the stem's part of 3, phase 5's
ResNet50 call (whose count is its `launches`, as in the full run) and
its timing of 7; `--only apps`, `train`, `parallel`, `int8` and `tools`
run phases 1, 2 and the phase they name, and time nothing; each prints
the same two lines (the kernels' entries with their launches from the
phase they ran, as `launches_from` says).

The run needs no network: `load_model` without a checkpoint would try
the tfjs download, so the run's `download._fetch` fails at once as
offline, and the download cache is a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from benchmarks import harness
from benchmarks.yardstick import (BF16_TENSOR_FLOPS, F32_FLOPS, HBM_BYTES_S, k2_bound_ms,
                                  layer_shapes)
from posenet_tpu_torch import (PoseNetPipeline, decode, decode_single_pose, load_model,
                               native_preprocess)
from posenet_tpu_torch.apps import full_float32
from posenet_tpu_torch.config import DecodeConfig, ModelConfig, TrainConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.decode import (_BWD_LEVELS, _FWD_LEVELS, DecodedPoses, _prepare_decode,
                                     decode_batch)
from posenet_tpu_torch.models import mobilenet_v1, quantized, resnet50
from posenet_tpu_torch.models.model_factory import PoseNet, ResNet50
from posenet_tpu_torch.ops import _build, sepconv, stem, traversal
from posenet_tpu_torch.parallel import mesh as mesh_lib
from posenet_tpu_torch.parallel import spatial
from posenet_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from posenet_tpu_torch.pipeline import infer, infer_raw, normalize
from posenet_tpu_torch.preprocess import preprocess_on_device, process_input
from posenet_tpu_torch.server import (LivePipelineBackend, PoseServer, _Request,
                                      make_http_server)
from posenet_tpu_torch.serving import load_serving_artifact, save_serving_artifact
from posenet_tpu_torch.serving import main as export_main
from posenet_tpu_torch.training import trainer
from posenet_tpu_torch.training import train_step as ts
from posenet_tpu_torch.training.dataset import PosenetDataset
from posenet_tpu_torch.training.ground_truth import prepare_ground_truth_data
from tests import torch_tfjs_fixture
from tests.torch_k1_cases import (head_views, k1_reads_heads_in_place, nose_zero_heads,
                                  peaked_heads)
from tools import train_accuracy_delta_torch, verify_spatial_large_torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'fixture_m50_s16.npz')
# Each hand-written kernel: (its name, its source, the TPU kernel it replaces).
KERNELS = {
    'K1': ('traverse_all_candidates', 'posenet_tpu_torch/csrc/traversal.cu',
           'posenet_tpu/ops/pallas/traversal.py:551'),
    'K2': ('sepconv', 'posenet_tpu_torch/csrc/sepconv.cu',
           'posenet_tpu/ops/pallas/sepconv.py:228'),
    'stem': ('stem_conv_relu_maxpool', 'posenet_tpu_torch/csrc/stem.cu', None),
}
# (B, H, W) of the stem's checks: the cell's 513x513 at B = 1, 3 and 256,
# maps of one or two tiles, odd sides, a 720p-like 257x449 and the least
# input it takes.
STEM_SHAPES = ((1, 513, 513), (3, 513, 513), (256, 513, 513), (1, 33, 33), (1, 17, 49),
               (2, 257, 449), (2, 7, 7))
# (H, W, C_in, C_out) of the rate-1 K2 layers of one m101 s16 513x513
# forward, then the other rate-1 K2 layers of the four models at 513x513:
# the C_in 16 and 24 stems of m50 and m75, m101 s32's last (the BM = 64
# path), and the rest of m50, m75 and m101 s8.
K2_M101_SHAPES = ((257, 257, 32, 64), (129, 129, 128, 128), (65, 65, 256, 256),
                  (33, 33, 512, 512), (33, 33, 512, 1024))
K2_OTHER_SHAPES = ((257, 257, 16, 32), (257, 257, 24, 48), (17, 17, 1024, 1024),
                   (129, 129, 64, 64), (129, 129, 96, 96), (65, 65, 128, 256),
                   (65, 65, 192, 192), (65, 65, 192, 384), (65, 65, 256, 512),
                   (33, 33, 256, 256), (33, 33, 384, 384))
# (H, W, C_in, C_out, rate): the dilated K2 layers of m101 s16 at 513x513
# (layer 13) and of m101 s8 at 721x1281 (layers 7-11, 12 and 13).
K2_M101_DILATED = ((33, 33, 1024, 1024, 2), (91, 161, 512, 512, 2), (91, 161, 512, 1024, 2),
                   (91, 161, 1024, 1024, 4))
# The other dilated layers of the four models at 513x513 (m50, m75 and
# m101 at s8), a ragged one-block pixel tile, a map smaller than the taps'
# reach, and C_in 64 (the BN = 16 fallback).
K2_OTHER_DILATED = ((65, 65, 256, 256, 2), (65, 65, 384, 384, 2), (65, 65, 512, 512, 2),
                    (65, 65, 512, 1024, 2), (65, 65, 1024, 1024, 4), (9, 9, 512, 512, 2),
                    (5, 5, 1024, 1024, 4), (11, 19, 64, 48, 2))
# (H_in, W_in, C_in, C_out) of the stride-2 K2 layers of the four models
# at 513x513: m101's layers 2, 4 and 6 and its s32 layer 12, then m50's and
# m75's 2, 4 and 6; a ragged one-block tile, even sides (the output's last
# row and column read one padding row and column), and the BN = 16
# fallback of each of the three stride-2 configurations.
K2_STRIDED = ((257, 257, 64, 128), (129, 129, 128, 256), (65, 65, 256, 512),
              (33, 33, 512, 1024), (257, 257, 32, 64), (129, 129, 64, 128),
              (65, 65, 128, 256), (257, 257, 48, 96), (129, 129, 96, 192),
              (65, 65, 192, 384), (9, 9, 512, 1024), (16, 22, 64, 128), (17, 13, 64, 48),
              (10, 12, 128, 80), (11, 9, 256, 112))
HEAD_ORDER = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')
# The module: the converter package exports the function `download` under its name.
download = importlib.import_module('posenet_tpu_torch.converter.download')


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f'chip_smoke: FAILED: {what}')


def offline_fetch(url):
    """`download._fetch` for the whole run, which needs no network:
    `load_model` without a checkpoint falls back to random weights (with
    allow_random_init) at once, as after a failed download, and never
    tries to reach the bucket."""
    raise urllib.error.URLError(f'chip_smoke runs offline ({url})')


def synth_heads(rng, b, h, w):
    """NHWC heads like tests/test_decode.py's synth_heads: uniform background
    scores, 1-3 people of 17 gaussian peaks each, smooth random offsets and
    displacements."""
    yy, xx = np.mgrid[0:h, 0:w]
    hm = rng.uniform(0, 0.3, (b, h, w, 17)).astype(np.float32)
    for i in range(b):
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.randint(3, h - 3), rng.randint(3, w - 3)
            for k in range(17):
                ky = np.clip(cy + rng.randint(-4, 5), 0, h - 1)
                kx = np.clip(cx + rng.randint(-4, 5), 0, w - 1)
                g = np.exp(-((yy - ky) ** 2 + (xx - kx) ** 2) / 4.0)
                hm[i, :, :, k] = np.maximum(hm[i, :, :, k], (0.6 + 0.4 * rng.rand()) * g)
    return [hm,
            rng.uniform(-8, 8, (b, h, w, 34)).astype(np.float32),
            rng.uniform(-24, 24, (b, h, w, 32)).astype(np.float32),
            rng.uniform(-24, 24, (b, h, w, 32)).astype(np.float32)]


def synth_figures(height, width):
    """(centre x, centre y, scale, colour) of synth_photo's two figures."""
    return ((width // 3, height // 2, height // 8, (150, 40, 40)),
            (2 * width // 3, height // 2 + 20, height // 10, (40, 120, 30)))


def figure_keypoints(height, width):
    """Per figure of synth_photo, its drawn parts as Dataloop points
    (label, x, y): the head's centre, the ends of the arms and legs, and
    the shoulders and hips on the torso. The figures face the camera, so
    their right side is on the image's left."""
    return [[('Nose', cx, cy - 2.2 * s),
             ('Right Shoulder', cx - 0.2 * s, cy - 1.3 * s),
             ('Left Shoulder', cx + 0.2 * s, cy - 1.3 * s),
             ('Right Wrist', cx - s, cy - 0.4 * s), ('Left Wrist', cx + s, cy - 0.6 * s),
             ('Right Hip', cx - 0.15 * s, cy), ('Left Hip', cx + 0.15 * s, cy),
             ('Right Ankle', cx - 0.6 * s, cy + 1.6 * s),
             ('Left Ankle', cx + 0.5 * s, cy + 1.7 * s)]
            for cx, cy, s, _ in synth_figures(height, width)]


def synth_photo(height, width, seed):
    """A photograph-like RGB uint8 scene with two person-shaped figures, the
    geometry of tests/tfjs_fixture.synth_photo (the scenes the fixture
    heads were fitted on), drawn with numpy alone."""
    rng = np.random.RandomState(seed)
    img = np.zeros((height, width, 3), np.float32)
    for c, (top, bot) in enumerate(((90, 70), (140, 110), (180, 60))):
        img[:, :, c] = np.linspace(top, bot, height)[:, None]
    yy, xx = np.mgrid[0:height, 0:width]

    def seg(p0, p1, thick, color):
        (x0, y0), (x1, y1) = p0, p1
        dx, dy = x1 - x0, y1 - y0
        t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / max(dx * dx + dy * dy, 1), 0, 1)
        near = (xx - x0 - t * dx) ** 2 + (yy - y0 - t * dy) ** 2 <= (thick / 2) ** 2
        img[near] = color

    for cx, cy, s, color in synth_figures(height, width):
        head = (xx - cx) ** 2 + (yy - (cy - 2.2 * s)) ** 2 <= (0.5 * s) ** 2
        img[head] = color
        seg((cx, cy - 1.6 * s), (cx, cy), max(2, 0.45 * s), color)
        seg((cx, cy - 1.3 * s), (cx - s, cy - 0.4 * s), max(1, 0.3 * s), color)
        seg((cx, cy - 1.3 * s), (cx + s, cy - 0.6 * s), max(1, 0.3 * s), color)
        seg((cx, cy), (cx - 0.6 * s, cy + 1.6 * s), max(1, 0.35 * s), color)
        seg((cx, cy), (cx + 0.5 * s, cy + 1.7 * s), max(1, 0.35 * s), color)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def assert_poses_equal(got: DecodedPoses, ref: DecodedPoses, what: str):
    """Keypoints bitwise, pose scores within 2 ulp, counts equal."""
    for f in ('keypoint_scores', 'keypoint_coords', 'pose_offsets', 'candidate_count'):
        check(torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f'{what}: {f}')
    a, b = got.pose_scores.cpu().numpy(), ref.pose_scores.cpu().numpy()
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    check(int(ulps.max()) <= 2, f'{what}: pose scores {int(ulps.max())} ulp apart')


def k1_args(heads, stride, cfg):
    """K1's tensor arguments for NHWC heads, as `decode_batch` makes them:
    the candidates, then the heads as row views."""
    rows = _prepare_decode(*heads, stride, cfg)
    return (*rows[4:7], *rows[:4])


def k1_against_plain(args, h, w, stride):
    """(bitwise equal, max abs difference, keypoints filled, the plain
    version's outputs) of K1 against the plain version on the same device
    tensors."""
    got = traversal.traverse_all_candidates(*args, h, w, stride)
    torch.cuda.synchronize()
    ref = traversal.traverse_all_candidates_reference(*args, h, w, stride)
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    return equal, err, int((ref[0] > 0).sum()), ref


def k2_inputs(b, h, w, c_in, c_out, seed, device):
    """K2's arguments: activations in ReLU6's range, unit-gain weights."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.rand((b, h, w, c_in), generator=g, device=device) * 6).to(torch.bfloat16)
    taps = sepconv.pack_depthwise(
        torch.randn((c_in, 1, 3, 3), generator=g, device=device) * 0.4)
    dw_b = torch.randn((c_in,), generator=g, device=device) * 0.3
    pw_w = (torch.randn((c_out, c_in), generator=g, device=device)
            / c_in ** 0.5).to(torch.bfloat16)
    pw_b = torch.randn((c_out,), generator=g, device=device) * 0.3
    return x, taps, dw_b, pw_w, pw_b


def k2_against_plain(args, rate=1, stride=1):
    """(within tolerance, max abs difference, share bitwise equal) of K2
    against its plain version at dilation `rate` and `stride`
    (`k2_close`)."""
    got = sepconv.sepconv(*args, rate=rate, stride=stride)
    torch.cuda.synchronize()
    return k2_close(got, args, rate, stride)


def k2_close(got, args, rate=1, stride=1):
    """(within tolerance, max abs difference, share bitwise equal) of the
    K2 output `got` against the plain version on `args`: each element
    within one bf16 ulp of the plain value, or 2^-16
    (tests/test_torch_sepconv.py)."""
    ref = sepconv.sepconv_reference(*args, rate, stride).float()
    diff = (got.float() - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    ok = bool((diff <= ulp.clamp_min(2.0 ** -16)).all())
    return ok, float(diff.max()), float((diff == 0).float().mean())


def benchmark_cells() -> list:
    """The names of BENCHMARK.json's cells, in its order."""
    return [w['name'] for w in harness.load_json(harness.BENCHMARK_JSON)['workloads']]


def cell_kernel_shapes(workload: str) -> list:
    """Each launch of a hand-written kernel in one call of the cell
    `workload` of BENCHMARK.json, at the cell's batch and frame size (its
    configuration's `model` and `decode`, its traffic's `batch`, `height`
    and `width`), as a dict with `kernel` ('K1', 'K2' or 'stem'), `batch`,
    `h` and `w`. An m101 forward launches K2 on each separable layer of
    `yardstick.layer_shapes`, with the layer's index `layer`, its output
    map `h` x `w`, its input map `h_in` x `w_in` (the previous layer's
    output), `c_in`, `c_out`, `stride` and dilation `rate` (the stride-1
    launches are the layers `k2_roofline.offline` bounds); a ResNet50
    forward launches the stem once on the `h` x `w` frames; the decode
    launches K1 once on the heads' grid, with the cell's `stride` and
    `decode` (a DecodeConfig)."""
    cell = harness.load_cell(workload)
    model, traffic = cell.config['model'], cell.traffic
    b, height, width, stride = (traffic['batch'], traffic['height'], traffic['width'],
                                model['output_stride'])
    if model.get('architecture') == 'resnet50':
        launches = [{'kernel': 'stem', 'batch': b, 'h': height, 'w': width}]
    else:
        layers = layer_shapes(model['model_id'], stride, height, width)
        launches = [{'kernel': 'K2', 'batch': b, 'layer': i, 'h': l['h'], 'w': l['w'],
                     'h_in': layers[i - 1]['h'], 'w_in': layers[i - 1]['w'], 'c_in': l['c_in'],
                     'c_out': l['c_out'], 'stride': l['stride'], 'rate': l['rate']}
                    for i, l in enumerate(layers) if l['kind'] == 'sep']
    return launches + [{'kernel': 'K1', 'batch': b, 'h': (height - 1) // stride + 1,
                        'w': (width - 1) // stride + 1, 'stride': stride,
                        'decode': DecodeConfig(**cell.config['decode'])}]


def k2_launch_bound_ms(s: dict) -> float:
    """The least time of the K2 launch `s` (`cell_kernel_shapes`). At
    stride 1, `yardstick.k2_bound_ms`, the bound `k2_roofline.offline`
    divides by. At stride 2, the same count at the yardstick's peaks with
    the input read at its own size: the `h_in` x `w_in` input read once and
    the `h` x `w` output written once (bf16, and the weights) at HBM speed,
    against the pointwise's products on the bf16 tensor cores and the
    depthwise's 9 taps in float32, whichever is longer."""
    b, h, w, c_in, c_out = (s[k] for k in ('batch', 'h', 'w', 'c_in', 'c_out'))
    if s['stride'] == 1:
        return k2_bound_ms(b, h, w, c_in, c_out)
    m = b * h * w
    nbytes = (2 * (b * s['h_in'] * s['w_in'] * c_in + m * c_out)
              + 2 * 9 * c_in + 4 * c_in + 2 * c_in * c_out + 4 * c_out)
    return 1e3 * max(nbytes / HBM_BYTES_S, 2 * m * c_in * c_out / BF16_TENSOR_FLOPS,
                     2 * 9 * m * c_in / F32_FLOPS)


def k1_fetches(args, h, w, stride):
    """The hops that fetch in this walk: a hop reads its rows only where it
    fills an empty keypoint from a filled one (traversal.cu), and one that
    lands on a zero score leaves its keypoint empty. Replays the walk's
    steps as the plain version rounds them, hop by hop, and fails unless
    its scores equal the plain version's."""
    cs, ck, rc, hm, off, dft, dbt = args
    st = torch.tensor(float(stride), device=cs.device)
    score, cy, cx = ([torch.where(ck == j, v, torch.zeros_like(cs)) for j in range(17)]
                     for v in (cs, rc[..., 0], rc[..., 1]))

    def cell(coord, n):
        return torch.clamp(torch.round(coord / st), 0.0, n - 1.0)

    def rows(table, iy, ix):
        idx = (iy * w + ix).long()
        return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))

    fetches = 0
    for levels, table in ((_BWD_LEVELS, dbt), (_FWD_LEVELS, dft)):
        for e, s, t in (hop for level in levels for hop in level):
            drow = rows(table, cell(cy[s], h), cell(cx[s], w))
            ty, tx = cell(cy[s] + drow[..., e], h), cell(cx[s] + drow[..., 16 + e], w)
            orow = rows(off, ty, tx)
            fill = (score[s] > 0.0) & (score[t] == 0.0)
            fetches += int(fill.sum())
            score[t] = torch.where(fill, rows(hm, ty, tx)[..., t], score[t])
            cy[t] = torch.where(fill, ty * st + orow[..., t], cy[t])
            cx[t] = torch.where(fill, tx * st + orow[..., 17 + t], cx[t])
    ref = traversal.traverse_all_candidates_reference(*args, h, w, stride)
    check(torch.equal(torch.stack(score, -1), ref[0]),
          'the replayed K1 walk differs from the plain version')
    return fetches


def k1_bound_ms(b, k, fetches):
    """K1's bound: the bytes this run's walk needs. Each of the B x K
    candidates reads its score, keypoint and root (16 bytes) and writes 17
    scores, coordinate pairs and offset pairs (340); each of the `fetches`
    hops (`k1_fetches`) reads one displacement pair (8) and the landing
    cell's score and offset pair (12), at the yardstick's HBM peak."""
    return (b * k * (16 + 340) + fetches * (8 + 12)) / HBM_BYTES_S * 1e3


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10):
    """Mean device time of one fn() call with the host out of the way:
    `calls` calls captured in one CUDA graph, replayed `replays` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def post_raw(base, frames):
    """POST each (H, W, 3) uint8 frame raw, all at once from one thread
    each; returns the JSON replies in order."""
    replies = [None] * len(frames)

    def post(i):
        req = urllib.request.Request(base + '/v1/decode', data=frames[i].tobytes(),
                                     headers={'Content-Type': 'application/x-posenet-frame'})
        with urllib.request.urlopen(req, timeout=300) as r:
            replies[i] = json.loads(r.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(all(r is not None for r in replies), 'a raw-frame request got no reply')
    return replies


def in_process_json(server, backend, frames):
    """Per frame, the reply JSON the server would send at each served
    batch size, from the backend called in-process on the same frames."""
    plain = _Request(None, (1.0, 1.0), 0.0, 0.0)
    expected = [dict() for _ in frames]
    for b in server.batch_sizes:
        for start in range(0, len(frames), b):
            chunk = frames[start:start + b]
            batch = np.zeros((b, *frames.shape[1:]), np.uint8)
            batch[:len(chunk)] = chunk
            out = backend(batch)
            ps, ks, kc = (getattr(out, f).cpu().numpy()
                          for f in ('pose_scores', 'keypoint_scores', 'keypoint_coords'))
            for i in range(len(chunk)):
                expected[start + i][b] = server._poses_json(ps[i], ks[i], kc[i], plain)
    return expected


def serve_and_check(backend, name, frames, what):
    """PoseServer over `backend` on 127.0.0.1: `frames` posted raw at once,
    each reply equal to the in-process result for its frame at one of the
    served batch sizes; /healthz and /statsz read. Returns the batch
    histogram."""
    server = PoseServer(backend, batch_wait_ms=2.0)
    server.warmup()
    httpd = make_http_server(server, '127.0.0.1', 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f'http://127.0.0.1:{httpd.server_address[1]}'
    try:
        health = json.loads(urllib.request.urlopen(base + '/healthz', timeout=60).read())
        check(health['ok'], f'{name} server /healthz not ok')
        replies = post_raw(base, frames)
        stats = json.loads(urllib.request.urlopen(base + '/statsz', timeout=60).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    expected = in_process_json(server, backend, frames)
    for i, reply in enumerate(replies):
        check(reply['source_hw'] == list(frames.shape[1:3]), f'{name}: source_hw {reply}')
        check(any(reply['poses'] == e for e in expected[i].values()),
              f'{name} server: the reply for {what} {i} equals no in-process result')
    poses = [len(r['poses']) for r in replies]
    check(min(poses) >= 1, f'{name} server replied without poses: {poses}')
    check(stats['requests_done'] == len(frames) and stats['errors'] == 0,
          f'{name} server /statsz {stats}')
    print(f'serving (b): {name} server, {len(frames)} {what}s posted raw at once: every reply '
          f'equal to the in-process result for its frame; poses per reply {poses}; '
          f'/statsz batches {stats["batches_by_size"]}, device_ms_total '
          f'{stats["device_ms_total"]:.3f}', flush=True)
    return stats['batches_by_size']


def serving_phase(model, dev):
    """Phase 6: export and load, serve raw frames, serve host-resized
    frames, serve under load at pipeline_depth 2 and 1."""
    dcfg = DecodeConfig(min_pose_score=0.0)
    g = torch.Generator(device=dev).manual_seed(3)
    frames8 = torch.randint(0, 256, (8, 513, 513, 3), generator=g, device=dev,
                            dtype=torch.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) export, load, check
        path = os.path.join(tmp, 'm101_s16_bf16.posenet')
        meta = save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(1, 8),
                                     input_hw=(513, 513), platforms=('cuda',))
        size_mb = os.path.getsize(path) / 2 ** 20
        art = load_serving_artifact(path)
        check(art.device.type == 'cuda', f'artifact loaded on {art.device}')
        pipe = PoseNetPipeline(model, dcfg)
        for b in (1, 8):
            art(frames8[:b])
        torch.cuda.synchronize()
        ref = pipe(frames8)
        torch.cuda.synchronize()
        traversal.launches = sepconv.launches = 0
        out = art(frames8)
        torch.cuda.synchronize()
        k1, k2 = traversal.launches, sepconv.launches
        check(k2 == 13 and k1 >= 1, f'the loaded artifact launched K1 {k1} and K2 {k2} times')
        for f, a, b in zip(DecodedPoses._fields, out, ref):
            check(torch.equal(a, b), f'artifact b8 differs from PoseNetPipeline in {f}')
        for b in (1, 8):   # K2 reads the previous layer's output in place
            made_by = [n.args[0].target for n in art._program(b).graph.nodes
                       if n.target == torch.ops.posenet_tpu_torch.sepconv.default]
            check(made_by == [torch.ops.aten.permute.default] * 13,
                  f'b{b} program: the K2 inputs are made by {made_by}, not 13 views (permute)')
        k1_inputs = [k1_reads_heads_in_place(art._program(b).graph) for b in (1, 8)]
        check(all(torch.equal(a, b) for a, b in zip(art(frames8[:1]), pipe(frames8[:1]))),
              'artifact b1 differs from PoseNetPipeline')
        n_poses = (out.pose_scores > 0).sum(1).tolist()
        print(f'serving (a): export m101 s16 bf16 513x513 batches {meta["batch_sizes"]} '
              f'platform cuda, {size_mb:.2f} MiB; loaded program bitwise equal to '
              f'PoseNetPipeline at b8 and b1; K2 launches {k2} and K1 launches {k1} in one '
              f'b8 call; every K2 input a view (permute), no copy, in both programs; '
              f'K1 reads the heads in place in both programs ({k1_inputs[1]}); '
              f'poses per image {n_poses}', flush=True)

        # (b) serve raw frames from the artifact and from the live pipeline
        rng = np.random.default_rng(16)
        raw16 = rng.integers(0, 256, (16, 513, 513, 3), dtype=np.uint8)
        live = LivePipelineBackend(model, decode_cfg=dcfg, input_hw=(513, 513),
                                   batch_sizes=(1, 8))
        serve_and_check(art, 'artifact', raw16, 'raw frame')
        serve_and_check(live, 'live', raw16, 'raw frame')

        # (c) host resize on the card's host, then served raw
        bgr = rng.integers(0, 256, (8, 720, 1280, 3), dtype=np.uint8)

        def resize_all(backend):
            return np.stack([native_preprocess.resize_rgb(f, (513, 513), backend) for f in bgr])

        has_cv2 = importlib.util.find_spec('cv2') is not None
        saved = sys.modules.get('cv2')
        sys.modules['cv2'] = None   # as on a host without cv2: 'auto' takes the library
        try:
            native = resize_all('auto')
        finally:
            if saved is None:
                del sys.modules['cv2']
            else:
                sys.modules['cv2'] = saved
        check(np.array_equal(native, resize_all('native')),
              "resize_rgb 'auto' without cv2 is not the native library")
        line = (f'serving (c): host resize 720x1280 BGR -> 513x513 RGB by '
                f'native_preprocess.resize_rgb without cv2 (the native library)')
        if has_cv2:
            lsb = int(np.abs(resize_all('cv2').astype(int) - native).max())
            check(lsb <= 1, f'native resize {lsb} LSB from cv2')
            line += f'; cv2 is present here: within {lsb} LSB of it'
        else:
            line += '; cv2 is absent here'
        print(line, flush=True)
        serve_and_check(art, 'artifact', native, 'host-resized 720p frame')
        del art

    # (d) tools/serve_loadgen.py against the live server, pipeline_depth 2 and 1
    for depth in (2, 1):
        live = LivePipelineBackend(model, decode_cfg=dcfg, input_hw=(513, 513),
                                   batch_sizes=(1, 8, 32))
        server = PoseServer(live, batch_wait_ms=2.0, pipeline_depth=depth)
        server.warmup()
        httpd = make_http_server(server, '127.0.0.1', 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            done = subprocess.run(
                [sys.executable, os.path.join(REPO, 'tools', 'serve_loadgen.py'), '--base',
                 f'http://127.0.0.1:{httpd.server_address[1]}', '--clients', '32',
                 '--seconds', '3'], capture_output=True, text=True, timeout=300)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        check(done.returncode == 0, f'serve_loadgen failed: {done.stderr[-2000:]}')
        result = json.loads(done.stdout.strip().splitlines()[-1])
        check(result['requests'] > 0 and result['errors'] == 0, f'serve_loadgen: {result}')
        print(f'serving (d): tools/serve_loadgen.py, 32 clients for 3 s against the live '
              f'server (batches (1, 8, 32), pipeline_depth {depth}): {result["requests"]} '
              f'replies, {result["errors"]} errors; batches {result["batches_by_size"]}',
              flush=True)


def device_phase():
    """Phase 1: the card's name and power limit, versions; TF32 off.
    Returns (kind, device), or None without CUDA."""
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on an NVIDIA GPU',
              file=sys.stderr)
        return None
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f'device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
          f'cuDNN {torch.backends.cudnn.version()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    return kind, dev


def ptxas_report(log: str, kernel: str):
    """(registers, stack frame bytes, spill store bytes, spill load bytes,
    ptxas's lines) that `nvcc -Xptxas -v` printed for the one entry
    function whose name holds `kernel`."""
    found = [part for part in log.split('Compiling entry function')[1:]
             if kernel in part.splitlines()[0]]
    check(len(found) == 1, f'ptxas reported {len(found)} entry functions named {kernel}')
    frame = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', found[0])
    regs = re.search(r'Used (\d+) registers', found[0])
    check(frame is not None and regs is not None, f'no ptxas report for {kernel}')
    lines = ' | '.join(line.strip() for line in found[0].splitlines()[1:] if line.strip())
    return (int(regs[1]), int(frame[1]), int(frame[2]), int(frame[3]), lines)


def build_phase():
    """Phase 2: K1, K2 and the stem, one nvcc each, in parallel, then
    loaded; what ptxas says of the stem and of K1's walk, which must keep
    its state in registers."""
    t0 = time.perf_counter()
    libs = _build.build_all(['traversal', 'sepconv', 'stem'])
    for name in libs:
        _build.load(name)
    print('build: ' + ', '.join(f'{k} {KERNELS[k][1]} -> {os.path.relpath(libs[lib], REPO)}'
                                for k, lib in (('K1', 'traversal'), ('K2', 'sepconv'),
                                               ('stem', 'stem')))
          + f' in {time.perf_counter() - t0:.2f} s (nvcc {" ".join(_build.NVCC_FLAGS)})',
          flush=True)
    regs, frame, spill_st, spill_ld, lines = ptxas_report(_build.build_log('stem'),
                                                          'stem_conv_relu_maxpool_kernel')
    print(f'build: stem_conv_relu_maxpool_kernel, ptxas: {regs} registers, {frame} bytes '
          f'stack frame, {spill_st} bytes spill stores, {spill_ld} bytes spill loads '
          f'({lines})', flush=True)
    regs, frame, spill_st, spill_ld, lines = ptxas_report(_build.build_log('traversal'),
                                                          'traverse_kernel')
    print(f'build: K1 traverse_kernel, ptxas: {regs} registers, {frame} bytes stack frame, '
          f'{spill_st} bytes spill stores, {spill_ld} bytes spill loads ({lines})', flush=True)
    check(frame == 0 and spill_st == 0 and spill_ld == 0,
          f'K1 walk: {frame} bytes stack frame, {spill_st} + {spill_ld} bytes spilled; '
          f'its state must stay in registers')


def k1_checks(dev) -> float:
    """Phase 3, K1: against its plain version, bitwise, at the main path's
    grid, at 91x161 stride 8, and where the first backward hop to the nose
    lands on a zero score (`nose_zero_heads`); returns the max abs
    difference."""
    rng = np.random.RandomState(0)
    max_err = 0.0
    for b, h, w, stride, k, views in ((8, 33, 33, 16, 128, False), (4, 91, 161, 8, 32, True)):
        heads = [torch.from_numpy(a).to(dev) for a in synth_heads(rng, b, h, w)]
        if views:
            heads = head_views(heads)
        cfg = DecodeConfig(min_pose_score=0.25, max_candidates=k, score_threshold=0.3)
        args = k1_args(heads, stride, cfg)
        equal, err, filled, _ = k1_against_plain(args, h, w, stride)
        max_err = max(max_err, err)
        check(equal, f'K1 differs from its plain version at B={b} {h}x{w} K={k} (max {err})')
        check(filled > b * k, f'K1 walk filled only {filled} keypoints at {h}x{w}')
        print(f'K1 vs plain: B={b} {h}x{w} s{stride} K={k}, heads as rows of '
              f'{[t.stride(1) for t in args[3:]]} floats: bitwise equal (tolerance 0), '
              f'{filled} keypoints filled', flush=True)
    args = k1_args([torch.from_numpy(a).to(dev) for a in nose_zero_heads()], 16,
                   DecodeConfig(max_candidates=16, score_threshold=0.3))
    equal, err, filled, ref = k1_against_plain(args, 33, 33, 16)
    max_err = max(max_err, err)
    check(equal, f'K1 differs from its plain version where a hop to the nose lands on a '
                 f'zero score (max {err})')
    nose = {int(kp): float(score) for kp, score in zip(args[1][0, :4], ref[0][0, :4, 0])}
    filled_nose = float(np.float32(0.2))
    check(nose == {1: 0.0, 2: filled_nose, 5: filled_nose, 6: filled_nose},
          f'nose_zero_heads: nose scores by root keypoint {nose}')
    print(f'K1 vs plain: the first backward hop to the nose lands on a zero score '
          f'(nose score by root keypoint {nose}): bitwise equal, {filled} keypoints '
          f'filled', flush=True)
    return max_err


def k2_checks(dev) -> float:
    """Phase 3, K2: against its plain version at every K2 shape, rate 1,
    dilated and stride 2, the ragged one-block tiles, and the pointwise
    alone against torch.matmul; returns the max abs difference."""
    k2_err = 0.0
    shapes = [(2, h, w, c_in, c_out, 1, 1)
              for h, w, c_in, c_out in K2_M101_SHAPES + K2_OTHER_SHAPES]
    shapes += [(1, 9, 9, 512, 512, 1, 1)]
    shapes += [(1 if h < 33 else 2, h, w, c_in, c_out, r, 1)
               for h, w, c_in, c_out, r in K2_M101_DILATED + K2_OTHER_DILATED]
    shapes += [(1 if h < 17 else 2, h, w, c_in, c_out, 1, 2)
               for h, w, c_in, c_out in K2_STRIDED]
    for i, (b, h, w, c_in, c_out, rate, stride) in enumerate(shapes):
        ok, err, equal = k2_against_plain(k2_inputs(b, h, w, c_in, c_out, i, dev), rate,
                                          stride)
        k2_err = max(k2_err, err)
        check(ok, f'K2 differs from its plain version at B={b} {h}x{w} {c_in}->{c_out} '
                  f'rate {rate} stride {stride} beyond one bf16 ulp (max {err})')
        print(f'K2 vs plain: B={b} {h}x{w} {c_in}->{c_out} rate {rate} stride {stride}: within '
              f'one bf16 ulp (or 2^-16), max abs {err:.3g}, share bitwise equal {equal:.6f}',
              flush=True)
    # The pointwise alone: with the centre tap 1, the others and the bias 0,
    # the depthwise of x in [0, 6) is x, so K2 is relu6(x @ pw^T + pw_b).
    x, _, _, pw_w, pw_b = k2_inputs(1, 8, 8, 64, 128, 99, dev)
    taps = torch.zeros((9, 64), dtype=torch.bfloat16, device=dev)
    taps[4] = 1
    got = sepconv.sepconv(x, taps, torch.zeros(64, device=dev), pw_w, pw_b).float()
    ref = torch.matmul(x.float().reshape(64, 64), pw_w.float().t()) + pw_b
    ref = ref.clamp(0, 6).to(torch.bfloat16).float().reshape(got.shape)
    diff = (got - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    check(bool((diff <= ulp.clamp_min(2.0 ** -16)).all()),
          f'K2 pointwise (64x128x64) differs from torch.matmul (max {float(diff.max())})')
    print(f'K2 pointwise alone, 64x128x64 (identity depthwise) vs torch.matmul: within one '
          f'bf16 ulp, max abs {float(diff.max()):.3g}', flush=True)
    return max(k2_err, float(diff.max()))


def k2_trunk_launches(dev) -> int:
    """bf16 m101 heads at 2x65x65, s16 and s8, the trunk through K2 on the
    card against its plain version on the CPU; returns K2's launches at
    s16 (13, 3 of them at stride 2 and layer 13 at rate 2; 13 at s8, 2 at
    stride 2 and layers 7-13 dilated)."""
    x65 = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (2, 65, 65, 3))
                           .astype(np.float32))
    launches = {}
    for stride, want, want_strided in ((16, 13, 3), (8, 13, 2)):
        cfg_bf16 = ModelConfig(model_id=101, output_stride=stride, compute_dtype=torch.bfloat16)
        p101 = mobilenet_v1.init_params(torch.Generator().manual_seed(5), cfg_bf16)
        ref_bf16 = mobilenet_v1.forward(mobilenet_v1.cast_params(p101, torch.bfloat16), x65,
                                        cfg_bf16)
        sepconv.launches = sepconv.strided_launches = 0
        got_bf16 = mobilenet_v1.forward(mobilenet_v1.cast_params(p101, torch.bfloat16, dev),
                                        x65.to(dev), cfg_bf16)
        torch.cuda.synchronize()
        launches[stride] = sepconv.launches
        strided = sepconv.strided_launches
        gap = max(float((got_bf16[k].cpu() - ref_bf16[k]).abs().max()) for k in ref_bf16)
        check((launches[stride], strided) == (want, want_strided),
              f'bf16 m101 s{stride} forward launched K2 {launches[stride]} times, '
              f'{strided} at stride 2, not {want} and {want_strided}')
        check(gap <= 2e-3, f'bf16 heads s{stride}, K2 on CUDA vs plain on CPU: {gap} '
                           f'(limit 2e-3)')
        print(f'bf16 heads m101 s{stride} 2x65x65, trunk through K2 (CUDA) vs its plain '
              f'version (CPU): within {gap:.3g} (limit 2e-3); K2 launches {launches[stride]}, '
              f'{strided} at stride 2', flush=True)
    return launches[16]


def k2_timing(dev, cell, launches) -> dict:
    """Phase 7, K2 in one cell: each of its launches (`cell_kernel_shapes`)
    held to its plain version at the cell's batch, then timed by CUDA
    events in turns (plain, kernel, cuDNN, cuDNN, kernel, plain) against
    it and against the cuDNN depthwise + pointwise pair, with its bias and
    ReLU6 passes, that the trunk ran before (dilated or strided as the
    layer is), beside its bound (`k2_launch_bound_ms`). Layers of one shape
    are timed once, and that time counts once for each of them. Returns the
    sums over the launches (`dilated_ms`: the kernel's over the dilated
    layers; `strided_ms`, `strided_bound_ms`, `strided_library_ms`: the
    kernel's, the bound's and the cuDNN pair's over the stride-2 layers)
    and the max abs difference."""
    sums = dict.fromkeys(('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dilated_ms',
                          'strided_ms', 'strided_bound_ms', 'strided_library_ms'), 0.0)
    err_max = 0.0
    layers_of = {}
    for s in launches:
        shape = tuple(s[k] for k in ('batch', 'h_in', 'w_in', 'c_in', 'c_out', 'rate', 'stride'))
        layers_of.setdefault(shape, []).append(s)
    for (b, h, w, c_in, c_out, rate, stride), same in layers_of.items():
        layers = [s['layer'] for s in same]
        args = k2_inputs(b, h, w, c_in, c_out, 100 + layers[0], dev)
        x, taps, dw_b, pw_w, pw_b = args
        x_nchw = x.permute(0, 3, 1, 2)
        dw_oihw = taps.t().reshape(c_in, 1, 3, 3).contiguous()
        pw_oihw = pw_w.reshape(c_out, c_in, 1, 1)
        ok, err, equal = k2_against_plain(args, rate, stride)
        err_max = max(err_max, err)
        what = (f'{cell} layer{"s" * (len(layers) > 1)} {", ".join(map(str, layers))}, '
                f'B={b} {h}x{w} {c_in}->{c_out} rate {rate} stride {stride}')
        check(ok, f'K2 differs from its plain version at {what} beyond one bf16 ulp (max {err})')

        def pair():
            y = mobilenet_v1._conv_relu6(x_nchw, dw_oihw, dw_b, stride=stride, dilation=rate,
                                         groups=c_in)
            return mobilenet_v1._conv_relu6(y, pw_oihw, pw_b)

        runs = {}
        for name, fn, iters in (('plain', sepconv.sepconv_reference, 3),
                                ('kernel', sepconv.sepconv, 20),
                                ('cudnn', None, 20), ('cudnn', None, 20),
                                ('kernel', sepconv.sepconv, 20),
                                ('plain', sepconv.sepconv_reference, 3)):
            call = pair if fn is None else (lambda fn=fn: fn(*args, rate, stride))
            runs.setdefault(name, []).append(cuda_ms(call, iters))
        ms = {k: sum(v) / len(v) for k, v in runs.items()}
        bound = k2_launch_bound_ms(same[0])
        for key, v in (('ms', ms['kernel']), ('plain_ms', ms['plain']),
                       ('library_ms', ms['cudnn']), ('bound_ms', bound),
                       ('dilated_ms', ms['kernel'] if rate > 1 else 0.0),
                       ('strided_ms', ms['kernel'] if stride > 1 else 0.0),
                       ('strided_bound_ms', bound if stride > 1 else 0.0),
                       ('strided_library_ms', ms['cudnn'] if stride > 1 else 0.0)):
            sums[key] += len(layers) * v
        print(f'K2 {what}: kernel {ms["kernel"]:.4f} ms a layer, cuDNN pair {ms["cudnn"]:.4f} ms, '
              f'bound {bound:.4f} ms, kernel / bound {ms["kernel"] / bound:.1f}x, plain '
              f'{ms["plain"]:.4f} ms; within one bf16 ulp of plain, max abs {err:.3g}, share '
              f'bitwise equal {equal:.6f} (runs plain, kernel, cudnn, cudnn, kernel, plain: '
              f'{runs})', flush=True)
        del args, x, x_nchw
        torch.cuda.empty_cache()
    print(f'K2 over the {len(launches)} launches of one {cell} forward: kernel '
          f'{sums["ms"]:.4f} ms (the dilated layers {sums["dilated_ms"]:.4f}, the stride-2 '
          f'layers {sums["strided_ms"]:.4f} against {sums["strided_bound_ms"]:.4f} bound and '
          f'{sums["strided_library_ms"]:.4f} cuDNN pair), cuDNN pair '
          f'{sums["library_ms"]:.4f} ms, bound {sums["bound_ms"]:.4f} ms, kernel / bound '
          f'{sums["ms"] / sums["bound_ms"]:.1f}x, plain {sums["plain_ms"]:.4f} ms', flush=True)
    return dict(sums, launches=len(launches), err=err_max)


def k1_timing(dev, cell, launches) -> dict:
    """Phase 7, K1 in one cell: its launch (`cell_kernel_shapes`) on peaked
    heads at the cell's batch and grid (`peaked_heads`), the candidates as
    the cell's decode config picks them, held bitwise to its plain
    version, then timed in turns against it (plain, call, kernel, kernel,
    call, plain): per call by CUDA events, host dispatch included, and by
    CUDA graph replay, the device alone; beside its bytes bound (the hops
    that fetch in this run's walk) and its latency floor: the graph time
    of the first candidate alone (B = K = 1), and of that candidate with
    its score -1, which fetches nothing."""
    (s,) = launches
    b, h, w, stride = s['batch'], s['h'], s['w'], s['stride']
    args = k1_args(peaked_heads(b, (h, w), 8, dev), stride, s['decode'])
    k = args[0].shape[1]
    equal, err, _, _ = k1_against_plain(args, h, w, stride)
    check(equal, f'K1 differs from its plain version in {cell}, B={b} (max {err})')
    fetches = k1_fetches(args, h, w, stride)

    def kernel(*a):
        return lambda: traversal.traverse_all_candidates(*a, h, w, stride)

    def plain():
        return traversal.traverse_all_candidates_reference(*args, h, w, stride)

    runs = {}
    for name, timer in (('plain', lambda: cuda_ms(plain, 20)),
                        ('call', lambda: cuda_ms(kernel(*args), 50)),
                        ('kernel', lambda: graph_ms(kernel(*args))),
                        ('kernel', lambda: graph_ms(kernel(*args))),
                        ('call', lambda: cuda_ms(kernel(*args), 50)),
                        ('plain', lambda: cuda_ms(plain, 20))):
        runs.setdefault(name, []).append(timer())
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    bound = k1_bound_ms(b, k, fetches)
    one = tuple(a[:1, :1] for a in args[:3]) + tuple(t[:1] for t in args[3:])
    one_fetches = k1_fetches(one, h, w, stride)
    floor = graph_ms(kernel(*one))
    dead = graph_ms(kernel(torch.full_like(one[0], -1.0), *one[1:]))
    print(f'K1 {cell}, B={b} K={k} {h}x{w} s{stride}: kernel {ms["kernel"]:.4f} ms a launch '
          f'(CUDA graph of 20 launches, the device alone), {ms["call"]:.4f} ms a call (CUDA '
          f'events, host dispatch included), plain {ms["plain"]:.4f} ms, bound {bound:.4f} ms '
          f'(bytes; {fetches} fetching hops of {args[0].numel() * 32}), kernel / bound '
          f'{ms["kernel"] / bound:.1f}x; latency floor: one candidate ({one_fetches} fetching '
          f'hops) {floor:.4f} ms a launch, one dead candidate (no fetch) {dead:.4f} ms (runs '
          f'plain, call, kernel, kernel, call, plain: {runs})', flush=True)
    return {'launches': 1, 'ms': ms['kernel'], 'call_ms': ms['call'], 'plain_ms': ms['plain'],
            'library_ms': None, 'bound_ms': bound, 'floor_ms': floor, 'dead_ms': dead,
            'err': err}


def stem_args(b, h, w, seed, dev):
    """Frames as `resnet50.normalize` writes them (uint8 RGB plus the
    ImageNet mean, bf16 NHWC) and He-scaled stem parameters as
    `resnet50.cast_params` keeps them (bf16, kernel in channels_last)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, generator=g, device=dev)
    x = resnet50.normalize(frames, {'mean': torch.tensor(resnet50.IMAGENET_MEAN, device=dev)},
                           torch.bfloat16)
    wt = torch.randn((64, 3, 7, 7), generator=g, device=dev) * (2 / 147) ** 0.5
    bias = torch.randn((64,), generator=g, device=dev)
    return (x, wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
            bias.to(torch.bfloat16))


def stem_against_plain(args):
    """(within one bf16 ulp, max abs difference, share bitwise equal) of the
    kernel against its plain version; the ulp has a floor of 2^-16 of the
    output's scale, where the float32 sums' order sets the gap near zero."""
    got = stem.stem(*args).float()
    ref = stem.stem_reference(*args).float()
    torch.cuda.synchronize()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    floor = 2.0 ** -16 * max(1.0, float(ref.abs().max()))
    diff = (got - ref).abs()
    return (bool((diff <= ulp.clamp_min(floor)).all()), float(diff.max()),
            float((diff == 0).float().mean()))


def stem_bound_ms(b, h, w):
    """(the least time of the fused stem, what bounds it): the frames read
    once and the pooled features written once at HBM speed, against the
    conv's products on the bf16 tensor cores, at the yardstick's peaks
    (`yardstick_r50.conv_bound_ms` bounds the unfused conv instead)."""
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    nbytes = 2 * b * (h * w * 3 + stem.output_size(h) * stem.output_size(w) * 64)
    flops = 2.0 * b * hc * wc * 64 * 147
    mem_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
    return (ops_ms, 'operations') if ops_ms >= mem_ms else (mem_ms, 'bytes')


def stem_checks(dev) -> float:
    """The stem kernel against its plain version at `STEM_SHAPES`; returns
    the max abs difference."""
    err_max = 0.0
    for i, (b, h, w) in enumerate(STEM_SHAPES):
        ok, err, equal = stem_against_plain(stem_args(b, h, w, 300 + i, dev))
        err_max = max(err_max, err)
        check(ok, f'stem kernel differs from its plain version at B={b} {h}x{w} beyond one '
                  f'bf16 ulp (max {err})')
        print(f'stem vs plain: B={b} {h}x{w}: within one bf16 ulp, max abs {err:.3g}, share '
              f'bitwise equal {equal:.6f}', flush=True)
        torch.cuda.empty_cache()
    return err_max


def stem_launches(dev) -> dict:
    """The stem's launches in one ResNet50 s16 bf16 forward at 2x129x129
    (53 convs, the stem one launch of the kernel), a float32 one (no
    launch) and an m101 bf16 one (no launch), by path."""
    cfg32 = ModelConfig(output_stride=16, architecture='resnet50')
    params = resnet50.init_params(torch.Generator().manual_seed(9), cfg32)
    x = stem_args(2, 129, 129, 9, dev)[0]
    counts = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(cfg32, compute_dtype=dtype)
        launches, convs = stem.launches, resnet50.convs
        with torch.no_grad():
            resnet50.forward(resnet50.cast_params(params, dtype, dev), x, cfg)
        torch.cuda.synchronize()
        counts[dtype] = stem.launches - launches
        check(resnet50.convs - convs == 53,
              f'ResNet50 {dtype} forward counted {resnet50.convs - convs} convs, not 53')
    cfg101 = ModelConfig(model_id=101, output_stride=16, compute_dtype=torch.bfloat16)
    p101 = mobilenet_v1.cast_params(mobilenet_v1.init_params(torch.Generator().manual_seed(9),
                                                             cfg101), torch.bfloat16, dev)
    launches = stem.launches
    with torch.no_grad():
        mobilenet_v1.forward(p101, torch.zeros((2, 129, 129, 3), device=dev), cfg101)
    torch.cuda.synchronize()
    counts['m101'] = stem.launches - launches
    check(counts == {torch.bfloat16: 1, torch.float32: 0, 'm101': 0},
          f'stem launches a forward: {counts} (want bf16 1, float32 0, m101 0)')
    print(f'stem launches a forward: ResNet50 bf16 {counts[torch.bfloat16]}, float32 '
          f'{counts[torch.float32]} (53 convs each), m101 bf16 {counts["m101"]}', flush=True)
    return {'ResNet50 s16 bf16 forward 2x129x129': counts[torch.bfloat16],
            'ResNet50 s16 float32 forward 2x129x129': counts[torch.float32],
            'm101 s16 bf16 forward 2x129x129': counts['m101']}


def stem_main_path(dev) -> int:
    """Phase 5's ResNet50 call: PoseNetPipeline over ResNet50(16, bf16,
    random init) on 8 uint8 513x513 frames, as the r50 cell runs it, with
    `stem.launches` and `resnet50.convs` set to 0 just before the call and
    read just after; returns the stem's launches (1)."""
    pipe = PoseNetPipeline(ResNet50(16, compute_dtype=torch.bfloat16, device=dev))
    g = torch.Generator(device=dev).manual_seed(5)
    frames8 = torch.randint(0, 256, (8, 513, 513, 3), generator=g, device=dev,
                            dtype=torch.uint8)
    pipe.warmup((513, 513), batch=8)
    torch.cuda.synchronize()
    stem.launches = resnet50.convs = 0
    poses = pipe(frames8)
    torch.cuda.synchronize()
    launches, convs = stem.launches, resnet50.convs
    check(launches == 1 and convs == 53,
          f'ResNet50 main path: the stem launched {launches} times and the trunk counted '
          f'{convs} convs in one call (want 1 and 53)')
    check(tuple(poses.keypoint_coords.shape) == (8, 10, 17, 2),
          f'ResNet50 keypoint_coords shape {tuple(poses.keypoint_coords.shape)}')
    check(all(bool(torch.isfinite(t.float()).all()) for t in poses),
          'ResNet50 main path: non-finite output')
    print(f'main path: ResNet50 s16 bf16 8x513x513 -> {tuple(poses.keypoint_coords.shape)}, '
          f'finite; stem launches {launches}, trunk convs {convs} in the call', flush=True)
    del pipe, frames8, poses
    torch.cuda.empty_cache()
    return launches


def stem_timing(dev, cell, launches) -> dict:
    """Phase 7, the stem in one cell: its launch (`cell_kernel_shapes`) held
    to its plain version, then timed in turns (plain, kernel, library,
    library, kernel, plain) by CUDA events against it and against the
    library calls the trunk ran before (cuDNN's fused conv-bias-ReLU and
    F.max_pool2d), beside its bound (`stem_bound_ms`)."""
    (s,) = launches
    b, h, w = s['batch'], s['h'], s['w']
    args = stem_args(b, h, w, 400, dev)
    x, wt, bias = args
    ok, err, equal = stem_against_plain(args)
    check(ok, f'stem kernel differs from its plain version in {cell}, B={b} {h}x{w} '
              f'(max {err})')
    x_nchw = x.permute(0, 3, 1, 2)

    def library():
        y = torch.cudnn_convolution_relu(x_nchw, wt, bias, (2, 2), (3, 3), (1, 1), 1)
        return torch.nn.functional.max_pool2d(y, 3, stride=2, padding=1)

    runs = {}
    for name, fn, iters in (('plain', lambda: stem.stem_reference(*args), 3),
                            ('kernel', lambda: stem.stem(*args), 20),
                            ('library', library, 20), ('library', library, 20),
                            ('kernel', lambda: stem.stem(*args), 20),
                            ('plain', lambda: stem.stem_reference(*args), 3)):
        runs.setdefault(name, []).append(cuda_ms(fn, iters))
        torch.cuda.empty_cache()
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    lib_equal = float((library() == stem.stem(*args)).float().mean())
    bound, bound_by = stem_bound_ms(b, h, w)
    print(f'stem {cell}, B={b} {h}x{w}: kernel {ms["kernel"]:.4f} ms, library (cuDNN '
          f'conv-bias-ReLU + max pool) {ms["library"]:.4f} ms, bound {bound:.4f} ms '
          f'({bound_by}), kernel / bound {ms["kernel"] / bound:.1f}x, plain {ms["plain"]:.4f} '
          f'ms; vs plain max abs {err:.3g}, share bitwise equal {equal:.6f}; share of the '
          f'library\'s values bitwise equal to the kernel\'s {lib_equal:.6f} (runs plain, '
          f'kernel, library, library, kernel, plain: {runs})', flush=True)
    del args, x, x_nchw
    torch.cuda.empty_cache()
    return {'launches': 1, 'ms': ms['kernel'], 'plain_ms': ms['plain'],
            'library_ms': ms['library'], 'bound_ms': bound, 'bound_by': bound_by, 'err': err}


# Phase 7's timer of each kernel: (device, cell, its launches there) -> sums.
TIMERS = {'K1': k1_timing, 'K2': k2_timing, 'stem': stem_timing}


def cell_timing(dev, kernel) -> dict:
    """Phase 7 for `kernel` ('K1', 'K2' or 'stem'): its launches in each
    cell of BENCHMARK.json that runs it, timed alone (`TIMERS`), once for
    cells whose launches are the same. Returns {cell: the sums over the
    cell's launches}."""
    out, timed_in = {}, {}
    for cell in benchmark_cells():
        launches = [s for s in cell_kernel_shapes(cell) if s['kernel'] == kernel]
        if not launches:
            continue
        same = repr([{k: v for k, v in s.items() if k != 'layer'} for s in launches])
        if same in timed_in:
            out[cell] = dict(out[timed_in[same]], timed_in=timed_in[same])
            print(f'{kernel} {cell}: the same launches as {timed_in[same]}, timed there',
                  flush=True)
        else:
            out[cell], timed_in[same] = TIMERS[kernel](dev, cell, launches), cell
    return out


def entry(kernel, **fields) -> dict:
    """`kernel`'s entry of the kernels line: its name, source and the TPU
    kernel it replaces, then `fields`: `launches` (and where they were
    counted: `launches_from`, `launches_by_path`), `max_abs_err` from its
    plain version, and phase 7's sums by cell (`cells`)."""
    name, source, replaces = KERNELS[kernel]
    return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces, **fields}


class FakeCapture:
    """A stand-in for cv2.VideoCapture over a list of BGR frames."""

    def __init__(self, frames):
        self.frames = list(frames)

    def set(self, *_):
        return True

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0)


def run_app(module, argv):
    """An app's `main(argv)` in-process, its standard output captured, with
    the K1 count set to 0 just before and read just after; returns (its
    output, K1 launches)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    traversal.launches = 0
    with contextlib.redirect_stdout(out):
        module.main(argv)
    torch.cuda.synchronize()
    return out.getvalue(), traversal.launches


def recorded_k1_args(fn, *args):
    """fn(*args) with the calls of K1's wrapper from `decode` recorded:
    (fn's result, the first call's seven tensor arguments)."""
    seen = []
    through = decode.traverse_all_candidates
    decode.traverse_all_candidates = lambda *a: seen.append(a) or through(*a)
    try:
        out = fn(*args)
    finally:
        decode.traverse_all_candidates = through
    return out, seen[0][:7]


def single_pose_phase(dev):
    """Phase 8 (1): `decode_single_pose` on the card against the same call
    on the CPU (K1's plain version), bitwise, with one K1 launch a call, on
    synthesized heads at 33x33 s16 and 91x161 s8, on the fixture m50 s16's
    heads of a synthesized photo, and on a heatmap with nothing above the
    threshold; then K1 at this B = K = 1 shape, held to its plain version.
    Returns (K1's max abs difference there, launches over the checked
    calls)."""
    rng = np.random.RandomState(8)
    cases = [(f'synth {h}x{w} s{s}', [a[0] for a in synth_heads(rng, 1, h, w)], s)
             for h, w, s in ((33, 33, 16), (91, 161, 8))]
    params = weights.params_from_jax(weights.load_params_npz(FIXTURE))
    photo = torch.from_numpy(synth_photo(353, 481, 300)[None])
    heads = mobilenet_v1.forward(params, normalize(photo, torch.float32),
                                 ModelConfig(model_id=50, output_stride=16))
    cases.append(('fixture m50 s16 heads, 23x31', [heads[k][0].numpy() for k in HEAD_ORDER], 16))
    cases.append(('nothing above the threshold, 33x33',
                  [np.full((33, 33, 17), 0.1, np.float32)]
                  + [rng.uniform(-8, 8, (33, 33, c)).astype(np.float32) for c in (34, 32, 32)],
                  16))
    launches = 0
    for name, hwc, stride in cases:
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in hwc]
        card = [t.to(dev) for t in host]
        ref = decode_single_pose(*host, stride)
        torch.cuda.synchronize()
        traversal.launches = 0
        got = decode_single_pose(*card, stride)
        torch.cuda.synchronize()
        check(traversal.launches == 1, f'single pose, {name}: K1 launched '
                                       f'{traversal.launches} times in one call')
        launches += traversal.launches
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)),
              f'single pose, {name}: the card differs from the CPU')
        filled = int((ref[0] > 0).sum())
        check(filled == 0 if name.startswith('nothing') else filled >= 9,
              f'single pose, {name}: {filled} keypoints filled')
        print(f'single pose, {name}: card (K1, one launch) bitwise equal to the CPU (plain '
              f'version): root keypoint {int(ref[2])}, {filled} keypoints filled',
              flush=True)

    # K1 at the single pose's shape: the wrapper's arguments as the path
    # makes them, recorded on the 33x33 case.
    card = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in cases[0][1]]
    _, args = recorded_k1_args(decode_single_pose, *card, 16)
    equal, err, _, _ = k1_against_plain(args, 33, 33, 16)
    check(equal, f'K1 at B = K = 1 differs from its plain version (max {err})')
    print('single pose 33x33 s16: K1 on its recorded arguments (B = K = 1) bitwise equal to '
          'its plain version', flush=True)
    return err, launches


def per_frame_decode(dev, frame):
    """Phase 8 (2): the per-frame apps' decode at their grids. The m101 s16
    float32 heads of one 720x1280 frame at scale 1.0 (image_demo and
    benchmark: 721x1281, 46x81 cells) and 0.7125 (webcam_demo: 513x913,
    33x58), decoded as `decode_multiple_poses` decodes them (`decode_batch`
    at B = 1, each app's min_pose_score) on the card and on the CPU:
    keypoints bitwise, pose scores within 2 ulp; and K1 on the card's
    recorded arguments against its plain version, bitwise."""
    model = load_model(101, 16, allow_random_init=True, device=dev)
    for scale, min_pose_score, apps in ((1.0, 0.25, 'image_demo, benchmark'),
                                        (0.7125, 0.15, 'webcam_demo')):
        x, _, _ = process_input(frame, scale, 16)
        heads = [t.permute(0, 2, 3, 1).contiguous() for t in model(x)]
        h, w = heads[0].shape[1:3]
        cfg = DecodeConfig(max_pose_detections=10, min_pose_score=min_pose_score)
        got, args = recorded_k1_args(decode_batch, *heads, 16, cfg)
        ref = decode_batch(*[t.cpu() for t in heads], 16, cfg)
        assert_poses_equal(got, ref, f'per-frame decode at {h}x{w} ({apps})')
        equal, err, filled, _ = k1_against_plain(args, h, w, 16)
        check(equal and filled > 17, f'K1 at {h}x{w} ({apps}): bitwise {equal} (max {err}), '
                                     f'{filled} keypoints filled')
        print(f'per-frame decode at {h}x{w} ({apps}; m101 s16 f32 heads of a 720x1280 frame at '
              f'scale {scale}): the card bitwise equal to the CPU, '
              f'{int((ref.pose_scores > 0).sum())} poses of {int(ref.candidate_count[0])} '
              f'candidates; K1 on its recorded arguments bitwise equal to its plain version, '
              f'{filled} keypoints filled', flush=True)


def apps_phase(dev) -> dict:
    """Phase 8 (2, 3): the apps, where cv2 imports. Returns K1's launches by
    app."""
    if importlib.util.find_spec('cv2') is None:
        print('apps: cv2 does not import here, and every app needs it: phase 8 ran the '
              'single pose only', flush=True)
        return {}
    import cv2

    from posenet_tpu_torch.apps import benchmark, image_demo, video_demo, webcam_demo

    launches = {}
    bgr = [np.ascontiguousarray(synth_photo(720, 1280, 400 + i)[..., ::-1]) for i in range(4)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)   # ./_models here holds no m101 checkpoint: random weights
        try:
            os.makedirs('images')
            for i, frame in enumerate(bgr):
                cv2.imwrite(os.path.join('images', f'photo{i}.jpg'), frame)

            # The first run at a shape pays cuDNN's start-up there; the
            # second, in the same process, is what a user sees after it.
            for when in ('cold', 'warm'):
                out, n = run_app(image_demo, ['--image_dir', 'images', '--output_dir',
                                              'overlays', '--allow_random_init'])
                shapes = [cv2.imread(os.path.join('overlays', f)).shape
                          for f in sorted(os.listdir('overlays'))]
                check(shapes == [(720, 1280, 3)] * 4, f'image_demo overlays {shapes}')
                check(n == 4, f'image_demo launched K1 {n} times for 4 images')
                launches[f'image_demo {when}'] = n
                print(f'apps: image_demo {when}, m101 s16 f32, 4 images 720x1280 -> 721x1281: '
                      f'4 overlays at 720x1280; K1 launches {n}; {out.count("Pose #")} poses '
                      f'printed', flush=True)

            for extra, label in (([], 'per-frame'), (['--profile', 'trace_frame'],
                                                     'per-frame --profile')):
                out, n = run_app(benchmark, ['--image_dir', 'images', '--num_images', '20',
                                             '--allow_random_init', *extra])
                check(n == 20, f'benchmark {label} launched K1 {n} times for 20 frames')
                launches[f'benchmark {label}'] = n
                print(f'apps: benchmark {label}, m101 s16 f32, 20 frames at 721x1281: K1 '
                      f'launches {n}', flush=True)

            out, n = run_app(benchmark, ['--image_dir', 'images', '--batch_size', '128',
                                         '--image_size', '513', '--allow_random_init',
                                         '--profile', 'trace_batch'])
            batches = 1000 // 128
            check(n == batches + 2, f'benchmark b128 launched K1 {n} times (warm-up, traced '
                                    f'batch and {batches} timed batches)')
            check(any(line.startswith('TOTAL') for line in out.splitlines()),
                  f'benchmark b128 --profile printed no device time: {out[-500:]}')
            launches['benchmark b128'] = n
            print(f'apps: benchmark --batch_size 128 --image_size 513 --profile, m101 s16 f32: '
                  f'K1 launches {n} (warm-up, the traced batch, {batches} timed), the traced '
                  f'batch\'s device time printed', flush=True)

            capture = cv2.VideoCapture
            for when, frames in (('cold', 8), ('warm', 24)):
                cv2.VideoCapture = lambda _id: FakeCapture(
                    [bgr[i % len(bgr)].copy() for i in range(frames)])
                try:
                    _, n = run_app(webcam_demo, ['--no_display', '--max_frames', str(frames),
                                                 '--allow_random_init'])
                finally:
                    cv2.VideoCapture = capture
                check(n == frames, f'webcam_demo {when} launched K1 {n} times for {frames} '
                                   f'frames')
                launches[f'webcam_demo {when}'] = n
                print(f'apps: webcam_demo {when} --no_display, m101 s16 f32, a stand-in capture '
                      f'of {frames} frames 720x1280 -> 513x913: K1 launches {n}', flush=True)

            writer = cv2.VideoWriter('in.mp4', cv2.VideoWriter_fourcc(*'mp4v'), 30, (1280, 720))
            check(writer.isOpened(), 'cv2 cannot write an mp4v video here')
            for i in range(40):
                writer.write(bgr[i % 4])
            writer.release()
            for extra, label in (([], 'host resize'), (['--device_preprocess'],
                                                       '--device_preprocess')):
                _, n = run_app(video_demo, [
                    '--video', 'in.mp4', '--resize', '513x513', '--batch_size', '16',
                    '--poses_out', 'poses.jsonl', '--allow_random_init', *extra])
                frames = [json.loads(line)['frame'] for line in open('poses.jsonl')]
                check(frames == list(range(40)), f'video_demo {label}: JSONL frames {frames}')
                check(n == 3, f'video_demo {label} launched K1 {n} times for 3 batches')
                launches[f'video_demo {label}'] = n
                print(f'apps: video_demo {label}, m101 s16 f32, 40 frames 720x1280 -> 513x513, '
                      f'batch 16, depth 2: one JSONL record a frame, in order; K1 launches {n}',
                      flush=True)

            per_frame_decode(dev, bgr[0])
            launches['video_demo fixture'] = fixture_parity()
        finally:
            os.chdir(cwd)
    return launches


def fixture_parity() -> int:
    """Phase 8 (3): video_demo --poses_out with the fixture m50 s16 weights
    (./_models), on the card and with --device cpu: equal pose counts,
    coordinates within 1e-3 px. Returns the card run's K1 launches."""
    import cv2

    from posenet_tpu_torch.apps import video_demo

    os.makedirs('_models')
    shutil.copy(FIXTURE, os.path.join('_models', 'mobilenet_v1_050.npz'))
    writer = cv2.VideoWriter('fixture.mp4', cv2.VideoWriter_fourcc(*'mp4v'), 10, (481, 353))
    for i in range(6):
        writer.write(np.ascontiguousarray(synth_photo(353, 481, 500 + i % 3)[..., ::-1]))
    writer.release()
    argv = ['--video', 'fixture.mp4', '--model', '50', '--resize', '353x481',
            '--batch_size', '4']
    _, n = run_app(video_demo, argv + ['--poses_out', 'card.jsonl'])
    run_app(video_demo, argv + ['--poses_out', 'cpu.jsonl', '--device', 'cpu'])
    check(n == 2, f'video_demo (fixture) launched K1 {n} times for 2 batches')
    card, cpu = ([json.loads(line) for line in open(f)] for f in ('card.jsonl', 'cpu.jsonl'))
    check(len(card) == len(cpu) == 6, f'fixture video: {len(card)} and {len(cpu)} records')
    counts = [len(r['poses']) for r in cpu]
    check([len(r['poses']) for r in card] == counts and sum(counts) >= 6,
          f'fixture video: pose counts {[len(r["poses"]) for r in card]} on the card, '
          f'{counts} on the CPU')
    coord_err = score_err = 0.0
    for a, b in zip(card, cpu):
        for pa, pb in zip(a['poses'], b['poses']):
            score_err = max(score_err, abs(pa['score'] - pb['score']))
            for ka, kb in zip(pa['keypoints'], pb['keypoints']):
                coord_err = max(coord_err, abs(ka['y'] - kb['y']), abs(ka['x'] - kb['x']))
    check(coord_err <= 1e-3 and score_err <= 1e-4,
          f'fixture video, card vs CPU: coords {coord_err} px, pose scores {score_err}')
    print(f'apps: video_demo --poses_out, fixture m50 s16, 6 frames 353x481, card vs '
          f'--device cpu (TF32 off): pose counts {counts} equal, coordinates within '
          f'{coord_err:.3g} px (limit 1e-3), pose scores within {score_err:.3g}; K1 launches '
          f'{n}', flush=True)
    return n


def phase8(dev):
    """Phase 8: the single pose, then the apps; returns (K1's max abs
    difference from its plain version, K1's launches by path)."""
    err, single = single_pose_phase(dev)
    return err, {'single pose': single, **apps_phase(dev)}


TRAIN_PHOTO_HW = ((480, 640), (513, 513), (720, 1280), (600, 450))
# Phase 9's model and input side: m101 s16 at 513x513, published widths and depth.
TRAIN_MODEL, TRAIN_SIZE = 101, 513


def train_dataset(root, n=16) -> PosenetDataset:
    """Phase 9's data: n synthesized photos of four sizes, each with a
    Dataloop annotation of its two figures, prepared by the port's
    `prepare_ground_truth_data`, read at TRAIN_SIZE."""
    import cv2

    images, labels, kpdir = (os.path.join(root, d) for d in ('images', 'labels', 'keypoints'))
    os.makedirs(images)
    os.makedirs(labels)
    for i in range(n):
        h, w = TRAIN_PHOTO_HW[i % len(TRAIN_PHOTO_HW)]
        cv2.imwrite(os.path.join(images, f'photo{i:02d}.jpg'),
                    np.ascontiguousarray(synth_photo(h, w, 900 + i)[..., ::-1]))
        annotations = []
        for p, points in enumerate(figure_keypoints(h, w)):
            annotations.append({'type': 'pose', 'id': f'p{p}'})
            annotations += [{'type': 'point', 'label': label,
                             'metadata': {'system': {'parentId': f'p{p}'}},
                             'coordinates': {'x': float(x), 'y': float(y)}}
                            for label, x, y in points]
        with open(os.path.join(labels, f'photo{i:02d}.json'), 'w') as f:
            json.dump({'metadata': {'system': {'height': h, 'width': w}},
                       'annotations': annotations}, f)
    stems = prepare_ground_truth_data(images, labels, keypoints_updated_dir=kpdir)
    check(len(stems) == n, f'prepare_ground_truth_data prepared {len(stems)} of {n} images')
    ds = PosenetDataset(images, kpdir, image_size=TRAIN_SIZE, output_stride=16)
    poses = (~np.all(ds.keypoints == -1, axis=(2, 3))).sum(1)
    check(len(ds) == n and bool((poses == 2).all()), f'dataset: {len(ds)} images, poses {poses}')
    return ds


def first_batch(ds: PosenetDataset, batch_size: int):
    """The dataset's first `batch_size` images in order, unaugmented."""
    gen = ds.iter_batches(batch_size, shuffle=False, augment=False, prefetch=0)
    try:
        return next(gen)
    finally:
        gen.close()


def train_init_params():
    """Seeded random weights, float32 on the host."""
    return mobilenet_v1.init_params(torch.Generator().manual_seed(9),
                                    ModelConfig(model_id=TRAIN_MODEL, output_stride=16))


def train_cfgs(dtype, **kw):
    return (TrainConfig(model_id=TRAIN_MODEL, compute_dtype=dtype, **kw),
            ModelConfig(model_id=TRAIN_MODEL, output_stride=16, compute_dtype=dtype))


def k2_per_forward(mcfg) -> int:
    """The fused block's layers in one forward of `mcfg` (13 for m101 s16 bf16)."""
    return sum(mobilenet_v1.uses_sepconv(layer, mcfg)
               for layer in mobilenet_v1.stride_plan(mcfg.model_id, mcfg.output_stride))


def train_step_parity(dev, ds) -> dict:
    """Phase 9 (1, 2): one step at b2 on the card against the same step on
    the CPU, float32 then bf16; returns K2's launches by dtype."""
    batch = first_batch(ds, 2)
    init = train_init_params()
    launches = {}
    for dtype, loss_tol, grad_tol in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, None, None)):
        cfg, mcfg = train_cfgs(dtype)
        out = {}
        for name, d in (('cpu', torch.device('cpu')), ('cuda', dev)):
            state = ts.init_train_state(init, cfg, d)
            sepconv.launches = 0
            state, m = ts.make_train_step(mcfg, cfg)(state, batch)
            loss = float(m['loss'])
            if name == 'cuda':
                launches[dtype] = sepconv.launches
            grads = {(n, k): t.grad.cpu() for n in HEAD_ORDER
                     for k, t in state.params['heads'][n].items()}
            with torch.no_grad():   # the forward at the step's starting params
                run = ts.compute_params(ts.tree_map(lambda t: t.to(d), init), mcfg)
                heads = mobilenet_v1.forward(run, torch.from_numpy(batch['image']).to(d), mcfg)
            out[name] = loss, grads, {k: v.cpu() for k, v in heads.items()}
        (cpu_loss, cpu_grads, cpu_heads), (loss, grads, heads) = out['cpu'], out['cuda']
        loss_gap = abs(loss - cpu_loss) / abs(cpu_loss)
        # The loss reads the heatmap and the offsets: the displacement heads'
        # gradients are zero, and must stay so on the card.
        check(all(bool((grads[k] == 0).all()) for k, g in cpu_grads.items()
                  if not bool(g.any())), f'{dtype} step: nonzero displacement gradients')
        grad_gap = max(float((grads[k] - g).abs().max()) / float(g.abs().max())
                       for k, g in cpu_grads.items() if bool(g.any()))
        head_gap = max(float((heads[k] - v).abs().max()) for k, v in cpu_heads.items())
        check(np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads.values()),
              f'{dtype} step on the card: loss {loss}, non-finite gradients')
        name = 'float32' if dtype == torch.float32 else 'bf16'
        if dtype == torch.float32:
            check(launches[dtype] == 0, f'a float32 step launched K2 {launches[dtype]} times')
            check(loss_gap <= loss_tol, f'f32 step loss, card vs CPU: {loss_gap:.3g} relative '
                                        f'(limit {loss_tol})')
            check(grad_gap <= grad_tol, f'f32 step head gradients, card vs CPU: {grad_gap:.3g} '
                                        f'of max |grad| (limit {grad_tol})')
        else:
            check(launches[dtype] == k2_per_forward(mcfg),
                  f'a bf16 step launched K2 {launches[dtype]} times')
            check(head_gap <= 2e-3, f'bf16 heads, K2 (card) vs plain (CPU): {head_gap} '
                                    f'(limit 2e-3)')
        print(f'train step m{TRAIN_MODEL} s16 {name} b2 {TRAIN_SIZE}x{TRAIN_SIZE} (TF32 off), '
              f'card vs CPU: loss {loss:.6f} '
              f'vs {cpu_loss:.6f} ({loss_gap:.3g} relative' +
              (f', limit {loss_tol}' if loss_tol else '') + f'), head gradients within '
              f'{grad_gap:.3g} of each tensor\'s max |grad|' +
              (f' (limit {grad_tol})' if grad_tol else '') + f', forward heads within '
              f'{head_gap:.3g}' + ('' if loss_tol else ' (limit 2e-3)') +
              f'; K2 launches {launches[dtype]}', flush=True)
    return launches


def same_tensors(a, b) -> bool:
    """Two parameter pytrees bitwise equal (on the host)."""
    flat = [ts.tree_map(lambda t: t.detach().cpu(), p) for p in (a, b)]
    return all(torch.equal(x, y) for la, lb in zip(*(p['backbone'] + list(p['heads'].values())
                                                     for p in flat))
               for x, y in ((la[k], lb[k]) for k in la))


def train_runs(dev, ds, root) -> dict:
    """Phase 9 (3, 4): `train()` on the card, float32 with visual dumps and
    bf16, then the bf16 run's checkpoint exported `--from_checkpoint`.
    Returns K1's and K2's launches by run."""
    init = train_init_params()
    launches = {}
    for dtype, visual in ((torch.float32, 1), (torch.bfloat16, 0)):
        name = 'float32' if dtype == torch.float32 else 'bf16'
        ckpt = os.path.join(root, f'ckpt_{name}')
        out_dir = os.path.join(root, f'visual_{name}')
        cfg, mcfg = train_cfgs(dtype, batch_size=16, learning_rate=1e-4, num_epochs=2,
                               checkpoint_dir=ckpt, output_dir=out_dir, visual_every=visual)
        before = trainer.evaluate(ds, cfg, init, eval_pose_metrics=False, device=dev)
        logger = trainer.MetricLogger(verbose=False)
        torch.cuda.synchronize()
        traversal.launches = sepconv.launches = 0
        state = trainer.train(ds, ds, cfg, logger=logger, params=init, resume=False, device=dev)
        torch.cuda.synchronize()
        k1, k2 = traversal.launches, sepconv.launches
        launches[name] = k1, k2
        after = trainer.evaluate(ds, cfg, state.params, eval_pose_metrics=False, device=dev)
        hist = logger.history
        # a step, an eval loss and an eval decode a epoch (one batch each),
        # and a visual dump a epoch in float32
        want = (2 + 2 * visual, 0) if dtype == torch.float32 else (2, 2 * 3 * k2_per_forward(mcfg))
        check((k1, k2) == want, f'train() {name} launched K1 {k1} and K2 {k2} times, not {want}')
        check(len(hist) == 2 and all(np.isfinite(h[k]) for h in hist
                                     for k in ('train_loss', 'test_loss', 'oks', 'mAP')),
              f'train() {name}: history {hist}')
        check(hist[1]['train_loss'] < hist[0]['train_loss'],
              f'train() {name}: the train loss on the repeated batch did not fall: {hist}')
        check(after['loss'] < before['loss'],
              f'train() {name}: eval loss {before["loss"]} before, {after["loss"]} after')
        trunk_same = all(torch.equal(t.cpu(), init['backbone'][i][k])
                         for i, layer in enumerate(state.params['backbone'])
                         for k, t in layer.items())
        check(trunk_same, f'train() {name} changed the frozen trunk')
        moved = max(float((t.detach().cpu() - init['heads'][n][k]).abs().max())
                    for n in HEAD_ORDER for k, t in state.params['heads'][n].items())
        check(moved > 0, f'train() {name} left the heads as they were')
        restored = trainer.restore_checkpoint(ckpt, ts.init_train_state(init, cfg, dev))
        check(restored is not None and restored.step == state.step == 2
              and same_tensors(restored.params, state.params),
              f'train() {name}: the latest checkpoint does not restore the final state')
        adam = [restored.optimizer.state[t]['exp_avg'] for t in ts.trainable_tensors(
            restored.params)]
        check(all(torch.equal(a, state.optimizer.state[t]['exp_avg'])
                  for a, t in zip(adam, ts.trainable_tensors(state.params))),
              f'train() {name}: the restored Adam moments differ')
        if visual:
            item = os.path.join(out_dir, 'epoch_1', 'photo00')
            check(os.path.exists(os.path.join(item, 'photo00_keypoints.jpg')),
                  f'train() {name}: no visual dump under {item}')
        print(f'train() m{TRAIN_MODEL} s16 {name} {TRAIN_SIZE}x{TRAIN_SIZE} b16, 16 images, '
              f'2 epochs, lr 1e-4, eval with '
              f'pose metrics: train loss ' + ', '.join(f'{h["train_loss"]:.6f}' for h in hist) +
              '; test loss ' + ', '.join(f'{h["test_loss"]:.6f}' for h in hist) +
              f'; OKS {hist[-1]["oks"]:.4f}, mAP {hist[-1]["mAP"]:.4f}; eval loss '
              f'{before["loss"]:.6f} -> {after["loss"]:.6f}; trunk bitwise unchanged, heads '
              f'moved up to {moved:.3g}; checkpoint step {restored.step} restored bitwise '
              f'(params and Adam moments); K1 launches {k1}, K2 launches {k2}' +
              ('; visual dumps written' if visual else ''), flush=True)
    export_from_checkpoint(dev, os.path.join(root, 'ckpt_bf16'), root, init)
    return launches


def export_from_checkpoint(dev, ckpt, root, init):
    """Phase 9 (4): `posenet-export-torch --from_checkpoint` to a `cuda`
    artifact, bitwise equal to PoseNetPipeline over the restored params."""
    path = os.path.join(root, 'trained.posenet')
    with contextlib.redirect_stdout(io.StringIO()):
        export_main(['--model', str(TRAIN_MODEL), '--output_stride', '16', '--size',
                     str(TRAIN_SIZE), str(TRAIN_SIZE), '--batch_sizes', '2', '--platforms',
                     dev.type, '--compute_dtype', 'bfloat16',
                     '--from_checkpoint', ckpt, '--output', path])
    cfg, mcfg = train_cfgs(torch.bfloat16)
    restored = trainer.restore_checkpoint(ckpt, ts.init_train_state(init, cfg, dev))
    pipe = PoseNetPipeline(PoseNet(ts.tree_map(torch.Tensor.detach, restored.params), mcfg))
    frames = torch.from_numpy(np.stack([synth_photo(TRAIN_SIZE, TRAIN_SIZE, 950 + i)
                                        for i in range(2)]))
    art = load_serving_artifact(path, device=dev)
    got, ref = art(frames), pipe(frames.to(dev))
    torch.cuda.synchronize()
    for f, a, b in zip(DecodedPoses._fields, got, ref):
        check(torch.equal(a, b), f'--from_checkpoint artifact differs from PoseNetPipeline in {f}')
    print(f'posenet-export-torch --from_checkpoint (bf16 run, step {restored.step}) -> cuda '
          f'artifact m{TRAIN_MODEL} s16 bf16 {TRAIN_SIZE}x{TRAIN_SIZE} b2: bitwise equal to '
          f'PoseNetPipeline over the restored params; poses per image '
          f'{(got.pose_scores > 0).sum(1).tolist()}', flush=True)


def phase9(dev) -> tuple:
    """Phase 9: heads-only fine-tuning of m101 s16 at 513x513. Returns K1's and
    K2's launches by path."""
    check(importlib.util.find_spec('cv2') is not None,
          'phase 9 needs cv2 (the dataset reads and writes JPEG files)')
    with tempfile.TemporaryDirectory() as root:
        ds = train_dataset(root)
        step_k2 = train_step_parity(dev, ds)
        runs = train_runs(dev, ds, root)
    k1 = {f'train() {name} (phase 9)': n for name, (n, _) in runs.items()}
    k2 = {'train step float32 b2 (phase 9)': step_k2[torch.float32],
          'train step bf16 b2 (phase 9)': step_k2[torch.bfloat16],
          **{f'train() {name} (phase 9)': n for name, (_, n) in runs.items()}}
    return k1, k2


# Phase 10: multi-device on the one card, m101 s16 at 513x513 in bf16.
PARALLEL_MODEL, PARALLEL_SIZE = 101, 513


def shard_heads(params, frames, cfg, bounds):
    """The heads each shard's forward computes, and the unsharded forward's
    rows of them: [(shard heads, unsharded rows)] for each (lo, hi)."""
    with torch.no_grad():
        whole = mobilenet_v1.forward(params, normalize(frames, cfg.compute_dtype), cfg)
        out = []
        for lo, hi in bounds:
            x = frames[lo:hi]
            if x.shape[0] < hi - lo:   # the pad of an uneven batch
                x = torch.cat([x, x.new_zeros((hi - lo - x.shape[0], *x.shape[1:]))])
            part = mobilenet_v1.forward(params, normalize(x, cfg.compute_dtype), cfg)
            out.append(({k: v[:frames.shape[0] - lo] for k, v in part.items()},
                        {k: v[lo:hi] for k, v in whole.items()}))
    return out


def heads_gap(got, ref) -> float:
    return max(float((got[k] - ref[k]).abs().max()) for k in HEAD_ORDER)


def data_partition(model, dcfg, frames, devices, name) -> dict:
    """The data partition of `frames` over `devices` against the unsharded
    pipeline: per shard its heads (bitwise, or within the bf16 bar 2e-3)
    and its poses (bitwise wherever the shard's heads are). Returns K1's and
    K2's launches over the sharded call."""
    plain = PoseNetPipeline(model, dcfg)
    sharded = PoseNetPipeline(model, dcfg, mesh=make_mesh(devices=devices))
    ref = plain(frames)
    sharded(frames)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = 0
    got = sharded(frames)
    torch.cuda.synchronize()
    launches = {'K1': traversal.launches, 'K2': sepconv.launches}
    n = len(devices)
    per = -(-frames.shape[0] // n)
    k2 = k2_per_forward(model.cfg)
    check(launches == {'K1': n, 'K2': k2 * n},
          f'data partition {name}: launches {launches}, expected K1 {n}, K2 {k2 * n}')
    check(tuple(got.keypoint_coords.shape) == (frames.shape[0], 10, 17, 2),
          f'data partition {name}: shape {tuple(got.keypoint_coords.shape)}')
    held = []
    for i, (part, whole) in enumerate(shard_heads(plain.params, frames, model.cfg,
                                                  [(i * per, (i + 1) * per)
                                                   for i in range(n)])):
        lo, hi = i * per, min((i + 1) * per, frames.shape[0])
        bitwise = all(torch.equal(part[k], whole[k]) for k in HEAD_ORDER)
        gap = heads_gap(part, whole)
        check(gap <= 2e-3, f'data partition {name}: shard {i} heads {gap} from the unsharded '
                           f'(limit 2e-3)')
        shard_poses = DecodedPoses(*(t[lo:hi] for t in got))
        ref_poses = DecodedPoses(*(t[lo:hi] for t in ref))
        poses_equal = all(torch.equal(a, b) for a, b in zip(shard_poses, ref_poses))
        if bitwise:
            check(poses_equal, f'data partition {name}: shard {i} heads bitwise, poses not')
        held.append(f'shard {i} heads ' + ('bitwise' if bitwise else f'within {gap:.3g}') +
                    f', poses {"bitwise" if poses_equal else "differ"}')
    n_poses = (got.pose_scores > 0).sum(1)
    check(bool((n_poses >= 1).all()), f'data partition {name}: no pose in some frame')
    print(f'data partition {name}, m{PARALLEL_MODEL} s16 bf16 '
          f'{frames.shape[0]}x{PARALLEL_SIZE}x{PARALLEL_SIZE} synth_photo frames, against the '
          f'unsharded pipeline: {"; ".join(held)}; poses per frame '
          f'{int(n_poses.min())}-{int(n_poses.max())}; K1 launches {launches["K1"]}, '
          f'K2 {launches["K2"]}', flush=True)
    return launches


def spatial_partition(model_cfg, params, frame, dcfg, devices) -> dict:
    """The spatial partition of one frame over `devices` against
    the unsharded forward and decode: heads within 2e-3 of each other
    (bf16) or 1e-4 of each head's scale (float32), poses bitwise where the
    heads are. Returns K1's and K2's launches over the sharded call."""
    model = PoseNet(params, model_cfg)
    plain = PoseNetPipeline(model, dcfg)
    n = len(devices)
    sharded = PoseNetPipeline(model, dcfg, mesh=make_mesh(devices=devices),
                              partition='spatial')
    ref = plain(frame)
    sharded(frame)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = 0
    got = sharded(frame)
    torch.cuda.synchronize()
    launches = {'K1': traversal.launches, 'K2': sepconv.launches}
    bf16 = model_cfg.compute_dtype == torch.bfloat16
    check(launches == {'K1': 1, 'K2': k2_per_forward(model_cfg) * n},
          f'spatial partition over {n}: launches {launches}')
    with torch.no_grad():
        x = normalize(frame, model_cfg.compute_dtype)
        whole = mobilenet_v1.head_conv(plain.params['heads'],
                                       mobilenet_v1.run_trunk(plain.params, x, model_cfg))
        part = spatial.forward(sharded.replicas, x, model_cfg, sharded.mesh.devices)
    bitwise = torch.equal(part, whole)
    gap = float((part - whole).abs().max())
    limit = 2e-3 if bf16 else 1e-4 * max(1.0, float(whole.abs().max()))
    check(gap <= limit, f'spatial partition over {n}: heads {gap} apart (limit {limit})')
    poses_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    if bitwise:
        check(poses_equal, f'spatial partition over {n}: heads bitwise, poses not')
    score_gap = float((got.pose_scores - ref.pose_scores).abs().max())
    coord_gap = float((got.keypoint_coords - ref.keypoint_coords).abs().max())
    print(f'spatial partition over {n} shards on {sorted({str(d) for d in devices})}, '
          f'm{model_cfg.model_id} s16 '
          f'{"bf16" if bf16 else "float32"} 1x{PARALLEL_SIZE}x{PARALLEL_SIZE}, trunk biases '
          f'+ 1.0: heads '
          + ('bitwise' if bitwise else f'within {gap:.3g} (limit {limit:.3g})')
          + f' of the unsharded forward; poses ' + ('bitwise' if poses_equal else
                                                    f'pose scores within {score_gap:.3g}, '
                                                    f'coordinates within {coord_gap:.3g} px')
          + f', {int((got.pose_scores > 0).sum())} poses; K1 launches {launches["K1"]}, K2 '
          f'{launches["K2"]}', flush=True)
    return launches


def rank_step(out_path: str, batch, dtype_name: str, device=None):
    """One rank of a data-parallel world (phase 10): the global batch's
    step from the seeded weights, this rank's slice on `device` (None: its
    own card); rank 0 writes the loss and the heads."""
    full_float32()   # as the parent process runs: TF32 off
    device = mesh_lib.local_device('cuda') if device is None else torch.device(device)
    dtype = getattr(torch, dtype_name)
    cfg, mcfg = train_cfgs(dtype)
    state = ts.init_train_state(train_init_params(), cfg, device)
    step = ts.make_train_step(mcfg, cfg, mesh=make_mesh(devices=[device]))
    state, m = step(state, batch)
    result = {'loss': float(m['loss']),
              'heads': ts.tree_map(lambda t: t.detach().cpu(), state.params)['heads']}
    if torch.distributed.get_rank() == 0:
        torch.save(result, out_path)


def check_ranks(out_path, state, metrics, init, what) -> dict:
    """Rank 0's result of `rank_step` against one device's step from the
    same weights: the loss within 1e-5 relative, each head's update within
    1e-3 of its norm (Adam turns rounding-level gradients into a fraction
    of a step on single elements). Returns the result."""
    got = torch.load(out_path, weights_only=True)
    loss_gap = abs(got['loss'] - float(metrics['loss'])) / abs(float(metrics['loss']))
    check(loss_gap <= 1e-5, f'{what}: loss {loss_gap} relative from one device')
    gaps = []
    for n in HEAD_ORDER[:2]:
        for k, t in got['heads'][n].items():
            ref = state.params['heads'][n][k].detach().cpu()
            before = init['heads'][n][k]
            gaps.append(float((t - ref).norm() / (ref - before).norm()))
    check(max(gaps) <= 1e-3, f'{what}: heads\' updates {max(gaps)} from one device\'s')
    got['loss_gap'], got['update_gap'] = loss_gap, max(gaps)
    return got


def dp_train_phase(dev, ds, root) -> dict:
    """Phase 10 (c): the DP step at b16 at world size 1 over NCCL against
    the single-device step, float32 and bf16, bitwise; then 2 gloo ranks
    on the one card. Returns K2's
    launches of the world-1 bf16 step."""
    batch = first_batch(ds, 16)
    init = train_init_params()
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')   # a world of this host alone
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    initialize_distributed(f'127.0.0.1:{mesh_lib._free_port()}', 1, 0, backend=backend)
    launches = {}
    try:
        mesh = make_mesh()
        check(mesh.devices == (dev,) and mesh.size == 1, f'world mesh {mesh}')
        for dtype in (torch.float32, torch.bfloat16):
            name = 'float32' if dtype == torch.float32 else 'bf16'
            cfg, mcfg = train_cfgs(dtype, batch_size=16)
            out = {}
            # cuDNN's weight gradients may sum in a run-dependent order: the
            # bitwise comparison runs in its deterministic mode, and whether
            # two plain steps agree without it is printed.
            for kind, m, deterministic in (('plain', None, False), ('plain again', None, False),
                                           ('plain', None, True), ('dp', mesh, True)):
                torch.backends.cudnn.deterministic = deterministic
                state = ts.init_train_state(init, cfg, dev)
                sepconv.launches = 0
                state, metrics = ts.make_train_step(mcfg, cfg, mesh=m)(state, batch)
                torch.cuda.synchronize()
                out[kind, deterministic] = (
                    metrics, {(n, k): (t.grad.clone(), t.detach().clone()) for n in HEAD_ORDER
                              for k, t in state.params['heads'][n].items()},
                    sepconv.launches)
            torch.backends.cudnn.deterministic = False

            def gaps(a, b):
                (am, ah, _), (bm, bh, _) = out[a], out[b]
                return ({k: float((am[k] - bm[k]).abs()) for k in am},
                        max(float((x - y).abs().max()) for key in ah
                            for x, y in zip(ah[key], bh[key])))

            dk2 = out['dp', True][2]
            launches[name] = dk2
            check(dk2 == k2_per_forward(mcfg), f'DP {name} step launched K2 {dk2} times')
            dp_gap = gaps(('plain', True), ('dp', True))
            check(max(dp_gap[0].values()) == 0 and dp_gap[1] == 0,
                  f'DP {name} step at world size 1 ({backend}) differs from the single-device '
                  f'step, both with cuDNN deterministic: metrics {dp_gap[0]}, head gradients '
                  f'and heads {dp_gap[1]}')
            again = gaps(('plain', False), ('plain again', False))
            reproducible = max(again[0].values()) == 0 and again[1] == 0
            print(f'DP train step m{TRAIN_MODEL} s16 {name} b16 {TRAIN_SIZE}x{TRAIN_SIZE}, world '
                  f'size 1 over {backend}: loss, head gradients and heads after Adam bitwise equal '
                  f'to the single-device step (cuDNN deterministic); two plain steps without '
                  f'deterministic mode ' + ('bitwise equal' if reproducible else
                                            f'apart by metrics {again[0]}, gradients and '
                                            f'heads {again[1]:.3g}') +
                  f'; K2 launches {dk2}', flush=True)
    finally:
        torch.distributed.destroy_process_group()

    # Two gloo ranks on the one card: NCCL refuses two ranks on one device.
    cfg, mcfg = train_cfgs(torch.float32, batch_size=16)
    state = ts.init_train_state(init, cfg, dev)
    state, m = ts.make_train_step(mcfg, cfg)(state, batch)
    out_path = os.path.join(root, 'gloo_rank0.pt')
    try:
        mesh_lib.launch(rank_step, 2, args=(out_path, batch, 'float32', str(dev)),
                        backend='gloo')
    except Exception as e:   # noqa: BLE001  (the issue asks why, where gloo refuses)
        print(f'DP train step over 2 gloo ranks on {dev}: not run, gloo refused: '
              f'{type(e).__name__}: {str(e).splitlines()[-1] if str(e) else e}', flush=True)
        return launches
    got = check_ranks(out_path, state, m, init, '2 gloo ranks')
    print(f'DP train step m{TRAIN_MODEL} s16 float32 b16 over 2 gloo ranks on {dev} (8 '
          f'images each): loss {got["loss_gap"]:.3g} relative from the single-device step '
          f'(limit 1e-5), heads\' updates within {got["update_gap"]:.3g} of their norm (limit '
          f'1e-3)', flush=True)
    return launches


def parallel_serving(model, dev, frames) -> None:
    """Phase 10 (d): LivePipelineBackend(num_devices=1), the data partition
    over the card, and an artifact exported with data_parallel_devices=1,
    each served and equal to the in-process result; the artifact bitwise
    equal to the pipeline."""
    dcfg = DecodeConfig(min_pose_score=0.0)
    live = LivePipelineBackend(model, decode_cfg=dcfg,
                               input_hw=(PARALLEL_SIZE, PARALLEL_SIZE), batch_sizes=(1, 8),
                               num_devices=1)
    check(live.meta['num_devices'] == 1 and live._pipe.mesh is not None,
          f'live backend meta {live.meta}')
    serve_and_check(live, 'live num_devices=1', frames, 'synth_photo frame')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'dp1.posenet')
        meta = save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(1, 8),
                                     input_hw=(PARALLEL_SIZE, PARALLEL_SIZE),
                                     platforms=(dev.type,), data_parallel_devices=1)
        check(meta['data_parallel_devices'] == 1, f'artifact meta {meta}')
        art = load_serving_artifact(path, device=dev.type)
        check(art.mesh is not None and art.device == dev, f'artifact on {art.device}')
        ref = PoseNetPipeline(model, dcfg)(frames[:8])
        got = art(frames[:8])
        for f, a, b in zip(DecodedPoses._fields, got, ref):
            check(torch.equal(a.cpu(), b.cpu()),
                  f'data_parallel_devices=1 artifact b8 differs from the pipeline in {f}')
        print('serving: artifact with data_parallel_devices=1, b8 bitwise equal to '
              'PoseNetPipeline', flush=True)
        serve_and_check(art, 'artifact data_parallel_devices=1', frames, 'synth_photo frame')


def inflate_biases(params):
    """`params` with every trunk bias + 1.0, a checkpoint's scale: a pad
    row that leaked into the image would move the heads."""
    out = ts.tree_map(lambda t: t, params)
    for layer in out['backbone']:
        for k in layer:
            if k.endswith('b'):
                layer[k] = layer[k] + 1.0
    return out


def phase10(dev) -> tuple:
    """Phase 10: the multi-device layer on the one card. Returns K1's and
    K2's launches by path."""
    check(importlib.util.find_spec('cv2') is not None,
          'phase 10 needs cv2 (its train step reads phase 9\'s JPEG dataset)')
    model = load_model(PARALLEL_MODEL, 16, allow_random_init=True, device=dev,
                       compute_dtype=torch.bfloat16)
    dcfg = DecodeConfig(min_pose_score=0.0)
    photos = np.stack([synth_photo(PARALLEL_SIZE, PARALLEL_SIZE, 700 + i) for i in range(8)])
    frames = torch.from_numpy(np.resize(photos, (129, PARALLEL_SIZE, PARALLEL_SIZE, 3))).to(dev)
    k1, k2 = {}, {}

    # (a) the data partition
    for frames_n, devices, name in ((frames[:128], [dev] * 2, f'b128 over 2 shards of {dev}'),
                                    (frames[:128], list(make_mesh().devices),
                                     f'b128 over every visible card '
                                     f'({torch.cuda.device_count()})'),
                                    (frames, [dev] * 2, f'uneven b129 over 2 shards of {dev}')):
        launches = data_partition(model, dcfg, frames_n, devices, name)
        k1[f'data partition {name} (phase 10)'] = launches['K1']
        k2[f'data partition {name} (phase 10)'] = launches['K2']

    # (b) the spatial partition, biases + 1.0
    inflated = inflate_biases(model.params)
    for dtype in (torch.bfloat16, torch.float32):
        mcfg = ModelConfig(PARALLEL_MODEL, 16, compute_dtype=dtype)
        for n in (2, 4):
            launches = spatial_partition(mcfg, inflated, frames[:1], dcfg, [dev] * n)
            if dtype == torch.bfloat16:
                k1[f'spatial partition b1 over {n} shards (phase 10)'] = launches['K1']
                k2[f'spatial partition b1 over {n} shards (phase 10)'] = launches['K2']

    # (c) the DP train step; (d) served replies
    with tempfile.TemporaryDirectory() as root:
        ds = train_dataset(root)
        step_k2 = dp_train_phase(dev, ds, root)
    k2['DP train step bf16 b16, world size 1 (phase 10)'] = step_k2['bf16']
    parallel_serving(model, dev, frames[:16].cpu().numpy())
    return k1, k2


def multicard() -> tuple:
    """`--only multicard`, on a host of several cards (not part of the
    one-card run): the layouts of phase 10 across every visible card. The
    data partition of 128 and of an uneven 129 frames; the spatial
    partition of one frame, bf16 and float32; the DP train step at b16
    over one NCCL rank a card against one card; an artifact exported with
    data_parallel_devices=N and loaded over the N cards (its programs moved
    off the card they were exported on) against the pipeline. Returns
    K1's and K2's launches by path."""
    n = torch.cuda.device_count()
    check(n >= 2, f'--only multicard needs several cards, found {n}')
    devs = [torch.device('cuda', i) for i in range(n)]
    model = load_model(PARALLEL_MODEL, 16, allow_random_init=True, device=devs[0],
                       compute_dtype=torch.bfloat16)
    dcfg = DecodeConfig(min_pose_score=0.0)
    photos = np.stack([synth_photo(PARALLEL_SIZE, PARALLEL_SIZE, 700 + i) for i in range(8)])
    frames = torch.from_numpy(np.resize(photos, (129, PARALLEL_SIZE, PARALLEL_SIZE, 3))
                              ).to(devs[0])
    k1, k2 = {}, {}
    for frames_n, name in ((frames[:128], f'b128 over {n} cards'),
                           (frames, f'uneven b129 over {n} cards')):
        launches = data_partition(model, dcfg, frames_n, devs, name)
        k1[f'data partition {name} (multicard)'] = launches['K1']
        k2[f'data partition {name} (multicard)'] = launches['K2']
    inflated = inflate_biases(model.params)
    for dtype in (torch.bfloat16, torch.float32):
        launches = spatial_partition(ModelConfig(PARALLEL_MODEL, 16, compute_dtype=dtype),
                                     inflated, frames[:1], dcfg, devs)
        if dtype == torch.bfloat16:
            k1[f'spatial partition b1 over {n} cards (multicard)'] = launches['K1']
            k2[f'spatial partition b1 over {n} cards (multicard)'] = launches['K2']

    with tempfile.TemporaryDirectory() as root:
        ds = train_dataset(root)
        batch = first_batch(ds, 16)
        init = train_init_params()
        cfg, mcfg = train_cfgs(torch.float32, batch_size=16)
        state = ts.init_train_state(init, cfg, devs[0])
        step = ts.make_train_step(mcfg, cfg)
        state, m = step(state, batch)
        out_path = os.path.join(root, 'nccl_rank0.pt')
        mesh_lib.launch(rank_step, n, args=(out_path, batch, 'float32', None), backend='nccl')
        got = check_ranks(out_path, state, m, init, f'{n} NCCL ranks')
        print(f'DP train step m{TRAIN_MODEL} s16 float32 b16 over {n} NCCL ranks, one a card '
              f'({16 // n} images each): loss {got["loss_gap"]:.3g} relative from one card '
              f'(limit 1e-5), heads\' updates within {got["update_gap"]:.3g} of their norm '
              f'(limit 1e-3)', flush=True)

        path = os.path.join(root, 'dp.posenet')
        save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(8,),
                              input_hw=(PARALLEL_SIZE, PARALLEL_SIZE), platforms=('cuda',),
                              data_parallel_devices=n)
        art = load_serving_artifact(path)
        check(art.mesh.devices == tuple(devs), f'artifact over {art.mesh.devices}')
        ref = PoseNetPipeline(model, dcfg)(frames[:8])
        art(frames[:8])
        torch.cuda.synchronize()
        traversal.launches = sepconv.launches = 0
        out = art(frames[:8])
        torch.cuda.synchronize()
        check(traversal.launches == n and sepconv.launches == 13 * n,
              f'artifact over {n} cards launched K1 {traversal.launches}, K2 '
              f'{sepconv.launches} times')
        for f, a, b in zip(DecodedPoses._fields, out, ref):
            check(torch.equal(a, b), f'artifact over {n} cards differs from the pipeline in {f}')
        print(f'serving: artifact with data_parallel_devices={n}, loaded over {n} cards, b8 '
              f'bitwise equal to PoseNetPipeline; K1 launches {n}, K2 {13 * n}', flush=True)
    return k1, k2


# Phase 11: the int8 trunk (models/quantized.py), m101 s16 at 513x513 bf16.
INT8_MODEL, INT8_SIZE = 101, 513


def int8_products(model_id, size, batch):
    """(M, layer) of each pointwise product of the `model_id` s16 trunk at
    size x size and `batch`: its rows, and the layer (K and N are its
    `inp` and `outp`)."""
    side, out = size, []
    for layer in mobilenet_v1.stride_plan(model_id, 16):
        side = (side - 1) // layer['stride'] + 1
        if layer['conv_type'] == 'sep':
            out.append((batch * side * side, layer))
    return out


def same_tree(a, b) -> bool:
    """Every leaf equal in dtype, shape and bits (`b` may lie elsewhere)."""
    return all(x[k].dtype == y[k].dtype and torch.equal(x[k], y[k].to(x[k].device))
               for x, y in zip(a['backbone'] + list(a['heads'].values()),
                               b['backbone'] + list(b['heads'].values())) for k in x)


def int8_product_checks(dev, params) -> None:
    """Phase 11 (1): `quantize_params` of m101's weights on the card bitwise
    equal to the CPU's; then at every (M, K, N) of the m101 s16 513x513
    b128 trunk, random s8 inputs: `int8_matmul` (`torch._int_mm`) on the
    card equal to the exact float64 product (every sum is an integer below
    2^53), and `_pw_int8` on the card bitwise equal to the CPU's on the
    same rows (all of them up to 65536, else the first and last 32768);
    and, on every row, at M = 9 (a one-frame 33x33 product, padded to 17
    rows) and at m50's K = 16."""
    q_cpu = quantized.quantize_params(params)
    q_dev = quantized.quantize_params(params, dev)
    check(same_tree(q_dev, q_cpu), 'quantize_params on the card differs from the CPU\'s')
    m50 = mobilenet_v1.init_params(torch.Generator().manual_seed(50), ModelConfig(50, 16))
    g = torch.Generator(device=dev).manual_seed(11)
    cases = [(m, layer['block_id'], q_cpu, q_dev)
             for m, layer in int8_products(INT8_MODEL, INT8_SIZE, 128)]
    cases += [(9, 7, q_cpu, q_dev),
              (66049, 1, quantized.quantize_params(m50), quantized.quantize_params(m50, dev))]
    lines = []
    for m, i, cpu_layers, dev_layers in cases:
        w_cpu, w_dev = cpu_layers['backbone'][i], dev_layers['backbone'][i]
        k, n = w_dev['pw_w8'].shape
        q = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        acc = quantized.int8_matmul(q, w_dev['pw_w8'])
        exact = all(torch.equal(acc[r:r + 2 ** 20],
                                (q[r:r + 2 ** 20].double() @ w_dev['pw_w8'].double())
                                .to(torch.int32))
                    for r in range(0, m, 2 ** 20))
        check(exact, f'torch._int_mm at ({m}, {k}, {n}) differs from the exact product')
        y = quantized._pw_int8(q.view(1, 1, m, k), w_dev)[0, 0]
        rows = (torch.arange(m, device=dev) if m <= 65536 else
                torch.cat([torch.arange(32768, device=dev),
                           torch.arange(m - 32768, m, device=dev)]))
        ref = quantized._pw_int8(q[rows].cpu().view(1, 1, -1, k), w_cpu)[0, 0]
        check(torch.equal(y[rows].cpu(), ref),
              f'_pw_int8 at ({m}, {k}, {n}) on the card differs from the CPU')
        lines.append(f'({m}, {k}, {n})')
        del q, acc, y
    torch.cuda.synchronize()
    print(f'int8 products: quantize_params of m{INT8_MODEL} on the card bitwise equal to the '
          f'CPU\'s; torch._int_mm exact and _pw_int8 bitwise equal to the CPU\'s at (M, K, N) '
          f'{", ".join(lines)}', flush=True)


@contextlib.contextmanager
def recorded_levels():
    """Every `_quantize_act` output of the enclosed forwards, in order."""
    seen = []
    through = quantized._quantize_act
    quantized._quantize_act = lambda y: seen.append(through(y)) or seen[-1]
    try:
        yield seen
    finally:
        quantized._quantize_act = through


def int8_trunk_check(dev, params) -> None:
    """Phase 11 (2): the m101 s16 int8 trunk at 2x65x65 on the card against
    the CPU: the share of differing int8 levels at each quantize (cuDNN
    sums each depthwise in its own order, and a bf16 rounding moved by it
    can move a level), and the heads within the bf16 bar 2e-3, or else
    within the JAX package's int8 envelope (heatmap 0.02, offsets 0.1)."""
    cfg = ModelConfig(INT8_MODEL, 16, compute_dtype=torch.bfloat16, quantized=True)
    x = torch.from_numpy(np.random.RandomState(12).uniform(-1, 1, (2, 65, 65, 3))
                         .astype(np.float32))
    outs, levels = {}, {}
    for name, d in (('cpu', 'cpu'), ('cuda', dev)):
        with recorded_levels() as seen:
            outs[name] = quantized.forward_quantized(quantized.quantize_params(params, d),
                                                     x.to(d), cfg)
        levels[name] = seen
    torch.cuda.synchronize()
    labels = ['conv0'] + [f'{i}{part}' for i in range(1, 14) for part in ('dw', 'pw')][:-1]
    check(len(levels['cuda']) == len(labels), f'{len(levels["cuda"])} quantizes, not 26')
    shares = [float((a.cpu() != b).float().mean())
              for a, b in zip(levels['cuda'], levels['cpu'])]
    gaps = {k: float((outs['cuda'][k].cpu() - outs['cpu'][k]).abs().max()) for k in HEAD_ORDER}
    if max(gaps.values()) <= 2e-3:
        held = 'the bf16 bar 2e-3'
    else:
        check(gaps['heatmap'] <= 0.02 and gaps['offset'] <= 0.1,
              f'int8 heads, card vs CPU: {gaps} (limits 2e-3, or heatmap 0.02 and offset 0.1)')
        held = 'the JAX int8 envelope (heatmap 0.02, offsets 0.1), not the bf16 bar 2e-3'
    print(f'int8 trunk m{INT8_MODEL} s16 2x65x65, card vs CPU: share of differing int8 levels '
          f'by quantize {dict(zip(labels, (f"{s:.2e}" for s in shares)))}; heads gaps '
          f'{ {k: f"{v:.3g}" for k, v in gaps.items()} }: within {held}', flush=True)


def int8_pipeline_checks(dev, model, dcfg) -> dict:
    """Phase 11 (3) and (4): the quantized PoseNetPipeline on 8 synth_photo
    513x513 frames, then the decode on peaked heads (shapes, finite values,
    >= 1 pose per peaked image; K1 once a batch, K2 never); the data
    partition over 2 shards of `dev`, bitwise equal to the unsharded run
    (K1 once a shard); the refusals of the spatial partition,
    device_resize_to and serving export. Returns K1's launches by path."""
    pipe = PoseNetPipeline(model, dcfg)
    frames = torch.from_numpy(np.stack([synth_photo(INT8_SIZE, INT8_SIZE, 1100 + i)
                                        for i in range(8)])).to(dev)
    peaked = peaked_heads(8, 33, 7, dev)
    pipe.warmup((INT8_SIZE, INT8_SIZE), batch=8)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = 0
    poses = pipe(frames)
    peaked_poses = decode_batch(*peaked, 16, dcfg)
    torch.cuda.synchronize()
    launches = {'K1': traversal.launches, 'K2': sepconv.launches}
    check(launches == {'K1': 2, 'K2': 0},
          f'quantized pipeline + peaked decode launched {launches}, expected K1 2, K2 0')
    for out in (poses, peaked_poses):
        check(tuple(out.keypoint_coords.shape) == (8, 10, 17, 2),
              f'quantized keypoint_coords shape {tuple(out.keypoint_coords.shape)}')
        check(all(bool(torch.isfinite(t.float()).all()) for t in out), 'non-finite output')
    per_image = (peaked_poses.pose_scores > 0).sum(1)
    check(bool((per_image >= 1).all()), f'peaked decode accepted {per_image.tolist()}')
    sharded = PoseNetPipeline(model, dcfg, mesh=make_mesh(devices=[dev, dev]))
    sharded(frames)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = 0
    got = sharded(frames)
    torch.cuda.synchronize()
    shard_launches = {'K1': traversal.launches, 'K2': sepconv.launches}
    check(shard_launches == {'K1': 2, 'K2': 0},
          f'quantized data partition launched {shard_launches}, expected K1 2, K2 0')
    check(all(torch.equal(a, b) for a, b in zip(got, poses)),
          'quantized data partition over 2 shards differs from the unsharded run')
    refused = []
    for what, call in (
            ('spatial partition', lambda: PoseNetPipeline(
                model, dcfg, mesh=make_mesh(devices=[dev, dev]), partition='spatial')),
            ('device_resize_to', lambda: PoseNetPipeline(model, dcfg,
                                                         device_resize_to=(513, 513))),
            ('serving export', lambda: save_serving_artifact(
                model, os.path.join(tempfile.gettempdir(), 'never.posenet'),
                input_hw=(65, 65)))):
        try:
            call()
        except NotImplementedError as e:
            refused.append(f'{what} ({str(e)[:40]}...)')
            continue
        check(False, f'the quantized model was not refused: {what}')
    print(f'quantized pipeline m{INT8_MODEL} s16 8x{INT8_SIZE}x{INT8_SIZE} synth_photo -> '
          f'{tuple(poses.keypoint_coords.shape)}, finite, poses per frame '
          f'{(poses.pose_scores > 0).sum(1).tolist()}; peaked decode poses per image '
          f'{per_image.tolist()}; K1 {launches["K1"]}, K2 {launches["K2"]}; data partition '
          f'over 2 shards of {dev}: bitwise equal, K1 {shard_launches["K1"]}, K2 '
          f'{shard_launches["K2"]}; refused: {"; ".join(refused)}', flush=True)
    return {'quantized pipeline b8 + peaked decode (phase 11)': launches,
            f'quantized data partition b8 over 2 shards of {dev} (phase 11)': shard_launches}


def converter_cold_start(dev) -> None:
    """Phase 11 (5): a tfjs checkpoint of m101 at published widths
    (tests/torch_tfjs_fixture.py) in a download cache, `load_model` cold
    from it on the card (a fetch would fail the run), then from the `.npz`
    it wrote on the CPU: float32 heads of a photo within 1e-4 of each
    head's scale."""
    def no_fetch(url):
        check(False, f'the cold start fetched {url}; the checkpoint is in the cache')

    with tempfile.TemporaryDirectory() as root:
        cache = os.path.join(root, 'cache')
        torch_tfjs_fixture.write_tfjs_checkpoint(cache, 'mobilenet_v1_101', model_id=101)
        base_dir, fetch = download.BASE_DIR, download._fetch
        download.BASE_DIR, download._fetch = cache, no_fetch
        try:
            model = load_model(101, 16, os.path.join(root, 'models'), device=dev)
        finally:
            download.BASE_DIR, download._fetch = base_dir, fetch
        cpu_model = load_model(101, 16, os.path.join(root, 'models'), device='cpu')
    x = normalize(torch.from_numpy(synth_photo(257, 257, 1200)[None]), torch.float32)
    ref = cpu_model.forward_nhwc(x)
    got = model.forward_nhwc(x.to(dev))
    worst = 0.0
    for k in HEAD_ORDER:
        rel = float((got[k].cpu() - ref[k]).abs().max()) / max(1.0, float(ref[k].abs().max()))
        worst = max(worst, rel)
        check(rel <= 1e-4, f'converted m101 f32 head {k}: card vs CPU {rel:.3g} of scale')
    print(f'converter: load_model cold start from a tfjs m101 checkpoint (read the shards, '
          f'convert, write the .npz, load onto {dev}), no fetch; the .npz onto the CPU; f32 '
          f'heads 1x257x257 card vs CPU within {worst:.3g} of each head\'s scale (limit 1e-4)', flush=True)


def phase11(dev) -> dict:
    """Phase 11: the int8 trunk on the card. Returns K1's launches by path
    (K2's are 0 on every one of them)."""
    base = load_model(INT8_MODEL, 16, allow_random_init=True, device=dev,
                      compute_dtype=torch.bfloat16)
    model = PoseNet(base.params, dataclasses.replace(base.cfg, quantized=True))
    cpu_params = {'backbone': [{k: v.cpu() for k, v in layer.items()}
                               for layer in base.params['backbone']],
                  'heads': {n: {k: v.cpu() for k, v in p.items()}
                            for n, p in base.params['heads'].items()}}
    int8_product_checks(dev, cpu_params)
    int8_trunk_check(dev, cpu_params)
    launches = int8_pipeline_checks(dev, model, DecodeConfig(min_pose_score=0.25))
    converter_cold_start(dev)
    return launches


def phase12_single_and_features(dev) -> dict:
    """Phase 12 (a): `decode_single` on the card against the CPU, bitwise,
    one K1 launch a call; `backbone_features` in bf16 through K2 on the
    card against its plain version on the CPU. Returns the launches."""
    rng = np.random.RandomState(12)
    cfg = DecodeConfig(min_pose_score=0.25)
    k1 = 0
    for h, w, stride in ((33, 33, 16), (91, 161, 8)):
        heads = [torch.from_numpy(a[0]) for a in synth_heads(rng, 1, h, w)]
        ref = decode.decode_single(*heads, stride, cfg)
        traversal.launches = 0
        got = decode.decode_single(*[t.to(dev) for t in heads], stride, cfg)
        torch.cuda.synchronize()
        k1 = traversal.launches
        check(k1 == 1, f'decode_single launched K1 {k1} times')
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)),
              f'decode_single on the card differs from the CPU at {h}x{w} s{stride}')
        print(f'decode_single {h}x{w} s{stride}: card bitwise equal to the CPU (pose scores '
              f'included), {int((ref.pose_scores > 0).sum())} poses, candidate_count '
              f'{int(ref.candidate_count)}; K1 launches 1', flush=True)
    mcfg = ModelConfig(101, 16, compute_dtype=torch.bfloat16)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(12), mcfg)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 257, 257, 3)).astype(np.float32))
    ref = mobilenet_v1.backbone_features(mobilenet_v1.cast_params(params, torch.bfloat16), x,
                                         mcfg)
    sepconv.launches = 0
    got = mobilenet_v1.backbone_features(mobilenet_v1.cast_params(params, torch.bfloat16, dev),
                                         x.to(dev), mcfg)
    torch.cuda.synchronize()
    k2 = sepconv.launches
    scale = max(1.0, float(ref.float().abs().max()))
    gap = float((got.cpu().float() - ref.float()).abs().max())
    check(k2 == 13, f'backbone_features m101 s16 bf16 launched K2 {k2} times')
    check(got.shape == ref.shape == (1, 17, 17, 1024) and got.dtype == torch.bfloat16
          and got.is_contiguous(), f'backbone_features: {tuple(got.shape)} {got.dtype}')
    check(gap <= 2e-3 * scale, f'backbone_features bf16, K2 on the card vs plain on the CPU: '
                               f'{gap} (limit 2e-3 x {scale})')
    print(f'backbone_features m101 s16 bf16 1x257x257 -> NHWC {tuple(got.shape)}: K2 on the '
          f'card vs its plain version on the CPU within {gap:.3g} (limit 2e-3 of scale '
          f'{scale:g}; max |feature| {float(ref.float().abs().max()):.4g}); K2 launches {k2}',
          flush=True)
    return {'K1': k1, 'K2': k2}


def phase12_infer_launches(dev) -> tuple:
    """Phase 12 (b): `infer` over bf16 m50 s16 at 1x513x513, m101 s16 at
    16x513x513, m101 s8 at 4x721x1281 and m101 s16 at 1x721x1281 (seeded
    random weights and frames), each call warmed, then counted alone: K1
    once, K2 once for each fused layer (`k2_per_forward`); then
    `decode_batch` on peaked b4 heads at the s8 1080p grid, 136x241: K1
    once, K2 never, the poses those of the CPU's decode. Returns K1's and K2's launches by path."""
    dcfg = DecodeConfig(min_pose_score=0.25)
    k1, k2, counts = {}, {}, []
    for model_id, stride, b, h, w in ((50, 16, 1, 513, 513), (101, 16, 16, 513, 513),
                                      (101, 8, 4, 721, 1281), (101, 16, 1, 721, 1281)):
        cfg = ModelConfig(model_id=model_id, output_stride=stride, compute_dtype=torch.bfloat16)
        params = mobilenet_v1.cast_params(
            mobilenet_v1.init_params(torch.Generator().manual_seed(0), cfg), torch.bfloat16, dev)
        frames = torch.randint(0, 256, (b, h, w, 3), device=dev, dtype=torch.uint8,
                               generator=torch.Generator(device=dev).manual_seed(1))
        infer(params, frames, cfg, dcfg)
        torch.cuda.synchronize()
        traversal.launches = sepconv.launches = 0
        poses = infer(params, frames, cfg, dcfg)
        torch.cuda.synchronize()
        name = f'infer m{model_id} s{stride} bf16 {b}x{h}x{w} (phase 12)'
        k1[name], k2[name] = traversal.launches, sepconv.launches
        want = (1, k2_per_forward(cfg))
        check((k1[name], k2[name]) == want,
              f'{name} launched K1 {k1[name]} and K2 {k2[name]} times, not {want}')
        check(tuple(poses.keypoint_coords.shape) == (b, 10, 17, 2)
              and all(bool(torch.isfinite(t.float()).all()) for t in poses),
              f'{name}: keypoint_coords {tuple(poses.keypoint_coords.shape)} or non-finite')
        counts.append(f'm{model_id} s{stride} {b}x{h}x{w} K1 {k1[name]}, K2 {k2[name]}')
        del params, frames, poses
    heads = peaked_heads(4, (136, 241), 7, dev)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = 0
    poses = decode_batch(*heads, 8, dcfg)
    torch.cuda.synchronize()
    name = 'decode_batch s8 4x136x241 (phase 12)'
    k1[name], k2[name] = traversal.launches, sepconv.launches
    check((k1[name], k2[name]) == (1, 0),
          f'{name} launched K1 {k1[name]} and K2 {k2[name]} times, not (1, 0)')
    assert_poses_equal(poses, decode_batch(*[t.cpu() for t in heads], 8, dcfg),
                       f'{name} on the card vs the CPU')
    counts.append(f'decode_batch s8 4x136x241 K1 {k1[name]}, K2 {k2[name]}, equal to the '
                  f'CPU\'s, poses per image {(poses.pose_scores > 0).sum(1).tolist()}')
    torch.cuda.empty_cache()
    print(f'infer bf16, launches in one call: {"; ".join(counts)}', flush=True)
    return k1, k2


def phase12(dev) -> tuple:
    """Phase 12: the tools on the card. Returns K1's and K2's launches by
    path."""
    k1, k2 = {}, {}

    # (a) decode_single and backbone_features
    launches = phase12_single_and_features(dev)
    k1['decode_single, a call (phase 12)'] = launches['K1']
    k2['backbone_features m101 s16 bf16 (phase 12)'] = launches['K2']

    # (b) infer at four inference configurations, decode_batch at 136x241
    infer_k1, infer_k2 = phase12_infer_launches(dev)
    k1.update(infer_k1)
    k2.update(infer_k2)

    # (c) the spatial partition at production grids over 8 shards
    traversal.launches = sepconv.launches = 0
    results = verify_spatial_large_torch.main([])
    torch.cuda.synchronize()
    check(all(r['bitwise'] for r in results),
          f'spatial partition not bitwise: {[(r["name"], r["bitwise"]) for r in results]}')
    k1['verify_spatial_large_torch, 2 grids x (plain + 8 shards) (phase 12)'] = \
        traversal.launches
    k2['verify_spatial_large_torch, 2 grids x (plain + 8 shards) (phase 12)'] = \
        sepconv.launches

    # (d) OKS/mAP before and after a heads-only fine-tune
    check(importlib.util.find_spec('cv2') is not None,
          'phase 12 (d) needs cv2 (the synthesized dataset is written as JPEG files)')
    with tempfile.TemporaryDirectory() as root:
        traversal.launches = sepconv.launches = 0
        acc = train_accuracy_delta_torch.run(['--workdir', os.path.join(root, 'acc')])
        torch.cuda.synchronize()
    check(all(np.isfinite(acc[p][k]) for p in ('before', 'after') for k in ('loss', 'oks',
                                                                             'mAP')),
          f'train_accuracy_delta_torch: {acc}')
    k1['train_accuracy_delta_torch, m50 129x129, 40 epochs (phase 12)'] = traversal.launches
    k2['train_accuracy_delta_torch, m50 129x129, 40 epochs (phase 12)'] = sepconv.launches
    print(f'train_accuracy_delta_torch: OKS {acc["before"]["oks"]:.4f} -> '
          f'{acc["after"]["oks"]:.4f}, mAP {acc["before"]["mAP"]:.4f} -> '
          f'{acc["after"]["mAP"]:.4f} ({"improved" if acc["improved"] else "not improved"})',
          flush=True)
    return k1, k2


def full_run(dev) -> list:
    """Phases 3-12; returns the kernels' entries."""
    max_err = k1_checks(dev)
    k2_err = k2_checks(dev)
    stem_err = stem_checks(dev)
    stem_by_path = stem_launches(dev)

    # 4. float32 parity on the card (fixture weights, synthesized photos)
    params = weights.load_params_npz(FIXTURE)
    cfg50 = ModelConfig(model_id=50, output_stride=16)
    frames = torch.from_numpy(np.stack([synth_photo(353, 481, 100 + i) for i in range(3)]))
    heads = {}
    for name, d in (('cpu', 'cpu'), ('cuda', dev)):
        p = weights.params_from_jax(params, d)
        heads[name] = mobilenet_v1.forward(p, normalize(frames.to(d), torch.float32), cfg50)
    worst = 0.0
    for k, ref in heads['cpu'].items():
        got = heads['cuda'][k].cpu()
        rel = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        worst = max(worst, rel)
        check(rel <= 1e-4, f'f32 head {k}: CUDA vs CPU {rel:.3g} of scale (limit 1e-4)')
    print(f'f32 heads, fixture m50 s16, 3x353x481: CUDA vs CPU within {worst:.3g} '
          f'of each head\'s scale (limit 1e-4)', flush=True)
    dcfg = DecodeConfig(min_pose_score=0.25)
    cpu_heads = [heads['cpu'][k] for k in HEAD_ORDER]
    ref = decode_batch(*cpu_heads, 16, dcfg)
    got = decode_batch(*[t.to(dev) for t in cpu_heads], 16, dcfg)
    assert_poses_equal(got, ref, 'decode_batch CUDA (K1) vs CPU (plain)')
    n_ref = (ref.pose_scores > 0).sum(1)
    check(bool((n_ref >= 1).all()), f'fixture decode found no pose: {n_ref.tolist()}')
    slice_gpu = decode_batch(*[heads['cuda'][k] for k in HEAD_ORDER], 16, dcfg)
    check(torch.equal((slice_gpu.pose_scores > 0).sum(1).cpu(), n_ref),
          'slice on CUDA finds another pose count than on the CPU')
    coord_err = float((slice_gpu.keypoint_coords.cpu() - ref.keypoint_coords).abs().max())
    score_err = float((slice_gpu.pose_scores.cpu() - ref.pose_scores).abs().max())
    check(coord_err <= 1e-2 and score_err <= 1e-4,
          f'slice on CUDA vs CPU: coords {coord_err} px, pose scores {score_err}')
    print(f'f32 decode: CUDA (K1) vs CPU (plain) on the same heads: coords and '
          f'keypoint scores bitwise, pose scores within 2 ulp; poses per image '
          f'{n_ref.tolist()}; whole slice CUDA vs CPU: coords {coord_err:.2g} px, '
          f'pose scores {score_err:.2g}', flush=True)
    bgr = torch.from_numpy(np.stack([synth_photo(480, 640, 200 + i)[..., ::-1]
                                     for i in range(2)]).copy())
    raw = {name: infer_raw(weights.params_from_jax(params, d), bgr.to(d), (353, 481),
                           cfg50, dcfg) for name, d in (('cpu', 'cpu'), ('cuda', dev))}
    n_raw = (raw['cpu'].pose_scores > 0).sum(1)
    check(bool((n_raw >= 1).all()), f'fixture raw-frame decode found no pose: {n_raw.tolist()}')
    check(torch.equal((raw['cuda'].pose_scores > 0).sum(1).cpu(), n_raw),
          'raw-frame slice on CUDA finds another pose count than on the CPU')
    raw_coord = float((raw['cuda'].keypoint_coords.cpu() - raw['cpu'].keypoint_coords).abs().max())
    raw_score = float((raw['cuda'].pose_scores.cpu() - raw['cpu'].pose_scores).abs().max())
    check(raw_coord <= 1e-2 and raw_score <= 1e-4,
          f'raw-frame slice on CUDA vs CPU: coords {raw_coord} px, pose scores {raw_score}')
    print(f'f32 raw-frame slice, fixture m50 s16, 2 BGR 480x640 -> 353x481: CUDA vs CPU '
          f'coords {raw_coord:.2g} px, pose scores {raw_score:.2g}; poses per image '
          f'{n_raw.tolist()}', flush=True)

    k2_trunk_launches(dev)

    # 5. the main path: m101 s16 bf16, random init, 513x513
    model = load_model(101, 16, allow_random_init=True, device=dev,
                       compute_dtype=torch.bfloat16)
    pipe = PoseNetPipeline(model)
    g = torch.Generator(device=dev).manual_seed(0)
    frames8 = torch.randint(0, 256, (8, 513, 513, 3), generator=g, device=dev,
                            dtype=torch.uint8)
    peaked8 = peaked_heads(8, 33, 7, dev)
    pipe.warmup((513, 513), batch=8)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = sepconv.strided_launches = 0
    poses = pipe(frames8)
    peaked_poses = decode_batch(*peaked8, 16, pipe.decode_cfg)
    torch.cuda.synchronize()
    launches = traversal.launches
    k2_launches, k2_strided = sepconv.launches, sepconv.strided_launches
    check(launches >= 2, f'K1 launched {launches} times on the main path')
    check((k2_launches, k2_strided) == (13, 3),
          f'K2 launched {k2_launches} times on the main path, {k2_strided} at stride 2 (one '
          f'm101 s16 forward has 13 separable layers, 3 of them at stride 2)')
    for out in (poses, peaked_poses):
        check(tuple(out.keypoint_coords.shape) == (8, 10, 17, 2),
              f'keypoint_coords shape {tuple(out.keypoint_coords.shape)}')
        check(tuple(out.pose_scores.shape) == (8, 10), 'pose_scores shape')
        check(all(bool(torch.isfinite(t.float()).all()) for t in out), 'non-finite output')
    per_image = (peaked_poses.pose_scores > 0).sum(1)
    check(bool((per_image >= 1).all()), f'peaked decode accepted {per_image.tolist()}')
    assert_poses_equal(peaked_poses, decode_batch(*[t.cpu() for t in peaked8], 16,
                                                  pipe.decode_cfg),
                       'peaked decode CUDA vs CPU')
    print(f'main path: m101 s16 bf16 8x513x513 -> {tuple(poses.keypoint_coords.shape)}, '
          f'finite; peaked decode poses per image {per_image.tolist()} (equal to the '
          f'CPU decode); K1 launches {launches}, K2 launches {k2_launches} ({k2_strided} at '
          f'stride 2)', flush=True)

    # 5b. the raw-frame path: BGR 720p frames resized on the device
    raw_pipe = PoseNetPipeline(model, device_resize_to=(513, 513))
    bgr16 = torch.randint(0, 256, (16, 720, 1280, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    raw_pipe.warmup((720, 1280), batch=16)
    torch.cuda.synchronize()
    traversal.launches = sepconv.launches = 0
    raw_poses = raw_pipe(bgr16)
    torch.cuda.synchronize()
    raw_k1, raw_k2 = traversal.launches, sepconv.launches
    check(raw_k1 >= 1 and raw_k2 == 13,
          f'raw-frame path launched K1 {raw_k1} and K2 {raw_k2} times')
    check(tuple(raw_poses.keypoint_coords.shape) == (16, 10, 17, 2),
          f'raw keypoint_coords shape {tuple(raw_poses.keypoint_coords.shape)}')
    check(all(bool(torch.isfinite(t.float()).all()) for t in raw_poses), 'non-finite raw output')
    x_raw = preprocess_on_device(bgr16, (513, 513))
    heads_raw = mobilenet_v1.forward(raw_pipe.params, x_raw, raw_pipe.cfg)
    chained = decode_batch(heads_raw['heatmap'], heads_raw['offset'],
                           heads_raw['displacement_fwd'], heads_raw['displacement_bwd'],
                           16, raw_pipe.decode_cfg)
    check(all(torch.equal(a, b) for a, b in zip(raw_poses, chained)),
          'raw-frame path differs from preprocess -> forward -> decode chained by hand')
    print(f'raw-frame path: m101 s16 bf16 16x720x1280 BGR -> 513x513 -> '
          f'{tuple(raw_poses.keypoint_coords.shape)}, finite, bitwise equal to the '
          f'hand-chained path; K1 launches {raw_k1}, K2 launches {raw_k2}', flush=True)

    # 5c. the ResNet50 main path: the stem's launches over one pipeline call
    stem_count = stem_main_path(dev)

    # 6. serving
    serving_phase(model, dev)

    # 7. the kernels alone at the cells' shapes
    del frames8, bgr16, peaked8, pipe, raw_pipe, model
    torch.cuda.empty_cache()
    timing = {kernel: cell_timing(dev, kernel) for kernel in ('K2', 'stem', 'K1')}

    # 8. the single pose and the apps (float32, as the JAX apps run)
    single_err, app_launches = phase8(dev)

    # 9. heads-only fine-tuning
    train_k1, train_k2 = phase9(dev)

    # 10. multi-device on the one card
    parallel_k1, parallel_k2 = phase10(dev)

    # 11. the int8 trunk
    int8_launches = phase11(dev)

    # 12. the tools
    tools_k1, tools_k2 = phase12(dev)
    k1_paths = {'main path (phase 5)': launches, **app_launches, **train_k1, **parallel_k1,
                **{k: v['K1'] for k, v in int8_launches.items()}, **tools_k1}
    k2_paths = {'main path (phase 5)': k2_launches, **train_k2, **parallel_k2,
                **{k: v['K2'] for k, v in int8_launches.items()}, **tools_k2}
    return [entry('K1', launches=launches, launches_by_path=k1_paths,
                  max_abs_err=max(max_err, single_err), cells=timing['K1']),
            entry('K2', launches=k2_launches, launches_by_path=k2_paths, max_abs_err=k2_err,
                  cells=timing['K2']),
            entry('stem', launches=stem_count,
                  launches_by_path={'main path (phase 5, ResNet50 s16 bf16 b8 513x513)':
                                    stem_count, **stem_by_path},
                  max_abs_err=stem_err, cells=timing['stem'])]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--only', choices=('k1', 'k2', 'stem', 'apps', 'train', 'parallel',
                                           'multicard', 'int8', 'tools'),
                        help='the device and build phases, then K1, K2 or the stem alone, '
                             'phase 8 (the single pose and the apps), phase 9 '
                             '(training), phase 10 (multi-device on one card) or its '
                             'layouts across every card of a host with several, '
                             'phase 11 (the int8 trunk) or phase 12 (the tools)')
    only = parser.parse_args(argv).only
    found = device_phase()
    if found is None:
        return 1
    kind, dev = found
    with tempfile.TemporaryDirectory() as cache:
        download._fetch, download.BASE_DIR = offline_fetch, cache
        kernels = run_phases(only, dev)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


def run_phases(only, dev) -> list:
    """Phase 2, then the phases `--only` names (all without it); returns
    the kernels' entries. Without a main path, `launches` is counted over
    the run that `launches_from` names."""
    build_phase()
    if only == 'k1':
        traversal.launches = 0
        err = k1_checks(dev)
        return [entry('K1', launches=traversal.launches,
                      launches_from='the K1 checks of phase 3, not the main path',
                      max_abs_err=err, cells=cell_timing(dev, 'K1'))]
    if only == 'k2':
        err = k2_checks(dev)
        return [entry('K2', launches=k2_trunk_launches(dev),
                      launches_from='bf16 trunk check at 2x65x65, not the main path',
                      max_abs_err=err, cells=cell_timing(dev, 'K2'))]
    if only == 'stem':
        err = stem_checks(dev)
        by_path = stem_launches(dev)
        launches = stem_main_path(dev)
        return [entry('stem', launches=launches,
                      launches_by_path={'main path (phase 5, ResNet50 s16 bf16 b8 513x513)':
                                        launches, **by_path},
                      max_abs_err=err, cells=cell_timing(dev, 'stem'))]
    if only == 'apps':
        err, app_launches = phase8(dev)
        return [entry('K1', launches=app_launches['single pose'],
                      launches_from='the single-pose calls of phase 8, not the main path',
                      launches_by_path=app_launches, max_abs_err=err)]
    if only == 'int8':
        by_path = {k: v['K1'] for k, v in phase11(dev).items()}
        run = 'quantized pipeline b8 + peaked decode (phase 11)'
        return [entry('K1', launches=by_path[run], launches_from=f'{run}, not the main path',
                      launches_by_path=by_path)]
    if only == 'train':
        k1, k2 = phase9(dev)
        runs = ['train() bf16 (phase 9)'] * 2
    elif only == 'parallel':
        k1, k2 = phase10(dev)
        runs = [f'data partition b128 over 2 shards of {dev} (phase 10)'] * 2
    elif only == 'multicard':
        k1, k2 = multicard()
        runs = [f'data partition b128 over {torch.cuda.device_count()} cards (multicard)'] * 2
    elif only == 'tools':
        k1, k2 = phase12(dev)
        runs = ['decode_single, a call (phase 12)', 'backbone_features m101 s16 bf16 (phase 12)']
    else:
        return full_run(dev)
    return [entry(kernel, launches=paths[run], launches_from=f'{run}, not the main path',
                  launches_by_path=paths)
            for kernel, paths, run in (('K1', k1, runs[0]), ('K2', k2, runs[1]))]


if __name__ == '__main__':
    sys.exit(main())
