#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py             # every phase: what a run must pass
    python3 chip_smoke.py --only k1   # device, build, K1's checks and timing
    python3 chip_smoke.py --only k2   # device, build, K2's checks and timing
    python3 chip_smoke.py --only apps # device, build, phase 8
    python3 chip_smoke.py --only train # device, build, phase 9
    python3 chip_smoke.py --only parallel # device, build, phase 10
    python3 chip_smoke.py --only multicard # phase 10's layouts across several cards

Phases, each printing its own line; any failure exits nonzero and prints
no result:
1. device: needs CUDA; prints the card's `name, power.limit` (nvidia-smi)
   and the torch / CUDA versions. TF32 is turned off (f32 parity mode).
2. build: compiles the traversal kernel K1 (csrc/traversal.cu) and the
   fused sepconv kernel K2 (csrc/sepconv.cu), one nvcc each, in parallel;
   prints what ptxas says of K1's walk (registers, stack frame, spills)
   and fails unless its state stays in registers (0-byte stack frame, no
   spills).
3. K1 against its plain PyTorch version on the card, bit for bit, at the
   main path's 33x33 stride-16 grid (B=8, K=128), at 91x161 stride 8 on
   views of one 115-channel heads tensor (as `run_heads` writes them), and
   where the first backward hop to the nose lands on a zero score.
   K2 against its plain version at B=2 at every (H, W, C_in, C_out) that
   a K2 layer of the four models has at 513x513 (17x17 1024->1024, m101
   s32's last, is the BM = 64 path), and at B=1 9x9 512->512 (one block,
   a ragged pixel tile): each element within one bf16 ulp, or 2^-16. K2's
   pointwise alone (identity depthwise) on one 64x128x64 product against
   torch.matmul, to the same tolerance.
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
   K2's (9, one forward) over exactly this run. Then the raw-frame path
   (device_resize_to=(513, 513)) on 16 BGR 720x1280 frames, with its own
   counts: shapes, finite values, equal to preprocess -> forward -> decode
   chained by hand.
6. serving, m101 s16 bf16 513x513, min_pose_score 0 so that poses come
   out: (a) export a `cuda` artifact at batch sizes (1, 8) with
   `torch.export`, load it, and hold it bitwise to PoseNetPipeline on 8
   frames, with K2 launched 9 times and K1 at least once by the loaded
   program, every K2 input a view of the previous layer, no copy, and
   K1's row inputs views of the heads tensor (the scores of its sigmoid);
   (b) PoseServer over the artifact and over LivePipelineBackend on
   127.0.0.1, 16 raw frames posted concurrently, each reply equal to the
   in-process result for its frame at a served batch size, /healthz and
   /statsz; (c) 720x1280 BGR frames resized on the host by
   native_preprocess.resize_rgb (the native library where cv2 is absent),
   ms a frame (and cv2's where present), posted raw and checked the same
   way (the server's JPEG/PNG path needs cv2 and then resizes with it, so
   it never reaches the native library); a host-clock breakdown of one
   b32 chunk through the server's own steps, and its device busy time
   (torch.profiler); (d) tools/serve_loadgen.py unchanged against the live
   server at batch sizes (1, 8, 32), 32 clients for 10 s, at
   pipeline_depth 2 and 1: req/s, p50/p99 latency, the batch histogram,
   and the CPU seconds of the server process and of the load generator.
7. timing (CUDA events / synchronize-bracketed host clock): fused m101 s16
   513x513 b128 bf16 forward + peaked decode in img/s, best of 3 windows;
   forward and decode alone; the raw-frame path from 720x1280 at b128 in
   img/s; `_prepare_decode` at b128 (CUDA graph and CUDA events) beside
   the row copies it no longer makes; per K2 layer at b128, K2 held to its
   plain version (one bf16 ulp, or 2^-16) and then timed against it and
   against the cuDNN conv pair the trunk ran before, beside its bound; K1
   at B=128, K=128, held to its plain version and timed against it, by
   CUDA graph replay (the device alone) and per call by CUDA events (host
   dispatch included), beside its bound (the hops that fetch in this run's
   walk) and its latency floor (one candidate alone).
8. the single pose and the apps, in float32 as the JAX apps run. (1)
   `decode_single_pose` on the card against the same call on the CPU,
   bitwise with the same root and one K1 launch a call, on synthesized
   heads at 33x33 s16 and 91x161 s8, the fixture m50 s16's heads of a
   synthesized photo and a heatmap with nothing above the threshold; K1 at
   that B = K = 1 shape held to its plain version and timed, and the whole
   call timed on the card and on the CPU. Where cv2 imports (else one line
   says so): (2) each app's `main(argv)` in-process with its default
   device, m101 s16 random weights, float32 with TF32 off (each app turns
   it off), inputs written with numpy and cv2 into a temporary directory
   (the working directory meanwhile): image_demo on 4 photos 720x1280,
   cold and then warm (the second run at a shape in the process),
   benchmark per frame (20 frames; again with --profile for its stage
   breakdown) and at --batch_size 128 --image_size 513 with --profile (the
   traced batch's device time by kernel), webcam_demo on a stand-in
   capture of 8 frames cold and 24 warm, then webcam_demo's own loop with
   `StageTimer` around the helpers it calls, video_demo on a 40-frame
   720x1280 mp4 at 513x513 batch 16, with the host resize and with
   --device_preprocess; outputs, K1's launches over each run, and each
   app's FPS line beside the card's `name, power.limit`. Then the
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
   the loss gap and the gradient gap printed, 9 K2 launches. (3) `train()`
   on the card, float32 (with visual dumps) and bf16, b16, 2 epochs, lr
   1e-4, eval with pose metrics on the same 16 images: finite losses, the
   trunk bitwise unchanged, the heads moved, the eval loss lower after
   than before and the second epoch's train loss (the same 16 images)
   below the first's, the latest checkpoint restored bitwise with its Adam
   moments; K2 launched 9 times for each bf16 forward (a step, an eval
   loss, an eval decode an epoch), none in float32; K1 once for each eval
   batch and visual dump. (4) `posenet-export-torch --from_checkpoint` of
   the bf16 run's checkpoint to a `cuda` artifact, bitwise equal to
   PoseNetPipeline over the restored params. (5) Timing, beside the card's
   `name, power.limit`, at b16 and b2, float32 and bf16: the median of 15
   warm steps by CUDA events, in img/s, and the host clock over 15; the
   split of a step into forward, loss + backward and Adam (CUDA events at
   their edges, median of 10); the host's staging of the batch alone; the
   device's busy share of 5 steps (`profiling.device_time_report` over a
   `profiling.trace`, against the host clock); the peak memory of a step
   (`torch.cuda.max_memory_allocated`); an eval batch's loss, and its
   forward + decode + host scoring.
10. multi-device on the one card, m101 s16 513x513 bf16 (published widths
   and depth, seeded random weights), every shard on cuda:0 through a
   device list that repeats it. (a) The data partition of 128 synth_photo
   frames over 2 shards and over every visible card, and of an uneven 129
   over 2: per shard its heads against the unsharded forward's rows,
   bitwise or within the bf16 bar 2e-3 (which held is printed), and its
   poses bitwise wherever its heads are; K2 launched 9 times and K1 once
   a shard. (b) The spatial partition of one frame, trunk biases + 1.0,
   over 2 and 4 shards, bf16 and float32: the gathered heads against the
   unsharded heads (2e-3; 1e-4 of each head's scale in float32), the
   poses bitwise where the heads are; K2 9 times a shard, K1 once. (c)
   The data-parallel train step at b16 on phase 9's dataset, world size 1
   over NCCL, against the single-device step, float32 and bf16: loss,
   head gradients and heads after Adam bitwise; then 2 gloo ranks on the
   one card (8 images each) against one device, or why gloo refused.
   (d) `LivePipelineBackend(num_devices=1)` and an artifact exported with
   `data_parallel_devices=1`, served, each reply equal to the in-process
   result; the artifact bitwise equal to the pipeline. (e) Timing beside
   the card's `name, power.limit`, each layout in turns: data-partition
   img/s over 2 shards against the unsharded pipeline (best of 3 windows
   of 5 b128 batches); spatial b1 latency at 1, 2 and 4 shards against the
   plain pipeline (CUDA events, a call's mean over 20); the DP step at
   world size 1 against the plain step (in (c)).
Then one JSON line describing the kernels (K1's and K2's with their
launches on each path of phases 5, 8, 9 and 10), and as the last line
{"ok": true, "device": {...}}. Its times are CUDA events per call (host
dispatch included), with one exception: K1's `ms` is CUDA graph replay,
the device alone, because its per-call time is the host's; K1's
`call_ms` is the per-call time, the method of its `plain_ms` (the plain
version cannot be captured in a graph: it copies its stride to the
card) and of K1's `ms` before the graph timing. `--only train` runs phases 1, 2
and 9, then K1's and K2's timing of 7; `--only parallel` the same with
phase 10. `--only k1` runs phases 1, 2, K1's part of
3 and K1's timing of 7; `--only apps` runs phases 1, 2 and 8, its K1
entry timed at the single pose's shape; `--only k2` runs phases 1, 2, K2's part of 3, the
bf16 trunk check of 4 and K2's per-layer timing of 7; each then prints the
same two lines (the kernel's entry; its `launches` from the checks, as
`launches_from` says).

Bounds (`bound_ms`) are the larger of bytes / 3.35 TB/s and operations /
the peak rate of their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
f32), the H100 SXM's published rates at 700 W.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from posenet_tpu_torch import (PoseNetPipeline, decode, decode_single_pose, load_model,
                               native_preprocess)
from posenet_tpu_torch.apps import full_float32
from posenet_tpu_torch.config import DecodeConfig, ModelConfig, TrainConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.decode import (_BWD_LEVELS, _FWD_LEVELS, DecodedPoses, _prepare_decode,
                                     decode_batch)
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import PoseNet
from posenet_tpu_torch.ops import _build, sepconv, traversal
from posenet_tpu_torch.parallel import mesh as mesh_lib
from posenet_tpu_torch.parallel import spatial
from posenet_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from posenet_tpu_torch.pipeline import infer, infer_raw, normalize
from posenet_tpu_torch.preprocess import preprocess_on_device, process_input
from posenet_tpu_torch.profiling import StageTimer, device_time_report, trace
from posenet_tpu_torch.server import (LivePipelineBackend, PoseServer, _Request,
                                      make_http_server)
from posenet_tpu_torch.serving import load_serving_artifact, save_serving_artifact
from posenet_tpu_torch.serving import main as export_main
from posenet_tpu_torch.training import trainer
from posenet_tpu_torch.training import train_step as ts
from posenet_tpu_torch.training.dataset import PosenetDataset
from posenet_tpu_torch.training.ground_truth import prepare_ground_truth_data
from tests.torch_k1_cases import head_views, k1_reads_heads_in_place, nose_zero_heads

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'fixture_m50_s16.npz')
K1_SOURCE = 'posenet_tpu_torch/csrc/traversal.cu'
K1_REPLACES = 'posenet_tpu/ops/pallas/traversal.py:551'
K2_SOURCE = 'posenet_tpu_torch/csrc/sepconv.cu'
K2_REPLACES = 'posenet_tpu/ops/pallas/sepconv.py:228'
# (H, W, C_in, C_out, K2 layers of one m101 s16 513x513 forward at this
# shape), then the other K2 layers of the four models at 513x513: the
# C_in 16 and 24 stems of m50 and m75, m101 s32's last (the BM = 64 path),
# and the rest of m50, m75 and m101 s8.
K2_M101_SHAPES = ((257, 257, 32, 64, 1), (129, 129, 128, 128, 1), (65, 65, 256, 256, 1),
                  (33, 33, 512, 512, 5), (33, 33, 512, 1024, 1))
K2_OTHER_SHAPES = ((257, 257, 16, 32, 0), (257, 257, 24, 48, 0), (17, 17, 1024, 1024, 0),
                   (129, 129, 64, 64, 0), (129, 129, 96, 96, 0), (65, 65, 128, 256, 0),
                   (65, 65, 192, 192, 0), (65, 65, 192, 384, 0), (65, 65, 256, 512, 0),
                   (33, 33, 256, 256, 0), (33, 33, 384, 384, 0))
HEAD_ORDER = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')
HBM_BYTES_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f'chip_smoke: FAILED: {what}')


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


def peaked_heads(batch, r, seed, device):
    """bench.py-style peaked heads: 3 gaussian people x 17 keypoints (peak
    0.9), uniform offsets and displacements in [-8, 8). Each person's
    keypoints lie within 4 cells of its centre (as in synth_heads), so that
    poses pass min_pose_score=0.25 and the accept does real work;
    independent random keypoints, as bench.py draws them, accept none.
    Drawn from a CPU generator, so every device gets the same heads."""
    g = torch.Generator().manual_seed(seed)
    centre = [torch.randint(5, r - 5, (batch, 3, 1, 1, 1), generator=g) for _ in range(2)]
    ky, kx = [(c + torch.randint(-4, 5, (batch, 3, 17, 1, 1), generator=g)).clamp(0, r - 1)
              for c in centre]
    yy = torch.arange(r)[:, None]
    xx = torch.arange(r)[None, :]
    blobs = torch.exp(-((yy - ky) ** 2 + (xx - kx) ** 2) / 4.0)   # (B,3,17,R,R)
    hm = (0.9 * blobs).amax(1).permute(0, 2, 3, 1).contiguous().to(device)
    flat = (torch.rand((batch, r, r, 98), generator=g) * 16 - 8).to(device)
    return hm, flat[..., :34], flat[..., 34:66], flat[..., 66:98]


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


def k2_against_plain(args):
    """(within tolerance, max abs difference, share bitwise equal) of K2
    against its plain version: each element within one bf16 ulp of the
    plain value, or 2^-16 (tests/test_torch_sepconv.py)."""
    got = sepconv.sepconv(*args).float()
    torch.cuda.synchronize()
    ref = sepconv.sepconv_reference(*args).float()
    diff = (got - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    ok = bool((diff <= ulp.clamp_min(2.0 ** -16)).all())
    return ok, float(diff.max()), float((diff == 0).float().mean())


def k2_bound_ms(b, h, w, c_in, c_out):
    """(bound ms, what bounds it) of one K2 call: each input read once and
    the output written once, in bytes; the pointwise's products on the
    bf16 tensor cores and the depthwise's 9 taps in f32, each at its peak."""
    m = b * h * w
    nbytes = 2 * m * (c_in + c_out) + 2 * 9 * c_in + 4 * c_in + 2 * c_in * c_out + 4 * c_out
    mem_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = max(2 * m * c_in * c_out / BF16_TENSOR_FLOPS, 2 * 9 * m * c_in / F32_FLOPS) * 1e3
    return (mem_ms, 'bytes') if mem_ms >= ops_ms else (ops_ms, 'operations')


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
    cell's score and offset pair (12)."""
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
    """Phase 6: export/load, serve raw frames, host resize, served timing."""
    dcfg = DecodeConfig(min_pose_score=0.0)
    g = torch.Generator(device=dev).manual_seed(3)
    frames8 = torch.randint(0, 256, (8, 513, 513, 3), generator=g, device=dev,
                            dtype=torch.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) export, load, check
        path = os.path.join(tmp, 'm101_s16_bf16.posenet')
        t0 = time.perf_counter()
        meta = save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(1, 8),
                                     input_hw=(513, 513), platforms=('cuda',))
        export_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 2 ** 20
        art = load_serving_artifact(path)
        check(art.device.type == 'cuda', f'artifact loaded on {art.device}')
        pipe = PoseNetPipeline(model, dcfg)
        t0 = time.perf_counter()
        for b in (1, 8):
            art(frames8[:b])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ref = pipe(frames8)
        torch.cuda.synchronize()
        traversal.launches = sepconv.launches = 0
        out = art(frames8)
        torch.cuda.synchronize()
        k1, k2 = traversal.launches, sepconv.launches
        check(k2 == 9 and k1 >= 1, f'the loaded artifact launched K1 {k1} and K2 {k2} times')
        for f, a, b in zip(DecodedPoses._fields, out, ref):
            check(torch.equal(a, b), f'artifact b8 differs from PoseNetPipeline in {f}')
        for b in (1, 8):   # K2 reads the previous layer's output in place
            made_by = [n.args[0].target for n in art._program(b).graph.nodes
                       if n.target == torch.ops.posenet_tpu_torch.sepconv.default]
            check(made_by == [torch.ops.aten.permute.default] * 9,
                  f'b{b} program: the K2 inputs are made by {made_by}, not 9 views (permute)')
        k1_inputs = [k1_reads_heads_in_place(art._program(b).graph) for b in (1, 8)]
        check(all(torch.equal(a, b) for a, b in zip(art(frames8[:1]), pipe(frames8[:1]))),
              'artifact b1 differs from PoseNetPipeline')
        n_poses = (out.pose_scores > 0).sum(1).tolist()
        print(f'serving (a): export m101 s16 bf16 513x513 batches {meta["batch_sizes"]} '
              f'platform cuda in {export_s:.2f} s, {size_mb:.2f} MiB; load + first call of '
              f'both programs {load_s:.2f} s; loaded program bitwise equal to '
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
            t0 = time.perf_counter()
            out = np.stack([native_preprocess.resize_rgb(f, (513, 513), backend) for f in bgr])
            return out, (time.perf_counter() - t0) * 1000 / len(bgr)

        has_cv2 = importlib.util.find_spec('cv2') is not None
        saved = sys.modules.get('cv2')
        sys.modules['cv2'] = None   # as on a host without cv2: 'auto' takes the library
        try:
            resize_all('auto')      # the first call builds the library
            native, native_ms = resize_all('auto')
        finally:
            if saved is None:
                del sys.modules['cv2']
            else:
                sys.modules['cv2'] = saved
        check(np.array_equal(native, resize_all('native')[0]),
              "resize_rgb 'auto' without cv2 is not the native library")
        line = (f'serving (c): host resize 720x1280 BGR -> 513x513 RGB by '
                f'native_preprocess.resize_rgb without cv2 (the native library): '
                f'{native_ms:.3f} ms a frame (mean of {len(bgr)}, host clock)')
        if has_cv2:
            resize_all('cv2')       # the first call imports cv2
            via_cv2, cv2_ms = resize_all('cv2')
            lsb = int(np.abs(via_cv2.astype(int) - native).max())
            check(lsb <= 1, f'native resize {lsb} LSB from cv2')
            line += f'; cv2 is present here: {cv2_ms:.3f} ms a frame, within {lsb} LSB'
        else:
            line += '; cv2 is absent here'
        print(line, flush=True)
        serve_and_check(art, 'artifact', native, 'host-resized 720p frame')
        del art

    # (d) served timing: tools/serve_loadgen.py against the live server
    serving_breakdown(model, dcfg)
    for depth in (2, 1):
        live = LivePipelineBackend(model, decode_cfg=dcfg, input_hw=(513, 513),
                                   batch_sizes=(1, 8, 32))
        server = PoseServer(live, batch_wait_ms=2.0, pipeline_depth=depth)
        server.warmup()
        httpd = make_http_server(server, '127.0.0.1', 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f'http://127.0.0.1:{httpd.server_address[1]}'
        cpu0, kids0 = time.process_time(), resource.getrusage(resource.RUSAGE_CHILDREN)
        try:
            done = subprocess.run(
                [sys.executable, os.path.join(REPO, 'tools', 'serve_loadgen.py'),
                 '--base', base, '--clients', '32', '--seconds', '10'],
                capture_output=True, text=True, timeout=300)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        server_cpu = time.process_time() - cpu0
        kids1 = resource.getrusage(resource.RUSAGE_CHILDREN)
        loadgen_cpu = (kids1.ru_utime + kids1.ru_stime) - (kids0.ru_utime + kids0.ru_stime)
        stats = server.stats
        check(done.returncode == 0, f'serve_loadgen failed: {done.stderr[-2000:]}')
        result = json.loads(done.stdout.strip().splitlines()[-1])
        check(result['requests'] > 0 and result['errors'] == 0, f'serve_loadgen: {result}')
        print(f'serving (d): live m101 s16 bf16 513x513, batches (1, 8, 32), pipeline_depth '
              f'{depth}, 32 clients, 10 s, raw frames: {result["req_per_s"]} req/s, latency '
              f'p50 {result["latency_ms"]["p50"]} ms, p99 {result["latency_ms"]["p99"]} ms; '
              f'batches {result["batches_by_size"]}; server device_ms (dispatch to fetched) '
              f'{stats["device_ms_total"] / max(1, sum(stats["batches_by_size"].values())):.3f}'
              f' ms a batch; CPU seconds, server process {server_cpu:.2f} and serve_loadgen '
              f'{loadgen_cpu:.2f} (its start-up included) (serve_loadgen: '
              f'{json.dumps(result)})', flush=True)


def serving_breakdown(model, dcfg, batch=32, reps=5):
    """Host clock of one b32 chunk through the server's own steps, called
    one at a time in this thread while its worker idles: `_dispatch_chunk`
    (pinned staging, then the backend call that queues the launches, timed
    apart), `_finish_chunk` (the one fetch wait, then the reply dicts), and
    json.dumps of each reply as the HTTP handler sends it."""
    live = LivePipelineBackend(model, decode_cfg=dcfg, input_hw=(513, 513),
                               batch_sizes=(batch,))
    server = PoseServer(live)
    backend_s = []

    def timed_backend(frames):
        t0 = time.perf_counter()
        out = live(frames)
        backend_s.append(time.perf_counter() - t0)
        return out

    server.artifact = timed_backend
    frames = np.random.default_rng(32).integers(0, 256, (batch, 513, 513, 3), dtype=np.uint8)
    steps = {'_dispatch_chunk': [], '_finish_chunk': [], 'json.dumps': []}
    try:
        for rep in range(reps + 1):
            reqs = [_Request(f, (1.0, 1.0), 0.0, 0.0) for f in frames]
            t = [time.perf_counter()]
            inflight = server._dispatch_chunk(reqs, batch)
            t.append(time.perf_counter())
            check(inflight is not None, f'the breakdown chunk failed: {reqs[0].error}')
            server._finish_chunk(inflight)
            t.append(time.perf_counter())
            for r in reqs:
                json.dumps({'poses': r.result, 'source_hw': [513, 513]})
            t.append(time.perf_counter())
            check(all(r.error is None for r in reqs), f'the breakdown chunk: {reqs[0].error}')
            if rep:   # the first repetition warms up
                for times, a, b in zip(steps.values(), t, t[1:]):
                    times.append((b - a) * 1000)
        # The device's busy time in one chunk: the union of its kernel and
        # copy intervals under torch.profiler.
        reqs = [_Request(f, (1.0, 1.0), 0.0, 0.0) for f in frames]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            server._finish_chunk(server._dispatch_chunk(reqs, batch))
        busy_us, end = 0.0, float('-inf')
        for start, stop in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                                  if e.device_type == DeviceType.CUDA):
            if stop > end:
                busy_us += stop - max(start, end)
                end = stop
    finally:
        server.close()
    ms = {k: sum(v) / len(v) for k, v in steps.items()}
    call_ms = sum(backend_s[1:reps + 1]) * 1000 / reps
    print(f'serving breakdown, live m101 s16 bf16 b{batch}, the server\'s steps, host clock, '
          f'mean of {reps}: _dispatch_chunk {ms["_dispatch_chunk"]:.3f} ms (staging '
          f'{ms["_dispatch_chunk"] - call_ms:.3f}, backend call {call_ms:.3f}), _finish_chunk '
          f'(fetch wait + reply dicts) {ms["_finish_chunk"]:.3f} ms, json.dumps '
          f'{ms["json.dumps"]:.3f} ms; total {sum(ms.values()):.3f} ms = '
          f'{sum(ms.values()) / batch:.3f} ms a request; device busy {busy_us / 1000:.3f} ms '
          f'a chunk (torch.profiler, union of kernels and copies)', flush=True)


def device_phase():
    """Phase 1: the card's name and power limit, versions; TF32 off.
    Returns (kind, device, the `name, power.limit` line), or None without
    CUDA."""
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
    return kind, dev, smi


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
    """Phase 2: K1 and K2, one nvcc each, in parallel, then loaded; what
    ptxas says of K1's walk, which must keep its state in registers."""
    t0 = time.perf_counter()
    libs = _build.build_all(['traversal', 'sepconv'])
    for name in libs:
        _build.load(name)
    print(f'build: K1 {K1_SOURCE} -> {os.path.relpath(libs["traversal"], REPO)}, '
          f'K2 {K2_SOURCE} -> {os.path.relpath(libs["sepconv"], REPO)} in '
          f'{time.perf_counter() - t0:.2f} s (nvcc {" ".join(_build.NVCC_FLAGS)})',
          flush=True)
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
    """Phase 3, K2: against its plain version at every K2 shape, the
    ragged one-block tile, and the pointwise alone against torch.matmul;
    returns the max abs difference."""
    k2_err = 0.0
    shapes = [(2, h, w, c_in, c_out) for h, w, c_in, c_out, _ in K2_M101_SHAPES + K2_OTHER_SHAPES]
    for i, (b, h, w, c_in, c_out) in enumerate(shapes + [(1, 9, 9, 512, 512)]):
        ok, err, equal = k2_against_plain(k2_inputs(b, h, w, c_in, c_out, i, dev))
        k2_err = max(k2_err, err)
        check(ok, f'K2 differs from its plain version at B={b} {h}x{w} {c_in}->{c_out} '
                  f'beyond one bf16 ulp (max {err})')
        print(f'K2 vs plain: B={b} {h}x{w} {c_in}->{c_out}: within one bf16 ulp '
              f'(or 2^-16), max abs {err:.3g}, share bitwise equal {equal:.6f}', flush=True)
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
    """bf16 m101 s16 heads at 2x65x65, the trunk through K2 on the card
    against its plain version on the CPU; returns K2's launches (9)."""
    cfg_bf16 = ModelConfig(model_id=101, output_stride=16, compute_dtype=torch.bfloat16)
    p101 = mobilenet_v1.init_params(torch.Generator().manual_seed(5), cfg_bf16)
    x65 = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (2, 65, 65, 3))
                           .astype(np.float32))
    ref_bf16 = mobilenet_v1.forward(mobilenet_v1.cast_params(p101, torch.bfloat16), x65,
                                    cfg_bf16)
    sepconv.launches = 0
    got_bf16 = mobilenet_v1.forward(mobilenet_v1.cast_params(p101, torch.bfloat16, dev),
                                    x65.to(dev), cfg_bf16)
    torch.cuda.synchronize()
    gap = max(float((got_bf16[k].cpu() - ref_bf16[k]).abs().max()) for k in ref_bf16)
    check(sepconv.launches == 9, f'bf16 m101 s16 forward launched K2 {sepconv.launches} times')
    check(gap <= 2e-3, f'bf16 heads, K2 on CUDA vs plain on CPU: {gap} (limit 2e-3)')
    print(f'bf16 heads m101 s16 2x65x65, trunk through K2 (CUDA) vs its plain version '
          f'(CPU): within {gap:.3g} (limit 2e-3); K2 launches 9', flush=True)
    return sepconv.launches


def k2_timing(dev, batch=128):
    """Phase 7, K2: each m101 s16 layer at batch 128, K2 against its plain
    version and the cuDNN conv pair the trunk ran before, in turns, beside
    its bound, after holding K2 against its plain version on the same
    inputs. Returns the sums over one forward's 9 layers, what bounds the
    most of the bound's sum, and the max abs difference."""
    k2_ms = k2_plain_ms = pair_ms = err_max = 0.0
    bound_by_ms = {'bytes': 0.0, 'operations': 0.0}
    for i, (h, w, c_in, c_out, count) in enumerate(K2_M101_SHAPES):
        args = k2_inputs(batch, h, w, c_in, c_out, 100 + i, dev)
        x, taps, dw_b, pw_w, pw_b = args
        x_nchw = x.permute(0, 3, 1, 2)
        dw_oihw = taps.t().reshape(c_in, 1, 3, 3).contiguous()
        pw_oihw = pw_w.reshape(c_out, c_in, 1, 1)
        ok, err, equal = k2_against_plain(args)
        err_max = max(err_max, err)
        check(ok, f'K2 differs from its plain version at B={batch} {h}x{w} {c_in}->{c_out} '
                  f'beyond one bf16 ulp (max {err})')
        print(f'K2 vs plain: B={batch} {h}x{w} {c_in}->{c_out}: within one bf16 ulp '
              f'(or 2^-16), max abs {err:.3g}, share bitwise equal {equal:.6f}', flush=True)

        def pair():
            y = mobilenet_v1._conv_relu6(x_nchw, dw_oihw, dw_b, groups=c_in)
            return mobilenet_v1._conv_relu6(y, pw_oihw, pw_b)

        runs = {}
        for name, fn, iters in (('plain', sepconv.sepconv_reference, 3),
                                ('kernel', sepconv.sepconv, 20),
                                ('cudnn', None, 20), ('cudnn', None, 20),
                                ('kernel', sepconv.sepconv, 20),
                                ('plain', sepconv.sepconv_reference, 3)):
            call = pair if fn is None else (lambda fn=fn: fn(*args))
            runs.setdefault(name, []).append(cuda_ms(call, iters))
        ms = {k: sum(v) / len(v) for k, v in runs.items()}
        bound, bound_by = k2_bound_ms(batch, h, w, c_in, c_out)
        k2_ms += count * ms['kernel']
        k2_plain_ms += count * ms['plain']
        pair_ms += count * ms['cudnn']
        bound_by_ms[bound_by] += count * bound
        print(f'K2 layer b{batch} {h}x{w} {c_in}->{c_out} (x{count} a forward): kernel '
              f'{ms["kernel"]:.4f} ms, cuDNN pair {ms["cudnn"]:.4f} ms, bound {bound:.4f} ms '
              f'({bound_by}), kernel / bound {ms["kernel"] / bound:.1f}x, plain '
              f'{ms["plain"]:.4f} ms (runs plain, kernel, cudnn, cudnn, kernel, plain: '
              f'{runs})', flush=True)
        del args, x, x_nchw
    bound_sum = sum(bound_by_ms.values())
    print(f'K2 over the 9 layers of one m101 s16 b{batch} forward: kernel {k2_ms:.4f} ms, '
          f'cuDNN pair {pair_ms:.4f} ms, bound {bound_sum:.4f} ms, kernel / bound '
          f'{k2_ms / bound_sum:.1f}x, plain {k2_plain_ms:.4f} ms', flush=True)
    return (k2_ms, k2_plain_ms, pair_ms, bound_sum, max(bound_by_ms, key=bound_by_ms.get),
            err_max)


def k1_timing(dev, peaked, cfg) -> dict:
    """Phase 7, K1: on the peaked b128 heads (K = 128, 33x33), held bitwise
    to its plain version, then timed in turns against it (plain, kernel,
    kernel, plain): per call by CUDA events, host dispatch included, and
    by CUDA graph replay, the device alone; beside
    its bytes bound (the hops that fetch in this run's walk) and its
    latency floor: the graph time of the first candidate alone (B = K = 1),
    and of that candidate with its score -1, which fetches nothing."""
    batch = peaked[0].shape[0]
    args = k1_args(peaked, 16, cfg)
    equal, err, _, _ = k1_against_plain(args, 33, 33, 16)
    check(equal, f'K1 differs from its plain version at B={batch} (max {err})')
    fetches = k1_fetches(args, 33, 33, 16)

    def kernel(*a):
        return lambda: traversal.traverse_all_candidates(*a, 33, 33, 16)

    def plain():
        return traversal.traverse_all_candidates_reference(*args, 33, 33, 16)

    runs = {}
    for name, timer in (('plain', lambda: cuda_ms(plain, 20)),
                        ('call', lambda: cuda_ms(kernel(*args), 50)),
                        ('kernel', lambda: graph_ms(kernel(*args))),
                        ('kernel', lambda: graph_ms(kernel(*args))),
                        ('call', lambda: cuda_ms(kernel(*args), 50)),
                        ('plain', lambda: cuda_ms(plain, 20))):
        runs.setdefault(name, []).append(timer())
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    bound = k1_bound_ms(batch, args[0].shape[1], fetches)
    one = tuple(a[:1, :1] for a in args[:3]) + tuple(t[:1] for t in args[3:])
    one_fetches = k1_fetches(one, 33, 33, 16)
    floor = graph_ms(kernel(*one))
    dead = graph_ms(kernel(torch.full_like(one[0], -1.0), *one[1:]))
    print(f'K1 at B={batch} K={args[0].shape[1]} 33x33: kernel {ms["kernel"]:.4f} ms a launch '
          f'(CUDA graph of 20 launches, the device alone), {ms["call"]:.4f} ms a call (CUDA '
          f'events, host dispatch included), plain {ms["plain"]:.4f} ms, bound {bound:.4f} ms '
          f'(bytes; {fetches} fetching hops of {args[0].numel() * 32}), kernel / bound '
          f'{ms["kernel"] / bound:.1f}x; latency floor: one candidate ({one_fetches} fetching '
          f'hops) {floor:.4f} ms a launch, one dead candidate (no fetch) {dead:.4f} ms (runs '
          f'plain, call, kernel, kernel, call, plain: {runs})', flush=True)
    return {'ms': ms['kernel'], 'call_ms': ms['call'], 'plain_ms': ms['plain'],
            'bound_ms': bound, 'floor_ms': floor, 'dead_ms': dead, 'err': err}


def k1_entry(launches, err, timing) -> dict:
    """K1's entry of the kernels line: `ms` by CUDA graph replay (the
    device alone); `call_ms` per call by CUDA events, host dispatch
    included, as `plain_ms` is timed; the latency floor beside them. No
    PyTorch call computes the walk, so `library_ms` is null."""
    return {'name': 'traverse_all_candidates', 'route': 'cuda', 'source': K1_SOURCE,
            'replaces': K1_REPLACES, 'launches': launches,
            'max_abs_err': max(err, timing['err']), 'ms': timing['ms'],
            'plain_ms': timing['plain_ms'], 'bound_ms': timing['bound_ms'],
            'bound_by': 'bytes', 'library_ms': None, 'call_ms': timing['call_ms'],
            'floor_ms': timing['floor_ms']}


def k2_entry(launches, err, timing) -> dict:
    """K2's entry of the kernels line; `library_ms` is the cuDNN pair's."""
    k2_ms, plain_ms, pair_ms, bound, bound_by, timing_err = timing
    return {'name': 'sepconv', 'route': 'cuda', 'source': K2_SOURCE,
            'replaces': K2_REPLACES, 'launches': launches,
            'max_abs_err': max(err, timing_err),
            'ms': k2_ms, 'plain_ms': plain_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'library_ms': pair_ms}


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
    output, K1 launches, host seconds)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    traversal.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    torch.cuda.synchronize()
    return out.getvalue(), traversal.launches, time.perf_counter() - t0


def printed_fps(out: str) -> float:
    """The FPS an app printed: 'Average FPS: x', or video_demo's 'x FPS'."""
    found = re.findall(r'Average FPS:\s*([0-9.eE+-]+)', out) or re.findall(r'([0-9.]+) FPS', out)
    check(len(found) == 1, f'no FPS line in the app\'s output: {out[-500:]}')
    return float(found[0])


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
    threshold; then K1 at this B = K = 1 shape, held to its plain version
    and timed. Returns (K1's timing dict, launches over the checked calls)."""
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
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in cases[0][1]]
    card = [t.to(dev) for t in host]
    _, args = recorded_k1_args(decode_single_pose, *card, 16)
    equal, err, _, _ = k1_against_plain(args, 33, 33, 16)
    check(equal, f'K1 at B = K = 1 differs from its plain version (max {err})')
    fetches = k1_fetches(args, 33, 33, 16)

    def kernel():
        return traversal.traverse_all_candidates(*args, 33, 33, 16)

    def plain():
        return traversal.traverse_all_candidates_reference(*args, 33, 33, 16)

    def whole():
        return decode_single_pose(*card, 16)

    runs = {}
    for name, timer in (('plain', lambda: cuda_ms(plain, 20)),
                        ('call', lambda: cuda_ms(kernel, 50)),
                        ('kernel', lambda: graph_ms(kernel)),
                        ('decode', lambda: cuda_ms(whole, 20)),
                        ('decode', lambda: cuda_ms(whole, 20)),
                        ('kernel', lambda: graph_ms(kernel)),
                        ('call', lambda: cuda_ms(kernel, 50)),
                        ('plain', lambda: cuda_ms(plain, 20))):
        runs.setdefault(name, []).append(timer())
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    t0 = time.perf_counter()
    for _ in range(20):
        decode_single_pose(*host, 16)
    cpu_ms = (time.perf_counter() - t0) * 1000 / 20
    bound = k1_bound_ms(1, 1, fetches)
    print(f'single pose 33x33 s16: decode_single_pose {ms["decode"]:.4f} ms a call on the card '
          f'(CUDA events, host dispatch included), {cpu_ms:.4f} ms on the CPU (host clock); '
          f'its K1 launch (B = K = 1, {fetches} fetching hops): {ms["kernel"]:.4f} ms (CUDA '
          f'graph, the device alone), {ms["call"]:.4f} ms a call, plain {ms["plain"]:.4f} ms, '
          f'bound {bound:.3g} ms (bytes), bitwise equal (runs plain, call, kernel, decode, '
          f'decode, kernel, call, plain: {runs})', flush=True)
    return ({'ms': ms['kernel'], 'call_ms': ms['call'], 'plain_ms': ms['plain'],
             'bound_ms': bound, 'floor_ms': ms['kernel'], 'err': err}, launches)


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


def webcam_steps(bgr, smi, n=24):
    """Where webcam_demo's time goes, from its own loop: its `main` on a
    stand-in capture of n warm 720x1280 frames (-> 513x913), with
    `StageTimer` stages around the helpers it calls: `read_cap` (the read,
    the host resize and normalize), the model's call (the upload and the
    forward, the device synchronised after it so that the stage holds the
    forward's device time), `decode_multiple_poses` (the decode and the
    read-back) and `draw_skel_and_kp`."""
    import cv2

    import posenet_tpu_torch as posenet
    from posenet_tpu_torch.apps import webcam_demo

    timer = StageTimer()

    def timed(name, fn, sync=False):
        def call(*a, **k):
            with timer.stage(name):
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
            return out
        return call

    def load_timed(*a, **k):
        model = load(*a, **k)
        model.forward = timed('upload + forward', model.forward, sync=True)
        return model

    load = posenet.load_model
    helpers = {'load_model': load_timed,
               'read_cap': timed('read + resize', posenet.read_cap),
               'decode_multiple_poses': timed('decode + read', posenet.decode_multiple_poses),
               'draw_skel_and_kp': timed('draw', posenet.draw_skel_and_kp)}
    saved = {name: getattr(posenet, name) for name in helpers}
    capture = cv2.VideoCapture
    cv2.VideoCapture = lambda _id: FakeCapture([bgr[i % len(bgr)].copy() for i in range(n)])
    try:
        for name, fn in helpers.items():
            setattr(posenet, name, fn)
        out, launches, _ = run_app(webcam_demo, ['--no_display', '--allow_random_init'])
    finally:
        cv2.VideoCapture = capture
        for name, fn in saved.items():
            setattr(posenet, name, fn)
    check(launches == n, f'webcam_demo (timed) launched K1 {launches} times for {n} frames')
    total = sum(timer.totals.values()) * 1000 / n
    print(f'apps: webcam_demo\'s own loop under StageTimer, m101 s16 f32, {n} warm frames '
          f'720x1280 -> 513x913 ({smi}): {total:.3f} ms a frame in its helpers, '
          f'{printed_fps(out):.2f} FPS printed (with the sync after each forward); '
          f'K1 launches {launches}\n{timer.report()}', flush=True)


def apps_phase(dev, smi) -> dict:
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
                out, n, secs = run_app(image_demo, ['--image_dir', 'images', '--output_dir',
                                                    'overlays', '--allow_random_init'])
                shapes = [cv2.imread(os.path.join('overlays', f)).shape
                          for f in sorted(os.listdir('overlays'))]
                check(shapes == [(720, 1280, 3)] * 4, f'image_demo overlays {shapes}')
                check(n == 4, f'image_demo launched K1 {n} times for 4 images')
                launches[f'image_demo {when}'] = n
                print(f'apps: image_demo {when}, m101 s16 f32, 4 images 720x1280 -> 721x1281: '
                      f'{printed_fps(out):.2f} FPS (its Average FPS line; {smi}); 4 overlays '
                      f'at 720x1280; K1 launches {n}; {out.count("Pose #")} poses printed; '
                      f'{secs:.2f} s in main', flush=True)

            for extra, label in (([], 'per-frame'), (['--profile', 'trace_frame'],
                                                     'per-frame --profile')):
                out, n, secs = run_app(benchmark, ['--image_dir', 'images', '--num_images',
                                                   '20', '--allow_random_init', *extra])
                check(n == 20, f'benchmark {label} launched K1 {n} times for 20 frames')
                launches[f'benchmark {label}'] = n
                report = out.split('Average FPS:', 1)[1].split('\n', 1)[1].rstrip()
                print(f'apps: benchmark {label}, m101 s16 f32, 20 frames at 721x1281: '
                      f'{printed_fps(out):.2f} FPS ({smi}); K1 launches {n}'
                      + (f'; its stage breakdown (device synchronised after each forward):\n'
                         f'{report}' if extra else ''), flush=True)

            out, n, secs = run_app(benchmark, ['--image_dir', 'images', '--batch_size', '128',
                                               '--image_size', '513', '--allow_random_init',
                                               '--profile', 'trace_batch'])
            batches = 1000 // 128
            check(n == batches + 2, f'benchmark b128 launched K1 {n} times (warm-up, traced '
                                    f'batch and {batches} timed batches)')
            launches['benchmark b128'] = n
            report = out.split('Average FPS:', 1)[0].strip().splitlines()
            report = report[:12] + report[12:][-1:]   # the largest, and the total
            print(f'apps: benchmark --batch_size 128 --image_size 513, m101 s16 f32: '
                  f'{printed_fps(out):.1f} FPS ({smi}); K1 launches {n} (warm-up, the traced '
                  f'batch, {batches} timed); device time of the traced batch by kernel '
                  f'(torch.profiler):\n' + '\n'.join(report), flush=True)

            capture = cv2.VideoCapture
            for when, frames in (('cold', 8), ('warm', 24)):
                cv2.VideoCapture = lambda _id: FakeCapture(
                    [bgr[i % len(bgr)].copy() for i in range(frames)])
                try:
                    out, n, secs = run_app(webcam_demo, ['--no_display', '--max_frames',
                                                         str(frames), '--allow_random_init'])
                finally:
                    cv2.VideoCapture = capture
                check(n == frames, f'webcam_demo {when} launched K1 {n} times for {frames} '
                                   f'frames')
                launches[f'webcam_demo {when}'] = n
                print(f'apps: webcam_demo {when} --no_display, m101 s16 f32, a stand-in capture '
                      f'of {frames} frames 720x1280 -> 513x913: {printed_fps(out):.2f} FPS '
                      f'({smi}); K1 launches {n}', flush=True)
            webcam_steps(bgr, smi)

            writer = cv2.VideoWriter('in.mp4', cv2.VideoWriter_fourcc(*'mp4v'), 30, (1280, 720))
            check(writer.isOpened(), 'cv2 cannot write an mp4v video here')
            for i in range(40):
                writer.write(bgr[i % 4])
            writer.release()
            for extra, label in (([], 'host resize'), (['--device_preprocess'],
                                                       '--device_preprocess')):
                out, n, secs = run_app(video_demo, [
                    '--video', 'in.mp4', '--resize', '513x513', '--batch_size', '16',
                    '--poses_out', 'poses.jsonl', '--allow_random_init', *extra])
                frames = [json.loads(line)['frame'] for line in open('poses.jsonl')]
                check(frames == list(range(40)), f'video_demo {label}: JSONL frames {frames}')
                check(n == 3, f'video_demo {label} launched K1 {n} times for 3 batches')
                launches[f'video_demo {label}'] = n
                print(f'apps: video_demo {label}, m101 s16 f32, 40 frames 720x1280 -> 513x513, '
                      f'batch 16, depth 2: {printed_fps(out):.1f} FPS (the first batch\'s '
                      f'start-up included; {smi}); one JSONL record a frame, in order; K1 '
                      f'launches {n}', flush=True)

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
    _, n, _ = run_app(video_demo, argv + ['--poses_out', 'card.jsonl'])
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


def phase8(dev, smi):
    """Phase 8: the single pose, then the apps; returns (K1's timing at the
    single pose's shape, K1's launches by path)."""
    timing, single = single_pose_phase(dev)
    return timing, {'single pose': single, **apps_phase(dev, smi)}


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
    """The fused block's layers in one forward of `mcfg` (9 for m101 s16 bf16)."""
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
        t0 = time.perf_counter()
        state = trainer.train(ds, ds, cfg, logger=logger, params=init, resume=False, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
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
              f'{before["loss"]:.6f} -> {after["loss"]:.6f}; epoch s ' +
              ', '.join(f'{h["epoch_time_s"]:.2f}' for h in hist) + f' ({secs:.2f} s in '
              f'train(), the first epoch\'s start-up included); trunk bitwise unchanged, heads '
              f'moved up to {moved:.3g}; checkpoint step {restored.step} restored bitwise '
              f'(params and Adam moments); K1 launches {k1}, K2 launches {k2}' +
              ('; visual dumps written' if visual else ''), flush=True)
    export_from_checkpoint(dev, os.path.join(root, 'ckpt_bf16'), root, init)
    return launches


def export_from_checkpoint(dev, ckpt, root, init):
    """Phase 9 (4): `posenet-export-torch --from_checkpoint` to a `cuda`
    artifact, bitwise equal to PoseNetPipeline over the restored params."""
    path = os.path.join(root, 'trained.posenet')
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export_main(['--model', str(TRAIN_MODEL), '--output_stride', '16', '--size',
                     str(TRAIN_SIZE), str(TRAIN_SIZE), '--batch_sizes', '2', '--platforms',
                     dev.type, '--compute_dtype', 'bfloat16',
                     '--from_checkpoint', ckpt, '--output', path])
    export_s = time.perf_counter() - t0
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
          f'artifact m{TRAIN_MODEL} s16 bf16 {TRAIN_SIZE}x{TRAIN_SIZE} b2 in {export_s:.2f} s: '
          f'bitwise equal to '
          f'PoseNetPipeline over the restored params; poses per image '
          f'{(got.pose_scores > 0).sum(1).tolist()}', flush=True)


def median_ms(events) -> float:
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def step_split(state, step, batch, n=10):
    """Median CUDA-event times of a step's forward, loss + backward and
    Adam, over `n` steps, and of the whole step: the forward is marked by
    wrapping `mobilenet_v1.forward`, Adam by the optimizer's step hooks."""
    marks = []

    def mark(*_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    forward = mobilenet_v1.forward

    def marked_forward(*a, **k):
        mark()
        out = forward(*a, **k)
        mark()
        return out

    hooks = [state.optimizer.register_step_pre_hook(mark),
             state.optimizer.register_step_post_hook(mark)]
    mobilenet_v1.forward = marked_forward
    try:
        for _ in range(n):
            mark()
            state, _ = step(state, batch)
            mark()
    finally:
        mobilenet_v1.forward = forward
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    check(len(marks) == 6 * n, f'step split: {len(marks)} marks for {n} steps')
    t = np.array([[marks[6 * i + j].elapsed_time(marks[6 * i + j + 1]) for j in range(5)]
                  for i in range(n)])
    # per step: [upload etc., forward, loss + backward, Adam, after Adam]
    return {'forward': float(np.median(t[:, 1])), 'loss+backward': float(np.median(t[:, 2])),
            'adam': float(np.median(t[:, 3])),
            'rest': float(np.median(t[:, 0] + t[:, 4])), 'step': float(np.median(t.sum(1)))}


def train_timing(dev, ds, smi):
    """Phase 9 (5): steps at b16 and b2, float32 and bf16, on the card."""
    init = train_init_params()
    b16 = first_batch(ds, 16)
    dcfg = DecodeConfig(min_pose_score=0.25, score_threshold=0.25)
    for dtype in (torch.float32, torch.bfloat16):
        name = 'float32' if dtype == torch.float32 else 'bf16'
        for b in (16, 2):
            batch = {k: b16[k][:b] for k in ('image', 'keypoints')}
            cfg, mcfg = train_cfgs(dtype, batch_size=b)
            state = ts.init_train_state(init, cfg, dev)
            step = ts.make_train_step(mcfg, cfg)
            for _ in range(3):
                state, _ = step(state, batch)
            events = []
            for _ in range(15):
                pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                pair[0].record()
                state, _ = step(state, batch)
                pair[1].record()
                events.append(pair)
            ms = median_ms(events)
            t0 = time.perf_counter()
            for _ in range(15):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / 15 * 1e3
            split = step_split(state, step, batch)
            staging = []
            for _ in range(5):   # the host's part of the upload, alone
                t0 = time.perf_counter()
                ts._step_batch(batch, dev)
                staging.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tdir:
                with trace(tdir, dev):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(5):
                        state, m = step(state, batch)
                    torch.cuda.synchronize()
                    traced_ms = (time.perf_counter() - t0) * 1e3
                report = device_time_report(tdir, top=8)
            total = re.search(r'^TOTAL\s+([\d.]+)', report, re.M)
            check(total is not None, f'no device time in the trace of {name} b{b} steps: {report}')
            device_ms = float(total[1])
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            state, m = step(state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            check(np.isfinite(float(m['loss'])), f'timed {name} b{b} steps: loss {m["loss"]}')
            eval_fn = ts.make_eval_step(mcfg, cfg)
            eval_fn(state.params, batch)
            events = []
            for _ in range(10):
                pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                pair[0].record()
                eval_fn(state.params, batch)
                pair[1].record()
                events.append(pair)
            eval_ms = median_ms(events)
            trainer.evaluate_poses(state.params, batch, mcfg, dcfg)
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                trainer.evaluate_poses(state.params, batch, mcfg, dcfg)
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f'train step m{TRAIN_MODEL} s16 {name} {TRAIN_SIZE}x{TRAIN_SIZE} b{b} ({smi}): '
                  f'{ms:.3f} ms (median of 15 '
                  f'warm steps, CUDA events), {b / ms * 1e3:.1f} img/s; host clock over 15 '
                  f'steps {host_ms:.3f} ms a step; split (medians of 10): forward '
                  f'{split["forward"]:.3f} ms, loss + backward {split["loss+backward"]:.3f} ms, '
                  f'Adam {split["adam"]:.3f} ms, upload and zero_grad {split["rest"]:.3f} ms '
                  f'(step {split["step"]:.3f} ms); the batch\'s pinned staging and upload on the '
                  f'host (`_step_batch`, host clock, median of 5) {np.median(staging):.3f} ms; '
                  f'device busy {device_ms:.3f} ms of '
                  f'{traced_ms:.3f} ms over 5 traced steps ({device_ms / traced_ms:.1%}); peak '
                  f'memory {peak / 2 ** 20:.1f} MiB ({held / 2 ** 20:.1f} MiB held before the '
                  f'step); eval loss {eval_ms:.3f} ms a batch (CUDA events), forward + decode '
                  f'+ host scoring {np.median(walls):.3f} ms a batch (host clock, median of 5)',
                  flush=True)
            if b == 16:
                print(f'device time of 5 traced {name} b16 steps by kernel (torch.profiler):\n'
                      f'{report}', flush=True)
            del state, step


def phase9(dev, smi) -> tuple:
    """Phase 9: heads-only fine-tuning of m101 s16 at 513x513. Returns K1's and
    K2's launches by path."""
    check(importlib.util.find_spec('cv2') is not None,
          'phase 9 needs cv2 (the dataset reads and writes JPEG files)')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        ds = train_dataset(root)
        step_k2 = train_step_parity(dev, ds)
        runs = train_runs(dev, ds, root)
        train_timing(dev, ds, smi)
    print(f'phase 9 took {time.perf_counter() - t0:.1f} s', flush=True)
    k1 = {f'train() {name} (phase 9)': n for name, (n, _) in runs.items()}
    k2 = {'train step float32 b2 (phase 9)': step_k2[torch.float32],
          'train step bf16 b2 (phase 9)': step_k2[torch.bfloat16],
          **{f'train() {name} (phase 9)': n for name, (_, n) in runs.items()}}
    return k1, k2


# Phase 10: multi-device on the one card, m101 s16 at 513x513 in bf16.
PARALLEL_MODEL, PARALLEL_SIZE = 101, 513


def step_times(state, step, batch, n=15) -> float:
    """Median CUDA-event ms of `n` steps, after 3 to warm up."""
    for _ in range(3):
        state, _ = step(state, batch)
    events = []
    for _ in range(n):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        state, _ = step(state, batch)
        pair[1].record()
        events.append(pair)
    return median_ms(events)


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
    own card), then the step's median time over 15 more; rank 0 writes the
    loss, the heads and the time."""
    full_float32()   # as the parent process runs: TF32 off
    device = mesh_lib.local_device('cuda') if device is None else torch.device(device)
    dtype = getattr(torch, dtype_name)
    cfg, mcfg = train_cfgs(dtype)
    state = ts.init_train_state(train_init_params(), cfg, device)
    step = ts.make_train_step(mcfg, cfg, mesh=make_mesh(devices=[device]))
    state, m = step(state, batch)
    result = {'loss': float(m['loss']),
              'heads': ts.tree_map(lambda t: t.detach().cpu(), state.params)['heads']}
    if device.type == 'cuda':
        result['ms'] = step_times(state, step, batch)
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
    the single-device step, float32 and bf16, bitwise; its time against
    the plain step's; then 2 gloo ranks on the one card. Returns K2's
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
            times = {}
            for kind, m in (('plain', None), ('dp', mesh), ('dp', mesh), ('plain', None)):
                state = ts.init_train_state(init, cfg, dev)
                times.setdefault(kind, []).append(
                    step_times(state, ts.make_train_step(mcfg, cfg, mesh=m), batch))
            print(f'DP train step m{TRAIN_MODEL} s16 {name} b16 {TRAIN_SIZE}x{TRAIN_SIZE}, world '
                  f'size 1 over {backend}: loss, head gradients and heads after Adam bitwise equal '
                  f'to the single-device step (cuDNN deterministic); two plain steps without '
                  f'deterministic mode ' + ('bitwise equal' if reproducible else
                                            f'apart by metrics {again[0]}, gradients and '
                                            f'heads {again[1]:.3g}') +
                  f'; K2 launches {dk2}; step {np.mean(times["dp"]):.3f} ms (plain '
                  f'{np.mean(times["plain"]):.3f} ms; CUDA events, median of 15, runs plain, '
                  f'dp, dp, plain: {times})', flush=True)
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
          f'1e-3); step {got.get("ms", float("nan")):.3f} ms (CUDA events on rank 0, median '
          f'of 15)', flush=True)
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
        t0 = time.perf_counter()
        meta = save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(1, 8),
                                     input_hw=(PARALLEL_SIZE, PARALLEL_SIZE),
                                     platforms=(dev.type,), data_parallel_devices=1)
        export_s = time.perf_counter() - t0
        check(meta['data_parallel_devices'] == 1, f'artifact meta {meta}')
        art = load_serving_artifact(path, device=dev.type)
        check(art.mesh is not None and art.device == dev, f'artifact on {art.device}')
        ref = PoseNetPipeline(model, dcfg)(frames[:8])
        got = art(frames[:8])
        for f, a, b in zip(DecodedPoses._fields, got, ref):
            check(torch.equal(a.cpu(), b.cpu()),
                  f'data_parallel_devices=1 artifact b8 differs from the pipeline in {f}')
        print(f'serving: artifact with data_parallel_devices=1 exported in {export_s:.1f} s, '
              f'b8 bitwise equal to PoseNetPipeline', flush=True)
        serve_and_check(art, 'artifact data_parallel_devices=1', frames, 'synth_photo frame')


def best_img_s(pipe, frames) -> float:
    """img/s of `pipe` on `frames` (on the card): best of 3 windows of 5
    calls, each closed by synchronize."""
    pipe(frames)
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            pipe(frames)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 5 * frames.shape[0] / best


def layout_timing(model, spatial_params, dcfg, frames, data_layouts, spatial_layouts, smi):
    """Phase 10 (e) and multicard's timing: the data partition's img/s on
    the b128 `frames` for each of `data_layouts` (name -> device list, None
    for the unsharded pipeline), and one frame's latency for each of
    `spatial_layouts` (CUDA events on the first card, a call's mean over
    20, host dispatch included), every layout in turns, forward then back."""
    def pipes(params, layouts, partition):
        m = PoseNet(params, model.cfg)
        return {name: PoseNetPipeline(m, dcfg) if devices is None else
                PoseNetPipeline(m, dcfg, mesh=make_mesh(devices=devices), partition=partition)
                for name, devices in layouts.items()}

    data, spatial_pipes = (pipes(model.params, data_layouts, 'data'),
                           pipes(spatial_params, spatial_layouts, 'spatial'))
    rates, lat = {}, {}
    for name in list(data) + list(data)[::-1]:
        rates.setdefault(name, []).append(best_img_s(data[name], frames))
    for name in list(spatial_pipes) + list(spatial_pipes)[::-1]:
        lat.setdefault(name, []).append(
            cuda_ms(lambda p=spatial_pipes[name]: p(frames[:1]), 20))
    print(f'data partition timing, m{PARALLEL_MODEL} s16 bf16 b{frames.shape[0]} '
          f'{PARALLEL_SIZE}x{PARALLEL_SIZE} ({smi}), img/s (best of 3 windows of 5, frames on '
          f'the card): ' + ', '.join(f'{k} {np.mean(v):.1f}' for k, v in rates.items()) +
          f' (runs: {rates})', flush=True)
    print(f'spatial partition latency, m{PARALLEL_MODEL} s16 bf16 '
          f'1x{PARALLEL_SIZE}x{PARALLEL_SIZE}, trunk biases + 1.0 ({smi}), ms a frame (CUDA '
          f'events, a call\'s mean over 20): ' +
          ', '.join(f'{k} {np.mean(v):.3f}' for k, v in lat.items()) + f' (runs: {lat})',
          flush=True)


def inflate_biases(params):
    """`params` with every trunk bias + 1.0, a checkpoint's scale: a pad
    row that leaked into the image would move the heads."""
    out = ts.tree_map(lambda t: t, params)
    for layer in out['backbone']:
        for k in layer:
            if k.endswith('b'):
                layer[k] = layer[k] + 1.0
    return out


def phase10(dev, smi) -> tuple:
    """Phase 10: the multi-device layer on the one card. Returns K1's and
    K2's launches by path."""
    check(importlib.util.find_spec('cv2') is not None,
          'phase 10 needs cv2 (its train step reads phase 9\'s JPEG dataset)')
    t0 = time.perf_counter()
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

    # (c) the DP train step; (d) served replies; (e) timing
    with tempfile.TemporaryDirectory() as root:
        ds = train_dataset(root)
        step_k2 = dp_train_phase(dev, ds, root)
    k2['DP train step bf16 b16, world size 1 (phase 10)'] = step_k2['bf16']
    parallel_serving(model, dev, frames[:16].cpu().numpy())
    layout_timing(model, inflated, dcfg, frames[:128],
                  {'unsharded': None, f'2 shards of {dev}': [dev] * 2},
                  {'plain': None, **{f'{n} shard(s) of {dev}': [dev] * n for n in (1, 2, 4)}},
                  smi)
    print(f'phase 10 took {time.perf_counter() - t0:.1f} s', flush=True)
    return k1, k2


def multicard(smi) -> tuple:
    """`--only multicard`, on a host of several cards (not part of the
    one-card run): the layouts of phase 10 across every visible card. The
    data partition of 128 and of an uneven 129 frames; the spatial
    partition of one frame, bf16 and float32; the DP train step at b16
    over one NCCL rank a card against one card; an artifact exported with
    data_parallel_devices=N and loaded over the N cards (its programs moved
    off the card they were exported on) against the pipeline; img/s and
    latency against one card. Returns K1's and K2's launches by path."""
    n = torch.cuda.device_count()
    check(n >= 2, f'--only multicard needs several cards, found {n}')
    devs = [torch.device('cuda', i) for i in range(n)]
    t0 = time.perf_counter()
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
        one_ms = step_times(ts.init_train_state(init, cfg, devs[0]), step, batch)
        out_path = os.path.join(root, 'nccl_rank0.pt')
        mesh_lib.launch(rank_step, n, args=(out_path, batch, 'float32', None), backend='nccl')
        got = check_ranks(out_path, state, m, init, f'{n} NCCL ranks')
        print(f'DP train step m{TRAIN_MODEL} s16 float32 b16 over {n} NCCL ranks, one a card '
              f'({16 // n} images each): loss {got["loss_gap"]:.3g} relative from one card '
              f'(limit 1e-5), heads\' updates within {got["update_gap"]:.3g} of their norm '
              f'(limit 1e-3); step {got["ms"]:.3f} ms on rank 0, one card {one_ms:.3f} ms (CUDA '
              f'events, median of 15; {smi})', flush=True)

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
        check(traversal.launches == n and sepconv.launches == 9 * n,
              f'artifact over {n} cards launched K1 {traversal.launches}, K2 '
              f'{sepconv.launches} times')
        for f, a, b in zip(DecodedPoses._fields, out, ref):
            check(torch.equal(a, b), f'artifact over {n} cards differs from the pipeline in {f}')
        print(f'serving: artifact with data_parallel_devices={n}, loaded over {n} cards, b8 '
              f'bitwise equal to PoseNetPipeline; K1 launches {n}, K2 {9 * n}', flush=True)

    layout_timing(model, inflated, dcfg, frames[:128], {'one card': None, f'{n} cards': devs},
                  {'one card': None, f'{n} cards': devs}, smi)
    print(f'multicard took {time.perf_counter() - t0:.1f} s', flush=True)
    return k1, k2


def full_run(dev, smi) -> list:
    """Phases 3-8; returns the kernels' entries."""
    max_err = k1_checks(dev)
    k2_err = k2_checks(dev)

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
    traversal.launches = sepconv.launches = 0
    poses = pipe(frames8)
    peaked_poses = decode_batch(*peaked8, 16, pipe.decode_cfg)
    torch.cuda.synchronize()
    launches = traversal.launches
    k2_launches = sepconv.launches
    check(launches >= 2, f'K1 launched {launches} times on the main path')
    check(k2_launches == 9, f'K2 launched {k2_launches} times on the main path (one '
                            f'm101 s16 forward has 9 stride-1 rate-1 separable layers)')
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
          f'CPU decode); K1 launches {launches}, K2 launches {k2_launches}', flush=True)

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
    check(raw_k1 >= 1 and raw_k2 == 9,
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

    # 6. serving
    serving_phase(model, dev)

    # 7. timing at batch 128
    batch = 128
    frames = torch.randint(0, 256, (batch, 513, 513, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    peaked = peaked_heads(batch, 33, 8, dev)
    cfg101 = pipe.cfg

    def fused():
        heads = mobilenet_v1.forward(pipe.params, normalize(frames, cfg101.compute_dtype),
                                     cfg101)
        return heads, decode_batch(*peaked, 16, pipe.decode_cfg)

    n_iters = 10
    fused()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fused()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    img_s = n_iters * batch / best
    fwd_ms = cuda_ms(lambda: mobilenet_v1.forward(
        pipe.params, normalize(frames, cfg101.compute_dtype), cfg101), n_iters)
    dec_ms = cuda_ms(lambda: decode_batch(*peaked, 16, pipe.decode_cfg), n_iters)
    pipe_ms = cuda_ms(lambda: infer(pipe.params, frames, cfg101, pipe.decode_cfg), n_iters)
    print(f'fused m101 s16 513x513 b{batch} bf16 forward + peaked decode: '
          f'{img_s:.1f} img/s (best of 3 windows of {n_iters}); forward {fwd_ms:.3f} ms, '
          f'peaked decode {dec_ms:.3f} ms, pipeline on its own heads {pipe_ms:.3f} ms '
          f'per batch', flush=True)
    prep_ms = graph_ms(lambda: _prepare_decode(*peaked, 16, pipe.decode_cfg))
    prep_call_ms = cuda_ms(lambda: _prepare_decode(*peaked, 16, pipe.decode_cfg), n_iters)
    copies_ms = graph_ms(lambda: (torch.cat(peaked[:2], dim=-1), peaked[2].contiguous(),
                                  peaked[3].contiguous()))
    print(f'_prepare_decode b{batch} 33x33 on the peaked heads: {prep_ms:.4f} ms a call (CUDA '
          f'graph of 20 calls, the device alone), {prep_call_ms:.4f} ms (CUDA events, host '
          f'dispatch included); the row copies it made before it passed views (scores '
          f'and offsets concatenated, dfwd and dbwd made contiguous: '
          f'{sum(t[0].numel() for t in peaked) * batch * 4 / 1e6:.1f} MB written) '
          f'{copies_ms:.4f} ms', flush=True)
    del frames
    bgr = torch.randint(0, 256, (batch, 720, 1280, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    raw_pipe(bgr)
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            raw_pipe(bgr)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    raw_img_s = 5 * batch / best
    pre_ms = cuda_ms(lambda: preprocess_on_device(bgr, (513, 513)), 5)
    print(f'raw-frame path m101 s16 b{batch} bf16 from 720x1280 BGR: {raw_img_s:.1f} img/s '
          f'(best of 3 windows of 5, decode on its own heads); preprocess alone '
          f'{pre_ms:.3f} ms per batch', flush=True)
    del bgr

    k2_time = k2_timing(dev, batch)

    k1_time = k1_timing(dev, peaked, pipe.decode_cfg)
    del peaked, frames8, bgr16, peaked8

    # 8. the single pose and the apps (float32, as the JAX apps run)
    single_time, app_launches = phase8(dev, smi)

    # 9. heads-only fine-tuning
    train_k1, train_k2 = phase9(dev, smi)

    # 10. multi-device on the one card
    parallel_k1, parallel_k2 = phase10(dev, smi)
    k1 = k1_entry(launches, max(max_err, single_time['err']), k1_time)
    k1['launches_by_path'] = {'main path (phase 5)': launches, **app_launches, **train_k1,
                              **parallel_k1}
    k2 = k2_entry(k2_launches, k2_err, k2_time)
    k2['launches_by_path'] = {'main path (phase 5)': k2_launches, **train_k2, **parallel_k2}
    return [k1, k2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--only', choices=('k1', 'k2', 'apps', 'train', 'parallel',
                                           'multicard'),
                        help='the device and build phases, then K1 or K2 alone, '
                             'phase 8 (the single pose and the apps), phase 9 '
                             '(training), phase 10 (multi-device on one card) or its '
                             'layouts across every card of a host with several')
    only = parser.parse_args(argv).only
    found = device_phase()
    if found is None:
        return 1
    kind, dev, smi = found
    build_phase()
    if only == 'k1':
        traversal.launches = 0
        k1_err = k1_checks(dev)
        # No main path runs here: `launches` is the checks'.
        kernels = [dict(k1_entry(traversal.launches, k1_err,
                                 k1_timing(dev, peaked_heads(128, 33, 8, dev),
                                           DecodeConfig(min_pose_score=0.25))),
                        launches_from='the K1 checks of phase 3, not the main path')]
    elif only == 'k2':
        k2_err = k2_checks(dev)
        k2_launches = k2_trunk_launches(dev)
        # No main path runs here: `launches` is the trunk check's (2x65x65).
        kernels = [dict(k2_entry(k2_launches, k2_err, k2_timing(dev)),
                        launches_from='bf16 trunk check at 2x65x65, not the main path')]
    elif only == 'apps':
        timing, app_launches = phase8(dev, smi)
        # No main path runs here: `launches` is the single pose's (phase 8),
        # and the timing is K1's at its B = K = 1 shape.
        kernels = [dict(k1_entry(app_launches['single pose'], timing['err'], timing),
                        launches_from='the single-pose calls of phase 8, not the main path',
                        launches_by_path=app_launches)]
    elif only == 'train':
        train_k1, train_k2 = phase9(dev, smi)
        # No main path runs here: `launches` is the bf16 train() run's.
        run = 'train() bf16 (phase 9)'
        kernels = [
            dict(k1_entry(train_k1[run], 0.0, k1_timing(dev, peaked_heads(128, 33, 8, dev),
                                                          DecodeConfig(min_pose_score=0.25))),
                 launches_from=f'{run}, not the main path', launches_by_path=train_k1),
            dict(k2_entry(train_k2[run], 0.0, k2_timing(dev)),
                 launches_from=f'{run}, not the main path', launches_by_path=train_k2)]
    elif only in ('parallel', 'multicard'):
        if only == 'parallel':
            parallel_k1, parallel_k2 = phase10(dev, smi)
            run = f'data partition b128 over 2 shards of {dev} (phase 10)'
        else:
            parallel_k1, parallel_k2 = multicard(smi)
            run = f'data partition b128 over {torch.cuda.device_count()} cards (multicard)'
        # No main path runs here: `launches` is the data partition's.
        kernels = [
            dict(k1_entry(parallel_k1[run], 0.0,
                          k1_timing(dev, peaked_heads(128, 33, 8, dev),
                                    DecodeConfig(min_pose_score=0.25))),
                 launches_from=f'{run}, not the main path', launches_by_path=parallel_k1),
            dict(k2_entry(parallel_k2[run], 0.0, k2_timing(dev)),
                 launches_from=f'{run}, not the main path', launches_by_path=parallel_k2)]
    else:
        kernels = full_run(dev, smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
