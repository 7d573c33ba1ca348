"""The plain reference of PoseNet MobileNetV1: preprocessing, forward pass
and multi-pose decode in plain PyTorch float32, written from the
architecture and the decoder's rules alone.

It imports nothing of the program under test. The benchmark draws one
parameter pytree and one frame pool from the seed and hands both to the
program and to this module; whatever the program derives from them (bf16
casts, packed depthwise taps, channels_last memory) is worked out again
here from the float32 originals.

Layers: a 3x3 conv (stride 2), then 13 depthwise-3x3 + pointwise-1x1
layers, each followed by bias and ReLU6, with torch-style symmetric
padding; once the cumulative stride reaches the output stride every later
nominal stride becomes a dilation (the stride plan). Four 1x1 heads:
heatmap (17, sigmoid), offsets (34 = 17 y then 17 x), forward and
backward displacements (32 = 16 y then 16 x).

Decode (PersonLab-style greedy decoding, the tfjs PoseNet rules): local
maxima of each keypoint's heatmap in a 3x3 window at or above the score
threshold; the K best by score (ties to the lowest (keypoint, y, x) index);
from each candidate root, a walk of the 16-edge kinematic tree (backward
displacements toward the nose, then forward displacements away from it),
each hop landing on the rounded, clamped cell and refined by that cell's
offset; then up to P rounds, each accepting the first candidate whose
root is not within the NMS radius of an accepted pose's same keypoint
and whose instance score (its keypoint scores, those within the radius
of an accepted pose's same keypoint counted as zero, over 17) reaches
the minimum pose score.

`quantize` hooks let the control (`control_build` in this package) run the same
forward in a lower precision: each conv's input and kernel pass through
it before the float32 product.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NUM_KEYPOINTS = 17
NUM_EDGES = 16

# (conv kind, in channels, out channels, nominal stride): MobileNetV1 at
# depth multipliers 1.0 (models 100 and 101) and 0.5 (model 50).
ARCH_100 = [('input', 3, 32, 2), ('sep', 32, 64, 1), ('sep', 64, 128, 2),
            ('sep', 128, 128, 1), ('sep', 128, 256, 2), ('sep', 256, 256, 1),
            ('sep', 256, 512, 2)] + [('sep', 512, 512, 1)] * 5 + [
            ('sep', 512, 1024, 2), ('sep', 1024, 1024, 1)]
ARCH_50 = [('input', 3, 16, 2), ('sep', 16, 32, 1), ('sep', 32, 64, 2),
           ('sep', 64, 64, 1), ('sep', 64, 128, 2), ('sep', 128, 128, 1),
           ('sep', 128, 256, 2)] + [('sep', 256, 256, 1)] * 7
ARCHS = {50: ARCH_50, 100: ARCH_100, 101: ARCH_100}
HEADS = (('heatmap', 17), ('offset', 34), ('displacement_fwd', 32),
         ('displacement_bwd', 32))

PART_NAMES = ['nose', 'leftEye', 'rightEye', 'leftEar', 'rightEar', 'leftShoulder',
              'rightShoulder', 'leftElbow', 'rightElbow', 'leftWrist', 'rightWrist',
              'leftHip', 'rightHip', 'leftKnee', 'rightKnee', 'leftAnkle', 'rightAnkle']
_CHAIN = [('nose', 'leftEye'), ('leftEye', 'leftEar'), ('nose', 'rightEye'),
          ('rightEye', 'rightEar'), ('nose', 'leftShoulder'), ('leftShoulder', 'leftElbow'),
          ('leftElbow', 'leftWrist'), ('leftShoulder', 'leftHip'), ('leftHip', 'leftKnee'),
          ('leftKnee', 'leftAnkle'), ('nose', 'rightShoulder'),
          ('rightShoulder', 'rightElbow'), ('rightElbow', 'rightWrist'),
          ('rightShoulder', 'rightHip'), ('rightHip', 'rightKnee'),
          ('rightKnee', 'rightAnkle')]
# Edge e: (parent, child) keypoint ids; displacement channel e is its y, 16 + e its x.
EDGES = [(PART_NAMES.index(p), PART_NAMES.index(c)) for p, c in _CHAIN]


def stride_plan(model_id: int, output_stride: int) -> List[dict]:
    """Each layer's kind, channels, stride and dilation rate."""
    current, rate, plan = 1, 1, []
    for kind, c_in, c_out, stride in ARCHS[model_id]:
        if current == output_stride:
            plan.append(dict(kind=kind, c_in=c_in, c_out=c_out, stride=1, rate=rate))
            rate *= stride
        else:
            plan.append(dict(kind=kind, c_in=c_in, c_out=c_out, stride=stride, rate=1))
            current *= stride
    return plan


def param_shapes(model_id: int, output_stride: int) -> List[Tuple[tuple, Tuple[int, ...], int]]:
    """(pytree path, shape, fan in) of every parameter, in drawing order:
    the layout the program's model takes (kernels OIHW)."""
    out = []
    for i, layer in enumerate(stride_plan(model_id, output_stride)):
        c_in, c_out = layer['c_in'], layer['c_out']
        if layer['kind'] == 'input':
            out += [(('backbone', i, 'w'), (c_out, c_in, 3, 3), 9 * c_in),
                    (('backbone', i, 'b'), (c_out,), 9 * c_in)]
        else:
            out += [(('backbone', i, 'dw_w'), (c_in, 1, 3, 3), 9),
                    (('backbone', i, 'dw_b'), (c_in,), 9),
                    (('backbone', i, 'pw_w'), (c_out, c_in, 1, 1), c_in),
                    (('backbone', i, 'pw_b'), (c_out,), c_in)]
    last = ARCHS[model_id][-1][2]
    for name, ch in HEADS:
        out += [(('heads', name, 'w'), (ch, last, 1, 1), last),
                (('heads', name, 'b'), (ch,), last)]
    return out


def draw_params(model_id: int, output_stride: int, seed: int, device: torch.device | str,
                kernel_gain: float = 1.0, head_gain: Optional[Dict[str, float]] = None) -> Dict:
    """Float32 parameters from `seed`, drawn on `device` in one call. Each
    tensor is uniform in +-gain/sqrt(fan in): the trunk's kernels with
    `kernel_gain` (sqrt(6) is He's uniform init, which keeps activations
    alive through 14 ReLU6 layers), its biases with 1, and each head's
    kernel and bias with `head_gain[name]` (default 1), which sets the
    spread of its outputs."""
    head_gain = head_gain or {}
    shapes = param_shapes(model_id, output_stride)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    params: Dict = {'backbone': [dict() for _ in stride_plan(model_id, output_stride)],
                    'heads': {name: {} for name, _ in HEADS}}
    for (path, shape, fan_in), chunk in zip(shapes, torch.split(flat, sizes)):
        if path[0] == 'heads':
            gain = head_gain.get(path[1], 1.0)
        else:
            gain = kernel_gain if path[2] in ('w', 'dw_w', 'pw_w') else 1.0
        params[path[0]][path[1]][path[2]] = (chunk * (gain * fan_in ** -0.5)).reshape(shape)
    return params


def _same_pad(stride: int, rate: int) -> int:
    return ((stride - 1) + rate * 2) // 2


def _conv(x, w, b, stride=1, rate=1, groups=1, quantize=None):
    if quantize is not None:
        x, w = quantize(x), quantize(w)
    pad = _same_pad(stride, rate) if w.shape[-1] == 3 else 0
    return F.conv2d(x, w, b, stride=stride, padding=pad, dilation=rate, groups=groups)


def forward(params: Dict, x_nhwc: torch.Tensor, model_id: int, output_stride: int,
            quantize: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) float32 input in [-1, 1] -> NHWC float32 heads:
    'heatmap' after its sigmoid (B, R, R', 17), 'offset' (34),
    'displacement_fwd' and 'displacement_bwd' (32)."""
    x = x_nhwc.permute(0, 3, 1, 2).float()
    for layer, p in zip(stride_plan(model_id, output_stride), params['backbone']):
        s, r = layer['stride'], layer['rate']
        if layer['kind'] == 'input':
            x = _conv(x, p['w'], p['b'], s, r, quantize=quantize).clamp(0.0, 6.0)
        else:
            x = _conv(x, p['dw_w'], p['dw_b'], s, r, groups=x.shape[1],
                      quantize=quantize).clamp(0.0, 6.0)
            x = _conv(x, p['pw_w'], p['pw_b'], quantize=quantize).clamp(0.0, 6.0)
    heads = {name: _conv(x, params['heads'][name]['w'], params['heads'][name]['b'],
                         quantize=quantize).permute(0, 2, 3, 1)
             for name, _ in HEADS}
    heads['heatmap'] = torch.sigmoid(heads['heatmap'])
    return heads


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> float32 in [-1, 1]: x * 2/255 - 1."""
    return frames_u8.float() * (2.0 / 255.0) - 1.0


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, out_h, out_w, C): bilinear with half-pixel
    centres and no antialiasing (cv2.INTER_LINEAR's rule), by explicit
    gathers of the four neighbours; source positions in float32."""
    def axis(n_in, n_out):
        pos = ((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
               * (n_in / n_out) - 0.5).clamp_min(0.0)
        lo = pos.floor().long().clamp_max(n_in - 1)
        hi = (lo + 1).clamp_max(n_in - 1)
        return lo, hi, (pos - lo).float()
    y0, y1, fy = axis(x.shape[1], out_h)
    x0, x1, fx = axis(x.shape[2], out_w)
    fy, fx = fy[None, :, None, None], fx[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - fx) + x[:, y0][:, :, x1] * fx
    bottom = x[:, y1][:, :, x0] * (1 - fx) + x[:, y1][:, :, x1] * fx
    return top * (1 - fy) + bottom * fy


def preprocess_raw(frames_bgr_u8: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 BGR (B, Hs, Ws, 3) -> float32 RGB (B, th, tw, 3) in [-1, 1]."""
    x = frames_bgr_u8.flip(-1).float()
    return resize_bilinear(x, *target_hw) * (2.0 / 255.0) - 1.0


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _depths() -> List[int]:
    depth = {0: 0}
    for p, c in EDGES:
        depth[c] = depth[p] + 1
    return [depth[k] for k in range(NUM_KEYPOINTS)]


DEPTH = _depths()
# The order of the walk's hops: (edge, source, target, backward?). Backward
# hops child -> parent, deepest first; then forward hops parent -> child,
# shallowest first. Within a depth no hop's source is another's target.
HOPS = ([(e, c, p, True) for d in range(max(DEPTH), 0, -1)
         for e, (p, c) in enumerate(EDGES) if DEPTH[c] == d]
        + [(e, p, c, False) for d in range(max(DEPTH))
           for e, (p, c) in enumerate(EDGES) if DEPTH[p] == d])


def cell_of(coord: torch.Tensor, n: int, stride: int) -> torch.Tensor:
    """The grid cell a coordinate falls in: round(coord / stride) (half to
    even), clamped to the grid."""
    return torch.clamp(torch.round(coord / float(stride)), 0.0, n - 1.0)


def _at(field: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, ch) -> torch.Tensor:
    """field (B, H, W, C) at cells (B, N) and channels `ch` ((B, N) or int)."""
    b = torch.arange(field.shape[0], device=field.device)[:, None]
    return field[b, iy.long(), ix.long(), ch]


def decode(heads: Dict[str, torch.Tensor], output_stride: int, score_threshold: float,
           nms_radius: float, min_pose_score: float, max_poses: int,
           max_candidates: int) -> Dict[str, torch.Tensor]:
    """Batched greedy multi-pose decode of NHWC heads. Returns
    pose_scores (B, P), keypoint_scores (B, P, 17), keypoint_coords
    (B, P, 17, 2), count (B,) and the candidates' scores (B, K) (-1 where
    none)."""
    hm, off = heads['heatmap'], heads['offset']
    b, h, w, _ = hm.shape
    dev = hm.device
    planes = hm.permute(0, 3, 1, 2)
    is_max = planes == F.max_pool2d(planes, 3, stride=1, padding=1)
    flat = torch.where(is_max & (planes >= score_threshold), planes, -1.0).reshape(b, -1)
    neg, idx = torch.sort(-flat, dim=1, stable=True)
    k = min(max_candidates, flat.shape[1])
    cand_scores, idx = -neg[:, :k], idx[:, :k]
    kp, cell = idx // (h * w), idx % (h * w)
    cy, cx = cell // w, cell % w

    # Walk every candidate: per keypoint, (B, K) score and y, x.
    score = [torch.zeros_like(cand_scores) for _ in range(NUM_KEYPOINTS)]
    ys = [torch.zeros_like(cand_scores) for _ in range(NUM_KEYPOINTS)]
    xs = [torch.zeros_like(cand_scores) for _ in range(NUM_KEYPOINTS)]
    root_y = cy.float() * output_stride + _at(off, cy, cx, kp)
    root_x = cx.float() * output_stride + _at(off, cy, cx, kp + NUM_KEYPOINTS)
    for j in range(NUM_KEYPOINTS):
        is_root = kp == j
        score[j] = torch.where(is_root, cand_scores, score[j])
        ys[j] = torch.where(is_root, root_y, ys[j])
        xs[j] = torch.where(is_root, root_x, xs[j])
    for e, s, t, backward in HOPS:
        disp = heads['displacement_bwd' if backward else 'displacement_fwd']
        sy, sx = cell_of(ys[s], h, output_stride), cell_of(xs[s], w, output_stride)
        ty = cell_of(ys[s] + _at(disp, sy, sx, e), h, output_stride)
        tx = cell_of(xs[s] + _at(disp, sy, sx, NUM_EDGES + e), w, output_stride)
        fill = (score[s] > 0.0) & (score[t] == 0.0)
        score[t] = torch.where(fill, _at(hm, ty, tx, t), score[t])
        ys[t] = torch.where(fill, ty * output_stride + _at(off, ty, tx, t), ys[t])
        xs[t] = torch.where(fill, tx * output_stride + _at(off, ty, tx, NUM_KEYPOINTS + t),
                            xs[t])
    all_scores = torch.stack(score, -1)                           # (B, K, 17)
    all_coords = torch.stack([torch.stack(ys, -1), torch.stack(xs, -1)], -1)
    root = torch.stack([root_y, root_x], -1)                      # (B, K, 2)

    p = max_poses
    r2 = float(nms_radius) ** 2
    bi = torch.arange(b, device=dev)
    pose_scores = torch.zeros((b, p), device=dev)
    kp_scores = torch.zeros((b, p, NUM_KEYPOINTS), device=dev)
    kp_coords = torch.zeros((b, p, NUM_KEYPOINTS, 2), device=dev)
    count = torch.zeros((b,), dtype=torch.long, device=dev)
    taken = torch.zeros((b, p), dtype=torch.bool, device=dev)
    for _ in range(p):
        at_root_kp = torch.gather(kp_coords, 2, kp[:, None, :, None].expand(b, p, k, 2))
        d2_root = ((at_root_kp - root[:, None]) ** 2).sum(-1)    # (B, P, K)
        suppressed = (taken[:, :, None] & (d2_root <= r2)).any(1)
        d2 = ((kp_coords[:, :, None] - all_coords[:, None]) ** 2).sum(-1)   # (B,P,K,17)
        overlapped = (taken[:, :, None, None] & (d2 <= r2)).any(1)
        inst = torch.where(overlapped, 0.0, all_scores).sum(-1) / NUM_KEYPOINTS
        ok = (cand_scores > -0.5) & ~suppressed & (inst >= min_pose_score)
        accept = ok.any(1) & (count < p)
        first = torch.where(ok, torch.arange(k, device=dev), k).argmin(1)
        slot = torch.zeros((b, p), dtype=torch.bool, device=dev)
        slot[bi[accept], count[accept]] = True
        pose_scores = torch.where(slot, inst[bi, first][:, None], pose_scores)
        kp_scores = torch.where(slot[..., None], all_scores[bi, first][:, None], kp_scores)
        kp_coords = torch.where(slot[..., None, None], all_coords[bi, first][:, None],
                                kp_coords)
        taken = taken | slot
        count = count + accept.long()
    return {'pose_scores': pose_scores, 'keypoint_scores': kp_scores,
            'keypoint_coords': kp_coords, 'count': count, 'cand_scores': cand_scores}
