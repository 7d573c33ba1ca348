"""Inputs and graph checks for the tree walk (K1), shared by the tests and
`chip_smoke.py`: heads laid out as `run_heads` writes them, peaked
multi-person heads whose poses pass the accept, a walk whose first
backward hop to the nose lands on a zero score, and the check that an
exported program feeds K1 views of the heads. Imports nothing of JAX."""

import numpy as np
import torch


def head_views(heads):
    """The four NHWC heads as views of one 115-channel tensor, the layout
    `run_heads` writes."""
    joined = torch.cat(heads, dim=-1)
    edges = np.cumsum([0] + [t.shape[-1] for t in heads])
    return [joined[..., a:b] for a, b in zip(edges[:-1], edges[1:])]


def peaked_heads(batch: int, grid, seed: int, device):
    """NHWC peaked heads (heatmap, offsets, dfwd, dbwd) on a grid of
    `grid` cells (an int: square; or (rows, columns)): 3 gaussian people
    x 17 keypoints (peak 0.9), uniform offsets and displacements in
    [-8, 8). Each person's keypoints lie within 4 cells of its centre, so
    that poses pass min_pose_score=0.25 and the accept does real work;
    independent random keypoints accept none. The centres lie in
    [5, n - 5), so each side needs at least 11 cells. Drawn from a CPU
    generator, so every device gets the same heads."""
    rows, cols = (grid, grid) if isinstance(grid, int) else grid
    if min(rows, cols) < 11:
        raise ValueError(f'peaked heads need a grid of at least 11x11 cells, got '
                         f'{rows}x{cols}')
    g = torch.Generator().manual_seed(seed)
    centre = [torch.randint(5, n - 5, (batch, 3, 1, 1, 1), generator=g) for n in (rows, cols)]
    ky, kx = [(c + torch.randint(-4, 5, (batch, 3, 17, 1, 1), generator=g)).clamp(0, n - 1)
              for c, n in zip(centre, (rows, cols))]
    yy = torch.arange(rows)[:, None]
    xx = torch.arange(cols)[None, :]
    blobs = torch.exp(-((yy - ky) ** 2 + (xx - kx) ** 2) / 4.0)   # (B,3,17,R,C)
    hm = (0.9 * blobs).amax(1).permute(0, 2, 3, 1).contiguous().to(device)
    flat = (torch.rand((batch, rows, cols, 98), generator=g) * 16 - 8).to(device)
    return hm, flat[..., :34], flat[..., 34:66], flat[..., 66:98]


def nose_zero_heads():
    """NHWC numpy heads of one 33x33 stride-16 image with four roots next to
    the nose (left eye, right eye, both shoulders; score 0.9, offsets 0),
    each of whose backward hops to the nose moves 4 cells up. The nose
    scores 0.2 everywhere but where the left eye's hop lands, so that hop,
    the first of its level to the nose, leaves the nose empty for its
    candidate, and the other three fill it. The other keypoints score 0.05
    off their roots (under the threshold: no candidates)."""
    rng = np.random.RandomState(11)
    hm = np.full((1, 33, 33, 17), 0.05, np.float32)
    hm[..., 0] = 0.2
    hm[0, 4, 8, 0] = 0.0
    offsets = rng.uniform(-6, 6, (1, 33, 33, 34)).astype(np.float32)
    dfwd, dbwd = (rng.uniform(-24, 24, (1, 33, 33, 32)).astype(np.float32) for _ in range(2))
    for kp, edge, y, x in ((1, 0, 8, 8), (2, 2, 8, 24), (5, 4, 24, 8), (6, 10, 24, 24)):
        hm[0, y, x, kp] = 0.9
        offsets[0, y, x, [kp, 17 + kp]] = 0.0
        dbwd[0, y, x, [edge, 16 + edge]] = (-64.0, 0.0)
    return [hm, offsets, dfwd, dbwd]


# Ops of an exported program that make a view of their first argument.
VIEW_OPS = (torch.ops.aten.view.default, torch.ops.aten.slice.Tensor,
            torch.ops.aten.permute.default, torch.ops.aten.alias.default)


def view_source(node):
    """(the node whose output `node` is a view of, through VIEW_OPS, and the
    names of those ops, outermost first)."""
    ops = []
    while node.op == 'call_function' and node.target in VIEW_OPS:
        ops.append(str(node.target))
        node = node.args[0]
    return node, ops


def k1_reads_heads_in_place(graph) -> str:
    """Checks that the one K1 node of an exported program reads views of
    the heads: the offsets and both displacements views of one tensor,
    the scores a view of its sigmoid, which reads a view of that same
    tensor. Returns how each input is made; raises AssertionError."""
    k1 = [n for n in graph.nodes
          if n.target == torch.ops.posenet_tpu_torch.traverse_all_candidates.default]
    if len(k1) != 1:
        raise AssertionError(f'{len(k1)} K1 nodes in the program')
    made = [view_source(a) for a in k1[0].args[3:7]]
    heads = made[1][0]
    if not all(m[0] is heads for m in made[2:]):
        raise AssertionError(f'the K1 offsets and displacements are not views of one '
                             f'tensor: {made}')
    sigmoid = made[0][0]
    if not (sigmoid.target == torch.ops.aten.sigmoid.default
            and view_source(sigmoid.args[0])[0] is heads):
        raise AssertionError(f'the K1 scores are not the sigmoid of a view of the heads '
                             f'tensor: {made[0]}')
    return '; '.join(f'{name} {" <- ".join(ops)} <- {src.target}' for name, (src, ops)
                     in zip(('scores', 'offsets', 'dfwd', 'dbwd'), made))
