"""The port's single-pose decode against the JAX package's: `split_yx`,
`build_part_with_score_single_pose`, `find_root`, `decode_pose` and
`decode_single_pose`, on `synth_heads` grids (33x33 at stride 16, 91x161 at
stride 8), on the heads of the fixture m50 s16 on a synthesized photo, on a
heatmap with nothing above the threshold and on a root at the grid's
corner.

Tolerance: none. The best cells, the root, the root coordinate and the
tree walk are copies and exactly rounded elementwise operations, so every
score, cell and coordinate must match bit for bit. The JAX decode walks the
tree edge by edge; the port's walk (K1 on the card) goes level by level.
With one root only one hop of a level is live, so the two agree; these
cases show it.

The test marked `cuda` holds the card (one K1 launch a call) against the
CPU; it skips without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from posenet_tpu import decode as jax_decode
from posenet_tpu.converter import tfjs2jax

from posenet_tpu_torch import decode
from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.constants import LOCAL_MAXIMUM_RADIUS, NUM_EDGES, NUM_KEYPOINTS
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.ops import traversal
from posenet_tpu_torch.pipeline import normalize

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.test_decode import synth_heads
from tests.tfjs_fixture import synth_photo


def _synth(seed, grid):
    """HWC numpy heads from synth_heads (CHW)."""
    return [np.ascontiguousarray(h.transpose(1, 2, 0)) for h in synth_heads(seed, r=grid)]


def _fixture_heads():
    """The fixture m50 s16's heads (CPU forward) on one synthesized photo,
    353x481 -> 23x31 cells."""
    params = weights.params_from_jax(tfjs2jax.load_params_npz(FIXTURE_PATH))
    frame = torch.from_numpy(np.ascontiguousarray(synth_photo(seed=100)[None, ..., ::-1]))
    heads = mobilenet_v1.forward(params, normalize(frame, torch.float32),
                                 ModelConfig(model_id=50, output_stride=16))
    return [heads[k][0].numpy().copy() for k in
            ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')]


def _empty(h=33, w=33):
    """Nothing at or above the threshold: every channel's best is score 0
    at cell 0, the root is keypoint 0 and the walk fills nothing."""
    rng = np.random.RandomState(9)
    return [np.full((h, w, NUM_KEYPOINTS), 0.1, np.float32)] + [
        rng.uniform(-8, 8, (h, w, c)).astype(np.float32) for c in (34, 32, 32)]


def _corner(h=33, w=33):
    """The root (left wrist, 0.95) in the grid's last cell, displacements
    that push every hop past the grid's far edge, so that every cell is
    clipped."""
    hm, off, dfwd, dbwd = _synth(7, (h, w))
    hm = np.minimum(hm, 0.9)
    hm[..., 9] = np.minimum(hm[..., 9], 0.4)
    hm[h - 1, w - 1, 9] = 0.95
    return [hm, off, dfwd + 40.0, dbwd + 40.0]


CASES = {
    '33x33_s16_seed0': (lambda: _synth(0, 33), 16),
    '33x33_s16_seed1': (lambda: _synth(1, 33), 16),
    '33x33_s16_seed2': (lambda: _synth(2, 33), 16),
    '91x161_s8_seed3': (lambda: _synth(3, (91, 161)), 8),
    '91x161_s8_seed4': (lambda: _synth(4, (91, 161)), 8),
    'fixture_m50_s16': (_fixture_heads, 16),
    'nothing_above_threshold': (_empty, 16),
    'root_at_corner': (_corner, 16),
}


def _jax(heads):
    return [jnp.asarray(h) for h in heads]


def _torch(heads, device='cpu'):
    return [torch.from_numpy(h).to(device) for h in heads]


def _equal(ours, ref, what):
    np.testing.assert_array_equal(ours.cpu().numpy(), np.asarray(ref), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_single_pose_matches_jax(case):
    make, stride = CASES[case]
    heads = make()
    jh, th = _jax(heads), _torch(heads)

    ref_best = jax_decode.build_part_with_score_single_pose(0.5, LOCAL_MAXIMUM_RADIUS, jh[0])
    best = decode.build_part_with_score_single_pose(0.5, LOCAL_MAXIMUM_RADIUS, th[0])
    _equal(best[0], ref_best[0], 'best scores')
    _equal(best[1], ref_best[1], 'best cells')

    ref_root = jax_decode.find_root(*ref_best)
    root = decode.find_root(*best)
    for a, b, what in zip(root, ref_root, ('root score', 'root id', 'root cell')):
        _equal(a, b, what)

    ref = jax_decode.decode_single_pose(*jh, stride)
    ours = decode.decode_single_pose(*th, stride)
    for a, b, what in zip(ours, ref, ('keypoint scores', 'keypoint coords', 'root id')):
        _equal(a, b, what)
    assert ours[0].shape == (17,) and ours[1].shape == (17, 2)

    filled = int((ours[0] > 0).sum())
    if case == 'nothing_above_threshold':
        assert filled == 0 and int(ours[2]) == 0
        assert ours[1][1:].abs().sum() == 0     # only the root's coordinate is set
    else:
        assert filled >= 9, filled               # the walk grew the pose
    if case == 'root_at_corner':
        assert int(ours[2]) == 9
        assert int(root[2][0]) == 32 and int(root[2][1]) == 32


@pytest.mark.parametrize("case", ['33x33_s16_seed1', '91x161_s8_seed3', 'root_at_corner'])
def test_decode_pose_on_given_roots_matches_jax(case):
    """`decode_pose` from roots the caller gives (each a keypoint's cell
    times the stride plus its offset there, and one far outside the grid),
    on the stacked fields `split_yx` makes, with its offsets."""
    make, stride = CASES[case]
    hm, off, dfwd, dbwd = make()
    h, w, _ = hm.shape
    j_fields = [jax_decode.split_yx(jnp.asarray(a), n)
                for a, n in ((off, NUM_KEYPOINTS), (dfwd, NUM_EDGES), (dbwd, NUM_EDGES))]
    t_fields = [decode.split_yx(torch.from_numpy(a), n)
                for a, n in ((off, NUM_KEYPOINTS), (dfwd, NUM_EDGES), (dbwd, NUM_EDGES))]
    for a, b in zip(t_fields, j_fields):
        _equal(a, b, 'split_yx')
    rng = np.random.RandomState(11)
    roots = []
    for kp in (0, 5, 9, 16):
        y, x = rng.randint(0, h), rng.randint(0, w)
        coord = (np.float32(y * stride) + off[y, x, kp], np.float32(x * stride) + off[y, x, 17 + kp])
        roots.append((np.float32(hm[y, x, kp]), kp, np.array(coord, np.float32)))
    roots.append((np.float32(0.7), 3, np.array([-50.0, w * stride + 60.0], np.float32)))
    for score, kp, coord in roots:
        ref = jax_decode.decode_pose(jnp.float32(score), kp, jnp.asarray(coord),
                                     jnp.asarray(hm), *j_fields, stride)
        ours = decode.decode_pose(torch.tensor(score), kp, torch.from_numpy(coord),
                                  torch.from_numpy(hm), *t_fields, stride)
        for a, b, what in zip(ours, ref, ('scores', 'coords', 'offsets')):
            _equal(a, b, f'root {kp}: {what}')
        assert int((ours[0] > 0).sum()) == 17


def test_single_pose_on_the_cpu_launches_nothing():
    before = traversal.launches
    decode.decode_single_pose(*_torch(_synth(0, 33)), 16)
    assert traversal.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_single_pose_on_card_matches_cpu(case):
    """The card (one K1 launch a call) against the CPU (K1's plain
    version), bit for bit, with the same root."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    make, stride = CASES[case]
    heads = make()
    ref = decode.decode_single_pose(*_torch(heads), stride)
    before = traversal.launches
    ours = decode.decode_single_pose(*_torch(heads, 'cuda'), stride)
    torch.cuda.synchronize()
    assert traversal.launches == before + 1
    for a, b in zip(ours, ref):
        assert torch.equal(a.cpu(), b)
