"""The PyTorch port's decoder against the JAX package's, on `synth_heads`
grids (33x33 at stride 16, 91x161 at stride 8), tie-heavy inputs, heads
laid out as the forward writes them (views of one 115-channel tensor) and
a walk whose first backward hop to the nose lands on a zero score
(`tests.torch_k1_cases.nose_zero_heads`).

Tolerances: candidate lists, tables, root coordinates, the tree walk,
keypoint scores and keypoint coordinates are copies and exactly rounded
elementwise operations, so they must match bit for bit. A pose score is a
17-element sum whose association differs between frameworks, so it may
differ by 2 ulp (the bar the JAX package holds its own TPU and CPU paths
to, PARITY.md "TPU excess precision").

The tests marked `cuda` hold the CUDA kernel to its plain version on a
card; they skip without one.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from posenet_tpu import constants as jax_constants
from posenet_tpu import decode as jax_decode
from posenet_tpu.config import DecodeConfig as JaxDecodeConfig
from posenet_tpu.ops.pallas.traversal import (_hop_metadata,
                                              traverse_all_candidates_pallas)

from posenet_tpu_torch import constants
from posenet_tpu_torch import decode
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.decode_multi import decode_multiple_poses
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.ops import traversal

from tests.test_decode import synth_heads
from tests.test_torch_single_pose import _fixture_heads
from tests.torch_k1_cases import head_views, nose_zero_heads, peaked_heads

GRIDS = [((33, 33), 16), ((91, 161), 8)]


@pytest.fixture
def cuda():
    """The card, with TF32 off (f32 parity mode); skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _batch(grid, seeds):
    """NHWC numpy heads (B, H, W, C), C-contiguous, from synth_heads (CHW)
    per seed."""
    heads = [synth_heads(s, r=grid) for s in seeds]
    return [np.ascontiguousarray(np.stack([h[i].transpose(1, 2, 0) for h in heads]))
            for i in range(4)]


def _cfgs(k, **kw):
    kw = dict(min_pose_score=0.25, max_candidates=k, score_threshold=0.3, **kw)
    return JaxDecodeConfig(**kw), DecodeConfig(**kw)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_prepare_jit(hm, o, f, b, stride, cfg):
    return jax.vmap(lambda *a: jax_decode._prepare_decode(*a, stride, cfg))(
        hm, o, f, b)


def _jax_prepare(nhwc, stride, cfg):
    """JAX stage 1, compiled once per (shape, stride, cfg) for the module."""
    return [np.asarray(a) for a in _jax_prepare_jit(
        *[jnp.asarray(a) for a in nhwc], stride, cfg)]


def _jax_walk(tables, h, w, stride):
    sov, dft, dbt, cs, ck, rc = [jnp.asarray(a) for a in tables]
    walk = jax.jit(jax.vmap(lambda *a: jax_decode._traverse_all_candidates(
        *a, h, w, stride)))
    return walk(cs, ck, rc, sov, dft, dbt)


def _torch_prepare(nhwc, stride, cfg):
    return decode._prepare_decode(*[torch.from_numpy(a) for a in nhwc], stride, cfg)


def _rows(sov, dft, dbt):
    """The JAX package's row tables as the walk's four row tensors: the
    scores and offsets are views of its packed sov table."""
    sov, dft, dbt = (torch.tensor(np.asarray(t)) for t in (sov, dft, dbt))
    return sov[..., :17], sov[..., 17:], dft, dbt


def _jax_walk_on(nhwc, h, w, stride, jcfg):
    """The JAX stage 1 and level-batched walk; returns (its candidates and
    rows as the port's walk takes them, the walk's outputs)."""
    sov, dft, dbt, cs, ck, rc, _ = _jax_prepare(nhwc, stride, jcfg)
    ref = _jax_walk((sov, dft, dbt, cs, ck, rc), h, w, stride)
    return [torch.tensor(x) for x in (cs, ck, rc)] + list(_rows(sov, dft, dbt)), ref


def _assert_poses(ours, ref):
    """Keypoints bitwise, pose scores within 2 ulp, counts equal."""
    np.testing.assert_array_equal(ours.keypoint_scores.numpy(),
                                  np.asarray(ref.keypoint_scores))
    np.testing.assert_array_equal(ours.keypoint_coords.numpy(),
                                  np.asarray(ref.keypoint_coords))
    np.testing.assert_array_equal(ours.pose_offsets.numpy(),
                                  np.asarray(ref.pose_offsets))
    np.testing.assert_array_max_ulp(ours.pose_scores.numpy(),
                                    np.asarray(ref.pose_scores), maxulp=2)
    if ref.candidate_count is not None:
        np.testing.assert_array_equal(ours.candidate_count.numpy(),
                                      np.asarray(ref.candidate_count))


def test_constants_match_jax():
    np.testing.assert_array_equal(constants.EDGES, jax_constants.EDGES)
    assert constants.PART_NAMES == jax_constants.PART_NAMES
    assert constants.NUM_KEYPOINTS == jax_constants.NUM_KEYPOINTS
    assert constants.NUM_EDGES == jax_constants.NUM_EDGES
    assert constants.LOCAL_MAXIMUM_RADIUS == jax_constants.LOCAL_MAXIMUM_RADIUS
    assert constants.PARENT_CHILD_TUPLES == jax_constants.PARENT_CHILD_TUPLES
    assert constants.PART_IDS == jax_constants.PART_IDS
    assert constants.POSE_CHAIN == jax_constants.POSE_CHAIN
    assert constants.CONNECTED_PART_NAMES == jax_constants.CONNECTED_PART_NAMES
    assert constants.CONNECTED_PART_INDICES == jax_constants.CONNECTED_PART_INDICES


def test_tree_levels_and_hop_table_match_jax():
    assert decode._tree_levels() == jax_decode._tree_levels()
    (be, bs, bt), (fe, fs, ft) = _hop_metadata()
    expected = np.stack([np.concatenate([be, fe]), np.concatenate([bs, fs]),
                         np.concatenate([bt, ft])])
    np.testing.assert_array_equal(traversal.hop_table(), expected)


@pytest.mark.parametrize("grid,stride", GRIDS)
@pytest.mark.parametrize("k", [32, 128])
def test_prepare_decode_matches_jax(grid, stride, k):
    """Tables, candidate list, root coordinates and candidate count."""
    nhwc = _batch(grid, (3, 4))
    jcfg, tcfg = _cfgs(k)
    ref = _jax_prepare(nhwc, stride, jcfg)
    scores, offsets, *ours = _torch_prepare(nhwc, stride, tcfg)
    ours = [torch.cat([scores, offsets], dim=-1)] + ours   # the JAX sov table
    for name, a, b in zip(('sov', 'dfwd', 'dbwd', 'cand_scores', 'cand_kp',
                           'root_coords', 'n_cand'), ours, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("grid,quantum,masked", [
    ((33, 33), 8, False),      # ties everywhere (tests/test_decode.py:469)
    ((7, 7), 8, False),        # masked volume smaller than k
    ((91, 161), 8, False),     # the JAX blockwise stage-1 grid (:491)
    ((91, 161), 64, True),     # sparse 1/64 ties (:514)
])
@pytest.mark.parametrize("seed", range(2))
def test_candidates_tie_order_matches_jax(grid, quantum, masked, seed):
    """Tie-heavy heatmaps: equal scores must rank lowest flat
    (keypoint, y, x) index first, as lax.top_k and the JAX selectors do."""
    rng = np.random.RandomState(seed)
    h, w = grid
    hm = np.floor(rng.uniform(0.4, 1.0, (2, h, w, 17)) * quantum) / quantum
    if masked:
        hm = np.where(rng.uniform(0, 1, hm.shape) < 0.03, hm, 0.1)
    hm = hm.astype(np.float32)
    nhwc = [hm] + [rng.uniform(-8, 8, (2, h, w, c)).astype(np.float32)
                   for c in (34, 32, 32)]
    for k in (16, 128):
        jcfg = JaxDecodeConfig(max_candidates=k, score_threshold=0.5)
        tcfg = DecodeConfig(max_candidates=k, score_threshold=0.5)
        ref = _jax_prepare(nhwc, 16, jcfg)
        ours = _torch_prepare(nhwc, 16, tcfg)
        for i in (3, 4, 5, 6):   # scores, keypoint ids, root coords, count
            i_ours = i + 1           # after the four row views
            np.testing.assert_array_equal(ours[i_ours].numpy(), ref[i],
                                          err_msg=f"k={k} output {i}")


@pytest.mark.parametrize("grid,stride", GRIDS)
def test_traversal_reference_matches_xla(grid, stride):
    """The plain tree walk against the JAX level-batched gather walk."""
    h, w = grid
    nhwc = _batch(grid, (3, 4))
    jcfg, _ = _cfgs(32)
    t, ref = _jax_walk_on(nhwc, h, w, stride, jcfg)
    ours = traversal.traverse_all_candidates_reference(*t, h, w, stride)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((ours[0] > 0).sum()) > 2 * 32   # the walk filled keypoints


@pytest.mark.parametrize("grid,stride", GRIDS)
def test_traversal_reference_on_head_views_equals_tables(grid, stride):
    """The heads as `run_heads` leaves them, views of one 115-channel
    tensor (rows 115 floats apart, the scores too), walk exactly as the
    contiguous tables do, and as the JAX walk does."""
    h, w = grid
    nhwc = _batch(grid, (5, 6))
    jcfg, tcfg = _cfgs(32)
    heads = [torch.from_numpy(a) for a in nhwc]
    views = decode._prepare_decode(*head_views(heads), stride, tcfg)
    tables = decode._prepare_decode(*heads, stride, tcfg)
    assert [r.stride(1) for r in views[:4]] == [115] * 4
    assert [r.stride(1) for r in tables[:4]] == [17, 34, 32, 32]
    ours = traversal.traverse_all_candidates_reference(*views[4:7], *views[:4], h, w, stride)
    plain = traversal.traverse_all_candidates_reference(*tables[4:7], *tables[:4], h, w, stride)
    _, ref = _jax_walk_on(nhwc, h, w, stride, jcfg)
    for a, b, r in zip(ours, plain, ref):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_traversal_zero_score_landing_at_the_nose_matches_jax():
    """The first backward hop to the nose (from the left eye) lands on a
    zero nose score, which leaves the nose empty for that candidate; the
    three other roots' hops fill it. (With one root a candidate, only the
    root's ancestors fill in the backward pass, so no second hop of that
    level is live for the same candidate.) The plain walk against the JAX
    walk and the TPU kernel in interpret mode."""
    nhwc = nose_zero_heads()
    jcfg = JaxDecodeConfig(max_candidates=16, score_threshold=0.3)
    t, ref = _jax_walk_on(nhwc, 33, 33, 16, jcfg)
    ours = traversal.traverse_all_candidates(*t, 33, 33, 16)   # CPU: plain route
    sov, dft, dbt, cs, ck, rc, _ = _jax_prepare(nhwc, 16, jcfg)
    kernel = traverse_all_candidates_pallas(
        *[jnp.asarray(x) for x in (cs, ck, rc, sov, dft, dbt)], 33, 33, 16,
        interpret=True, version=2)
    for a, b, c in zip(ours, ref, kernel):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert t[1][0, :4].tolist() == [1, 2, 5, 6]             # the four roots, in rank order
    nose = ours[0][0, :4, 0].tolist()
    assert nose[0] == 0.0 and nose[1:] == [np.float32(0.2)] * 3
    assert ours[1][0, 0, 0].tolist() != [0.0, 0.0]          # landed, and left empty


def test_peaked_heads_need_eleven_cells():
    heads = peaked_heads(2, (11, 13), 7, 'cpu')
    assert [tuple(t.shape) for t in heads] == [(2, 11, 13, c) for c in (17, 34, 32, 32)]
    square = peaked_heads(2, 13, 7, 'cpu')
    assert all(torch.equal(a, b) for a, b in zip(square, peaked_heads(2, (13, 13), 7, 'cpu')))
    with pytest.raises(ValueError, match='11x11'):
        peaked_heads(2, 9, 7, 'cpu')


def test_prepare_decode_reads_heads_in_place():
    """On the forward's heads, `_prepare_decode` copies nothing: the offset
    and displacement rows share the 115-channel heads tensor's memory, the
    score rows the heatmap's, and the walk on them matches the JAX walk on
    the JAX package's packed tables."""
    cfg = ModelConfig(model_id=50, output_stride=16)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (2, 65, 65, 3))
                         .astype(np.float32))
    heads = mobilenet_v1.forward(params, x, cfg)
    order = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')
    rows = decode._prepare_decode(*[heads[k] for k in order], 16,
                                  DecodeConfig(score_threshold=0.0, max_candidates=16))
    base = heads['offset'].untyped_storage().data_ptr()
    assert heads['displacement_bwd'].untyped_storage().data_ptr() == base
    for r, (name, cols, first) in zip(rows[1:4], (('offsets', 34, 17), ('dfwd', 32, 51),
                                                  ('dbwd', 32, 83))):
        assert r.untyped_storage().data_ptr() == base, name
        assert r.data_ptr() == base + 4 * first and r.stride() == (5 * 5 * 115, 115, 1)
        assert r.shape == (2, 25, cols)
    assert rows[0].untyped_storage().data_ptr() == heads['heatmap'].untyped_storage().data_ptr()
    nhwc = [heads[k].numpy() for k in order]
    t, ref = _jax_walk_on(nhwc, 5, 5, 16, JaxDecodeConfig(score_threshold=0.0,
                                                          max_candidates=16))
    for a, b in zip(t, (*rows[4:7], *rows[:4])):
        assert torch.equal(a, b)
    ours = traversal.traverse_all_candidates(*rows[4:7], *rows[:4], 5, 5, 16)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_traversal_reference_matches_pallas_interpret():
    """... and against the TPU kernel itself, run in interpret mode, at the
    production 33x33 stride-16 grid. Kernel body v2 (the rolled loop): it
    interprets in a fifth of v3/v4's time, and tests/test_decode.py holds
    all generations bit-identical."""
    h = w = 33
    nhwc = _batch((h, w), (3, 4))
    jcfg, _ = _cfgs(32)
    sov, dft, dbt, cs, ck, rc, _ = _jax_prepare(nhwc, 16, jcfg)
    ref = traverse_all_candidates_pallas(
        *[jnp.asarray(x) for x in (cs, ck, rc, sov, dft, dbt)], h, w, 16,
        interpret=True, version=2)
    t = [torch.tensor(x) for x in (cs, ck, rc)] + list(_rows(sov, dft, dbt))
    ours = traversal.traverse_all_candidates(*t, h, w, 16)   # CPU: plain route
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wrapper_counts_only_kernel_launches():
    """CPU tensors take the plain version and leave the launch count alone."""
    nhwc = _batch((33, 33), (7,))
    _, tcfg = _cfgs(16)
    before = traversal.launches
    decode.decode_batch(*[torch.from_numpy(a) for a in nhwc], 16, tcfg)
    assert traversal.launches == before


@pytest.mark.parametrize("grid,stride,params", [
    ((33, 33), 16, dict(max_pose_detections=10, nms_radius=20, min_pose_score=0.25)),
    ((91, 161), 8, dict(max_pose_detections=10, nms_radius=5, min_pose_score=0.0)),
])
def test_decode_batch_matches_jax(grid, stride, params):
    nhwc = _batch(grid, (11, 12, 13))
    kw = dict(score_threshold=0.3, max_candidates=64, **params)
    ref = jax_decode.decode_batch(*[jnp.asarray(a) for a in nhwc], stride,
                                  JaxDecodeConfig(**kw))
    ours = decode.decode_batch(*[torch.from_numpy(a) for a in nhwc], stride,
                               DecodeConfig(**kw))
    _assert_poses(ours, ref)
    assert (ours.pose_scores > 0).any()


def _tie_candidates(case):
    """The adversarial accept inputs of tests/test_decode.py:535: quantized
    scores and coordinates, duplicated candidates, radius 0 included."""
    rng = np.random.RandomState(1000 + case)
    k = 48
    p = int(rng.choice([1, 3, 10]))
    radius = int(rng.choice([0, 1, 5, 20, 60]))
    min_ps = float(rng.choice([0.0, 0.25, 0.5]))
    n_live = rng.randint(0, k + 1)
    cand_scores = np.full((k,), -1.0, np.float32)
    cand_scores[:n_live] = np.sort(
        np.round(rng.uniform(0.3, 1.0, n_live) * 4) / 4)[::-1].astype(np.float32)
    cand_kp = rng.randint(0, 17, k).astype(np.int32)
    root_coords = rng.randint(0, 12, (k, 2)).astype(np.float32) * 5.0
    for _ in range(k // 3):
        i, j = rng.randint(0, k, 2)
        root_coords[i] = root_coords[j]
        cand_kp[i] = cand_kp[j]
    all_coords = (root_coords[:, None, :]
                  + rng.randint(-8, 9, (k, 17, 2)) * 5.0).astype(np.float32)
    all_coords[np.arange(k), cand_kp] = root_coords
    all_scores = rng.uniform(0, 1, (k, 17)).astype(np.float32)
    all_offsets = rng.uniform(-8, 8, (k, 17, 2)).astype(np.float32)
    kw = dict(score_threshold=0.3, max_candidates=k, max_pose_detections=p,
              nms_radius=radius, min_pose_score=min_ps)
    return (cand_scores, cand_kp, root_coords, all_scores, all_coords,
            all_offsets), kw


@pytest.mark.parametrize("case", range(8))
def test_greedy_accept_matches_jax_on_ties(case):
    """Exactly P batched rounds against the JAX while_loop, on boundary
    distances (d^2 == r^2) and tied, duplicated candidates."""
    arrays, kw = _tie_candidates(case)
    # Batch of two: the case and a copy with the candidates reversed, so
    # images in one batch take different numbers of rounds.
    batch = [np.stack([a, a[::-1]]) for a in arrays]
    jcfg = JaxDecodeConfig(**kw)
    ref = jax.vmap(lambda *a: jax_decode._greedy_accept(*a, jcfg))(
        *[jnp.asarray(a) for a in batch])
    ours = decode._greedy_accept(*[torch.from_numpy(a) for a in batch],
                                 DecodeConfig(**kw))
    _assert_poses(ours, ref)


def test_decode_multiple_poses_is_decode_batch_of_one():
    """The reference-API wrapper: one image's CHW heads in, numpy out, the
    same numbers as decode_batch on that image."""
    heads = synth_heads(21)
    kw = dict(max_pose_detections=10, score_threshold=0.5, nms_radius=20,
              min_pose_score=0.25)
    ours = decode_multiple_poses(*heads, 16, device='cpu', **kw)
    batch = decode.decode_batch(
        *[torch.from_numpy(h.transpose(1, 2, 0))[None] for h in heads], 16,
        DecodeConfig(**kw))
    assert [a.dtype for a in ours] == [np.float32, np.float32, np.float64, np.float64]
    for a, b in zip(ours, batch):
        np.testing.assert_array_equal(a, b[0].numpy().astype(a.dtype))
    assert (ours[0] > 0).sum() >= 1
    with pytest.raises(ValueError, match="ONE image"):
        decode_multiple_poses(*[np.stack([h, h]) for h in heads], 16, device='cpu')


def test_candidate_count_surfaces_topk_overflow():
    """242 isolated peaks against a budget of 128 (tests/test_decode.py:656)."""
    h = w = 33
    scores = np.full((1, h, w, 17), 0.01, np.float32)
    scores[0, 1::3, 1::3, 0] = 0.9
    scores[0, 1::3, 1::3, 5] = 0.9
    zeros = [np.zeros((1, h, w, c), np.float32) for c in (34, 32, 32)]
    cfg = DecodeConfig(score_threshold=0.5, min_pose_score=0.0)
    out = decode.decode_batch(*[torch.from_numpy(a) for a in [scores] + zeros],
                              16, cfg)
    assert out.candidate_count.tolist() == [242]
    assert out.overflowed(cfg.max_candidates).tolist() == [True]
    legacy = decode.DecodedPoses(*out[:4])
    with pytest.raises(ValueError, match="candidate_count"):
        legacy.overflowed(cfg.max_candidates)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,stride,k,b", [
    ((33, 33), 16, 128, 8), ((91, 161), 8, 32, 4), ((136, 241), 8, 64, 2)])
def test_kernel_matches_plain_on_card(cuda, grid, stride, k, b):
    """The CUDA kernel against its plain version, bit for bit, on the same
    device tables; and the launch count moves by one."""
    h, w = grid
    nhwc = _batch(grid, tuple(range(30, 30 + b)))
    _, tcfg = _cfgs(k)
    rows = decode._prepare_decode(*[torch.from_numpy(a).to(cuda) for a in nhwc], stride, tcfg)
    _assert_kernel_is_plain(rows, h, w, stride)


def _assert_kernel_is_plain(rows, h, w, stride):
    """K1 on `_prepare_decode`'s outputs against its plain version, bit for
    bit, with one launch counted; returns the plain outputs."""
    args = (*rows[4:7], *rows[:4], h, w, stride)
    before = traversal.launches
    got = traversal.traverse_all_candidates(*args)
    torch.cuda.synchronize()
    assert traversal.launches == before + 1
    ref = traversal.traverse_all_candidates_reference(*args)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("grid,stride", GRIDS)
def test_kernel_on_head_views_on_card(cuda, grid, stride):
    """K1 reads views of one 115-channel heads tensor (rows 115 floats
    apart) bit for bit as its plain version does, and as it reads the
    same heads as contiguous tables."""
    h, w = grid
    heads = [torch.from_numpy(a).to(cuda) for a in _batch(grid, (40, 41, 42))]
    _, tcfg = _cfgs(64)
    rows = decode._prepare_decode(*head_views(heads), stride, tcfg)
    assert [r.stride(1) for r in rows[:4]] == [115] * 4
    ref = _assert_kernel_is_plain(rows, h, w, stride)
    tables = decode._prepare_decode(*heads, stride, tcfg)
    for a, r in zip(traversal.traverse_all_candidates(*tables[4:7], *tables[:4], h, w, stride),
                    ref):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_kernel_zero_score_landing_at_the_nose_on_card(cuda):
    """`nose_zero_heads` on the card: the first backward hop to the nose
    lands on a zero score; K1 is its plain version bit for bit."""
    rows = decode._prepare_decode(*[torch.from_numpy(a).to(cuda) for a in nose_zero_heads()],
                                  16, DecodeConfig(max_candidates=16, score_threshold=0.3))
    ref = _assert_kernel_is_plain(rows, 33, 33, 16)
    assert ref[0][0, :4, 0].tolist() == [0.0] + [np.float32(0.2)] * 3


@pytest.mark.cuda
def test_prepare_decode_reads_heads_in_place_on_card(cuda):
    """The card's forward writes the heads channels_last: `_prepare_decode`
    passes K1 views of them (rows 115 floats apart), no copy."""
    cfg = ModelConfig(model_id=50, output_stride=16)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(3), cfg)
    params = mobilenet_v1.cast_params(params, torch.float32, cuda)
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (2, 129, 129, 3))
                         .astype(np.float32)).to(cuda)
    heads = mobilenet_v1.forward(params, x, cfg)
    rows = decode._prepare_decode(heads['heatmap'], heads['offset'], heads['displacement_fwd'],
                                  heads['displacement_bwd'], 16,
                                  DecodeConfig(score_threshold=0.0, max_candidates=64))
    base = heads['offset'].untyped_storage().data_ptr()
    assert all(r.untyped_storage().data_ptr() == base and r.stride(1) == 115
               for r in rows[1:4])
    _assert_kernel_is_plain(rows, 9, 9, 16)


@pytest.mark.cuda
def test_kernel_refuses_another_hop_table(cuda, monkeypatch):
    """The C entry compares the hop table it is passed with the one
    compiled in; on a mismatch it launches nothing and the op raises."""
    nhwc = _batch((9, 11), (1,))
    rows = decode._prepare_decode(*[torch.from_numpy(a).to(cuda) for a in nhwc], 16,
                                  DecodeConfig(max_candidates=16, score_threshold=0.3))
    bad = traversal._kernel()[1].copy()
    bad[1, 12], bad[1, 13] = bad[1, 13], bad[1, 12]   # two sources of the nose's level swapped
    monkeypatch.setitem(traversal._kernel_cache, 'hops', bad)
    before = traversal.launches
    with pytest.raises(RuntimeError, match="hop table"):
        traversal.traverse_all_candidates(*rows[4:7], *rows[:4], 9, 11, 16)
    assert traversal.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("grid,stride", GRIDS)
def test_decode_batch_on_card_matches_jax(cuda, grid, stride):
    nhwc = _batch(grid, (11, 12, 13))
    kw = dict(score_threshold=0.3, max_candidates=64, min_pose_score=0.25)
    ref = jax_decode.decode_batch(*[jnp.asarray(a) for a in nhwc], stride,
                                  JaxDecodeConfig(**kw))
    out = decode.decode_batch(*[torch.from_numpy(a).to(cuda) for a in nhwc],
                              stride, DecodeConfig(**kw))
    _assert_poses(decode.DecodedPoses(*[t.cpu() for t in out]), ref)


def _hwc(seed, grid):
    return [np.ascontiguousarray(h.transpose(1, 2, 0)) for h in synth_heads(seed, r=grid)]


DECODE_SINGLE_CASES = {
    'fixture_m50_s16': (_fixture_heads, 16),
    '33x33_s16': (lambda: _hwc(31, 33), 16),
    '91x161_s8': (lambda: _hwc(32, (91, 161)), 8),
}


@pytest.mark.parametrize("case", list(DECODE_SINGLE_CASES))
def test_decode_single_matches_jax(case):
    """One image's HWC heads -> unbatched DecodedPoses, against JAX's
    `decode_single`: keypoints bitwise, pose scores within 2 ulp, the same
    candidate count; and exactly element 0 of the port's `decode_batch`."""
    make, stride = DECODE_SINGLE_CASES[case]
    heads = make()
    kw = dict(min_pose_score=0.25)
    ref = jax.jit(jax_decode.decode_single, static_argnums=(4, 5))(
        *[jnp.asarray(h) for h in heads], stride, JaxDecodeConfig(**kw))
    ours = decode.decode_single(*[torch.from_numpy(h) for h in heads], stride,
                                DecodeConfig(**kw))
    assert ours.pose_scores.shape == (10,) and ours.candidate_count.shape == ()
    _assert_poses(ours, ref)
    assert (ours.pose_scores > 0).any()
    batch = decode.decode_batch(*[torch.from_numpy(h)[None] for h in heads], stride,
                                DecodeConfig(**kw))
    for a, b in zip(ours, batch):
        assert torch.equal(a, b[0])


@pytest.mark.cuda
def test_decode_single_on_card_matches_cpu(cuda):
    """On the card: bitwise the CPU's result, with one K1 launch."""
    heads = _hwc(33, (91, 161))
    cfg = DecodeConfig(min_pose_score=0.25)
    ref = decode.decode_single(*[torch.from_numpy(h) for h in heads], 8, cfg)
    before = traversal.launches
    got = decode.decode_single(*[torch.from_numpy(h).to(cuda) for h in heads], 8, cfg)
    torch.cuda.synchronize()
    assert traversal.launches == before + 1
    for a, r in zip(got, ref):
        assert torch.equal(a.cpu(), r)
