"""The port's serving artifacts (`posenet_tpu_torch.serving`): the
`torch.export` round trip against the in-process `infer`, bit for bit, and
against the JAX package's `jax.export` artifact on the same weights and
frames, at the slice's tolerance (tests/test_torch_pipeline.py: the same
pose counts and candidate counts, scores within 1e-4, coordinates within
1e-2 px; fixture m50 s16 weights, synthesized photos). Also the loader's
validation, the platform rules, atomic export, the export CLI, the custom
ops' fake implementations, and (marked `cuda`) the custom ops and a `cuda`
artifact on the card.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from posenet_tpu.config import DecodeConfig as JaxDecodeConfig
from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.models.model_factory import PoseNet as JaxPoseNet
from posenet_tpu.serving import load_serving_artifact as jax_load
from posenet_tpu.serving import save_serving_artifact as jax_save

from posenet_tpu_torch import serving
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.decode import DecodedPoses
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import MobileNetV1, PoseNet
from posenet_tpu_torch.ops import sepconv, traversal
from posenet_tpu_torch.pipeline import PoseNetPipeline, infer
from posenet_tpu_torch.serving import load_serving_artifact, save_serving_artifact

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.test_torch_decode import cuda  # noqa: F401  (fixture)
from tests.tfjs_fixture import synth_photo
from tests.torch_k1_cases import k1_reads_heads_in_place
from tests.torch_offline import offline_download  # noqa: F401 (autouse)

PHOTO_HW = (353, 481)      # the fixture's scenes; stride-valid at 16
DCFG = DecodeConfig(min_pose_score=0.25)


@pytest.fixture(scope="module")
def fixture_params():
    return tfjs2jax.load_params_npz(FIXTURE_PATH)


@pytest.fixture(scope="module")
def photos():
    """(2, 353, 481, 3) uint8 RGB."""
    return np.ascontiguousarray(
        np.stack([synth_photo(*PHOTO_HW, seed=100 + i)[..., ::-1] for i in range(2)]))


@pytest.fixture(scope="module")
def artifact(fixture_params, tmp_path_factory):
    """Fixture m50 s16 float32 at 353x481, batches (1, 2), for the CPU."""
    model = PoseNet(weights.params_from_jax(fixture_params), ModelConfig(50, 16))
    path = str(tmp_path_factory.mktemp("art") / "m50.posenet")
    meta = save_serving_artifact(model, path, decode_cfg=DCFG, batch_sizes=(2, 1),
                                 input_hw=PHOTO_HW, platforms=("cpu",))
    return model, load_serving_artifact(path, device="cpu"), meta


@pytest.fixture(scope="module")
def jax_artifact(fixture_params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "m50_jax.posenet")
    jax_save(JaxPoseNet(jax.tree.map(jnp.asarray, fixture_params),
                        JaxModelConfig(model_id=50, output_stride=16)),
             path, decode_cfg=JaxDecodeConfig(min_pose_score=0.25), batch_sizes=(2,),
             input_hw=PHOTO_HW, platforms=("cpu",))
    return path


def test_artifact_round_trip_is_bitwise_infer(artifact, photos):
    model, art, meta = artifact
    assert meta["format"] == serving.FORMAT and meta["batch_sizes"] == [1, 2]
    assert meta["platforms"] == ["cpu"] and meta["compute_dtype"] == "float32"
    assert art.device == torch.device("cpu") and art.input_hw == PHOTO_HW
    for frames in (photos, photos[1:]):
        out = art(frames)
        assert isinstance(out, DecodedPoses)
        ref = infer(model.params, torch.from_numpy(frames), model.cfg, DCFG)
        for name, a, b in zip(DecodedPoses._fields, out, ref):
            assert torch.equal(a, b), name


def test_artifact_matches_jax_artifact(artifact, jax_artifact, photos):
    """The same weights and frames through both packages' artifacts."""
    ours = artifact[1](photos)
    ref = jax_load(jax_artifact)(photos)
    n_ref = (np.asarray(ref.pose_scores) > 0).sum(axis=1)
    assert n_ref.min() >= 1
    np.testing.assert_array_equal((ours.pose_scores.numpy() > 0).sum(axis=1), n_ref)
    np.testing.assert_array_equal(ours.candidate_count.numpy(),
                                  np.asarray(ref.candidate_count))
    np.testing.assert_allclose(ours.pose_scores.numpy(), np.asarray(ref.pose_scores),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.keypoint_scores.numpy(),
                               np.asarray(ref.keypoint_scores), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.keypoint_coords.numpy(),
                               np.asarray(ref.keypoint_coords), atol=1e-2, rtol=0)


@pytest.mark.parametrize("case,error", [
    ("batch_3", "no program for batch size 3"),
    ("shape", "expected \\(B, 353, 481, 3\\)"),
    ("float", "uint8"),
    ("float_tensor", "uint8"),
    ("shape_before_dtype", "expected \\(B"),
    ("dtype_before_batch", "uint8"),
])
def test_artifact_validates_in_order(artifact, case, error):
    """Shape, then dtype, then platform, then batch size, as the JAX
    loader checks them."""
    art = artifact[1]
    frames = {
        "batch_3": np.zeros((3, *PHOTO_HW, 3), np.uint8),
        "shape": np.zeros((1, 64, 64, 3), np.uint8),
        "float": np.zeros((1, *PHOTO_HW, 3), np.float32),
        "float_tensor": torch.zeros((1, *PHOTO_HW, 3)),
        "shape_before_dtype": np.zeros((1, 64, 64, 3), np.float32),
        "dtype_before_batch": np.zeros((3, *PHOTO_HW, 3), np.float32),
    }[case]
    with pytest.raises(ValueError, match=error):
        art(frames)


def test_artifact_takes_tensors_and_routes_batches(artifact, photos):
    art = artifact[1]
    as_tensor = art(torch.from_numpy(photos))
    as_numpy = art(photos)
    assert all(torch.equal(a, b) for a, b in zip(as_tensor, as_numpy))
    assert as_numpy.pose_scores.shape == (2, 10)
    assert art(photos[:1]).keypoint_coords.shape == (1, 10, 17, 2)
    assert sorted(art._programs) == [1, 2]   # each loaded once, then cached
    program = art._programs[2]
    art(photos)
    assert art._programs[2] is program


def _rewrite_meta(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "meta.json":
                meta = json.loads(data)
                meta.update(changes)
                data = json.dumps(meta)
            zout.writestr(item, data)


def test_platform_mismatch_is_actionable(artifact, tmp_path, monkeypatch):
    """A `cuda` artifact where CUDA is absent raises instead of running on
    the CPU, loaded by default or asked to run on the CPU; the platform is
    checked before the batch size."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda_only = str(tmp_path / "cuda_only.posenet")
    _rewrite_meta(artifact[1].path, cuda_only, platforms=["cuda"])
    art = load_serving_artifact(cuda_only, device="cpu")
    assert art.device == torch.device("cpu")
    for batch in (1, 3):
        with pytest.raises(ValueError, match="exported for platforms.*cuda.*'cpu'"):
            art(np.zeros((batch, *PHOTO_HW, 3), np.uint8))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        load_serving_artifact(cuda_only, device="cuda")
    model = artifact[0]
    out = str(tmp_path / "x.posenet")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        save_serving_artifact(model, out, input_hw=(65, 65), platforms=("cuda",))
    with pytest.raises(ValueError, match="unknown platform 'tpu'"):
        save_serving_artifact(model, out, input_hw=(65, 65), platforms=("tpu",))
    assert not os.path.exists(out)


def test_loader_rejects_other_formats(artifact, jax_artifact, tmp_path):
    with pytest.raises(ValueError, match="not a posenet_tpu_torch serving artifact.*JAX"):
        load_serving_artifact(jax_artifact)
    other = str(tmp_path / "other.posenet")
    _rewrite_meta(artifact[1].path, other, format="something-else")
    with pytest.raises(ValueError, match="format 'something-else'"):
        load_serving_artifact(other)
    newer = str(tmp_path / "newer.posenet")
    _rewrite_meta(artifact[1].path, newer, format_version=serving.FORMAT_VERSION + 1)
    with pytest.raises(ValueError, match="format_version"):
        load_serving_artifact(newer)
    # Version 1's K1 op took three packed tables: such a program must be
    # exported again, not fail inside deserialization. Version 3 added
    # data-parallel programs; a version-2 artifact still loads.
    assert serving.FORMAT_VERSION == 3
    older = str(tmp_path / "older.posenet")
    _rewrite_meta(artifact[1].path, older, format_version=1)
    with pytest.raises(ValueError, match="has format_version 1; this loader reads versions 2 "
                                         "and 3"):
        load_serving_artifact(older)
    v2 = str(tmp_path / "v2.posenet")
    _rewrite_meta(artifact[1].path, v2, format_version=2)
    assert load_serving_artifact(v2, device="cpu").meta["format_version"] == 2


def test_export_rejects_bad_configs(artifact, tmp_path):
    model = artifact[0]
    out = str(tmp_path / "x.posenet")
    with pytest.raises(ValueError, match="stride-valid"):
        save_serving_artifact(model, out, input_hw=(64, 64), platforms=("cpu",))
    with pytest.raises(ValueError, match="bad batch_sizes"):
        save_serving_artifact(model, out, input_hw=(65, 65), batch_sizes=(0,),
                              platforms=("cpu",))
    with pytest.raises(ValueError, match="data_parallel_devices=2 must divide every "
                                         "batch size; got \\[1\\]"):
        save_serving_artifact(model, out, input_hw=(65, 65), platforms=("cpu",),
                              data_parallel_devices=2)
    assert not os.path.exists(out)


def test_failed_export_leaves_no_artifact(artifact, tmp_path, monkeypatch):
    """An export that dies after meta.json is in the zip leaves nothing at
    the output path (no loadable zip listing programs it lacks)."""
    def boom(*a, **kw):
        raise RuntimeError("trace failed")

    monkeypatch.setattr(torch.export, "export", boom)
    path = str(tmp_path / "broken.posenet")
    with pytest.raises(RuntimeError, match="trace failed"):
        save_serving_artifact(artifact[0], path, input_hw=(65, 65), platforms=("cpu",))
    assert not os.path.exists(path)
    assert not os.path.exists(path + ".tmp")


def test_bf16_artifact_keeps_the_k2_route(tmp_path):
    """A bf16 CPU export holds K2's plain version (the wrapper's pointer
    check now sits in the CUDA op, out of the tracer's way) and stays
    bitwise equal to `infer`."""
    model = MobileNetV1(50, 16, compute_dtype=torch.bfloat16, seed=4, device="cpu")
    dcfg = DecodeConfig(min_pose_score=0.0, score_threshold=0.25)
    path = str(tmp_path / "bf16.posenet")
    meta = save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(1,),
                                 input_hw=(33, 33), platforms=("cpu",))
    assert meta["compute_dtype"] == "bfloat16"
    frames = np.random.RandomState(4).randint(0, 256, (1, 33, 33, 3), np.uint8)
    out = load_serving_artifact(path, device="cpu")(frames)
    ref = infer(mobilenet_v1.cast_params(model.params, torch.bfloat16),
                torch.from_numpy(frames), model.cfg, dcfg)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_export_cli(tmp_path, monkeypatch):
    """posenet-export-torch end to end on a random-init model."""
    monkeypatch.chdir(tmp_path)   # keep ./_models lookups out of the repo
    out = str(tmp_path / "cli.posenet")
    meta = serving.main(["--model", "50", "--output_stride", "16", "--size", "70", "70",
                         "--batch_sizes", "1", "--platforms", "cpu",
                         "--compute_dtype", "float32", "--output", out,
                         "--random_init_ok"])
    assert meta["input_hw"] == [65, 65]   # 70 snaps to the stride-valid 65
    frames = np.zeros((1, 65, 65, 3), np.uint8)
    scores = load_serving_artifact(out, device="cpu")(frames).pose_scores
    assert scores.shape == (1, 10) and torch.isfinite(scores).all()


@pytest.mark.parametrize("entry", ["save_serving_artifact", "ServingArtifact",
                                   "load_serving_artifact", "posenet-export-torch"])
def test_serving_entry_points_default_to_the_card(artifact, tmp_path, monkeypatch, entry):
    """With no platform or device named, export and load target the card:
    on a host without a CUDA device each raises, and nothing is written,
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "x.posenet")
    call = {
        "save_serving_artifact": lambda: save_serving_artifact(artifact[0], out,
                                                               input_hw=(65, 65)),
        "ServingArtifact": lambda: serving.ServingArtifact(artifact[1].path),
        "load_serving_artifact": lambda: load_serving_artifact(artifact[1].path),
        "posenet-export-torch": lambda: serving.main(
            ["--model", "50", "--size", "65", "65", "--output", out, "--random_init_ok"]),
    }[entry]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        call()
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags,item", [
    (["--from_checkpoint", "ckpt"], "item 13"),
    (["--data_parallel_devices", "2", "--random_init_ok"], "item 14"),
])
def test_export_cli_unported_options(tmp_path, monkeypatch, flags, item):
    """Both options are ported, and each refuses what it cannot export,
    writing nothing: item 13's `--from_checkpoint` a directory without a
    checkpoint (`test_torch_trainer.py` exports a real one), item 14's
    `--data_parallel_devices 2` the default batch size 1, which two devices
    cannot split (`test_torch_parallel.py` serves a real one)."""
    monkeypatch.chdir(tmp_path)
    error, match = ((SystemExit, "no checkpoint found in ckpt") if item == "item 13"
                    else (ValueError, "data_parallel_devices=2 must divide every batch size"))
    with pytest.raises(error, match=match):
        serving.main(["--model", "50", "--size", "65", "65", "--platforms", "cpu",
                      "--output", str(tmp_path / "x.posenet"), *flags])
    assert not os.path.exists(tmp_path / "x.posenet")


def _k2_args(device="cpu"):
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((2, 5, 7, 32), generator=g) * 6).to(torch.bfloat16)
    taps = sepconv.pack_depthwise(torch.randn((32, 1, 3, 3), generator=g) * 0.4)
    pw = (torch.randn((64, 32), generator=g) / 32 ** 0.5).to(torch.bfloat16)
    args = (x, taps, torch.randn((32,), generator=g) * 0.3, pw,
            torch.randn((64,), generator=g) * 0.3)
    return [a.to(device) for a in args]


def _k1_args(device="cpu"):
    from posenet_tpu_torch.decode import _prepare_decode
    from tests.test_torch_decode import _batch

    heads = [torch.from_numpy(h).to(device) for h in _batch((9, 11), (1, 2))]
    rows = _prepare_decode(*heads, 16, DecodeConfig(max_candidates=16, score_threshold=0.3))
    return [*rows[4:7], *rows[:4], 9, 11, 16]


OPS = {
    "sepconv": (lambda: torch.ops.posenet_tpu_torch.sepconv, sepconv.sepconv_reference,
                _k2_args),
    "traverse_all_candidates": (lambda: torch.ops.posenet_tpu_torch.traverse_all_candidates,
                                traversal.traverse_all_candidates_reference, _k1_args),
}


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(OPS))
def test_custom_op_fake_gives_plain_shapes(name):
    """On meta tensors (what `torch.export` traces with) each op's fake
    implementation gives the plain version's shapes and dtypes; on CPU
    tensors the op itself has no kernel, so nothing falls back."""
    op, plain, make_args = OPS[name]
    args = make_args()
    ref = _as_list(plain(*args))
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    fake = _as_list(op()(*meta_args))
    assert [(t.shape, t.dtype, t.device.type) for t in fake] == \
        [(t.shape, t.dtype, "meta") for t in ref]
    with pytest.raises(NotImplementedError):
        op()(*args)


def test_decoded_poses_tuple_round_trip():
    fields = [torch.full((1, 2), float(i)) for i in range(5)]
    poses = DecodedPoses(*fields)
    flat = poses.as_tuple()
    assert type(flat) is tuple and len(flat) == 5
    back = DecodedPoses.from_tuple(flat)
    assert isinstance(back, DecodedPoses) and back.candidate_count is fields[4]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPS))
def test_custom_op_matches_plain_on_card(cuda, name):   # noqa: F811
    op, plain, make_args = OPS[name]
    args = make_args(cuda)
    counter = sepconv if name == "sepconv" else traversal
    before = counter.launches
    got = _as_list(op()(*args))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = _as_list(plain(*args))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if name == "sepconv":
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       atol=2.0 ** -16, rtol=2.0 ** -7)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name,arg,match", [
    pytest.param("sepconv", 0, "contiguous", id="sepconv"),
    pytest.param("traverse_all_candidates", 0, "contiguous", id="traverse_all_candidates"),
    pytest.param("traverse_all_candidates", 4, "unit column stride",
                 id="traverse_all_candidates-offsets"),
])
def test_custom_op_rejects_strided_input_on_card(cuda, name, arg, match):   # noqa: F811
    """A loaded program calls the op past the wrapper's checks, so the op
    itself refuses memory its kernel would misread, and launches nothing:
    a strided first input, and (K1) a row tensor whose columns are apart."""
    op, _, make_args = OPS[name]
    args = make_args(cuda)
    args[arg] = args[arg].repeat_interleave(2, -1)[..., ::2]   # same values, stride 2
    assert args[arg].stride(-1) == 2
    counter = sepconv if name == "sepconv" else traversal
    before = counter.launches
    with pytest.raises(ValueError, match=match):
        op()(*args)
    assert counter.launches == before


@pytest.mark.cuda
def test_cuda_artifact_round_trip(cuda, tmp_path):   # noqa: F811
    """A bf16 artifact exported on the card keeps K1 and K2 as custom ops:
    the loaded program launches them (13 K2 layers for m101 s16) and is
    bitwise equal to the pipeline; the same artifact's cpu program runs
    on the CPU."""
    model = MobileNetV1(101, 16, compute_dtype=torch.bfloat16, seed=1)
    dcfg = DecodeConfig(min_pose_score=0.0, score_threshold=0.25)
    path = str(tmp_path / "m101.posenet")
    save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(2,),
                          input_hw=(65, 65), platforms=("cuda", "cpu"))
    art = load_serving_artifact(path)
    assert art.device.type == "cuda"
    frames = np.random.RandomState(1).randint(0, 256, (2, 65, 65, 3), np.uint8)
    ref = PoseNetPipeline(model.to(cuda), dcfg)(frames)
    torch.cuda.synchronize()
    k1, k2 = traversal.launches, sepconv.launches
    out = art(frames)
    torch.cuda.synchronize()
    assert sepconv.launches - k2 == 13 and traversal.launches - k1 >= 1
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # Each K2 node reads a view of the previous layer's output, not a copy,
    # and K1 reads views of the heads.
    made_by = [n.args[0].target for n in art._program(2).graph.nodes
               if n.target == torch.ops.posenet_tpu_torch.sepconv.default]
    assert made_by == [torch.ops.aten.permute.default] * 13
    k1_reads_heads_in_place(art._program(2).graph)
    on_cpu = load_serving_artifact(path, device="cpu")(frames)
    assert on_cpu.pose_scores.device.type == "cpu"
