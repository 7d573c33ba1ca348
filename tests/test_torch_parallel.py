"""The port's multi-device layer (`posenet_tpu_torch.parallel`, the
pipeline's partitions, data-parallel serving) against its own unsharded
paths and the JAX package's mesh paths, on the CPU: the port's meshes are
device lists such as ['cpu'] * 8, JAX's the 8 host devices conftest.py
forces.

Tolerances:
- data partition: bitwise against the port's unsharded pipeline (each
  shard runs the same program on its own frames); against JAX's
  `PoseNetPipeline(mesh=make_mesh(8))` the float32 slice's bar of
  tests/test_torch_pipeline.py: the same pose count, scores within 1e-4,
  coordinates within 1e-2 px;
- spatial partition (biases + 1.0, so that a pad row leaking into the
  image would show): scores within 1e-5 and coordinates within 1e-3 px,
  JAX's own bounds between its spatial and unsharded pipelines, against
  the port's unsharded pipeline and JAX's `partition='spatial'`; the bf16
  trunk (K2's plain version on slabs) within the bf16 heads bar, 2e-3;
- the data-parallel artifact: JAX's bounds, scores 1e-5 and coordinates
  1e-3 px, against the plain artifact.
"""

import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from posenet_tpu.config import DecodeConfig as JaxDecodeConfig
from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.models.model_factory import PoseNet as JaxPoseNet
from posenet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from posenet_tpu.pipeline import PoseNetPipeline as JaxPipeline

from posenet_tpu_torch import PoseNetPipeline
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import PoseNet
from posenet_tpu_torch.ops import sepconv
from posenet_tpu_torch.parallel import dryrun, spatial
from posenet_tpu_torch.parallel.mesh import (initialize_distributed, make_mesh, pad_batch,
                                             replicate, shard_batch, shard_bounds)
from posenet_tpu_torch.pipeline import normalize
from posenet_tpu_torch.server import LivePipelineBackend, PoseServer, make_http_server
from posenet_tpu_torch.serving import load_serving_artifact, save_serving_artifact

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.tfjs_fixture import synth_photo

CFG50 = ModelConfig(model_id=50, output_stride=16)
DATA_DCFG = dict(min_pose_score=0.0, score_threshold=0.25)
SPATIAL_DCFG = dict(min_pose_score=0.0, score_threshold=0.3, max_candidates=32)
WORLD_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK')


@pytest.fixture(scope='module')
def fixture_params():
    return tfjs2jax.load_params_npz(FIXTURE_PATH)


def _photos(n, size=65):
    """n RGB frames: the fixture's synthesized scenes resized to size^2."""
    import cv2

    return np.stack([cv2.resize(synth_photo(seed=300 + i), (size, size))[..., ::-1]
                     for i in range(n)]).copy()


def _assert_equal(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name


def _assert_close(got, ref, score_tol, coord_tol):
    """`got` (the port's DecodedPoses) against `ref` (a DecodedPoses of
    either package): pose counts, scores and coordinates."""
    ref = [np.asarray(t) for t in ref[:3]]
    got = [t.numpy() for t in got[:3]]
    np.testing.assert_array_equal((got[0] > 0).sum(1), (ref[0] > 0).sum(1))
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=score_tol)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=score_tol)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=coord_tol)


# --- the mesh -------------------------------------------------------------

def test_initialize_distributed_single_process(monkeypatch):
    """Nothing configured: the process stays local and gets rank 0, again
    on a repeat call, and joins no world."""
    for k in WORLD_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() == 0
    assert initialize_distributed(backend='gloo') == 0
    assert not dist.is_initialized()


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.mark.parametrize('case', ['unreachable', 'no_address', 'bad_rank'])
def test_initialize_distributed_explicit_failure_raises(case):
    """An explicitly requested multi-process world that cannot form raises,
    and leaves the process in no world: rank 1 of 2 whose coordinator never
    answers (after a 1 s timeout), a world size without an address, a
    rank outside the world."""
    kwargs = {
        'unreachable': dict(coordinator_address=f'127.0.0.1:{_closed_port()}',
                            num_processes=2, process_id=1, timeout_s=1),
        'no_address': dict(num_processes=2, process_id=0),
        'bad_rank': dict(coordinator_address='127.0.0.1:1', num_processes=2, process_id=2),
    }[case]
    with pytest.raises((RuntimeError, TimeoutError, ValueError)):
        initialize_distributed(backend='gloo', **kwargs)
    assert not dist.is_initialized()


def test_make_mesh_and_batch_helpers():
    """Device lists may repeat a device; more devices than exist raise,
    never shrink; batches pad to the mesh and split in equal slices."""
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f'a mesh of {cards + 1} cuda device'):
        make_mesh(cards + 1)
    with pytest.raises(ValueError, match='a mesh of 2 cpu device.*has 1'):
        make_mesh(2, device_type='cpu')
    assert make_mesh(device_type='cpu').devices == (torch.device('cpu'),)
    mesh = make_mesh(devices=['cpu'] * 8)
    assert mesh.size == 8 and mesh.rank == 0 and mesh.group is None
    assert make_mesh(3, devices=['cpu'] * 8).size == 3
    with pytest.raises(ValueError, match='num_devices=9 but the device list has 8'):
        make_mesh(9, devices=['cpu'] * 8)

    x = np.arange(9 * 2).reshape(9, 2)
    padded = pad_batch(x, mesh)
    assert padded.shape == (16, 2) and not padded[9:].any()
    assert pad_batch(torch.from_numpy(x), mesh).shape == (16, 2)
    assert shard_bounds(16, mesh)[3] == (6, 8)
    with pytest.raises(ValueError, match='pad it to 16'):
        shard_bounds(9, mesh)
    shards = shard_batch({'a': padded}, mesh)
    assert len(shards) == 8 and torch.equal(shards[4]['a'], torch.from_numpy(padded[8:10]))
    copies = replicate({'w': torch.ones(3)}, mesh)
    assert all(c['w'] is copies[0]['w'] for c in copies)   # one copy a device


def test_split_rows_and_halo_ranges():
    """Uneven row ranges cover the height; a stride-2 layer's output rows
    read their input rows with the padding row above; a rate-2 layer's
    two rows each side."""
    assert spatial.split_rows(9, 4) == [(0, 3), (3, 5), (5, 7), (7, 9)]
    assert spatial.split_rows(2, 3) == [(0, 1), (1, 2), (2, 2)]
    plan = mobilenet_v1.stride_plan(101, 16)
    assert spatial.output_height(513, plan[0]) == 257
    assert spatial.input_rows(0, 129, plan[0]) == (-1, 258)   # rows -1 .. 257
    assert plan[13]['rate'] == 2 and spatial.output_height(33, plan[13]) == 33
    assert spatial.input_rows(4, 8, plan[13]) == (2, 10)
    assert spatial.input_rows(4, 8, plan[3]) == (3, 9)         # K2's one-row halo


# --- the data partition ---------------------------------------------------

@pytest.mark.parametrize('batch', [8, 9], ids=['b8', 'b9_uneven'])
def test_data_partition_matches_unsharded_and_jax(fixture_params, batch):
    frames = _photos(batch)
    model = PoseNet(weights.params_from_jax(fixture_params), CFG50)
    dcfg = DecodeConfig(**DATA_DCFG)
    sharded = PoseNetPipeline(model, dcfg, mesh=make_mesh(devices=['cpu'] * 8))
    got = sharded(frames)
    assert got.pose_scores.shape == (batch, 10) and got.candidate_count.shape == (batch,)
    _assert_equal(got, PoseNetPipeline(model, dcfg)(frames))
    assert (got.pose_scores > 0).sum() >= batch

    jax_pipe = JaxPipeline(
        JaxPoseNet(jax.tree.map(jnp.asarray, fixture_params), JaxModelConfig(50, 16)),
        JaxDecodeConfig(**DATA_DCFG), mesh=jax_make_mesh(8))
    _assert_close(got, jax_pipe(frames), 1e-4, 1e-2)


def _refuse(name):
    def refuse(*a, **k):
        raise AssertionError(f'{name} on the pipeline\'s path: it would wait on the host')
    return refuse


@pytest.mark.parametrize('layout', ['data', 'data_raw', 'spatial'])
def test_a_shard_never_waits_on_the_host(monkeypatch, layout):
    """No shard's program waits on the host, or N devices would run one
    after another: nothing on the path reads a device value back (item,
    tolist, bool, float, numpy) or copies a host value to the device
    (`torch.tensor(..., device=)`, a copy that first waits for the work
    queued on the device). Checked here by refusing each during a call."""
    model = PoseNet(mobilenet_v1.init_params(torch.Generator().manual_seed(0), CFG50), CFG50)
    mesh = make_mesh(devices=['cpu'] * 3)
    pipe = PoseNetPipeline(model, DecodeConfig(**DATA_DCFG), mesh=mesh,
                           partition='spatial' if layout == 'spatial' else 'data',
                           device_resize_to=(33, 33) if layout == 'data_raw' else None)
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1 if layout == 'spatial' else 5, 40 if layout == 'data_raw' else 33, 33, 3),
        np.uint8))
    real_tensor = torch.tensor
    monkeypatch.setattr(torch, 'tensor', lambda *a, **k: (
        _refuse('torch.tensor(..., device=)')() if 'device' in k else real_tensor(*a, **k)))
    for name in ('item', 'tolist', 'numpy', '__bool__', '__float__', '__int__'):
        monkeypatch.setattr(torch.Tensor, name, _refuse(f'Tensor.{name}'))
    out = pipe(frames)
    monkeypatch.undo()
    assert out.pose_scores.shape == (frames.shape[0], 10)


def test_pipeline_mesh_validation():
    model = PoseNet(mobilenet_v1.init_params(torch.Generator().manual_seed(0), CFG50), CFG50)
    mesh = make_mesh(devices=['cpu'] * 2)
    with pytest.raises(ValueError, match="partition must be"):
        PoseNetPipeline(model, mesh=mesh, partition='model')
    with pytest.raises(ValueError, match='a device or a mesh'):
        PoseNetPipeline(model, device='cpu', mesh=mesh)
    with pytest.raises(NotImplementedError, match='device_resize_to'):
        PoseNetPipeline(model, mesh=mesh, partition='spatial', device_resize_to=(65, 65))
    raw = PoseNetPipeline(model, mesh=mesh, device_resize_to=(33, 33))
    bgr = np.random.RandomState(0).randint(0, 255, (3, 40, 50, 3), np.uint8)
    _assert_equal(raw(bgr), PoseNetPipeline(model, device_resize_to=(33, 33))(bgr))


# --- the spatial partition ------------------------------------------------

@pytest.fixture(scope='module')
def inflated():
    """Seeded random m50 s16 weights with every trunk bias + 1.0 (a
    checkpoint's scale): JAX's (HWIO numpy arrays) and the port's."""
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(0), CFG50)
    for layer in params['backbone']:
        for k in layer:
            if k.endswith('b'):
                layer[k] = layer[k] + 1.0
    hwio = jax.tree.map(lambda t: (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).numpy(),
                        params)
    assert all(torch.equal(la[k], lb[k])
               for la, lb in zip(weights.params_from_jax(hwio)['backbone'], params['backbone'])
               for k in lb)
    return hwio, params


@pytest.mark.parametrize('n', [8, 3], ids=['8_shards', '3_uneven'])
def test_spatial_partition_matches_unsharded_and_jax(inflated, n):
    jax_params, params = inflated
    frames = np.random.RandomState(7).randint(0, 255, (1, 129, 129, 3), dtype=np.uint8)
    model = PoseNet(params, CFG50)
    dcfg = DecodeConfig(**SPATIAL_DCFG)
    sharded = PoseNetPipeline(model, dcfg, mesh=make_mesh(devices=['cpu'] * n),
                              partition='spatial')
    got = sharded(frames)
    plain = PoseNetPipeline(model, dcfg)
    _assert_close(got, plain(frames), 1e-5, 1e-3)
    assert (got.pose_scores > 0).sum() >= 1

    jax_pipe = JaxPipeline(JaxPoseNet(jax_params, JaxModelConfig(50, 16)),
                           JaxDecodeConfig(**SPATIAL_DCFG), mesh=jax_make_mesh(n),
                           partition='spatial')
    _assert_close(got, jax_pipe(frames), 1e-5, 1e-3)


@pytest.mark.parametrize('stride', [16, 8])
def test_spatial_bf16_trunk_runs_the_fused_block_on_slabs(inflated, monkeypatch, stride):
    """bf16: every separable layer runs the fused block (K2's plain version
    here) at its rate and stride on each shard's slab: at stride 1 its
    `rate` halo rows cut on each side, at stride 2 with one zero row above
    the slab and the output row it adds cut; the heads stay within the
    bf16 bar of the unsharded forward's. At s16 layers 2, 4 and 6 run at
    stride 2, at s8 layers 2 and 4, and 7-13 at rate 2."""
    cfg = ModelConfig(model_id=50, output_stride=stride, compute_dtype=torch.bfloat16)
    params = mobilenet_v1.cast_params(inflated[1], torch.bfloat16)
    x = normalize(torch.from_numpy(np.random.RandomState(8).randint(
        0, 255, (2, 97, 65, 3), dtype=np.uint8)), torch.bfloat16)
    ref = mobilenet_v1.head_conv(params['heads'], mobilenet_v1.run_trunk(params, x, cfg))
    calls = []
    call = sepconv.sepconv
    monkeypatch.setattr(sepconv, 'sepconv',
                        lambda *a: calls.append((a[0].shape, a[5], a[6])) or call(*a))
    devices = [torch.device('cpu')] * 3
    got = spatial.forward([params] * 3, x, cfg, devices)
    assert got.shape == ref.shape and got.is_contiguous()
    assert float((got - ref).abs().max()) <= 2e-3
    # 13 fused layers at m50 s16 and s8, 3 slabs each; a stride-1 slab
    # 2 * rate rows taller than its shard's output rows, a stride-2 one
    # (with the zero row above it) twice their count and 2 rows
    plan = [l for l in mobilenet_v1.stride_plan(50, stride) if mobilenet_v1.uses_sepconv(l, cfg)]
    assert len(calls) == 3 * len(plan) == 39
    assert calls[0][0][1] == spatial.split_rows(49, 3)[0][1] + 2
    for i, layer in enumerate(plan):
        rows = spatial.split_rows((97 - 1) // layer['cumulative_stride'] + 1, 3)
        for (shape, rate, s), (a, b) in zip(calls[3 * i:3 * i + 3], rows):
            assert (rate, s) == (layer['rate'], layer['stride'])
            assert shape[1] == (b - a + 2 * rate if s == 1 else 2 * (b - a) + 2)
    assert [l['rate'] for l in plan] == [1] * (13 if stride == 16 else 6) + [2] * (
        0 if stride == 16 else 7)
    assert [l['block_id'] for l in plan if l['stride'] == 2] == (
        [2, 4, 6] if stride == 16 else [2, 4])


# --- data-parallel serving ------------------------------------------------

def test_data_parallel_artifact(fixture_params, tmp_path):
    """data_parallel_devices=4 over an explicit CPU device list: each
    program runs a shard of 2, and the poses match the plain artifact's;
    JAX's two messages for a batch without a program and a batch that
    does not divide."""
    model = PoseNet(weights.params_from_jax(fixture_params), CFG50)
    dcfg = DecodeConfig(**DATA_DCFG)
    plain_path, dp_path = str(tmp_path / 'plain.posenet'), str(tmp_path / 'dp.posenet')
    save_serving_artifact(model, plain_path, decode_cfg=dcfg, batch_sizes=(8,),
                          input_hw=(65, 65), platforms=('cpu',))
    meta = save_serving_artifact(model, dp_path, decode_cfg=dcfg, batch_sizes=(8,),
                                 input_hw=(65, 65), platforms=('cpu',),
                                 data_parallel_devices=4)
    assert meta['data_parallel_devices'] == 4 and meta['format_version'] == 3

    frames = _photos(8)
    ref = load_serving_artifact(plain_path, device='cpu')(frames)
    art = load_serving_artifact(dp_path, devices=['cpu'] * 4)
    assert art.device == torch.device('cpu') and art.mesh.size == 4
    got = art(frames)
    _assert_close(got, ref, 1e-5, 1e-3)
    assert (got.pose_scores > 0).sum() >= 8

    with pytest.raises(ValueError, match='no program for batch size 4'):
        art(np.zeros((4, 65, 65, 3), np.uint8))
    with pytest.raises(ValueError, match='must divide every batch size'):
        save_serving_artifact(model, str(tmp_path / 'x.posenet'), batch_sizes=(6,),
                              input_hw=(65, 65), platforms=('cpu',),
                              data_parallel_devices=4)
    # the loader needs the artifact's N devices: the CPU is one
    with pytest.raises(ValueError, match='a mesh of 4 cpu device'):
        load_serving_artifact(dp_path, device='cpu')
    with pytest.raises(ValueError, match='needs 4 devices'):
        load_serving_artifact(dp_path, devices=['cpu'] * 2)


def test_live_backend_data_partition_and_healthz(fixture_params):
    """LivePipelineBackend over 4 CPU shards: the replies of the served
    program equal the unsharded pipeline's, /healthz reports num_devices,
    and a host without the devices asked for is refused."""
    model = PoseNet(weights.params_from_jax(fixture_params), CFG50)
    dcfg = DecodeConfig(**DATA_DCFG)
    with pytest.raises(ValueError, match='a mesh of 2 cpu device.*has 1'):
        LivePipelineBackend(model, decode_cfg=dcfg, input_hw=(65, 65), batch_sizes=(4,),
                            num_devices=2)
    backend = LivePipelineBackend(model, decode_cfg=dcfg, input_hw=(65, 65),
                                  batch_sizes=(4,), devices=['cpu'] * 4)
    assert backend.meta['num_devices'] == 4
    frames = _photos(4)
    _assert_equal(backend(frames), PoseNetPipeline(model, dcfg)(frames))
    server = PoseServer(backend, batch_wait_ms=50.0)
    httpd = make_http_server(server, '127.0.0.1', 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f'http://127.0.0.1:{httpd.server_address[1]}'
        health = json.loads(urllib.request.urlopen(base + '/healthz', timeout=60).read())
        assert health['ok'] and health['artifact']['num_devices'] == 4
        req = urllib.request.Request(base + '/v1/decode', data=frames[0].tobytes(),
                                     headers={'Content-Type': 'application/x-posenet-frame'})
        reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
        ref = PoseNetPipeline(model, dcfg)(np.repeat(frames[:1], 4, axis=0))
        assert len(reply['poses']) == int((ref.pose_scores[0] > 0).sum())
        np.testing.assert_allclose([p['score'] for p in reply['poses']],
                                   ref.pose_scores[0][:len(reply['poses'])].numpy(),
                                   rtol=0, atol=1e-6)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


# --- the dry run ----------------------------------------------------------

def test_dryrun_multichip(capsys):
    """Two gloo ranks for the step, two CPU shards for each partition; JAX's
    three lines."""
    dryrun.dryrun_multichip(2)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(':')[1].split(',')[0].strip() for line in lines
            if line.startswith('dryrun_multichip(2)')] == [
        'DP step ok', 'spatial-partition inference ok',
        'data-partition (shard_map) inference ok']

