"""`posenet-serve-torch` (`posenet_tpu_torch.server`): the HTTP frontend
and the coalescing device worker, over a small CPU artifact and over the
live pipeline. The cases mirror tests/test_server.py's behaviours, and one
holds the port server's JSON to the JAX server's on the same fixture
weights and frames, at the slice's tolerance (the same pose counts, scores
within 1e-4, coordinates within 1e-2 px; tests/test_torch_pipeline.py).
"""

import concurrent.futures
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from posenet_tpu_torch.config import DecodeConfig
from posenet_tpu_torch.models.model_factory import MobileNetV1
from posenet_tpu_torch.server import (LivePipelineBackend, PoseServer,
                                      ServerUnavailable, make_http_server)
from posenet_tpu_torch.serving import load_serving_artifact, save_serving_artifact

from tests.torch_offline import offline_download  # noqa: F401 (autouse)

HW = (65, 65)
DCFG = DecodeConfig(min_pose_score=0.0, score_threshold=0.25)


@pytest.fixture(scope="module")
def model():
    return MobileNetV1(50, 16, seed=11, device="cpu")


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "m50.posenet")
    save_serving_artifact(model, path, decode_cfg=DCFG, batch_sizes=(1, 4),
                          input_hw=HW, platforms=("cpu",))
    return load_serving_artifact(path, device="cpu")


@pytest.fixture(scope="module")
def live(model):
    return LivePipelineBackend(model, decode_cfg=DCFG, input_hw=HW, batch_sizes=(1, 4))


@pytest.fixture(params=["artifact", "live"])
def backend(request, artifact, live):
    return {"artifact": artifact, "live": live}[request.param]


@pytest.fixture(scope="module")
def server(artifact):
    srv = PoseServer(artifact, batch_wait_ms=2.0)
    yield srv
    srv.close()


def _serve(srv):
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def http_base(server):
    httpd, base = _serve(server)
    yield base
    httpd.shutdown()
    httpd.server_close()


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, *HW, 3)).astype(np.uint8)


def _expected(backend, frame):
    """The poses of `frame` run alone at batch 1, as a server replies."""
    out = backend(frame[None])
    return [np.asarray(t)[0] for t in (out.pose_scores, out.keypoint_scores,
                                       out.keypoint_coords)]


def _assert_matches(poses, expected, exact=False):
    scores, kp_scores, kp_coords = expected
    assert len(poses) == int((scores > 0).sum())
    for p, pose in enumerate(poses):
        assert pose["score"] == (float(scores[p]) if exact else
                                 pytest.approx(float(scores[p]), abs=1e-5))
        got = np.array([[kp["y"], kp["x"]] for kp in pose["keypoints"]])
        if exact:
            np.testing.assert_array_equal(got, kp_coords[p])
            assert [kp["score"] for kp in pose["keypoints"]] == kp_scores[p].tolist()
        else:
            np.testing.assert_allclose(got, kp_coords[p], atol=1e-3, rtol=0)


def _post_raw(base, frame, query=""):
    req = urllib.request.Request(
        base + "/v1/decode" + query, data=frame.tobytes(),
        headers={"Content-Type": "application/x-posenet-frame"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _concurrent(srv, frames, timeout=180):
    results = [None] * len(frames)

    def call(i):
        results[i] = srv.decode_frame(frames[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    return results


def test_decode_frame_matches_backend(backend):
    """One frame alone runs at batch 1: the reply is its poses exactly."""
    srv = PoseServer(backend, batch_wait_ms=2.0)
    try:
        frame = _frames(1)[0]
        poses = srv.decode_frame(frame)
        assert poses and {"part", "y", "x", "score"} <= set(poses[0]["keypoints"][0])
        _assert_matches(poses, _expected(backend, frame), exact=True)
    finally:
        srv.close()


@pytest.mark.parametrize("depth", [2, 1])
def test_concurrent_requests_coalesce_and_match(backend, depth):
    """8 concurrent clients over batches {1, 4}, at both pipeline depths:
    every caller gets its own frame's poses, and the batches coalesce."""
    frames = _frames(8, seed=3)
    srv = PoseServer(backend, batch_wait_ms=20.0, pipeline_depth=depth)
    try:
        results = _concurrent(srv, frames)
        for i in range(8):
            _assert_matches(results[i], _expected(backend, frames[i]))
        assert srv.stats["batches_by_size"][4] >= 1
        assert srv.stats["requests_done"] == 8 and srv.stats["errors"] == 0
    finally:
        srv.close()


def test_pipelined_multi_chunk_burst(artifact):
    """Depth-2 pipelining across many successive chunks (24 requests over
    batches {1, 4}): chunk N+1 is dispatched before chunk N is fetched,
    and every caller still gets its own frame's result."""
    frames = _frames(24, seed=37)
    srv = PoseServer(artifact, batch_wait_ms=5.0, pipeline_depth=2)
    try:
        results = _concurrent(srv, frames)
        for i in range(24):
            _assert_matches(results[i], _expected(artifact, frames[i]))
        assert srv.stats["requests_done"] == 24
        assert srv.stats["errors"] == 0
    finally:
        srv.close()


def test_many_clients_with_short_switch_interval(artifact):
    """64 concurrent callers, more than the cores, with a short thread
    switch interval: every caller gets its own frame's poses, and the
    worker's counters lose no update."""
    frames = _frames(64, seed=53)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    srv = PoseServer(artifact, batch_wait_ms=1.0)
    try:
        results = _concurrent(srv, frames)
    finally:
        sys.setswitchinterval(old)
        srv.close()
    for i in range(64):
        _assert_matches(results[i], _expected(artifact, frames[i]))
    assert srv.stats["requests_done"] == 64 and srv.stats["errors"] == 0
    assert sum(b * n for b, n in srv.stats["batches_by_size"].items()) >= 64


def test_scale_yx_applied(server):
    frame = _frames(1, seed=5)[0]
    base = server.decode_frame(frame)
    scaled = server.decode_frame(frame, scale_yx=(2.0, 3.0))
    assert base
    for p0, p1 in zip(base, scaled):
        for k0, k1 in zip(p0["keypoints"], p1["keypoints"]):
            assert k1["y"] == pytest.approx(2.0 * k0["y"], rel=1e-6)
            assert k1["x"] == pytest.approx(3.0 * k0["x"], rel=1e-6)


@pytest.mark.parametrize("frame", [np.zeros((3, 3, 3), np.uint8),
                                   np.zeros((*HW, 3), np.float32)])
def test_decode_frame_validates(server, frame):
    with pytest.raises(ValueError, match="uint8"):
        server.decode_frame(frame)


def test_http_healthz_and_raw_frame(http_base, artifact):
    with urllib.request.urlopen(http_base + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["artifact"]["model_id"] == 50
    assert health["artifact"]["format"] == "posenet_tpu_torch.export"
    frame = _frames(1, seed=7)[0]
    body = _post_raw(http_base, frame)
    assert body["source_hw"] == list(HW)
    _assert_matches(body["poses"], _expected(artifact, frame))


def test_http_png_round_trip_scales_to_source(http_base, artifact):
    cv2 = pytest.importorskip("cv2")
    src = np.random.default_rng(9).integers(0, 255, (130, 260, 3)).astype(np.uint8)
    ok, enc = cv2.imencode(".png", src)   # png: exact pixels through the codec
    assert ok
    req = urllib.request.Request(http_base + "/v1/decode", data=enc.tobytes(),
                                 headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    assert body["source_hw"] == [130, 260]
    rgb = cv2.cvtColor(cv2.resize(src, (HW[1], HW[0]), interpolation=cv2.INTER_LINEAR),
                       cv2.COLOR_BGR2RGB)
    scores, kp_scores, coords = _expected(artifact, rgb)
    _assert_matches(body["poses"], (scores, kp_scores, coords * [2.0, 4.0]))
    for pose in body["poses"]:
        for kp in pose["keypoints"]:
            assert -1 <= kp["y"] <= 131 and -1 <= kp["x"] <= 262


def test_encoded_image_without_cv2_is_500(http_base, monkeypatch):
    """A host without cv2 (the card's machine) answers JPEG/PNG with 500,
    as the JAX server does, and keeps serving raw frames."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    req = urllib.request.Request(http_base + "/v1/decode", data=b"\x89PNG....",
                                 headers={"Content-Type": "image/png"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 500
    assert "cv2" in json.loads(e.value.read())["error"]
    assert "poses" in _post_raw(http_base, _frames(1, seed=8)[0])


def test_per_request_thresholds(http_base, server):
    frame = _frames(1, seed=23)[0]
    base = server.decode_frame(frame)
    assert base
    top = base[0]["score"]
    assert server.decode_frame(frame, min_pose_score=top + 1e-3) == []
    strict = server.decode_frame(frame, min_part_score=2.0)
    assert len(strict) == len(base)
    assert all(p["keypoints"] == [] for p in strict)
    assert _post_raw(http_base, frame, f"?min_pose_score={top + 1e-3}")["poses"] == []
    req = urllib.request.Request(http_base + "/v1/decode?bogus=1", data=frame.tobytes())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_statsz_counts_batches(http_base, server):
    def stats():
        return json.loads(urllib.request.urlopen(http_base + "/statsz", timeout=30).read())

    before = stats()
    server.decode_frame(_frames(1, seed=13)[0])
    after = stats()
    assert after["requests_done"] == before["requests_done"] + 1
    assert after["batches_by_size"]["1"] == before["batches_by_size"]["1"] + 1
    assert after["device_ms_last"] > 0


@pytest.mark.parametrize("case", ["route", "undecodable", "oversized", "raw_size"])
def test_http_client_errors(http_base, case):
    url, data, headers, code = {
        "route": ("/v1/nope", b"x", {}, 404),
        "undecodable": ("/v1/decode", b"not an image", {}, 400),
        "oversized": ("/v1/decode", b"x", {"Content-Length": str(100 << 20)}, 400),
        "raw_size": ("/v1/decode", b"\0" * 17,
                     {"Content-Type": "application/x-posenet-frame"}, 400),
    }[case]
    req = urllib.request.Request(http_base + url, data=data, headers=headers)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == code


def test_unhealthy_server_maps_to_503(artifact):
    """A dead device worker flips healthy=False: /healthz answers 503 and
    new requests are refused with ServerUnavailable (503 over HTTP)."""
    srv = PoseServer(artifact, batch_wait_ms=2.0)
    try:
        srv.healthy = False   # what the worker's top-level guard sets
        with pytest.raises(ServerUnavailable, match="unhealthy"):
            srv.decode_frame(_frames(1)[0])
        httpd, base = _serve(srv)
        try:
            for path, data in (("/healthz", None), ("/v1/decode", _frames(1)[0].tobytes())):
                req = urllib.request.Request(
                    base + path, data=data,
                    headers={"Content-Type": "application/x-posenet-frame"})
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req, timeout=10)
                assert e.value.code == 503
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        srv.close()


class _Slow:
    """A backend that takes `delay_s` per batch."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self.input_hw, self.batch_sizes = inner.input_hw, inner.batch_sizes
        self.meta, self.device = inner.meta, inner.device
        self.delay_s = delay_s

    def __call__(self, frames):
        time.sleep(self.delay_s)
        return self._inner(frames)


def test_stalled_device_is_504(artifact):
    """A reply that does not come in time is a TimeoutError, 504 over
    HTTP (a server-side stall, not a caller bug)."""
    srv = PoseServer(_Slow(artifact, 1.0), batch_wait_ms=2.0)
    try:
        with pytest.raises(TimeoutError):
            srv.decode_frame(_frames(1)[0], timeout_s=0.05)
        httpd, base = _serve(srv)
        original = srv.decode_frame
        srv.decode_frame = lambda frame, **kw: original(frame, timeout_s=0.05, **kw)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_raw(base, _frames(1)[0])
            assert e.value.code == 504
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        srv.close()


def test_live_backend_validation(model):
    with pytest.raises(ValueError, match="stride-valid"):
        LivePipelineBackend(model, input_hw=(64, 64))
    with pytest.raises(ValueError, match="bad batch_sizes"):
        LivePipelineBackend(model, input_hw=HW, batch_sizes=())
    # more devices than the host has: the CPU is one device
    with pytest.raises(ValueError, match="a mesh of 4 cpu device.*has 1"):
        LivePipelineBackend(model, input_hw=HW, batch_sizes=(1, 4), num_devices=4)
    with pytest.raises(ValueError, match="must divide every served batch size"):
        LivePipelineBackend(model, input_hw=HW, batch_sizes=(1, 4), devices=["cpu"] * 4)
    backend = LivePipelineBackend(model, input_hw=HW, num_devices=1)
    assert backend.meta["backend"] == "live-pipeline" and backend.meta["num_devices"] == 1
    assert backend.device == torch.device("cpu")


@pytest.mark.parametrize("argv", [[], ["--artifact", "x.posenet", "--model", "50"]])
def test_serve_cli_requires_exactly_one_source(argv):
    from posenet_tpu_torch.server import main as serve_main

    with pytest.raises(SystemExit):
        serve_main(argv)


def test_serve_cli_live_mode_needs_the_card(monkeypatch, tmp_path):
    """`posenet-serve-torch --model` loads its model on the card: on a host
    without a CUDA device it raises before it serves anything."""
    from posenet_tpu_torch.server import main as serve_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)   # keep ./_models lookups out of the repo
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve_main(["--model", "50", "--allow_random_init", "--port", "0"])


def test_shutdown_answers_queued_requests(backend):
    """Requests accepted before close() are still answered (the graceful
    shutdown contract); new ones after it are refused."""
    srv = PoseServer(backend, batch_wait_ms=50.0)
    try:
        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            futs = [ex.submit(srv.decode_frame, _frames(1, seed=i)[0]) for i in range(6)]
            time.sleep(0.05)   # let them enqueue
            closer = ex.submit(srv.close)
            results = [f.result(timeout=120) for f in futs]
            closer.result(timeout=120)
        assert all(isinstance(r, list) for r in results)
        with pytest.raises(ServerUnavailable, match="shutting down"):
            srv.decode_frame(_frames(1)[0])
    finally:
        srv.close()


def test_shutdown_sentinel_consumed_mid_batch(artifact):
    """close() while the worker sits inside the coalescing window: the
    sentinel is consumed mid-batch, and the worker still exits after
    answering the batch instead of blocking in the next queue.get()."""
    srv = PoseServer(artifact, batch_wait_ms=300.0)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            fut = ex.submit(srv.decode_frame, _frames(1)[0], timeout_s=60.0)
            time.sleep(0.08)   # worker now coalescing inside the window
            srv.close()        # sentinel lands mid-window
            assert isinstance(fut.result(timeout=60), list)
        srv._worker.join(timeout=10.0)
        assert not srv._worker.is_alive()
    finally:
        srv.close()


def test_pipelined_dispatch_failure_recovers(artifact):
    """A backend that raises on one chunk's dispatch fails that chunk's
    callers with the error (not a hang), and the worker keeps serving."""

    class Flaky(_Slow):
        fail_next = 0

        def __call__(self, frames):
            if self.fail_next > 0:
                self.fail_next -= 1
                raise RuntimeError("injected dispatch failure")
            return self._inner(frames)

    flaky = Flaky(artifact, 0.0)
    srv = PoseServer(flaky, batch_wait_ms=2.0, pipeline_depth=2)
    try:
        frame = _frames(1, seed=41)[0]
        assert isinstance(srv.decode_frame(frame), list)
        flaky.fail_next = 1
        with pytest.raises(RuntimeError, match="injected dispatch"):
            srv.decode_frame(frame)
        assert srv.healthy
        assert isinstance(srv.decode_frame(frame), list)
        assert srv.stats["errors"] == 1
    finally:
        srv.close()


def test_server_json_matches_jax_server():
    """The port's server and the JAX package's, each over its live
    pipeline on the same fixture weights, answer the same photos with the
    same poses, within the slice's tolerance."""
    import jax
    import jax.numpy as jnp

    from posenet_tpu.config import DecodeConfig as JaxDecodeConfig
    from posenet_tpu.config import ModelConfig as JaxModelConfig
    from posenet_tpu.converter import tfjs2jax
    from posenet_tpu.models.model_factory import PoseNet as JaxPoseNet
    from posenet_tpu.server import LivePipelineBackend as JaxLive
    from posenet_tpu.server import PoseServer as JaxServer

    from posenet_tpu_torch.config import ModelConfig
    from posenet_tpu_torch.converter import weights
    from posenet_tpu_torch.models.model_factory import PoseNet
    from tests.make_fixture_checkpoint import FIXTURE_PATH
    from tests.tfjs_fixture import synth_photo

    hw = (353, 481)
    params = tfjs2jax.load_params_npz(FIXTURE_PATH)
    photos = [np.ascontiguousarray(synth_photo(*hw, seed=100 + i)[..., ::-1])
              for i in range(2)]
    ours = PoseServer(LivePipelineBackend(
        PoseNet(weights.params_from_jax(params), ModelConfig(50, 16)),
        decode_cfg=DecodeConfig(min_pose_score=0.25), input_hw=hw, batch_sizes=(1,)))
    theirs = JaxServer(JaxLive(
        JaxPoseNet(jax.tree.map(jnp.asarray, params), JaxModelConfig(50, 16)),
        decode_cfg=JaxDecodeConfig(min_pose_score=0.25), input_hw=hw, batch_sizes=(1,)))
    try:
        for photo in photos:
            got = ours.decode_frame(photo)
            ref = theirs.decode_frame(photo)
            assert ref and len(got) == len(ref)
            for a, b in zip(got, ref):
                assert a["score"] == pytest.approx(b["score"], abs=1e-4)
                assert [k["part"] for k in a["keypoints"]] == [k["part"] for k in b["keypoints"]]
                for ka, kb in zip(a["keypoints"], b["keypoints"]):
                    assert ka["score"] == pytest.approx(kb["score"], abs=1e-4)
                    assert ka["y"] == pytest.approx(kb["y"], abs=1e-2)
                    assert ka["x"] == pytest.approx(kb["x"], abs=1e-2)
    finally:
        ours.close()
        theirs.close()
