"""`posenet-serve-torch`: the HTTP serving frontend over a serving artifact
(`posenet_tpu_torch.serving`) or over the live fused pipeline.

The counterpart of `posenet_tpu.server`, with the same endpoints, JSON,
status codes, coalescing, shutdown contract and `pipeline_depth`:

    posenet-export-torch --model 101 --batch_sizes 1,8 --output m101.posenet
    posenet-serve-torch --artifact m101.posenet --port 8080
    curl -s --data-binary @photo.jpg localhost:8080/v1/decode | jq .

or, without an export step, the in-process pipeline (`LivePipelineBackend`):

    posenet-serve-torch --model 101 --size 513 513 --batch_sizes 1,8

(The JAX package's `PoseServer` cannot be reused: importing
`posenet_tpu.server` imports the `posenet_tpu` facade, which imports jax,
and the port's runtime never imports jax.)

Design:
- **One worker thread owns the device.** HTTP handler threads enqueue
  (frame, reply-slot) pairs; the worker sets the backend's device, drains
  the queue and dispatches, so every kernel launches on that thread's
  current stream.
- **Request coalescing**: the worker groups what is queued into the
  largest served batch that is <= the pending count (repeatedly), and pads
  the remainder up to the smallest served batch that covers it (padding
  rows are zero frames whose results are dropped).
- **Depth-2 pipelining** (`pipeline_depth=2`): batch N+1 is built and
  queued on the device before batch N's results are fetched. On a card the
  batch is staged in pinned host memory and uploaded with
  `non_blocking=True` (`pipeline.to_device`); a pageable upload would make
  the host wait for batch N. Right after a batch is queued, its three
  result tensors are queued for copy into pinned host memory behind it, and
  an event marks the copies' end: the fetch waits on that event alone, not
  on batch N+1 queued later on the same stream.
- **Host does images, device does math**: JPEG/PNG decode (cv2) and the
  resize to the served resolution (`native_preprocess.resize_rgb`) run on
  the request thread; only uint8 frames cross into the worker. cv2 is
  imported at call time: on a host without it (the card's machine) encoded
  images answer 500 and raw frames are the path. Coordinates are scaled
  back to the source resolution before replying.

Endpoints:
    GET  /healthz      -> {"ok": true, "artifact": <meta>}
    GET  /statsz       -> request/error counts, batch-size histogram,
                          device time (coalescing effectiveness)
    POST /v1/decode    -> optional ?min_pose_score=&min_part_score=
                          (per-request post-filters; only stricter than
                          the artifact's baked config has effect)
                          body: JPEG/PNG bytes (or raw
                          `application/x-posenet-frame` uint8 RGB at the
                          artifact resolution)
                          reply: {"poses": [{"score", "keypoints":
                          [{"part", "y", "x", "score"}]}], "source_hw"}
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from posenet_tpu_torch.constants import PART_NAMES

_RAW_CONTENT_TYPE = "application/x-posenet-frame"
# The results a reply reads, fetched to the host once per chunk.
_FETCHED = ("pose_scores", "keypoint_scores", "keypoint_coords")


class ServerUnavailable(RuntimeError):
    """Transient server-side refusal (shutting down / overloaded / dead
    worker): the HTTP layer maps it to 503 so clients and load balancers
    retry instead of treating it as a caller bug."""


class _Request:
    """One enqueued frame and its reply slot."""

    __slots__ = ("frame", "scale_yx", "min_pose_score", "min_part_score",
                 "event", "result", "error")

    def __init__(self, frame: np.ndarray, scale_yx: Tuple[float, float],
                 min_pose_score: float, min_part_score: float):
        self.frame = frame
        self.scale_yx = scale_yx
        self.min_pose_score = min_pose_score
        self.min_part_score = min_part_score
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


def _enqueue_fetch(out):
    """Queue the copy of `out`'s replied fields to the host. Returns (event
    or None, host arrays or tensors) for `_wait_fetch`. CUDA results are
    copied into pinned memory behind the work already queued, and the
    event recorded after the copies is the one thing a fetch waits for."""
    tensors = [getattr(out, f) for f in _FETCHED]
    if tensors[0].device.type != "cuda":
        return None, tensors
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return done, host


def _wait_fetch(fetch) -> List[np.ndarray]:
    """The host arrays of an `_enqueue_fetch`, after its one wait."""
    done, host = fetch
    if done is not None:
        done.synchronize()
    return [np.asarray(t) for t in host]


class LivePipelineBackend:
    """The in-process fused pipeline behind the interface a ServingArtifact
    exposes (`__call__` / `input_hw` / `batch_sizes` / `meta` / `device`),
    so PoseServer can serve either. No export step: it serves the model's
    current weights, through K1 and K2 on the card (a quantized model
    through its int8 trunk and K1; the artifact refuses it).

    `num_devices=N` serves each batch over N devices, the pipeline's data
    partition: `devices` (N of them; a device may repeat), or else the
    first N devices of the model's type, which must exist (the cards, or
    the one CPU). N must divide every served batch size. None serves on the
    model's device without a mesh."""

    def __init__(self, model, *,
                 decode_cfg=None,
                 input_hw: Tuple[int, int] = (513, 513),
                 batch_sizes: Sequence[int] = (1, 8),
                 num_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        from posenet_tpu_torch.config import DecodeConfig
        from posenet_tpu_torch.parallel.mesh import make_mesh
        from posenet_tpu_torch.pipeline import PoseNetPipeline
        from posenet_tpu_torch.serving import _validate_input_hw

        if decode_cfg is None:
            decode_cfg = DecodeConfig(min_pose_score=0.25)
        _validate_input_hw(tuple(input_hw), model.cfg.output_stride)
        self.input_hw = tuple(int(v) for v in input_hw)
        self.batch_sizes = sorted(set(int(b) for b in batch_sizes))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise ValueError(f"bad batch_sizes {batch_sizes}")
        mesh = None
        if num_devices is not None or devices is not None:
            mesh = make_mesh(num_devices, devices=devices, device_type=model.device.type)
            n = len(mesh.devices)
            bad = [b for b in self.batch_sizes if b % n]
            if bad:
                raise ValueError(
                    f"num_devices={n} must divide every served "
                    f"batch size; got {bad}")
        self._pipe = PoseNetPipeline(model, decode_cfg, mesh=mesh)
        self.device = self._pipe.device
        self.meta = {
            "backend": "live-pipeline",
            "model_id": model.cfg.model_id,
            "output_stride": model.cfg.output_stride,
            "input_hw": list(self.input_hw),
            "batch_sizes": self.batch_sizes,
            "num_devices": 1 if mesh is None else len(mesh.devices),
            "decode": dataclasses.asdict(decode_cfg),
        }

    def __call__(self, frames):
        return self._pipe(frames)


class PoseServer:
    """Serving loop: backend + coalescing worker + HTTP frontend. The
    backend is a ServingArtifact, a LivePipelineBackend, or anything with
    their `__call__`, `input_hw`, `batch_sizes`, `meta` and `device`."""

    def __init__(self, artifact, *, min_part_score: float = 0.0,
                 batch_wait_ms: float = 2.0, queue_depth: int = 256,
                 pipeline_depth: int = 2):
        self.artifact = artifact
        self.input_hw = tuple(artifact.input_hw)
        self.batch_sizes = sorted(artifact.batch_sizes)
        self.device = torch.device(artifact.device)
        self.min_part_score = float(min_part_score)
        self.batch_wait_s = batch_wait_ms / 1000.0
        # 2: dispatch batch N+1 before fetching batch N's results, so the
        # device computes while the host coalesces and uploads. 1: fully
        # synchronous (dispatch, fetch, reply, repeat).
        self.pipeline_depth = 2 if int(pipeline_depth) >= 2 else 1
        # Flipped false if the device worker thread dies; /healthz reports
        # it and new enqueues are refused (they could never be answered).
        self.healthy = True
        # /statsz counters; worker-thread writes, reader copies (GIL-atomic
        # int/float updates, no lock needed).
        self.stats = {"requests_done": 0, "errors": 0,
                      "batches_by_size": {b: 0 for b in self.batch_sizes},
                      "device_ms_total": 0.0, "device_ms_last": 0.0}
        self._queue: "queue.Queue[_Request]" = queue.Queue(queue_depth)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="posenet-device-worker",
                                        daemon=True)
        self._worker.start()

    # ---- device worker ----

    def _drain(self, block: bool) -> List[_Request]:
        """Coalesce queued requests into one batch, bounded by the largest
        program. `block` (nothing in flight): wait as long as it takes for
        the first request. Otherwise (a chunk in flight) the first get is
        bounded by the window too, so the worker comes back to fetch the
        in-flight chunk instead of leaving its callers waiting; the wait
        overlaps device compute. Each arrival extends the window by
        batch_wait_ms; batch_wait_ms=0 takes only what is queued. Consuming
        the shutdown sentinel sets _stop and ends the batch."""
        batch: List[_Request] = []
        while len(batch) < self.batch_sizes[-1]:
            try:
                if block and not batch:
                    nxt = self._queue.get()
                elif self.batch_wait_s == 0:
                    nxt = self._queue.get_nowait()
                else:
                    nxt = self._queue.get(timeout=self.batch_wait_s)
            except queue.Empty:
                break
            if nxt is None:
                self._stop.set()
                break
            batch.append(nxt)
        return batch

    def _program_batch(self, n: int) -> int:
        """Smallest served batch size that covers n pending frames."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def _worker_loop(self):
        # Drain until the shutdown sentinel: requests accepted before
        # close() must still be answered, so the loop is not gated on
        # _stop. The top-level guard answers every request at risk if the
        # worker dies, and marks the server unhealthy.
        #
        # Pipelining (pipeline_depth=2): at most ONE chunk is
        # dispatched-but-unfetched at any time (`inflight`). The loop never
        # blocks on the queue while a chunk is in flight (its callers would
        # hang): it drains with a bounded wait and, when nothing came,
        # fetches the in-flight chunk instead. Every request stays reachable
        # by the handler until answered: in `pending` until its dispatch
        # returns, then in `inflight` until fetched.
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        pending: List[_Request] = []
        inflight = None  # (fetch, chunk, batch_size, t0)
        while True:
            try:
                pending = self._drain(block=inflight is None)
                if not pending:
                    if inflight is None:
                        return
                    self._finish_chunk(inflight)
                    inflight = None
                    if self._stop.is_set() and self._queue.empty():
                        return
                    continue
                # Largest served batch repeatedly, remainder padded up.
                while pending:
                    b = self._program_batch(len(pending))
                    nxt = self._dispatch_chunk(pending[:b], b)
                    if inflight is not None:
                        self._finish_chunk(inflight)
                    inflight = nxt  # None if the dispatch itself failed
                    pending = pending[b:]
                    if self.pipeline_depth == 1 and inflight is not None:
                        self._finish_chunk(inflight)
                        inflight = None
                # The sentinel can be consumed inside a drain's window (it
                # sets _stop and returns the batch); without this gate the
                # next blocking drain would wait forever.
                if self._stop.is_set():
                    if inflight is not None:
                        self._finish_chunk(inflight)
                        inflight = None
                    if self._queue.empty():
                        return
            except BaseException as e:  # noqa: BLE001 — sole worker
                self.healthy = False
                # Only requests not yet answered: _finish_chunk may have
                # delivered results before the raise.
                at_risk = list(inflight[1]) + pending if inflight else pending
                unanswered = [r for r in at_risk if not r.event.is_set()]
                self.stats["errors"] += len(unanswered)
                for req in unanswered:
                    req.error = f"device worker died: {type(e).__name__}: {e}"
                    req.event.set()
                raise

    def _dispatch_chunk(self, chunk: List[_Request], batch_size: int):
        """Build and queue one padded batch and the copy of its results;
        no wait. Returns the in-flight record for _finish_chunk, or None
        (callers already failed) if the dispatch itself raised."""
        t0 = time.perf_counter()
        try:
            frames = torch.empty((batch_size, *self.input_hw, 3), dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
            rows = frames.numpy()
            for i, req in enumerate(chunk):
                rows[i] = req.frame
            rows[len(chunk):] = 0
            fetch = _enqueue_fetch(self.artifact(frames))
        except Exception as e:  # propagate to every caller in the chunk
            self.stats["errors"] += len(chunk)
            for req in chunk:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            return None
        return (fetch, chunk, batch_size, t0)

    def _finish_chunk(self, inflight):
        """Wait for one dispatched chunk's results and reply to its
        callers. device_ms spans dispatch -> fetch complete, so under
        pipelining it includes host work overlapped with the NEXT chunk's
        dispatch."""
        fetch, chunk, batch_size, t0 = inflight
        try:
            pose_scores, kp_scores, kp_coords = _wait_fetch(fetch)
            results = [self._poses_json(pose_scores[i], kp_scores[i],
                                        kp_coords[i], req)
                       for i, req in enumerate(chunk)]
        except Exception as e:  # propagate to every caller in the chunk
            self.stats["errors"] += len(chunk)
            for req in chunk:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            return
        ms = (time.perf_counter() - t0) * 1000.0
        self.stats["batches_by_size"][batch_size] += 1
        self.stats["device_ms_total"] += ms
        self.stats["device_ms_last"] = ms
        self.stats["requests_done"] += len(chunk)
        for req, result in zip(chunk, results):
            req.result = result
            req.event.set()

    def _poses_json(self, pose_scores, kp_scores, kp_coords, req: _Request):
        poses = []
        for p in range(pose_scores.shape[0]):
            # per-request thresholds are post-filters, sound because they
            # can only be stricter than the artifact's baked decode config
            if pose_scores[p] <= 0 or pose_scores[p] < req.min_pose_score:
                continue
            kps = [{"part": PART_NAMES[k],
                    "y": float(kp_coords[p, k, 0] * req.scale_yx[0]),
                    "x": float(kp_coords[p, k, 1] * req.scale_yx[1]),
                    "score": float(kp_scores[p, k])}
                   for k in range(kp_scores.shape[1])
                   if kp_scores[p, k] >= req.min_part_score]
            poses.append({"score": float(pose_scores[p]), "keypoints": kps})
        return poses

    # ---- request-thread API ----

    def decode_frame(self, frame: np.ndarray,
                     scale_yx: Tuple[float, float] = (1.0, 1.0),
                     timeout_s: float = 120.0,
                     min_pose_score: float = 0.0,
                     min_part_score: Optional[float] = None):
        """Enqueue one preprocessed (H, W, 3) uint8 RGB frame; block for
        the decoded poses. Thread-safe. Per-call thresholds post-filter
        the artifact's results (only stricter values have any effect)."""
        if frame.shape != (*self.input_hw, 3) or frame.dtype != np.uint8:
            raise ValueError(
                f"frame must be uint8 {(*self.input_hw, 3)}, got "
                f"{frame.dtype} {frame.shape}")
        if self._stop.is_set() or not self.healthy:
            raise ServerUnavailable(
                "server is shutting down" if self._stop.is_set()
                else "device worker died; server is unhealthy")
        req = _Request(frame, scale_yx, float(min_pose_score),
                       self.min_part_score if min_part_score is None
                       else float(min_part_score))
        try:
            self._queue.put(req, timeout=5.0)
        except queue.Full:
            raise ServerUnavailable(
                "request queue full (server overloaded)") from None
        if not req.event.wait(timeout_s):
            raise TimeoutError("decode timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def warmup(self):
        """Run every served batch size once and wait for it, so that no
        request pays a first call (the kernels build at first use). Called
        before the HTTP frontend binds, while the worker is idle."""
        for b in self.batch_sizes:
            out = self.artifact(torch.zeros((b, *self.input_hw, 3), dtype=torch.uint8))
            _wait_fetch(_enqueue_fetch(out))

    def decode_image_bytes(self, data: bytes, content_type: str = "",
                           **thresholds):
        """Decode an encoded image (JPEG/PNG) or a raw frame; returns
        (poses, source_hw). `thresholds` forwards per-request
        min_pose_score/min_part_score to decode_frame."""
        th, tw = self.input_hw
        if content_type == _RAW_CONTENT_TYPE:
            frame = np.frombuffer(data, np.uint8)
            if frame.size != th * tw * 3:
                raise ValueError(
                    f"raw frame must be {th}x{tw}x3={th * tw * 3} bytes, "
                    f"got {frame.size}")
            return (self.decode_frame(frame.reshape(th, tw, 3),
                                      **thresholds), [th, tw])
        import cv2
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("could not decode image bytes (JPEG/PNG?)")
        sh, sw = bgr.shape[:2]
        from posenet_tpu_torch import native_preprocess as npp
        frame = npp.resize_rgb(bgr, (th, tw))
        poses = self.decode_frame(frame, scale_yx=(sh / th, sw / tw),
                                  **thresholds)
        return poses, [sh, sw]

    def close(self):
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout=10.0)


def make_http_server(pose_server: PoseServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind the HTTP frontend (serve_forever is the caller's loop)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                ok = pose_server.healthy
                self._reply(200 if ok else 503,
                            {"ok": ok,
                             "artifact": pose_server.artifact.meta})
            elif self.path == "/statsz":
                s = dict(pose_server.stats)
                s["batches_by_size"] = {
                    str(k): v for k, v in s["batches_by_size"].items()}
                self._reply(200, s)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            from urllib.parse import parse_qsl, urlsplit

            url = urlsplit(self.path)
            if url.path != "/v1/decode":
                self._reply(404, {"error": f"no route {url.path}"})
                return
            try:
                thresholds = {}
                for key, val in parse_qsl(url.query):
                    if key not in ("min_pose_score", "min_part_score"):
                        raise ValueError(f"unknown query param '{key}'")
                    thresholds[key] = float(val)
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    raise ValueError("empty body (send image bytes)")
                if n > 64 << 20:
                    raise ValueError(
                        f"body too large ({n} bytes; limit 64 MiB)")
                data = self.rfile.read(n)
                poses, source_hw = pose_server.decode_image_bytes(
                    data, self.headers.get("Content-Type", ""),
                    **thresholds)
                self._reply(200, {"poses": poses, "source_hw": source_hw})
            except ValueError as e:
                # the body may not have been consumed (e.g. oversized):
                # close instead of letting keep-alive desync on it
                self.close_connection = True
                self._reply(400, {"error": str(e)})
            except TimeoutError as e:
                # server-side stall (device hang / overload), NOT a
                # caller bug: 504 so clients and load balancers retry
                self.close_connection = True
                self._reply(504, {"error": str(e)})
            except ServerUnavailable as e:
                self.close_connection = True
                self._reply(503, {"error": str(e)})
            except Exception as e:
                self.close_connection = True
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet by default
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's listen backlog of 5 resets connections when more
        # clients than that connect at once (tools/serve_loadgen.py with 32
        # clients against a CPU server: 14 of 159 requests reset); a
        # backlog the size of the request queue keeps them waiting instead.
        request_queue_size = 256

    return Server((host, port), Handler)


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    from posenet_tpu_torch.serving import load_serving_artifact

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact",
                   help="*.posenet artifact from posenet-export-torch "
                        "(mutually exclusive with --model)")
    p.add_argument("--model", type=int, choices=(50, 75, 100, 101),
                   help="LIVE mode: serve the in-process fused pipeline "
                        "for this model id instead of an artifact (no "
                        "export step; see LivePipelineBackend)")
    p.add_argument("--output_stride", type=int, default=16,
                   help="live mode: model output stride")
    p.add_argument("--size", type=int, nargs=2, default=(513, 513),
                   metavar=("H", "W"),
                   help="live mode: stride-valid input resolution")
    p.add_argument("--batch_sizes", type=str, default="1,8",
                   help="live mode: comma-separated served batch programs")
    p.add_argument("--min_pose_score", type=float, default=0.25,
                   help="live mode: decode min pose score")
    p.add_argument("--num_devices", type=int, default=None,
                   help="live mode: serve each batch over the first N cards "
                        "(data partition; N must divide every batch size)")
    p.add_argument("--allow_random_init", action="store_true",
                   help="live mode: random weights if the checkpoint is missing")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--min_part_score", type=float, default=0.0)
    p.add_argument("--batch_wait_ms", type=float, default=2.0,
                   help="coalescing window after the first queued request")
    p.add_argument("--pipeline_depth", type=int, default=2, choices=(1, 2),
                   help="2 (default): dispatch the next batch before "
                        "fetching the in-flight one, overlapping device "
                        "compute with host coalescing + upload; 1: fully "
                        "synchronous batches")
    args = p.parse_args(argv)

    if bool(args.artifact) == bool(args.model):
        p.error("exactly one of --artifact or --model is required")
    if args.model:
        from posenet_tpu_torch.config import DecodeConfig
        from posenet_tpu_torch.models import load_model

        model = load_model(args.model, output_stride=args.output_stride,
                           allow_random_init=args.allow_random_init)   # on the card
        artifact = LivePipelineBackend(
            model,
            decode_cfg=DecodeConfig(min_pose_score=args.min_pose_score),
            input_hw=tuple(args.size),
            batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
            num_devices=args.num_devices)
        source = f"live model {args.model} s{args.output_stride}"
    else:
        artifact = load_serving_artifact(args.artifact)
        source = args.artifact
    pose_server = PoseServer(artifact,
                             min_part_score=args.min_part_score,
                             batch_wait_ms=args.batch_wait_ms,
                             pipeline_depth=args.pipeline_depth)
    print("posenet-serve-torch: warming programs for batches "
          f"{pose_server.batch_sizes} ...")
    pose_server.warmup()
    httpd = make_http_server(pose_server, args.host, args.port)
    print(f"posenet-serve-torch: {args.host}:{httpd.server_address[1]} "
          f"serving={source} batches={pose_server.batch_sizes}")

    # Graceful SIGTERM (the container-orchestrator stop signal): finish
    # in-flight batches, refuse new connections, exit 0.
    import signal

    def _term(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        pose_server.close()


if __name__ == "__main__":
    main()
