"""Serving: shape-bucketed request batching over one device, an HTTP front
end and its CLI; counterpart of mapanything_tpu/serve.py and
scripts/serve.py.

`BatchingEngine` owns the device: callers `submit()` scenes (lists of
preprocessed view dicts) and get a Future. One worker thread groups
compatible scenes (same view count, image shape, modality set and request
flags) into one batched `InferencePipeline.infer`, pads the batch up to a
"nice" size (1/2/4/8) by replicating the last scene, so the set of batch
shapes stays bounded, then copies each response key to the host once and
splits the scenes in numpy. Only the worker touches the device; an error
fails every future of its group and the worker keeps serving.

`InferenceServer` is a stdlib ThreadingHTTPServer speaking numpy npz. Its
threads decode requests and preprocess them (numpy and PIL) and wait on
their future:

    POST /v1/infer   body: .npz with "images" (V, H, W, 3) float in [0, 1]
                     or uint8, optional "intrinsics" (V, 3, 3), "depth_z"
                     (V, H, W), "camera_poses" (V, 4, 4), "is_metric_scale"
                     (V,); query parameters set the request flags
                     (?task=mvs&apply_confidence_mask=1).
                     response: .npz of the per-view outputs stacked on V
                     (pts3d (V, H, W, 3), depth_z, conf, mask, intrinsics,
                     camera_poses, ...).
                     400: a body that does not decode or validate; 500:
                     the engine failed the scene; 503: no result within
                     the request timeout (a scene not dispatched yet is
                     dropped).
    GET  /healthz    200 once the warm-up call has finished, 503 before.
    GET  /v1/stats   JSON counters (requests, batched calls, buckets).

CLI (the card unless --device says otherwise; seeded random weights
without --checkpoint):

    python -m mapanything_tpu_torch.serve --port 8000 --checkpoint FILE \\
        --resolution-set 518 --max-batch 4

    # client
    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.savez(buf, images=imgs)  # (V, H, W, 3) in [0, 1]
    req = urllib.request.Request(
        "http://127.0.0.1:8000/v1/infer?apply_confidence_mask=1",
        data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        out = dict(np.load(io.BytesIO(r.read())))
    out["pts3d"]  # (V, H, W, 3)
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import io
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .data.image import find_closest_aspect_ratio, preprocess_inputs
from .models import MapAnything, MapAnythingConfig
from .models.pretrained import from_pretrained
from .utils.device import resolve_device
from .utils.inference import InferencePipeline

log = logging.getLogger(__name__)

# infer() flags a request may set; everything else is fixed at engine
# construction so it cannot fragment the batches
_REQUEST_FLAGS = (
    "apply_mask",
    "mask_edges",
    "apply_confidence_mask",
    "confidence_percentile",
    "task",
    "memory_efficient_inference",
)

# per-view outputs shipped to clients (each costs one device-to-host copy
# per batched call; the pointmaps dominate)
_RESPONSE_KEYS = (
    "pts3d",
    "pts3d_cam",
    "depth_z",
    "conf",
    "mask",
    "non_ambiguous_mask",
    "intrinsics",
    "camera_poses",
    "metric_scaling_factor",
)

# batch sizes the engine pads a group up to (with max_batch): the set of
# batch shapes per bucket
_NICE_BATCHES = (1, 2, 4, 8)

# how long an HTTP request waits for its scene before it answers 503
_REQUEST_TIMEOUT_S = 600.0


@dataclass
class ServeStats:
    requests: int = 0
    batched_calls: int = 0
    scenes_padded: int = 0
    errors: int = 0
    buckets: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "batched_calls": self.batched_calls,
            "scenes_padded": self.scenes_padded,
            "errors": self.errors,
            "buckets": dict(self.buckets),
        }


class _Request:
    __slots__ = ("views", "flags", "future", "key")

    def __init__(self, views, flags, future, key):
        self.views = views
        self.flags = flags
        self.future = future
        self.key = key


def _scene_key(views: List[Dict[str, Any]], flags: Dict[str, Any]):
    """Batchability key: view count, image shape, per-view modalities and
    flags."""
    mods = tuple(
        tuple(sorted(
            k for k in v
            if k in ("intrinsics", "ray_directions", "depth_z",
                     "camera_poses", "is_metric_scale")
        ))
        for v in views
    )
    img = np.asarray(views[0]["img"])
    return (len(views), img.shape, mods, tuple(sorted(flags.items())))


def merge_scenes(scenes: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Scenes of one key as one batch: each view's arrays concatenated
    along the batch axis, its list metadata (true_shape, idx, instance)
    joined, data_norm_type taken from the first scene."""
    merged = []
    for j, v0 in enumerate(scenes[0]):
        view = {}
        for k, x0 in v0.items():
            if k == "data_norm_type":
                view[k] = x0
            elif isinstance(x0, list):
                view[k] = sum((list(s[j][k]) for s in scenes), [])
            else:
                view[k] = np.concatenate([np.asarray(s[j][k])
                                          for s in scenes], axis=0)
        merged.append(view)
    return merged


def split_outputs(out_views: List[Dict[str, torch.Tensor]],
                  n_scenes: int) -> List[List[Dict[str, np.ndarray]]]:
    """The first `n_scenes` scenes of a batched infer result as numpy, one
    dict per view. Each response key moves to the host in one copy (all
    views stacked); the scenes are then split in numpy."""
    keys = [k for k in _RESPONSE_KEYS if k in out_views[0]]
    host = {}
    for k in keys:
        host[k] = torch.stack([ov[k] for ov in out_views],
                              dim=1).cpu().numpy()  # (B, V, ...)
    return [[{k: np.asarray(host[k][i, j]) for k in keys}
             for j in range(len(out_views))] for i in range(n_scenes)]


class BatchingEngine:
    """Device-owner thread batching compatible scenes into one forward.

    Args:
        pipeline: `utils.inference.InferencePipeline` (the model and its
            device).
        max_batch: largest scene count merged into one forward. The CUDA
            kernels' grid takes batch x heads < 2**16 per attention call
            (ops/flash_attention.py::_check_kernel_args): the encoder runs
            max_batch x views images of 16 heads each, so max_batch x
            views must stay under 4096 (8 scenes of 100 views: 800 x 16 =
            12,800, inside).
        max_wait_ms: how long the head-of-line request waits for company
            before dispatching (latency against throughput).

    A group pads up to the next of `nice_batches` (_NICE_BATCHES up to
    max_batch, and max_batch) by replicating its last scene.
    """

    def __init__(self, pipeline: InferencePipeline, max_batch: int = 4,
                 max_wait_ms: float = 10.0):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.nice_batches = tuple(sorted(
            {b for b in _NICE_BATCHES if b <= max_batch} | {max_batch}))
        self.stats = ServeStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "BatchingEngine":
        """Build the CUDA kernels the forward launches (a build failure
        raises here, not in the first request), then start the worker."""
        if self._thread is not None:
            raise RuntimeError("the serving engine was started already")
        device = next(self.pipeline.model.parameters()).device
        if device.type == "cuda":
            from .ops._build import build_library

            build_library("flash_attn_fwd")
        self._thread = threading.Thread(target=self._worker,
                                        name="serve-device-owner",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker; requests it has not dispatched fail with
        RuntimeError."""
        with self._lock:
            self._stop.set()
        self._q.put(None)  # wake the worker
        if self._thread is not None:
            self._thread.join(timeout)
        else:
            self._fail_pending(collections.deque())

    # -- client API --------------------------------------------------------
    def submit(self, views: List[Dict[str, Any]],
               **flags) -> concurrent.futures.Future:
        """Enqueue one scene (a list of per-view dicts, as
        data/image.py::preprocess_inputs returns them); returns a Future of
        its per-view output dicts (numpy). Scenes queued before start() are
        grouped by the worker's first rounds; a future cancelled before its
        group is dispatched never runs."""
        unknown = set(flags) - set(_REQUEST_FLAGS)
        if unknown:
            raise ValueError(f"unknown request flags {sorted(unknown)}; "
                             f"allowed: {_REQUEST_FLAGS}")
        fut = concurrent.futures.Future()
        req = _Request(views, flags, fut, _scene_key(views, flags))
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("the serving engine is stopped")
            self.stats.requests += 1
            self._q.put(req)
        return fut

    def stats_dict(self) -> Dict[str, Any]:
        """A consistent copy of the counters."""
        with self._lock:
            return self.stats.as_dict()

    def infer(self, views: List[Dict[str, Any]],
              timeout: Optional[float] = None, **flags):
        """submit() and wait at most `timeout` seconds for the result."""
        return self.submit(views, **flags).result(timeout)

    # -- device owner ------------------------------------------------------
    def _worker(self) -> None:
        # A request of another key than the group's head waits in `spilled`
        # and heads the very next round: re-queuing it at the tail would let
        # a steady stream of one key starve a rarer one.
        spilled: collections.deque = collections.deque()
        while not self._stop.is_set():
            if spilled:
                head = spilled.popleft()
            else:
                try:
                    head = self._q.get(timeout=0.25)
                except queue.Empty:
                    continue
                if head is None:
                    continue
            group = [head]
            deadline = time.monotonic() + self.max_wait_s
            for req in [r for r in spilled if r.key == head.key][
                    :self.max_batch - 1]:
                spilled.remove(req)
                group.append(req)
            while len(group) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is not None:
                    (group if nxt.key == head.key else spilled).append(nxt)
            self._dispatch(group)
        self._fail_pending(spilled)

    def _fail_pending(self, spilled: collections.deque) -> None:
        with self._lock:
            pending = list(spilled)
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    pending.append(req)
        for req in pending:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    RuntimeError("the serving engine stopped"))

    def _dispatch(self, group: List[_Request]) -> None:
        # drop the scenes whose client gave up; the rest can no longer be
        # cancelled
        group = [r for r in group if r.future.set_running_or_notify_cancel()]
        if not group:
            return
        try:
            n_real = len(group)
            n_nice = next(b for b in self.nice_batches if b >= n_real)
            padded = group + [group[-1]] * (n_nice - n_real)
            out_views = self.pipeline.infer(
                merge_scenes([r.views for r in padded]),
                **dict(group[0].flags))
            results = split_outputs(out_views, n_real)
            with self._lock:
                self.stats.batched_calls += 1
                self.stats.scenes_padded += n_nice - n_real
                bkey = str(group[0].key[:2])
                self.stats.buckets[bkey] = self.stats.buckets.get(bkey, 0) + 1
            for req, res in zip(group, results):
                req.future.set_result(res)
        except Exception as e:  # noqa: BLE001 — serving must not die
            log.exception("batched call of %d scenes failed", len(group))
            with self._lock:
                self.stats.errors += 1
            for req in group:
                if not req.future.done():
                    req.future.set_exception(e)


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

def _views_from_npz(arrays: Dict[str, np.ndarray],
                    resolution_set: int) -> List[Dict[str, Any]]:
    """Decode a client npz into preprocessed per-view dicts (bucketed,
    DINOv2-normalised) through data/image.py::preprocess_inputs. Arrays of
    the wrong shape raise ValueError here, before the engine sees them."""
    if "images" not in arrays:
        raise ValueError("npz must contain 'images' (V, H, W, 3)")
    imgs = np.asarray(arrays["images"])
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"'images' must be (V, H, W, 3), got {imgs.shape}")
    v, h, w = imgs.shape[:3]
    allowed = {"intrinsics": [(v, 3, 3)],
               "depth_z": [(v, h, w), (v, h, w, 1)],
               "camera_poses": [(v, 4, 4)], "is_metric_scale": [(v,)]}
    for key, shapes in allowed.items():
        if key in arrays and np.shape(arrays[key]) not in shapes:
            raise ValueError(f"'{key}' must be of shape "
                             f"{' or '.join(map(str, shapes))}, got "
                             f"{np.shape(arrays[key])}")
    raw_views = []
    for i in range(imgs.shape[0]):
        view: Dict[str, Any] = {"img": imgs[i]}
        for key in ("intrinsics", "depth_z", "camera_poses"):
            if key in arrays:
                view[key] = np.asarray(arrays[key])[i]
        if "is_metric_scale" in arrays:
            view["is_metric_scale"] = bool(
                np.asarray(arrays["is_metric_scale"])[i])
        raw_views.append(view)
    return preprocess_inputs(raw_views, resolution_set=resolution_set)


def _flags_from_query(query: str) -> Dict[str, Any]:
    """The request flags of a URL query string: task as text,
    confidence_percentile as a float, the rest as booleans."""
    from urllib.parse import parse_qs

    qs = {k: vs[-1] for k, vs in parse_qs(query).items()}
    flags: Dict[str, Any] = {}
    for k in _REQUEST_FLAGS:
        if k not in qs:
            continue
        if k == "task":
            flags[k] = qs[k]
        elif k == "confidence_percentile":
            flags[k] = float(qs[k])
        else:
            flags[k] = qs[k].lower() in ("1", "true", "yes")
    return flags


def _npz_bytes(per_view: List[Dict[str, np.ndarray]]) -> bytes:
    """Stack per-view outputs along a leading V axis and serialise."""
    out = {k: np.stack([np.asarray(v[k]) for v in per_view], axis=0)
           for k in per_view[0]}
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


class InferenceServer:
    """stdlib HTTP front end over a BatchingEngine."""

    def __init__(self, engine: BatchingEngine, host: str = "127.0.0.1",
                 port: int = 8000, resolution_set: int = 518):
        self.engine = engine
        self.host = host
        self.port = port
        self.resolution_set = resolution_set
        self._httpd = None
        self._thread = None
        self.ready = threading.Event()

    def warmup(self, num_views: int = 2) -> None:
        """Run the most common signature once before taking traffic: the
        resolution set's square bucket, images only."""
        w, h = find_closest_aspect_ratio(1.0, self.resolution_set)
        views = preprocess_inputs(
            [{"img": np.zeros((h, w, 3), np.float32)}
             for _ in range(num_views)],
            resolution_set=self.resolution_set)
        self.engine.infer(views, timeout=_REQUEST_TIMEOUT_S)
        self.ready.set()

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup_views: int = 0) -> "InferenceServer":
        """Bind (port 0 resolves to a free port, stored in `port`), serve,
        then warm up with `warmup_views` views (0: none); /healthz reads
        503 until the warm-up has finished."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import urlparse

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no access log on stderr
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    ok = server.ready.is_set()
                    self._json(200 if ok else 503, {"ok": ok})
                elif self.path == "/v1/stats":
                    self._json(200, server.engine.stats_dict())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                parsed = urlparse(self.path)
                if parsed.path != "/v1/infer":
                    self._json(404, {"error": "not found"})
                    return
                try:  # the client's part: decode and validate
                    length = int(self.headers.get("Content-Length", "0"))
                    arrays = dict(np.load(io.BytesIO(self.rfile.read(length)),
                                          allow_pickle=False))
                    flags = _flags_from_query(parsed.query)
                    views = _views_from_npz(arrays, server.resolution_set)
                except Exception as e:  # noqa: BLE001 — answer, keep serving
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:  # the server's part
                    future = server.engine.submit(views, **flags)
                    body = _npz_bytes(
                        future.result(timeout=_REQUEST_TIMEOUT_S))
                except concurrent.futures.TimeoutError:
                    future.cancel()  # not dispatched yet: it never runs
                    self._json(503, {"error": f"no result within "
                                              f"{_REQUEST_TIMEOUT_S} s"})
                    return
                except Exception as e:  # noqa: BLE001 — answer, keep serving
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        try:
            if warmup_views:
                self.warmup(warmup_views)
            else:
                self.ready.set()
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mapanything_tpu_torch.serve",
        description="Serve MapAnything over HTTP with request batching.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--checkpoint", default=None,
                   help="a file of train/checkpoints.py (save_params or "
                        "save_train_state); seeded random weights if "
                        "omitted (smoke mode)")
    p.add_argument("--resolution-set", type=int, default=518,
                   choices=(518, 512))
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--warmup-views", type=int, default=2,
                   help="run the common signature once before serving "
                        "(0 disables)")
    p.add_argument("--fp32", action="store_true",
                   help="compute in float32 (default: bfloat16)")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) when omitted")
    return p


def build_server(argv: Optional[List[str]] = None,
                 config_overrides: Optional[Dict[str, Any]] = None):
    """The CLI's composition: parse `argv`, load the checkpoint (or seed the
    model), start the engine and the server (warm-up included). Returns
    (engine, server), both running; the caller stops them.

    `config_overrides` are MapAnythingConfig fields of the served
    architecture (the released one when None; the checkpoint files store
    no config)."""
    args = _parser().parse_args(argv)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.checkpoint:
        t0 = time.perf_counter()
        model = from_pretrained(args.checkpoint, dtype, config_overrides,
                                args.device)
        print(f"loaded checkpoint {args.checkpoint} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    else:
        cfg = MapAnythingConfig(dtype=dtype, **dict(config_overrides or {}))
        device = resolve_device(args.device)
        model = MapAnything(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0)).eval()
        print("WARNING: random weights (no --checkpoint) — smoke mode",
              flush=True)
    engine = BatchingEngine(InferencePipeline(model),
                            max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms).start()
    try:
        server = InferenceServer(
            engine, host=args.host, port=args.port,
            resolution_set=args.resolution_set,
        ).start(warmup_views=args.warmup_views)
    except BaseException:
        engine.stop()
        raise
    return engine, server


def main(argv: Optional[List[str]] = None) -> None:
    engine, server = build_server(argv)
    print(f"serving on http://{server.host}:{server.port} "
          f"(POST /v1/infer, GET /healthz, GET /v1/stats)", flush=True)
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        engine.stop()


if __name__ == "__main__":
    main()
