"""The port's serving path (mapanything_tpu_torch/serve.py and
models/pretrained.py) on the CPU.

The engine's result per scene is held against the JAX package's
`InferencePipeline.infer` on the same raw scene, each side preprocessed by
its own data/image.py::preprocess_inputs (bit-equal:
tests/test_torch_image.py),
at the tiny config of tests/test_serve.py with JAX's init (on views carrying
every prior) perturbed by seeded numpy noise, converted with
utils/weights.py::from_jax_params; fp32 both sides, JAX under
`jax.default_matmul_precision("highest")`. Tolerance: 1e-4 of max(1, the
reference's largest magnitude) per output; boolean masks agree on >= 99.9%
of the pixels. Batched against solo calls of the same engine: 1e-5.

A tiny resolution set (42) is patched into both packages' bucket tables so
the preprocessing keeps the scenes small. Scenes whose grouping a test
counts are queued before the engine starts; every future and every HTTP
call has a timeout; servers bind 127.0.0.1:0 and stop in teardown.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.data import image as JImage
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.utils.inference import InferencePipeline as JaxPipeline
from mapanything_tpu_torch import serve
from mapanything_tpu_torch.data import image as PImage
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.pretrained import from_pretrained
from mapanything_tpu_torch.serve import BatchingEngine, InferenceServer
from mapanything_tpu_torch.train import (
    OptimConfig,
    create_train_state,
    save_params,
    save_train_state,
)
from mapanything_tpu_torch.utils.inference import InferencePipeline
from mapanything_tpu_torch.utils.weights import (
    load_jax_params,
    write_safetensors,
)
from torch_jax_init import init_params
from torch_reference_layout import reference_state_dict

TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8),
            dense_head_chunk=2)
H, W = 28, 42
SET = 42  # the tiny resolution set: (W, H) by aspect ratio
TABLE = {1.5: (42, 28), 1.0: (28, 28), 0.667: (28, 42)}
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def tiny_buckets():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JImage, PImage):
            mp.setitem(mod.RESOLUTION_MAPPINGS, SET, TABLE)
        yield


@pytest.fixture(scope="module")
def models():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), init_params(jax_model, H, W))
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                    device="cpu"), params).eval()
    return JaxPipeline(jax_model, params), InferencePipeline(port)


@pytest.fixture(scope="module")
def engine(models):
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=50.0).start()
    yield eng
    eng.stop()


def _raw_scene(seed, w=90, h=60, views=2, intrinsics=False, depth=False,
               metric=None):
    """Raw client views: uint8 images of (w, h), optional pinhole
    intrinsics off the centre, z-depth and metric flags."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(views):
        view = {"img": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)}
        if intrinsics:
            f = rng.uniform(0.8, 1.2) * w
            view["intrinsics"] = np.array(
                [[f, 0, w * rng.uniform(0.4, 0.6)],
                 [0, f, h * rng.uniform(0.4, 0.6)], [0, 0, 1]], np.float32)
        if depth:
            view["depth_z"] = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
        if metric is not None:
            view["is_metric_scale"] = metric
        raw.append(view)
    return raw


def _scene(seed, **kw):
    return PImage.preprocess_inputs(_raw_scene(seed, **kw),
                                    resolution_set=SET)


def _close(out, ref, tol=1e-4, name=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert np.isfinite(out).all(), name
    err = np.max(np.abs(out - ref))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def _compare(result, ref, tol):
    """A scene's per-view numpy outputs against per-view references (numpy
    or torch (1, ...) tensors from a solo infer)."""
    assert len(result) == len(ref)
    for got, want in zip(result, ref):
        assert set(got) == set(serve._RESPONSE_KEYS) & set(want)
        for key, val in got.items():
            w = want[key]
            w = (w[0].numpy() if isinstance(w, torch.Tensor)
                 else np.asarray(w)[0])
            if w.dtype == bool:
                agree = np.mean(val == w)
                assert agree >= 0.999, f"{key} agreement {agree}"
            else:
                _close(val, w, tol, key)


# --- the engine against JAX --------------------------------------------------

CASES = {
    "images_only": dict(w=90, h=60),
    "intrinsics_depth": dict(w=90, h=60, intrinsics=True, depth=True),
    "portrait_bucket": dict(w=62, h=90),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(models, engine, case):
    raw = _raw_scene(40 + len(case), **CASES[case])
    views = PImage.preprocess_inputs(raw, resolution_set=SET)
    assert views[0]["img"].shape[1:3] == JImage.find_closest_aspect_ratio(
        raw[0]["img"].shape[1] / raw[0]["img"].shape[0], SET)[::-1]
    with jax.default_matmul_precision("highest"):
        ref = models[0].infer(
            JImage.preprocess_inputs(raw, resolution_set=SET),
            apply_confidence_mask=True)
    got = engine.infer(views, timeout=TIMEOUT, apply_confidence_mask=True)
    _compare(got, ref, 1e-4)


# --- batching ----------------------------------------------------------------

def test_queued_scenes_make_one_batched_call(models):
    scenes = [_scene(i) for i in range(4)]
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=50.0)
    futs = [eng.submit(s) for s in scenes]
    eng.start()
    try:
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        assert eng.stats_dict()["batched_calls"] == 1
        assert eng.stats.scenes_padded == 0
        for scene, out in zip(scenes, outs):
            _compare(out, models[1].infer(scene), 1e-5)
        assert not np.allclose(outs[0][0]["pts3d"], outs[1][0]["pts3d"])
    finally:
        eng.stop()


KINDS = {
    "flags": (dict(), dict(flags={"apply_confidence_mask": True})),
    "metric_scale": (dict(), dict(metric=True)),
    "shape": (dict(), dict(w=60, h=60)),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_distinct_keys_never_merge(models, kind):
    """Two scenes of each of two keys, interleaved and queued before the
    start: two batched calls of two scenes, each scene its solo result."""
    a, b = KINDS[kind]
    reqs = []
    for i in range(4):
        kw = dict(a if i % 2 == 0 else b)
        flags = kw.pop("flags", {})
        reqs.append((_scene(60 + i, **kw), flags))
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=50.0)
    futs = [eng.submit(s, **f) for s, f in reqs]
    eng.start()
    try:
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        stats = eng.stats_dict()
        assert stats["batched_calls"] == 2 and stats["scenes_padded"] == 0
        for (scene, flags), out in zip(reqs, outs):
            _compare(out, models[1].infer(scene, **flags), 1e-5)
    finally:
        eng.stop()


def test_nice_batch_padding(models):
    """Three scenes pad to the nice batch of four with the last scene."""
    scenes = [_scene(70 + i) for i in range(3)]
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=50.0)
    assert eng.nice_batches == (1, 2, 4)
    futs = [eng.submit(s) for s in scenes]
    eng.start()
    try:
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        stats = eng.stats_dict()
        assert stats["batched_calls"] == 1 and stats["scenes_padded"] == 1
        _compare(outs[2], models[1].infer(scenes[2]), 1e-5)
    finally:
        eng.stop()


def test_concurrent_submitters_get_their_own_scenes(models):
    """16 threads submit 2 scenes each while the worker runs, with the
    interpreter switching threads every 10 us: every request is counted
    once and every scene gets its own solo result back."""
    import sys

    scenes = [_scene(140 + i) for i in range(8)]
    solo = [models[1].infer(s) for s in scenes]
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=5.0).start()
    got, errors = {}, []

    def client(t):
        try:
            for i in (t % 8, (t + 3) % 8):
                got[(t, i)] = eng.submit(scenes[i]).result(timeout=TIMEOUT)
        except Exception as e:  # noqa: BLE001 — collected and asserted
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        eng.stop()
    assert not errors, errors
    assert len(got) == 32
    stats = eng.stats_dict()
    assert stats["requests"] == 32 and stats["errors"] == 0
    assert 8 <= stats["batched_calls"] <= 32
    for (_, i), out in got.items():
        _compare(out, solo[i], 1e-5)


def test_unknown_flag_raises(engine):
    with pytest.raises(ValueError, match="unknown request flags"):
        engine.submit(_scene(80), bogus=True)


def test_error_fails_only_its_group(models):
    bad = [{k: v for k, v in view.items() if k != "data_norm_type"}
           for view in _scene(81)]  # fails infer's validation
    good = _scene(82, w=60, h=60)  # another key: another group
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=50.0)
    f_bad = [eng.submit(bad), eng.submit(bad)]
    f_good = eng.submit(good)
    eng.start()
    try:
        for f in f_bad:
            with pytest.raises(ValueError, match="data_norm_type"):
                f.result(timeout=TIMEOUT)
        _compare(f_good.result(timeout=TIMEOUT), models[1].infer(good), 1e-5)
        assert eng.stats_dict()["errors"] == 1
        later = eng.infer(_scene(83), timeout=TIMEOUT)
        assert np.isfinite(later[0]["pts3d"]).all()
        assert eng.stats_dict()["errors"] == 1
    finally:
        eng.stop()


def test_engine_has_one_device_owner(models):
    eng = BatchingEngine(models[1]).start()
    try:
        with pytest.raises(RuntimeError, match="started already"):
            eng.start()
    finally:
        eng.stop()


def test_stop_fails_what_was_not_dispatched(models):
    eng = BatchingEngine(models[1])
    fut = eng.submit(_scene(84))
    eng.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(_scene(84))


def test_serving_shapes_are_what_the_engine_launches(models, monkeypatch):
    """The attention shapes batched and non-square scenes give the forward
    (B, tokens, n_valid), which chip_smoke.py phase 9a holds the CUDA kernel
    to: the tiny model pads its tokens to 128 as the released one does, so
    they do not depend on the width."""
    import chip_smoke
    from mapanything_tpu_torch.ops import flash_attention as fa

    seen = set()
    plain = fa.flash_attention_plain

    def record(q, k, v, n_valid=None):
        seen.add((q.shape[0], q.shape[1], n_valid))
        return plain(q, k, v, n_valid)

    monkeypatch.setattr(fa, "flash_attention_plain", record)
    eng = BatchingEngine(models[1], max_batch=4, max_wait_ms=50.0)
    cases = [  # (scenes, views, raw W, raw H): the shapes they launch
        (4, 2, 640, 480, {(8, 1152, 1037), (8, 1036, None), (4, 2176, 2073)}),
        (1, 2, 1036, 336, {(2, 512, 445), (2, 444, None), (1, 896, 889)}),
        (1, 4, 640, 480, {(4, 1152, 1037), (4, 1036, None), (1, 4224, 4145)}),
    ]
    launched = set()
    try:
        for case, (n, views, w, h, want) in enumerate(cases):
            scenes = [PImage.preprocess_inputs(  # the 518 set
                _raw_scene(130 + i, w=w, h=h, views=views)) for i in range(n)]
            seen.clear()
            futs = [eng.submit(s) for s in scenes]
            if case == 0:  # the first case's scenes make one batch
                eng.start()
            for f in futs:
                f.result(timeout=TIMEOUT)
            assert seen == want, (w, h, n, views)
            launched |= seen
        assert eng.stats_dict()["batched_calls"] == 3
    finally:
        eng.stop()
    table = {(shape[0], shape[1], n_valid)
             for _, shape, n_valid in chip_smoke.SERVING_SHAPES}
    assert table <= launched


# --- HTTP --------------------------------------------------------------------

def _get(srv, path):
    try:
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}{path}", timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def _post(srv, body, query=""):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/v1/infer{query}", data=body,
        method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"] == "application/x-npz"
        return dict(np.load(io.BytesIO(r.read())))


def _npz(raw):
    arrays = {"images": np.stack([v["img"] for v in raw])}
    for key in ("intrinsics", "depth_z", "is_metric_scale"):
        if key in raw[0]:
            arrays[key] = np.stack([np.asarray(v[key]) for v in raw])
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.fixture(scope="module")
def server(engine):
    srv = InferenceServer(engine, host="127.0.0.1", port=0,
                          resolution_set=SET).start(warmup_views=2)
    yield srv
    srv.stop()


def test_http_roundtrip_equals_the_engine(server, engine):
    raw = _raw_scene(90, intrinsics=True, depth=True, metric=True)
    out = _post(server, _npz(raw), "?apply_confidence_mask=1")
    assert out["pts3d"].shape == (2, H, W, 3)
    assert out["intrinsics"].shape == (2, 3, 3)
    assert out["metric_scaling_factor"].shape == (2,)
    ref = engine.infer(PImage.preprocess_inputs(raw, resolution_set=SET),
                       timeout=TIMEOUT, apply_confidence_mask=True)
    for key, val in out.items():
        np.testing.assert_allclose(
            val, np.stack([v[key] for v in ref]), rtol=0, atol=1e-5,
            err_msg=key)


def test_http_concurrent_burst(server):
    before = _get(server, "/v1/stats")[1]
    results, errors = [], []

    def post(seed):
        try:
            kw = dict(w=62, h=90) if seed % 3 == 0 else {}
            results.append(_post(server, _npz(_raw_scene(seed, **kw))))
        except Exception as e:  # noqa: BLE001 — collected and asserted
            errors.append(e)

    threads = [threading.Thread(target=post, args=(100 + i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 6
    assert all(np.isfinite(r["pts3d"]).all() for r in results)
    after = _get(server, "/v1/stats")[1]
    assert after["requests"] - before["requests"] == 6
    assert after["errors"] == before["errors"]
    assert after["batched_calls"] - before["batched_calls"] <= 6


def test_http_bad_body_is_400_and_serving_goes_on(server):
    for body in (b"not an npz", _npz(_raw_scene(110))[:-20]):
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/v1/infer", data=body,
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        ei.value.close()
        assert ei.value.code == 400
    buf = io.BytesIO()
    np.savez(buf, images=np.zeros((2, 60, 90), np.uint8))  # no channels
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, buf.getvalue())
    ei.value.close()
    assert ei.value.code == 400
    out = _post(server, _npz(_raw_scene(111)))
    assert np.isfinite(out["pts3d"]).all()


BAD_ARRAYS = {
    "intrinsics": dict(intrinsics=np.eye(3, dtype=np.float32)[None]),
    "depth_z": dict(depth_z=np.ones((2, 30, 90), np.float32)),
    "camera_poses": dict(camera_poses=np.tile(np.eye(4, dtype=np.float32),
                                              (2, 1, 1))[:, :3]),
    "is_metric_scale": dict(is_metric_scale=np.ones(3, bool)),
}


@pytest.mark.parametrize("key", sorted(BAD_ARRAYS))
def test_http_arrays_of_the_wrong_shape_are_400(server, key):
    """A prior array that does not fit the images is refused before the
    engine sees it."""
    before = _get(server, "/v1/stats")[1]
    buf = io.BytesIO()
    np.savez(buf, images=np.zeros((2, 60, 90, 3), np.uint8), **BAD_ARRAYS[key])
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, buf.getvalue())
    with ei.value:
        assert ei.value.code == 400
        assert f"'{key}' must be of shape" in json.loads(ei.value.read())[
            "error"]
    assert _get(server, "/v1/stats")[1]["requests"] == before["requests"]


class _Recording:
    """A pipeline that records the batch of each call; with `fail_first`,
    its first call fails as a device fault would."""

    def __init__(self, pipe, fail_first=False):
        self.model, self._pipe, self.fail_first = pipe.model, pipe, fail_first
        self.batches = []

    def infer(self, views, **flags):
        self.batches.append(len(views[0]["img"]))
        if self.fail_first and len(self.batches) == 1:
            raise RuntimeError("device fault")
        return self._pipe.infer(views, **flags)


def test_http_engine_fault_is_500_and_serving_goes_on(models):
    eng = BatchingEngine(_Recording(models[1], fail_first=True)).start()
    srv = InferenceServer(eng, port=0, resolution_set=SET).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, _npz(_raw_scene(112)))
        with ei.value:
            assert ei.value.code == 500
            assert json.loads(ei.value.read()) == {
                "error": "RuntimeError: device fault"}
        assert _get(srv, "/v1/stats")[1]["errors"] == 1
        out = _post(srv, _npz(_raw_scene(113)))
        assert np.isfinite(out["pts3d"]).all()
    finally:
        srv.stop()
        eng.stop()


def test_http_timeout_is_503_and_the_scene_never_runs(models, monkeypatch):
    """A request the engine does not answer in time gets 503, and its scene,
    not dispatched yet, is dropped: it never runs on the device."""
    monkeypatch.setattr(serve, "_REQUEST_TIMEOUT_S", 0.2)
    pipe = _Recording(models[1])
    eng = BatchingEngine(pipe, max_batch=4, max_wait_ms=50.0)
    srv = InferenceServer(eng, port=0, resolution_set=SET).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, _npz(_raw_scene(114)))  # the worker is not running
        with ei.value:
            assert ei.value.code == 503
            assert "no result within 0.2 s" in json.loads(ei.value.read())[
                "error"]
        scene = _scene(115)
        fut = eng.submit(scene)
        eng.start()
        _compare(fut.result(timeout=TIMEOUT), models[1].infer(scene), 1e-5)
        stats = eng.stats_dict()
        assert stats["requests"] == 2
        assert stats["batched_calls"] == 1 and stats["scenes_padded"] == 0
        assert pipe.batches == [1]
    finally:
        srv.stop()
        eng.stop()


def test_http_healthz_and_stats(server):
    assert _get(server, "/healthz") == (200, {"ok": True})
    code, stats = _get(server, "/v1/stats")
    assert code == 200
    assert set(stats) == {"requests", "batched_calls", "scenes_padded",
                          "errors", "buckets"}
    assert stats["batched_calls"] >= 1  # the warm-up
    assert _get(server, "/nowhere")[0] == 404


def test_http_healthz_is_503_until_the_warmup_ends(models):
    eng = BatchingEngine(models[1])  # not started: the warm-up waits
    srv = InferenceServer(eng, port=0, resolution_set=SET)
    t = threading.Thread(target=srv.start, kwargs={"warmup_views": 1})
    t.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while srv.port == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _get(srv, "/healthz") == (503, {"ok": False})
        eng.start()
        t.join(TIMEOUT)
        assert not t.is_alive()
        assert _get(srv, "/healthz") == (200, {"ok": True})
    finally:
        srv.stop()
        eng.stop()
        t.join(TIMEOUT)


# --- checkpoints and the CLI -------------------------------------------------

@pytest.fixture(scope="module")
def source_model(models):
    return models[1].model


def _assert_bitwise(model, source):
    got, want = model.state_dict(), source.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_from_pretrained_params_file(tmp_path, source_model):
    path = str(tmp_path / "params.pt")
    save_params(path, source_model)
    model = from_pretrained(path, torch.float32, TINY, device="cpu")
    _assert_bitwise(model, source_model)
    assert not model.training and model.cfg.dtype == torch.float32


def test_from_pretrained_train_state_file(tmp_path, source_model):
    path = str(tmp_path / "checkpoint-last")
    save_train_state(path, create_train_state(source_model, OptimConfig()),
                     best_so_far=1.5, epoch=2)
    model = from_pretrained(path, torch.bfloat16, TINY, device="cpu")
    _assert_bitwise(model, source_model)
    assert model.cfg.dtype == torch.bfloat16


def test_from_pretrained_other_architecture_raises(tmp_path, source_model):
    path = str(tmp_path / "params.pt")
    save_params(path, source_model)
    with pytest.raises(RuntimeError, match="state_dict"):
        from_pretrained(path, torch.float32, dict(TINY, trunk_depth=4),
                        device="cpu")


def _reference(model):
    return reference_state_dict(model.state_dict(), TINY["trunk_indices"])


def _reference_safetensors(tmp_path, model):
    path = tmp_path / "model.safetensors"
    write_safetensors(str(path), _reference(model))
    return path


def _reference_pt(tmp_path, model):
    path = tmp_path / "reference.pt"
    torch.save({"model": _reference(model)}, path)
    return path


def _hf_snapshot(tmp_path, model):
    (tmp_path / "config.json").write_text("{}")
    write_safetensors(str(tmp_path / "model.safetensors"), _reference(model))
    return tmp_path


@pytest.mark.parametrize("make", [_reference_safetensors, _reference_pt,
                                  _hf_snapshot])
def test_from_pretrained_reads_the_reference_layouts(tmp_path, source_model,
                                                     make):
    model = from_pretrained(str(make(tmp_path, source_model)), torch.float32,
                            TINY, device="cpu")
    _assert_bitwise(model, source_model)


def test_from_pretrained_refuses_orbax(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        from_pretrained(str(tmp_path), device="cpu")


@pytest.mark.parametrize("checkpoint", [True, False])
def test_cli_composition_on_the_cpu(tmp_path, source_model, capsys,
                                    checkpoint):
    argv = ["--device", "cpu", "--port", "0", "--fp32", "--warmup-views", "1",
            "--max-batch", "2"]
    if checkpoint:
        path = str(tmp_path / "params.pt")
        save_params(path, source_model)
        argv += ["--checkpoint", path]
    eng, srv = serve.build_server(argv, config_overrides=TINY)
    try:
        printed = capsys.readouterr().out
        assert ("loaded checkpoint" in printed) == checkpoint
        assert ("smoke mode" in printed) != checkpoint
        assert srv.port != 0 and eng.max_batch == 2
        assert next(eng.pipeline.model.parameters()).device.type == "cpu"
        if checkpoint:
            _assert_bitwise(eng.pipeline.model, source_model)
        assert _get(srv, "/healthz") == (200, {"ok": True})
        out = _post(srv, _npz(_raw_scene(120, w=700, h=520)))
        assert out["pts3d"].shape == (2, 392, 518, 3)  # the 518 set
        assert np.isfinite(out["pts3d"]).all()
    finally:
        srv.stop()
        eng.stop()
