"""The two demos end to end on the CPU at --tiny (demo_images_only.py and
demo_colmap.py --ba), the COLMAP demo's refinement against the JAX
composition of scripts/demo_colmap.py's --ba branch given the same
predictions, and the server started on a checkpoint in the reference's
layout.

Tolerances of the refinement (fp32): tracks within 1e-4 px, the refined
poses, intrinsics and points within 1e-3 of their largest magnitude; the
query frames, the track masks and the start points are equal.
"""

import io
import json
import struct
import urllib.request

import numpy as np
import PIL.Image
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.geometry import (
    pose_quats_trans_to_matrix as jax_pose_matrix,
)
from mapanything_tpu.geometry import (
    rotation_matrix_to_quaternion as jax_matrix_to_quat,
)
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.nn.dinov2 import DinoViT as JaxDinoViT
from mapanything_tpu.utils import ba as JB
from mapanything_tpu.utils import tracking as JT
from mapanything_tpu.utils.inference import InferencePipeline as JaxPipeline
from mapanything_tpu_torch import demo_colmap, demo_images_only, serve
from mapanything_tpu_torch.data.image import load_images
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.utils import colmap_io as PC
from mapanything_tpu_torch.utils.inference import InferencePipeline
from mapanything_tpu_torch.utils.weights import load_jax_params, random_normal_
from torch_jax_init import init_params
from torch_reference_layout import reference_state_dict, write_snapshot

TINY = demo_colmap.TINY_CONFIG


def _smooth(x, it=2):
    for _ in range(it):
        x = (x + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 5.0
    return x


def _texture_frames(seed, n, h, w):
    """n views of one smooth colour texture, each shifted a few pixels."""
    rng = np.random.default_rng(seed)
    tex = _smooth(rng.uniform(0, 1, (h + 24, w + 24, 3)))
    return [tex[2 * i:2 * i + h, 3 * i:3 * i + w].astype(np.float32)
            for i in range(n)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 images of 310 x 100: the smallest bucket, 518 x 168."""
    path = tmp_path_factory.mktemp("images")
    for i, img in enumerate(_texture_frames(5, 3, 100, 310)):
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(
            path / f"im{i}.png")
    return str(path)


@pytest.fixture(scope="module")
def tiny_model():
    """The demos' model without --checkpoint: --tiny, seed 0."""
    return random_normal_(MapAnything(MapAnythingConfig(**TINY),
                                      device="cpu"), seed=0).eval()


def _glb(path):
    """(JSON chunk, positions of accessor 0) of a GLB file."""
    raw = open(path, "rb").read()
    assert raw[:4] == b"glTF"
    n = struct.unpack("<I", raw[12:16])[0]
    gltf = json.loads(raw[20:20 + n])
    binary = raw[20 + n + 8:]
    view = gltf["bufferViews"][0]
    pos = np.frombuffer(binary[view["byteOffset"]:view["byteOffset"]
                               + view["byteLength"]], np.float32)
    return gltf, pos.reshape(-1, 3)


def _masked(preds):
    return np.concatenate([p["pts3d"][0][p["mask"][0, ..., 0].bool()].numpy()
                           for p in preds])


def test_images_only_demo_writes_the_masked_points(tmp_path, folder,
                                                   tiny_model):
    out = tmp_path / "rec.ply"
    assert demo_images_only.main(["--image_folder", folder, "--output",
                                  str(out), "--tiny", "--device", "cpu"]) == 0
    want = _masked(InferencePipeline(tiny_model).infer(
        load_images(folder), memory_efficient_inference=False))
    gltf, pos = _glb(tmp_path / "rec.glb")
    np.testing.assert_array_equal(pos, want)
    assert gltf["accessors"][0]["count"] == len(want) > 0
    assert gltf["accessors"][2]["count"] == 3 * 16  # one frustum per view
    lines = out.read_text().splitlines()
    assert lines[2] == f"element vertex {len(want)}"
    body = np.loadtxt(lines[lines.index("end_header") + 1:])
    np.testing.assert_allclose(body[:, :3], want, atol=6e-6)


def test_colmap_demo_with_ba(tmp_path, folder):
    out = tmp_path / "out"
    assert demo_colmap.main(["--image_folder", folder, "--output_dir",
                             str(out), "--tiny", "--device", "cpu", "--ba",
                             "--max_query_pts", "96", "--ba_iters", "5"]) == 0
    for sub in ("sparse", "sparse_ba"):
        cams = PC.read_cameras_bin(str(out / sub / "cameras.bin"))
        imgs = PC.read_images_bin(str(out / sub / "images.bin"))
        pts, _ = PC.read_points3d_bin(str(out / sub / "points3D.bin"))
        assert len(cams) == len(imgs) == 3 and len(pts) > 0
        assert np.isfinite(pts).all()
        for im in imgs:
            rot = PC.quaternion_wxyz_to_matrix_np(im["qvec"])
            np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    gltf, pos = _glb(out / "points.glb")
    sparse, _ = PC.read_points3d_bin(str(out / "sparse" / "points3D.bin"))
    np.testing.assert_array_equal(pos, sparse.astype(np.float32))
    assert gltf["accessors"][0]["count"] == len(sparse)


def test_ba_without_a_card_raises(folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_colmap.main(["--image_folder", folder, "--tiny", "--ba"])


# --- the refinement against JAX's composition --------------------------------

SMALL = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
             trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
             dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
H, W = 84, 112
FLAGS = dict(max_query_pts=60, num_query_frames=2, vis_thresh=0.6,
             ba_iters=5)


def jax_refine(preds, images, enc_params, cfg, max_query_pts,
               num_query_frames, vis_thresh, ba_iters):
    """scripts/demo_colmap.py's --ba branch, its computation only."""
    imgs = np.stack([np.asarray(p["img_no_norm"][0]) for p in preds])
    poses = np.stack([np.asarray(p["camera_poses"][0]) for p in preds])
    intrinsics = np.stack([np.asarray(p["intrinsics"][0]) for p in preds])
    enc = JaxDinoViT(size=cfg.encoder_size, patch_size=cfg.patch_size,
                     dtype=cfg.dtype, fold_layerscale=cfg.fold_layerscale)
    feats = JT.frame_features_from_encoder(
        jax.jit(lambda x: enc.apply({"params": enc_params}, x)), images)
    ranked = JT.rank_query_frames(feats, num_query_frames)
    query_frames = ([0] + [i for i in ranked if i != 0])[:num_query_frames]
    per_frame = max(1, max_query_pts // len(query_frames))
    xy, mask, pts = [], [], []
    for qf in query_frames:
        q_yx, _ = JT.select_query_points(
            jnp.asarray(np.asarray(preds[qf]["conf"][0])),
            JT.to_gray(jnp.asarray(imgs[qf])), per_frame)
        tracks_yx, vis = JT.track_points(jnp.asarray(imgs), q_yx,
                                         query_frame=qf)
        xy.append(np.asarray(tracks_yx)[..., ::-1])
        mask.append(np.asarray(vis) > vis_thresh)
        qi = np.asarray(q_yx).astype(int)
        pts.append(np.asarray(preds[qf]["pts3d"][0])[qi[:, 0], qi[:, 1]])
    w2c = np.linalg.inv(poses)
    problem = JB.BAProblem(
        tracks=jnp.asarray(np.concatenate(xy, axis=1).copy()),
        track_mask=jnp.asarray(np.concatenate(mask, axis=1)),
        base_quats=jax_matrix_to_quat(jnp.asarray(w2c[:, :3, :3])),
        base_trans=jnp.asarray(w2c[:, :3, 3]),
        intrinsics=jnp.asarray(np.array(
            [intrinsics[0, 0, 0], intrinsics[0, 1, 1], intrinsics[0, 0, 2],
             intrinsics[0, 1, 2]], np.float32)),
        points=jnp.asarray(np.concatenate(pts)))
    out = JB.bundle_adjust(problem, iters=ba_iters)
    return {"query_frames": query_frames, "problem": problem, "ba": out,
            "w2c": np.asarray(jax_pose_matrix(out["cam_quats"],
                                              out["cam_trans"]))}


@pytest.fixture(scope="module")
def small_models():
    """(JAX model, its seeded params, the port's model holding them)."""
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **SMALL))
    rng = np.random.default_rng(6)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape))
        .astype(np.float32), init_params(jax_model, H, W))
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **SMALL),
                    device="cpu"), params).eval()
    return jax_model, params, port


def _model_predictions(jax_model, params, frames):
    """JAX infer's outputs on the frames, masks and confidence mask on."""
    views = [{"img": img[None], "data_norm_type": ["dinov2"]}
             for img in _normalise(frames)]
    with jax.default_matmul_precision("highest"):
        preds = JaxPipeline(jax_model, params).infer(
            views, apply_confidence_mask=True, confidence_percentile=10.0)
    return [{k: np.asarray(v) for k, v in p.items()} for p in preds]


def _geometry_predictions(jax_model, params, frames):
    """Predictions of the scene the frames show: a fronto-parallel textured
    plane at depth 2, frame i seen from a camera moved by (3i, 2i) pixels'
    worth (as _texture_frames shifts it), the poses and the focal length
    then perturbed, so the adjustment has work to do."""
    rng = np.random.default_rng(11)
    f, d = 100.0, 2.0
    k = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    preds = []
    for i, img in enumerate(frames):
        t = np.array([3 * i * d / f, 2 * i * d / f, 0.0], np.float32)
        pts = np.stack([(xx - W / 2) * d / f + t[0],
                        (yy - H / 2) * d / f + t[1],
                        np.full_like(xx, d)], -1)
        a = rng.normal(size=3) * 0.01
        rot = np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]])
        u, _, vt = np.linalg.svd(rot)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = u @ vt
        pose[:3, 3] = t + rng.normal(size=3) * 0.01
        preds.append({
            "pts3d": pts[None], "img_no_norm": img[None],
            "camera_poses": pose[None],
            "intrinsics": (k * np.array([[1.02], [1.02], [1]],
                                        np.float32))[None],
            "conf": rng.uniform(1, 2, (1, H, W)).astype(np.float32),
            "mask": np.ones((1, H, W, 1), bool)})
    return preds


def _normalise(frames):
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return np.stack([(f - mean) / std for f in frames]).astype(np.float32)


@pytest.mark.parametrize("source", ["model", "geometry"])
def test_refinement_matches_jax(small_models, source):
    jax_model, params, port = small_models
    frames = _texture_frames(7, 3, H, W)
    make = {"model": _model_predictions,
            "geometry": _geometry_predictions}[source]
    preds = make(jax_model, params, frames)
    images = _normalise(frames)
    with jax.default_matmul_precision("highest"):
        ref = jax_refine(preds, jnp.asarray(images),
                         params["params"]["encoder"], jax_model.cfg, **FLAGS)
    torch_preds = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
                   for p in preds]
    out = demo_colmap.refine(torch_preds, torch.from_numpy(images),
                             port.encoder, **FLAGS)
    problem = ref["problem"]
    assert out["query_frames"] == ref["query_frames"]
    assert len(out["query_frames"]) == 2
    np.testing.assert_allclose(out["tracks_xy"].numpy(),
                               np.asarray(problem.tracks), atol=1e-4)
    np.testing.assert_array_equal(out["track_mask"].numpy(),
                                  np.asarray(problem.track_mask))
    np.testing.assert_array_equal(out["points"].numpy(),
                                  np.asarray(problem.points))
    assert out["track_mask"].sum() > out["track_mask"].shape[1]
    ba, jba = out["ba"], ref["ba"]
    np.testing.assert_allclose(ba["rms_before"], float(jba["rms_before"]),
                               rtol=1e-5)
    assert ba["rms_after"] <= ba["rms_before"]
    if source == "geometry":  # the perturbation is taken out
        assert ba["rms_after"] < ba["rms_before"] / 4
    for key in ("cam_quats", "cam_trans", "intrinsics", "points"):
        want = np.asarray(jba[key], np.float64)
        err = np.abs(ba[key].double().numpy() - want).max()
        assert err <= 1e-3 * max(1.0, np.abs(want).max()), (key, err)


# --- serving a checkpoint in the reference's layout --------------------------

def test_server_takes_a_reference_snapshot(tmp_path, tiny_model):
    folder = write_snapshot(
        str(tmp_path / "snap"),
        reference_state_dict(tiny_model.state_dict(), TINY["trunk_indices"]),
        shards=2)
    eng, srv = serve.build_server(
        ["--device", "cpu", "--port", "0", "--fp32", "--warmup-views", "1",
         "--max-batch", "1", "--checkpoint", folder],
        config_overrides=dict(encoder_size="small", trunk_num_heads=6,
                              trunk_indices=TINY["trunk_indices"]))
    try:
        got = eng.pipeline.model.state_dict()
        for key, want in tiny_model.state_dict().items():
            assert torch.equal(got[key], want), key
        rng = np.random.default_rng(9)
        buf = io.BytesIO()
        np.savez(buf, images=rng.integers(0, 256, (2, 100, 310, 3),
                                          dtype=np.uint8))
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/v1/infer", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = dict(np.load(io.BytesIO(r.read())))
        assert out["pts3d"].shape == (2, 168, 518, 3)
        assert np.isfinite(out["pts3d"]).all()
    finally:
        srv.stop()
        eng.stop()
