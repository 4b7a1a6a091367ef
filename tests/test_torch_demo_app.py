"""The interactive demo app's core (utils/demo_core.py, utils/mesh.py,
utils/colormaps.py, geometry/edges.py::points_to_normals) and its CLI
(demo_app.py) against the JAX package on the CPU.

Both packages' exports are numpy over the same predictions, so they are
held bitwise: the meshes, the GLB files byte for byte, the packed
predictions, the background mask, the measure, the coloured normals and
depth (the colormaps against JAX's matplotlib and matplotlib itself) and
the heuristic sky mask. The normal maps run in torch against XLA's fused
arithmetic: within 1e-6 on smooth surfaces (a model's pointmaps). The sky
model's resizes are cv2.resize (INTER_LINEAR) in numpy: within 1 grey
level of cv2 (bitwise on every case here), and the < 32 sky threshold may
flip only where cv2's resized logit lies within 1 level of it. `run_model`
of a small JAX model against the port's, the weights carried by
`load_jax_params`: the predictions within 1e-4 of their largest magnitude
(fp32), the masks equal.
"""

import json
import os

import cv2
import matplotlib
import numpy as np
import PIL.Image
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.geometry import points_to_normals as jax_normals
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.utils import demo_core as JD
from mapanything_tpu.utils import mesh as JM
from mapanything_tpu.utils.inference import InferencePipeline as JaxPipeline
from mapanything_tpu_torch import demo_app
from mapanything_tpu_torch.geometry import points_to_normals
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.utils import colormaps as PC
from mapanything_tpu_torch.utils import demo_core as PD
from mapanything_tpu_torch.utils import mesh as PM
from mapanything_tpu_torch.utils.inference import InferencePipeline
from mapanything_tpu_torch.utils.weights import load_jax_params
from test_demo_core import parse_glb, synthetic_predictions
from torch_jax_init import init_params

NORMAL_TOL = 1e-6
PRED_TOL = 1e-4
SMALL = dict(encoder_size="test", trunk_dim=64, trunk_depth=4,
             trunk_num_heads=2, trunk_indices=(1, 3), dpt_feature_dim=32,
             dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
H, W = 42, 56


def smooth_surface(shape, seed):
    """(..., H, W, 3) pointmaps of wavy surfaces seen by a pinhole camera,
    as a model predicts them (random points make the four quad normals
    nearly cancel, where fp32 rounding dominates)."""
    rng = np.random.default_rng(seed)
    *lead, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(int(np.prod(lead, dtype=int))):
        f = rng.uniform(400, 600)
        ph = rng.uniform(0, 6, 2)
        z = (2 + 0.3 * np.sin(xx / 5 + ph[0]) + 0.2 * np.cos(yy / 4 + ph[1])
             + rng.uniform(0, 0.01, (h, w)))
        out.append(np.stack([(xx - w / 2) * z / f, (yy - h / 2) * z / f, z],
                            -1))
    return np.stack(out).reshape(*lead, h, w, 3).astype(np.float32)


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# utils/mesh.py, bitwise


@pytest.mark.parametrize("hw", [(2, 2), (5, 7), (9, 4)])
def test_grid_quad_faces(hw):
    assert_same(PM.grid_quad_faces(*hw), JM.grid_quad_faces(*hw))


@pytest.mark.parametrize("how", ["shorter_diagonal", "backslash", "fan",
                                 "triangles"])
def test_triangulate(how):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    quads = rng.integers(0, 40, (25, 4))
    kw = {"shorter_diagonal": dict(vertices=verts),
          "backslash": dict(backslash=rng.uniform(size=25) > 0.5)}.get(how, {})
    faces = {"fan": rng.integers(0, 40, (6, 5)),
             "triangles": quads[:, :3]}.get(how, quads)
    assert_same(PM.triangulate(faces, **kw), JM.triangulate(faces, **kw))


def test_compact_vertices():
    rng = np.random.default_rng(2)
    faces = rng.integers(0, 50, (30, 3))
    attrs = (rng.normal(size=(50, 3)), rng.uniform(size=(50, 3)))
    for got, want in zip(PM.compact_vertices(faces, *attrs,
                                             return_indices=True),
                         JM.compact_vertices(faces, *attrs,
                                             return_indices=True)):
        assert_same(got, want)


@pytest.mark.parametrize("case", ["full", "tri", "masked", "masked_diagonal",
                                  "indices"])
def test_image_mesh(case):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(9, 11, 3)).astype(np.float32)
    cols = rng.uniform(size=(9, 11, 3))
    mask = rng.uniform(size=(9, 11)) > 0.25
    kw = {"full": {}, "tri": dict(tri=True),
          "masked": dict(mask=mask, tri=True),
          "masked_diagonal": dict(mask=mask, tri=True, diagonal_attr=0),
          "indices": dict(mask=mask, return_indices=True)}[case]
    got, want = PM.image_mesh(pts, cols, **kw), JM.image_mesh(pts, cols, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)


def test_alignment_markers_and_transform():
    rng = np.random.default_rng(4)
    extr = np.tile(np.eye(4), (3, 1, 1))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3, 3)))
    extr[:, :3, :3], extr[:, :3, 3] = q, rng.normal(size=(3, 3))
    assert_same(PM.OPENGL_FLIP, JM.OPENGL_FLIP)
    for e in (extr, extr[:, :3]):
        assert_same(PM.alignment_transform(e), JM.alignment_transform(e))
    pts = rng.normal(size=(20, 3))
    align = JM.alignment_transform(extr)
    assert_same(PM.transform_points(align, pts),
                JM.transform_points(align, pts))
    for got, want in zip(PM.camera_marker_mesh(extr[1], 0.2),
                         JM.camera_marker_mesh(extr[1], 0.2)):
        assert_same(got, want)


def test_write_glb_mesh_bytes(tmp_path):
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (40, 3)).astype(np.int32)
    marker = JM.camera_marker_mesh(np.eye(4), 0.5)
    kw = dict(vertex_colors=rng.uniform(size=(30, 3)),
              vertex_normals=rng.normal(size=(30, 3)),
              extra_meshes=[(*marker, (255, 0, 0))])
    PM.write_glb_mesh(str(tmp_path / "p.glb"), verts, faces, **kw)
    JM.write_glb_mesh(str(tmp_path / "j.glb"), verts, faces, **kw)
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb"
                                                  ).read_bytes()
    with pytest.raises(ValueError, match="nothing to export"):
        PM.write_glb_mesh(str(tmp_path / "e.glb"), verts[:0], faces[:0])


# ---------------------------------------------------------------------------
# utils/colormaps.py against matplotlib


@pytest.mark.parametrize("name", ["turbo_r", "gist_rainbow"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_colormap_equals_matplotlib(name, dtype):
    rng = np.random.default_rng(6)
    x = np.concatenate([
        rng.uniform(-0.3, 1.3, 2000),
        [0.0, -0.0, 1.0, np.nextafter(1.0, 0), np.nextafter(1.0, 2),
         -1e-9, 1 / 256, 255 / 256, 0.5, np.nan, np.inf, -np.inf]]).astype(
        dtype)
    got, want = PC.apply_colormap(name, x), matplotlib.colormaps[name](x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for scalar in (0.0, 0.3, 1.0, 7 / 8):  # the markers' scalar calls
        np.testing.assert_array_equal(
            PC.apply_colormap(name, scalar),
            np.array(matplotlib.colormaps[name](scalar)))
    idx = np.arange(-3, 262)
    np.testing.assert_array_equal(PC.apply_colormap(name, idx),
                                  matplotlib.colormaps[name](idx))


def test_unknown_colormap_raises():
    with pytest.raises(KeyError, match="turbo_r"):
        PC.lookup_table("viridis")


# ---------------------------------------------------------------------------
# geometry/edges.py::points_to_normals, within NORMAL_TOL


@pytest.mark.parametrize("shape", [(8, 10), (2, 17, 23), (2, 2, 9, 11)])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_points_to_normals(shape, masked):
    pts = smooth_surface(shape, 7)
    mask = (np.random.default_rng(8).uniform(size=shape) > 0.2
            if masked else None)
    want, want_mask = jax_normals(pts, mask)
    got, got_mask = points_to_normals(
        torch.from_numpy(pts),
        None if mask is None else torch.from_numpy(mask))
    assert got.shape == pts.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=NORMAL_TOL)
    if masked:
        assert not got[~got_mask].any()


# ---------------------------------------------------------------------------
# utils/demo_core.py on identical predictions


def infer_outputs(seed, n=3, h=6, w=8, torch_tensors=False):
    rng = np.random.default_rng(seed)
    outputs = []
    for _ in range(n):
        out = {"pts3d": rng.normal(size=(1, h, w, 3)),
               "depth_z": rng.uniform(-0.1, 1, size=(1, h, w, 1)),
               "img_no_norm": rng.uniform(size=(1, h, w, 3)),
               "conf": rng.uniform(1, 2, size=(1, h, w, 1)),
               "mask": rng.uniform(size=(1, h, w, 1)) > 0.2,
               "camera_poses": np.eye(4)[None] + rng.normal(
                   0, 0.1, (1, 4, 4)),
               "intrinsics": np.eye(3)[None] * 30}
        if torch_tensors:
            out = {k: torch.from_numpy(v).float() if v.dtype != bool
                   else torch.from_numpy(v) for k, v in out.items()}
        outputs.append(out)
    return outputs


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "tensors"])
def test_pack_predictions(as_tensors):
    want = JD.pack_predictions(infer_outputs(9))
    got = PD.pack_predictions(infer_outputs(9, torch_tensors=as_tensors))
    assert list(got) == list(want)
    for key in want:
        assert_same(got[key], want[key])


def test_pack_predictions_names_a_missing_key():
    outputs = infer_outputs(9)
    del outputs[1]["depth_z"]
    with pytest.raises(KeyError, match="depth_z"):
        PD.pack_predictions(outputs)


@pytest.mark.parametrize("filters", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_background_mask(filters):
    rng = np.random.default_rng(10)
    img = rng.uniform(size=(12, 14, 3))
    img[:3] = 0.01
    img[-3:] = 0.99
    for image in (img, img * 255.0):
        assert_same(PD.background_mask(image, *filters),
                    JD.background_mask(image, *filters))


def test_process_for_visualization():
    preds = synthetic_predictions(s=3, h=12, w=15, seed=11)
    preds["world_points"] = smooth_surface((3, 12, 15), 11)
    preds["images"][0, :2] = 0.0  # black rows for the filter
    want = JD.process_for_visualization(preds, filter_black_bg=True)
    got = PD.process_for_visualization(preds, filter_black_bg=True,
                                       device="cpu")
    assert list(got) == list(want)
    for i in want:
        for key in ("image", "points3d", "depth", "mask"):
            assert_same(got[i][key], want[i][key])
        np.testing.assert_allclose(got[i]["normal"], want[i]["normal"],
                                   rtol=0, atol=NORMAL_TOL)
        # colorize_normal bitwise on the same normals
        assert_same(PD.colorize_normal(want[i]["normal"], want[i]["mask"]),
                    JD.colorize_normal(want[i]["normal"], want[i]["mask"]))


def test_colorize_depth_under_over_and_one():
    """Depth normalised by its 5th and 95th percentiles: below p5 is under
    (< 0), above p95 over (> 1), p95 itself exactly 1; invalid white."""
    rng = np.random.default_rng(12)
    depth = rng.uniform(0.5, 3.0, (20, 20))
    depth[0, :5] = [0.0, -1.0, np.nan, 0.01, 100.0]
    mask = rng.uniform(size=(20, 20)) > 0.1
    for m in (None, mask):
        got, want = PD.colorize_depth(depth, m), JD.colorize_depth(depth, m)
        assert_same(got, want)
    p5, p95 = np.percentile(depth[depth > 0], [5, 95])
    norm = (depth[depth > 0] - p5) / (p95 - p5)
    assert (norm < 0).any() and (norm > 1).any()
    # 21 values: p5 and p95 land on samples, so 20 maps to exactly 1
    ramp = np.arange(1.0, 22.0).reshape(3, 7)
    p5, p95 = np.percentile(ramp, [5, 95])
    assert (p5, p95) == (2.0, 20.0) and (20.0 - p5) / (p95 - p5) == 1.0
    assert_same(PD.colorize_depth(ramp), JD.colorize_depth(ramp))
    flat = np.full((4, 4), 2.0)  # p5 == p95: every valid value maps to 0
    flat[0, 0] = 3.0
    assert_same(PD.colorize_depth(flat), JD.colorize_depth(flat))


def test_measure():
    preds = synthetic_predictions(seed=13)
    view = JD.process_for_visualization(preds)[1]
    for clicks in (((2, 3), (5, 4)), ((2, 3), None), ((0, 0), (2, 2)),
                   ((99, 0), (1, 1)), ((1, 1), (9, 7))):
        assert PD.measure(view, *clicks) == JD.measure(view, *clicks)


@pytest.mark.parametrize("kw", [
    dict(as_mesh=True),
    dict(as_mesh=False, conf_percentile=50.0),
    dict(frame=0, show_cam=False),
    dict(as_mesh=True, mask_black_bg=True, mask_white_bg=True,
         align_to_first_camera=False, conf_percentile=20.0),
], ids=["mesh", "pointcloud", "single_frame", "filters"])
def test_glb_scene_bitwise(tmp_path, kw):
    preds = synthetic_predictions(s=3, h=9, w=12, seed=14)
    preds["extrinsic"][2, :3, 3] = [0.2, -0.4, 0.1]
    n_got = PD.predictions_to_glb_scene(str(tmp_path / "p.glb"), preds, **kw)
    n_want = JD.predictions_to_glb_scene(str(tmp_path / "j.glb"), preds,
                                         **kw)
    assert n_got == n_want > 0
    got, want = (tmp_path / "p.glb").read_bytes(), (tmp_path / "j.glb"
                                                     ).read_bytes()
    assert got == want
    gltf, _ = parse_glb(str(tmp_path / "p.glb"))
    assert gltf["accessors"][0]["count"] == n_got


def sky_image(seed, h=60, w=80):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[: h // 2] = [0.55, 0.7, 0.95]
    img[h // 2:] = rng.uniform(0.0, 0.4, size=(h - h // 2, w, 3))
    return img


@pytest.mark.parametrize("seed", [6, 15])
def test_sky_mask_heuristic(seed):
    img = sky_image(seed)
    assert_same(PD.sky_mask_heuristic(img), JD.sky_mask_heuristic(img))
    assert_same(PD.segment_sky(img * 255), JD.segment_sky(img * 255))


@pytest.mark.parametrize("src,dst", [((392, 518, 3), (320, 320)),
                                     ((320, 320), (518, 392)),
                                     ((64, 48, 3), (320, 320)),
                                     ((320, 320), (48, 64)),
                                     ((37, 91, 3), (320, 320)),
                                     ((320, 320), (320, 320))])
def test_resize_linear_against_cv2(src, dst):
    rng = np.random.default_rng(16)
    img = rng.integers(0, 256, src).astype(np.uint8)
    got, want = PD.resize_linear(img, dst), cv2.resize(img, dst)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class FakeSession:
    """The onnxruntime session surface: logits low in the top rows (sky),
    with a smooth ramp so the threshold crosses many levels."""

    class Tensor:
        def __init__(self, name):
            self.name = name

    def get_inputs(self):
        return [self.Tensor("in")]

    def get_outputs(self):
        return [self.Tensor("out")]

    def run(self, outs, feed):
        x = feed["in"]
        assert x.shape == (1, 3, 320, 320) and x.dtype == np.float32
        yy, xx = np.mgrid[0:320, 0:320] / 320.0
        out = (yy + 0.05 * np.sin(9 * xx) + 0.01 * x[0, 0]).astype(
            np.float32)
        return [out[None, None]]


@pytest.mark.parametrize("hw", [(64, 48), (392, 518), (100, 310)])
def test_segment_sky_with_a_session(hw):
    img = np.random.default_rng(17).uniform(size=(*hw, 3)).astype(np.float32)
    got = PD.segment_sky(img, onnx_session=FakeSession())
    want = JD.segment_sky(img, onnx_session=FakeSession())
    assert got.shape == want.shape == hw and got.dtype == np.uint8
    # where the masks differ, cv2's resized logit is within 1 of 32
    bgr = cv2.cvtColor((np.clip(img, 0, 1) * 255).astype(np.uint8),
                       cv2.COLOR_RGB2BGR)
    logits = cv2.resize(JD.run_skyseg(FakeSession(), [320, 320], bgr),
                        (hw[1], hw[0]))
    differ = got != want
    assert np.all(np.abs(logits[differ].astype(int) - 32) <= 1)
    assert differ.mean() <= 1e-2
    assert_same(PD.run_skyseg(FakeSession(), [320, 320], bgr),
                JD.run_skyseg(FakeSession(), [320, 320], bgr))


# ---------------------------------------------------------------------------
# run_model: a small JAX model against the port's


@pytest.fixture(scope="module")
def small_models():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **SMALL))
    params = init_params(jax_model, H, W)
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape)).astype(np.float32), params)
    port = MapAnything(MapAnythingConfig(dtype=torch.float32, **SMALL),
                       device="cpu")
    load_jax_params(port, params)
    return (jax_model, params), port.eval()


def test_run_model_matches_jax(small_models):
    (jax_model, params), port = small_models
    rng = np.random.default_rng(8)
    views = [{"img": rng.standard_normal((1, H, W, 3)).astype(np.float32),
              "data_norm_type": ["dinov2"]} for _ in range(2)]
    with jax.default_matmul_precision("highest"):
        want, want_vis = JD.run_model(JaxPipeline(jax_model, params), views)
    got, got_vis = PD.run_model(InferencePipeline(port), views)
    assert list(got) == list(want)
    for key in ("world_points", "depth", "images", "conf", "extrinsic",
                "intrinsic"):
        ref = np.asarray(want[key], np.float64)
        err = np.abs(got[key].astype(np.float64) - ref).max()
        assert err <= PRED_TOL * max(1.0, np.abs(ref).max()), (key, err)
    assert_same(got["final_mask"], want["final_mask"])
    for i in want_vis:
        assert_same(got_vis[i]["mask"], want_vis[i]["mask"])


# ---------------------------------------------------------------------------
# demo_app.py


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    path = tmp_path_factory.mktemp("app_images")
    rng = np.random.default_rng(18)
    for i in range(2):
        img = rng.uniform(0, 255, (100, 310, 3))
        img[:30] = [140, 180, 240]  # a smooth bright band for the sky mask
        PIL.Image.fromarray(img.astype(np.uint8)).save(path / f"im{i}.png")
    return str(path)


def test_app_writes_every_file(image_folder, tmp_path, capsys):
    out = tmp_path / "out"
    rc = demo_app.main(["--image_folder", image_folder, "--out_dir",
                        str(out), "--tiny", "--device", "cpu",
                        "--sky_masks", "--measure", "10,10,200,80", "--view",
                        "1", "--ui"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "gradio not installed; falling back to headless export" in text
    assert "running with RANDOM weights" in text and "device: cpu" in text
    names = {"scene.glb", "measure.json", "sky"} | {
        f"{kind}_{i:03d}.png" for kind in ("depth", "normal")
        for i in range(2)}
    assert set(os.listdir(out)) == names
    assert sorted(os.listdir(out / "sky")) == ["skymask_000.png",
                                               "skymask_001.png"]
    for i in range(2):
        for kind in ("depth", "normal"):
            png = np.asarray(PIL.Image.open(out / f"{kind}_{i:03d}.png"))
            assert png.shape == (168, 518, 3) and png.dtype == np.uint8
        sky = np.asarray(PIL.Image.open(out / "sky" / f"skymask_{i:03d}.png"))
        assert sky.shape == (168, 518) and set(np.unique(sky)) <= {0, 255}
    with open(out / "measure.json") as f:
        assert set(json.load(f)) >= {"valid", "points"}
    gltf, _ = parse_glb(str(out / "scene.glb"))
    n = int(text.split("scene.glb (")[1].split(" vertices")[0])
    assert gltf["accessors"][0]["count"] == n > 0
    for stage in ("load", "model", "infer", "normals", "glb", "pngs",
                  "measure", "sky"):
        assert f"wall {stage}: " in text


def test_app_runs_on_the_card_unless_asked(image_folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the check of the default device needs a machine "
                    "without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_app.main(["--image_folder", image_folder, "--out_dir",
                       str(tmp_path), "--tiny"])
