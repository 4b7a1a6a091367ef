"""The port's per-source converters, follow-on stages and CLI
(mapanything_tpu_torch/data/{converters,converters_corpus}.py,
mapanything_tpu_torch/convert_dataset.py) against the JAX package's, on the
CPU.

Every converter runs on the JAX tests' own synthetic raw trees
(tests/test_converters.py, tests/test_converters_corpus.py, imported, not
edited) once through each package; the two WAI trees must match file by
file: JSON equal as parsed, images and masks bitwise, depth within 1e-6.
MegaDepth's rectified intrinsics are the one exception, within 1e-6
relative: JAX calls cv2 where it imports, the port computes OpenCV's rule
in numpy (`_rectified_pinhole_K`, held to cv2 below). The mesh ray cast
differs by fp32 rounding (tests/test_torch_covisibility.py's limits).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_converters as JT
import test_converters_corpus as JTC
from mapanything_tpu.data import converters as JV
from mapanything_tpu.data import converters_corpus as JCC
from mapanything_tpu_torch import convert_dataset as CLI
from mapanything_tpu_torch.data import converters as PV
from mapanything_tpu_torch.data import converters_corpus as PCC
from mapanything_tpu_torch.data.wai import load_frame, load_scene_meta

from torch_offline_scenes import (
    assert_render_close,
    assert_trees_equal,
    room_mesh,
    write_ply,
)

REPO = Path(__file__).resolve().parent.parent
K_RTOL = 1e-6  # MegaDepth's K: the port's numpy rule against cv2


def _raw(case, root):
    """Write case's raw tree under root; returns (scene, converter kwargs,
    JAX converter, port converter)."""
    if case == "eth3d":
        JT._write_eth3d_scene(root)
        return ("courtyard", {"raw_depth_hw": (JT.H, JT.W)},
                JV.convert_eth3d_scene, PV.convert_eth3d_scene)
    if case == "eth3d_portrait":  # the quirk table's rotated frames
        JT._write_eth3d_scene(root, scene="relief",
                              names=("DSC_0427.JPG", "DSC_0001.JPG"))
        return ("relief", {"raw_depth_hw": (JT.H, JT.W)},
                JV.convert_eth3d_scene, PV.convert_eth3d_scene)
    if case == "scannetppv2":
        JT._write_scannetpp_scene(root)
        return ("0e900bcc5c", {}, JV.convert_scannetppv2_scene,
                PV.convert_scannetppv2_scene)
    if case == "tav2_wb":
        JT._write_tav2_scene(root)
        return ("Supermarket", {}, JV.convert_tav2_wb_scene,
                PV.convert_tav2_wb_scene)
    scene, kw = {
        "blendedmvs": ("5a2a95f0", {}), "dl3dv": ("1K_abc123", {}),
        "dynamicreplica": ("90ac3c-3_obj_source", {}),
        "megadepth": ("0000_0", {}),
        "mpsd": ("geoeven_4_2019-03-17T16_16_24", {}),
        "mvs_synth": ("0000", {}), "paralleldomain4d": ("scene_000000", {}),
        "sailvos3d": ("ah_3a_ext", {}), "spring": ("0001", {}),
        "spring_test": ("0003", {}), "unrealstereo4k": ("00000", {}),
        "ase": ("session_0", {}),
    }[case]
    name = case.replace("_test", "")
    if case == "blendedmvs":
        JTC._write_blendedmvs(root, scene)
    elif case == "spring_test":
        JTC._write_spring(root, scene=scene, split="test")
    elif case == "ase":
        kw = {"calib_json_path": JTC._write_ase(root)}
    else:
        writer = {"dl3dv": JTC._write_dl3dv,
                  "dynamicreplica": JTC._write_dynamicreplica,
                  "megadepth": JTC._write_megadepth,
                  "mpsd": JTC._write_mpsd, "mvs_synth": JTC._write_mvs_synth,
                  "paralleldomain4d": JTC._write_pd4d,
                  "sailvos3d": JTC._write_sailvos,
                  "spring": JTC._write_spring,
                  "unrealstereo4k": JTC._write_us4k}[name]
        writer(root)
    return (scene, kw, JCC.CORPUS_CONVERTERS[name],
            PCC.CORPUS_CONVERTERS[name])


CASES = ["eth3d", "eth3d_portrait", "scannetppv2", "tav2_wb", "ase",
         "blendedmvs", "dl3dv", "dynamicreplica", "megadepth", "mpsd",
         "mvs_synth", "paralleldomain4d", "sailvos3d", "spring",
         "spring_test", "unrealstereo4k"]


@pytest.mark.parametrize("case", CASES)
def test_converter_tree_matches_jax(case, tmp_path, monkeypatch):
    # ASE's camera-rgb size is a protocol constant (704); the fixture's
    # renders are 16 px, as in the JAX test
    monkeypatch.setattr(JCC, "ASE_RGB_IMAGE_SIZE", JTC.ASE_W)
    monkeypatch.setattr(PCC, "ASE_RGB_IMAGE_SIZE", JTC.ASE_W)
    scene, kw, jax_fn, port_fn = _raw(case, tmp_path / "raw")
    want = jax_fn(tmp_path / "raw", tmp_path / "jax", scene, **kw)
    got = port_fn(tmp_path / "raw", tmp_path / "port", scene, **kw)
    assert Path(got).name == Path(want).name
    n = assert_trees_equal(want, got, json_rtol=K_RTOL
                           if case == "megadepth" else 0.0)
    assert n >= 2


# (K, distortion, source size, new size): OpenCV's 4-, 5- and 8-term
# models, shrinking and keeping sizes, and a barrel strong enough that
# OpenCV stops the border points at their distorted position
MEGADEPTH_CAMERAS = [
    ([[500, 0, 320], [0, 500, 240]], [-0.1, 0, 0, 0], (640, 480), (640, 480)),
    ([[20, 0, 8], [0, 20, 6]], [0.0, 0, 0, 0], (16, 12), (16, 12)),
    ([[1200, 0, 800.5], [0, 1190, 533.2]], [0.05, 0, 0, 0], (1600, 1067),
     (800, 533)),
    ([[700, 0, 512], [0, 700, 380]], [-0.25, 0, 0, 0], (1024, 768),
     (1024, 768)),
    ([[300, 0, 160], [0, 310, 120]], [0.12, -0.03, 0.001, -0.002, 0.01],
     (320, 240), (300, 200)),
    ([[900, 0, 600], [0, 905, 410]],
     [0.3, 0.1, 0.001, 0.0005, 0.02, 0.1, 0.02, 0.001], (1200, 820),
     (1200, 820)),
]


@pytest.mark.parametrize("K,dist,pre,post", MEGADEPTH_CAMERAS)
def test_megadepth_intrinsics_match_cv2(K, dist, pre, post):
    cv2 = pytest.importorskip("cv2")
    K = np.array(K + [[0, 0, 1]], np.float64)
    want = cv2.getOptimalNewCameraMatrix(
        K, np.array(dist, np.float64), pre, alpha=0, newImgSize=post,
        centerPrincipalPoint=True)[0]
    got = PCC._rectified_pinhole_K(K, dist, pre, post)
    np.testing.assert_allclose(got, want, rtol=K_RTOL,
                               atol=K_RTOL * np.abs(want).max())


@pytest.mark.parametrize("package,case", [("h5py", "megadepth"),
                                          ("yaml", "sailvos3d")])
def test_missing_format_package_is_named(package, case, tmp_path,
                                         monkeypatch):
    scene, kw, _, port_fn = _raw(case, tmp_path / "raw")
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=repr(package)):
        port_fn(tmp_path / "raw", tmp_path / "port", scene, **kw)


def test_read_ply_matches_jax(tmp_path):
    verts, faces, colours = room_mesh(cells=3)
    write_ply(tmp_path / "room.ply", verts, faces, colours)
    (tmp_path / "a.ply").write_text("\n".join([
        "ply", "format ascii 1.0", "element vertex 3",
        "property float x", "property float y", "property float z",
        "element face 1", "property list uchar int vertex_indices",
        "end_header", "0 0 0", "1 0 0", "0 1 0", "3 0 1 2"]) + "\n")
    for name in ("room.ply", "a.ply"):
        got, want = PV.read_ply(tmp_path / name), JV.read_ply(tmp_path / name)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(PV.read_ply(tmp_path / "room.ply")[1],
                                  faces)
    (tmp_path / "q.ply").write_text((tmp_path / "a.ply").read_text().replace(
        "3 0 1 2", "4 0 1 2 0"))
    with pytest.raises(ValueError, match="non-triangle"):
        PV.read_ply(tmp_path / "q.ply")


@pytest.fixture(scope="module")
def snpp_stages(tmp_path_factory):
    """ScanNet++ through conversion, undistortion and the mesh render, in
    each package."""
    root = tmp_path_factory.mktemp("snpp")
    JT._write_scannetpp_scene(root / "raw")
    out = {}
    for tag, mod, kw in (("jax", JV, {}), ("port", PV, {"device": "cpu"})):
        dst = mod.convert_scannetppv2_scene(root / "raw", root / tag,
                                            "0e900bcc5c", link=False)
        mod.undistort_scene(dst)
        mod.render_scene_depth_stage(dst, **kw)
        out[tag] = dst
    return out


def test_undistort_and_render_stages_match_jax(snpp_stages):
    n = assert_trees_equal(snpp_stages["jax"], snpp_stages["port"],
                           compare={"rendered_depth/": assert_render_close})
    assert n >= 4 * 4  # images and masks, distorted and not, and depth
    meta = load_scene_meta(snpp_stages["port"] / "scene_meta.json")
    assert meta["camera_model"] == "PINHOLE"
    d = load_frame(snpp_stages["port"], 0, ["rendered_depth"],
                   scene_meta=meta)["rendered_depth"]
    hit = d > 0
    assert hit.mean() > 0.5  # the plane at z = 2 fills most of the view
    np.testing.assert_allclose(d[hit], 2.0, rtol=1e-5)


def test_rendered_tree_loads_through_the_dataset(snpp_stages):
    """The port's converted, undistorted and rendered ScanNet++ scene with
    the port's covisibility loads through its `scannetpp` spec."""
    from mapanything_tpu_torch.data.covisibility import (
        compute_pairwise_covisibility,
    )
    from mapanything_tpu_torch.data.wai import store_data
    from mapanything_tpu_torch.data.wai_datasets import WAIDataset

    dst = snpp_stages["port"]
    meta = load_scene_meta(dst / "scene_meta.json")
    recs = [load_frame(dst, i, ["rendered_depth"], scene_meta=meta)
            for i in range(len(meta["frames"]))]
    covis = compute_pairwise_covisibility(
        np.stack([r["rendered_depth"] for r in recs]),
        np.stack([r["intrinsics"] for r in recs]),
        np.stack([r["extrinsics"] for r in recs]), device="cpu")
    store_data(dst / "covisibility" / "v0" / "covis.npy", covis, "mmap")
    ds = WAIDataset(ROOT=str(dst.parent), spec="scannetpp", num_views=2,
                    covisibility_thres=0.1, resolution=(64, 48),
                    data_norm_type="dinov2", seed=0)
    views = ds[0]
    assert len(views) == 2 and views[0]["img"].shape[:2] == (48, 64)
    assert float(np.asarray(views[0]["depthmap"]).max()) > 0


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_dataset", REPO / "scripts" / "convert_dataset.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def test_cli_accepts_all_fourteen_and_discovers_as_jax(tmp_path):
    choices = next(a for a in CLI.parser()._actions
                   if a.dest == "dataset").choices
    assert sorted(choices) == sorted(
        ["eth3d", "scannetppv2", "tav2_wb", *JCC.CORPUS_CONVERTERS])
    assert len(choices) == 14
    jcli = _jax_cli()
    for case in ("dl3dv", "megadepth", "spring", "dynamicreplica", "mpsd",
                 "blendedmvs"):
        _raw(case, tmp_path / case)
        assert (CLI._discover_scenes(case, str(tmp_path / case))
                == jcli._discover_scenes(case, str(tmp_path / case)))


@pytest.mark.parametrize("dataset,flags", [
    ("blendedmvs", []), ("dl3dv", ["--copy"]),
    ("scannetppv2", ["--undistort", "--render-depth"])])
def test_cli_tree_matches_jax_cli(dataset, flags, tmp_path):
    _raw(dataset, tmp_path / "raw")
    _jax_cli().main([dataset, str(tmp_path / "raw"), str(tmp_path / "jax"),
                     *flags])
    roots = CLI.main([dataset, str(tmp_path / "raw"), str(tmp_path / "port"),
                      *flags, "--device", "cpu"])
    assert [r.parent for r in roots] == [tmp_path / "port"]
    assert_trees_equal(tmp_path / "jax", tmp_path / "port",
                       compare={"0e900bcc5c/rendered_depth/":
                                assert_render_close})


def test_cli_refuses_pseudo_depth_naming_item_9(tmp_path):
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        CLI.main(["tav2_wb", str(tmp_path), str(tmp_path / "out"),
                  "--pseudo-depth", "moge.pt", "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    JT._write_tav2_scene(tmp_path / "raw")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["tav2_wb", str(tmp_path / "raw"), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_cli_python_m(tmp_path):
    JT._write_tav2_scene(tmp_path / "raw")
    run = subprocess.run(
        [sys.executable, "-m", "mapanything_tpu_torch.convert_dataset",
         "tav2_wb", str(tmp_path / "raw"), str(tmp_path / "out"),
         "--device", "cpu", "--copy"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "converted 1 scene(s)" in run.stdout
    JV.convert_tav2_wb_scene(tmp_path / "raw", tmp_path / "jax",
                             "Supermarket", link=False)
    assert_trees_equal(tmp_path / "jax", tmp_path / "out")
