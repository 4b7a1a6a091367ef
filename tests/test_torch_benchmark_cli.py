"""The three benchmark CLIs of the port on the CPU (`--tiny --device cpu`):

  * `python -m mapanything_tpu_torch.benchmark_dense_n_view` and
    `benchmark_calibration` over a WAI tree written by the port's writer,
    beside the JAX package's scripts/benchmark_*.py on the same tree and
    flags: the same files, JSON keys and set counts (the weights differ:
    each package's own seeded init, so the values are not compared here;
    tests/test_torch_benchmarks.py holds the harnesses' numbers);
  * `benchmark_rmvd`: --selftest, the clean error without the rmvd
    package, and the external harness's call shape against a fake rmvd
    module (as tests/test_rmvd_cli.py holds the JAX script);
  * without --device each CLI runs on the card, and raises without one.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from mapanything_tpu_torch import benchmark_calibration as PCalCLI
from mapanything_tpu_torch import benchmark_dense_n_view as PDenseCLI
from mapanything_tpu_torch import benchmark_rmvd as PRmvdCLI
from mapanything_tpu_torch.data.wai import write_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def wai_root(tmp_path_factory):
    """Two scenes of six 64 x 80 frames (depth in EXR and in npy), a banded
    covisibility, a camera moving along x."""
    root = tmp_path_factory.mktemp("wai")
    rng = np.random.default_rng(0)
    d = np.abs(np.arange(6)[:, None] - np.arange(6)[None, :])
    covis = np.clip(1.0 - d / 3, 0, 1).astype(np.float32)
    yy = np.linspace(0, 1, 64)[:, None] * np.ones((1, 80))
    for scene, fmt in (("scene_a", "exr"), ("scene_b", "npy")):
        frames = []
        for i in range(6):
            pose = np.eye(4)
            pose[:3, 3] = [0.1 * i, 0.0, 0.02 * i]
            frames.append({
                "frame_name": f"f{i}",
                "image": rng.integers(0, 255, (64, 80, 3), dtype=np.uint8),
                "depth": (2.0 + yy + rng.uniform(0, 0.1, (64, 80))).astype(
                    np.float32),
                "transform_matrix": pose})
        write_scene(str(root / scene), frames,
                    dict(fx=60.0, fy=60.0, cx=40.0, cy=32.0, w=80, h=64),
                    covis, depth_format=fmt)
    return str(root)


def json_shape(obj):
    """The keys and list lengths of a JSON document, values left out."""
    if isinstance(obj, dict):
        return {k: json_shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_shape(v) for v in obj]
    return type(obj).__name__


def test_dense_n_view_cli_writes_what_the_jax_script_writes(
        wai_root, tmp_path, monkeypatch):
    flags = ["--wai_root", wai_root, "--tiny", "--views", "2", "4",
             "--batch_sizes", "2", "1", "--num_sets", "2"]
    out = str(tmp_path / "port")
    results = PDenseCLI.main(flags + ["--output_dir", out, "--device", "cpu"])
    assert set(results) == {2, 4}
    ref = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["benchmark_dense_n_view.py", *flags,
                                      "--output_dir", ref, "--cpu"])
    jax_script("benchmark_dense_n_view").main()
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref)) == [
        "eth3d_2views.json", "eth3d_4views.json", "summary.json"]
    for name in os.listdir(ref):
        with open(os.path.join(out, name)) as f:
            got = json.load(f)
        with open(os.path.join(ref, name)) as f:
            want = json.load(f)
        assert json_shape(got) == json_shape(want), name
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    for views in ("2", "4"):
        assert summary[views]["num_sets"] == 2
        assert all(np.isfinite(v) for k, v in summary[views].items()
                   if k not in ("pose_auc_5",))


def test_dense_n_view_cli_with_priors(wai_root, tmp_path):
    results = PDenseCLI.main([
        "--wai_root", wai_root, "--tiny", "--views", "2", "--batch_sizes",
        "2", "--num_sets", "2", "--task", "all_priors", "--memory_efficient",
        "--output_dir", str(tmp_path), "--device", "cpu"])
    assert results[2]["num_sets"] == 2
    assert np.isfinite(results[2]["pointmaps_abs_rel"])


def test_dense_n_view_cli_reads_a_checkpoint(wai_root, tmp_path):
    """--checkpoint takes a train/checkpoints.py::save_params file: the
    numbers are those of the saved weights, not of a fresh init."""
    from mapanything_tpu_torch.train.checkpoints import save_params

    model = PDenseCLI.build_model(True, None, "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    save_params(str(tmp_path / "params.pt"), model)
    flags = ["--wai_root", wai_root, "--tiny", "--views", "2",
             "--batch_sizes", "2", "--num_sets", "2", "--device", "cpu"]
    fresh = PDenseCLI.main(flags + ["--output_dir", str(tmp_path / "a")])
    loaded = PDenseCLI.main(flags + ["--output_dir", str(tmp_path / "b"),
                                     "--checkpoint",
                                     str(tmp_path / "params.pt")])
    assert loaded[2]["num_sets"] == 2
    assert loaded[2]["pointmaps_abs_rel"] != fresh[2]["pointmaps_abs_rel"]


def test_calibration_cli_writes_what_the_jax_script_writes(
        wai_root, tmp_path, monkeypatch):
    flags = ["--wai_root", wai_root, "--tiny", "--batch_size", "2",
             "--num_sets", "4"]
    out = str(tmp_path / "port")
    summary = PCalCLI.main(flags + ["--output_dir", out, "--device", "cpu"])
    assert summary["num_images"] == 4
    assert np.isfinite(summary["ray_angular_error_deg_mean"])
    ref = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["benchmark_calibration.py", *flags,
                                      "--output_dir", ref, "--cpu"])
    jax_script("benchmark_calibration").main()
    assert os.listdir(out) == os.listdir(ref) == ["eth3d_calibration.json"]
    with open(os.path.join(out, "eth3d_calibration.json")) as f:
        got = json.load(f)
    with open(os.path.join(ref, "eth3d_calibration.json")) as f:
        want = json.load(f)
    assert json_shape(got) == json_shape(want)


@pytest.mark.parametrize("cli,argv", [
    (PDenseCLI, ["--wai_root", "unused", "--tiny"]),
    (PCalCLI, ["--wai_root", "unused", "--tiny"]),
    (PRmvdCLI, ["--selftest"]),
])
def test_clis_run_on_the_card_by_default(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


# --- RMVD -------------------------------------------------------------------


def test_rmvd_selftest_runs_without_rmvd(capsys):
    assert PRmvdCLI.main(["--selftest", "--selftest-res", "56",
                          "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_samples"] == 2 and np.isfinite(out["depth_abs_rel"])


def test_rmvd_missing_package_is_a_clean_error(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setitem(sys.modules, "rmvd", None)  # import -> ImportError
    assert PRmvdCLI.main(["--out", str(tmp_path / "o"),
                          "--device", "cpu"]) == 2
    assert "rmvd" in capsys.readouterr().err


@pytest.fixture()
def fake_rmvd(monkeypatch):
    """A stand-in rmvd recording its calls and driving the adaptor as the
    mvd evaluation does (input_adapter -> model -> output_adapter)."""
    calls = {}

    def create_dataset(name, task, input_size=None, root=None):
        calls["dataset"] = dict(name=name, task=task, input_size=input_size,
                                root=root)
        rng = np.random.default_rng(0)
        h, w = input_size
        k = np.array([[[w / 2.0, 0, w / 2], [0, w / 2.0, h / 2], [0, 0, 1]]],
                     np.float32)
        return [{
            "images": [rng.integers(0, 255, size=(1, 3, h, w)).astype(
                np.uint8) for _ in range(2)],
            "keyview_idx": 0,
            "poses": [np.eye(4, dtype=np.float32)[None]] * 2,
            "intrinsics": [k] * 2,
            "gt": rng.uniform(1, 4, size=(h, w)).astype(np.float32),
        }]

    def create_evaluation(evaluation_type, out_dir, inputs=(),
                          alignment=None, eval_uncertainty=False,
                          max_source_views=None):
        calls["evaluation"] = dict(
            evaluation_type=evaluation_type, out_dir=out_dir,
            inputs=list(inputs), alignment=alignment,
            eval_uncertainty=eval_uncertainty,
            max_source_views=max_source_views)

        def evaluation(dataset, model):
            assert hasattr(model, "name")
            inputs = calls["evaluation"]["inputs"]
            absrels = []
            for s in dataset:
                views = model.input_adapter(
                    s["images"], s["keyview_idx"],
                    poses=s["poses"] if "poses" in inputs else None,
                    intrinsics=(s["intrinsics"] if "intrinsics" in inputs
                                else None),
                    depth_range=None)
                pred, aux = model.output_adapter(model(views))
                assert pred["depth"].shape == (1, 1, *s["gt"].shape)
                assert np.isfinite(pred["depth"]).all()
                assert "depth_uncertainty" in pred
                valid = s["gt"] > 0
                absrels.append(float(np.abs(
                    pred["depth"][0, 0][valid] - s["gt"][valid]).mean()))
            calls["ran"] = len(absrels)
            return {"abs_err": float(np.mean(absrels))}

        return evaluation

    mod = types.ModuleType("rmvd")
    mod.create_dataset = create_dataset
    mod.create_evaluation = create_evaluation
    monkeypatch.setitem(sys.modules, "rmvd", mod)
    return calls


def test_rmvd_external_harness_wiring(fake_rmvd, tmp_path):
    assert PRmvdCLI.main([
        "--dataset", "eth3d", "--data-root", str(tmp_path),
        "--conditioning", "image+intrinsics+pose",
        "--resolution", "56", "42", "--out", str(tmp_path / "out"),
        "--device", "cpu"]) == 0
    # the reference's call shape (benchmark.py:63-88)
    assert fake_rmvd["dataset"] == dict(
        name="eth3d", task="mvd", input_size=(42, 56),
        root=os.path.join(str(tmp_path), "eth3d"))
    ev = fake_rmvd["evaluation"]
    assert ev["evaluation_type"] == "mvd"
    assert ev["inputs"] == ["intrinsics", "poses"]
    assert ev["alignment"] == "median"
    assert ev["max_source_views"] == 7
    assert fake_rmvd["ran"] == 1
    with open(tmp_path / "out" / "setting.json") as f:
        setting = json.load(f)
    assert setting["conditioning"] == "image+intrinsics+pose"
    assert setting["device"] == "cpu"
