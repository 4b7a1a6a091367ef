"""The data-loading profiler (profile_dataloading.py), the checkpoint
converter (convert_torch_checkpoint.py) and the host block timers
(perf/timing.py) against the JAX package's scripts and utils on the CPU.

The profiler counts the same batches and images as
scripts/profile_dataloading.py on a one-bucket WAI tree (the two packages'
dynamic samplers differ on purpose where a mix has several buckets). The
converter prints what scripts/convert_torch_checkpoint.py prints, line for
line but the last ("wrote"), and its file loads bitwise equal to the JAX
package's conversion of the same state dict taken onto the port's model
(`from_jax_params`), for MapAnything through `from_pretrained` and for a
DINOv2 encoder into `DinoViT`.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mapanything_tpu.utils import timing as JT
from mapanything_tpu.utils import weights as JW
from mapanything_tpu_torch import convert_torch_checkpoint as conv
from mapanything_tpu_torch import profile_dataloading
from mapanything_tpu_torch.data.wai import write_scene
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.pretrained import from_pretrained
from mapanything_tpu_torch.nn.dinov2 import DinoViT
from mapanything_tpu_torch.perf import timing as PT
from mapanything_tpu_torch.utils import weights as PW
from torch_reference_layout import reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(encoder_size="test", trunk_dim=64, trunk_depth=4,
             trunk_num_heads=2, trunk_indices=(1, 3), dpt_feature_dim=32,
             dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
# what infer_model_config cannot read from the shapes
OVERRIDES = dict(encoder_size="test", trunk_num_heads=2, trunk_indices=(1, 3))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_printed(fn, *args, argv=None, monkeypatch=None):
    """(fn's return value, its stdout); with `argv`, sys.argv is set for a
    main() that parses it."""
    if argv is not None:
        monkeypatch.setattr(sys, "argv", ["script"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# the profiler


@pytest.fixture(scope="module")
def wai_root(tmp_path_factory):
    """Two scenes of six 64 x 80 frames, one resolution bucket."""
    root = tmp_path_factory.mktemp("wai")
    rng = np.random.default_rng(0)
    d = np.abs(np.arange(6)[:, None] - np.arange(6)[None, :])
    covis = np.clip(1.0 - d / 3, 0, 1).astype(np.float32)
    for scene, fmt in (("scene_a", "exr"), ("scene_b", "npy")):
        frames = [{"frame_name": f"f{i}",
                   "image": rng.integers(0, 255, (64, 80, 3), dtype=np.uint8),
                   "depth": rng.uniform(1.0, 4.0, (64, 80)).astype(
                       np.float32),
                   "transform_matrix": np.eye(4)} for i in range(6)]
        write_scene(root / scene, frames,
                    dict(fx=60.0, fy=60.0, cx=40.0, cy=32.0, w=80, h=64),
                    covis, depth_format=fmt)
    return str(root)


def profiler_argv(root, samples, views, imgs, epochs, workers):
    spec = (f"{samples} @ WAIDataset(ROOT=wai_root, spec='eth3d', "
            f"num_views={views}, covisibility_thres=0.25, "
            f"resolution=(56, 42), seed=7)")
    return ["--wai_root", root, "--dataset_spec", spec, "--epochs",
            str(epochs), "--max_imgs_per_device", str(imgs),
            "--num_workers", str(workers)]


def counts_of(text):
    batches = [int(n) for n in re.findall(r"^epoch \d+: (\d+) batches$",
                                          text, re.M)]
    images = int(re.search(r"^TOTAL: (\d+) images in ", text, re.M).group(1))
    return batches, images


@pytest.mark.parametrize("samples,views,imgs,epochs,workers", [
    (8, 2, 4, 2, 2), (6, 3, 6, 1, 0), (5, 2, 6, 2, 1)])
def test_profiler_counts_equal_jax(wai_root, monkeypatch, samples, views,
                                   imgs, epochs, workers):
    argv = profiler_argv(wai_root, samples, views, imgs, epochs, workers)
    _, want = run_printed(jax_script("profile_dataloading").main, argv=argv,
                          monkeypatch=monkeypatch)
    got, text = run_printed(profile_dataloading.main, argv + ["--device",
                                                              "cpu"])
    assert counts_of(text) == counts_of(want)
    assert (got["batches"], got["images"]) == counts_of(want)
    assert got["images"] > 0 and got["images_per_s"] > 0
    assert re.search(rf"\({workers} workers\)$", text.strip())
    timers = got["timers"]
    assert sorted(timers) == sorted([f"epoch_{e}" for e in range(epochs)]
                                    + ["to_device"])
    assert timers["to_device"]["count"] == sum(got["batches"])


def test_profiler_runs_on_the_card_unless_asked(wai_root):
    if torch.cuda.is_available():
        pytest.skip("the check of the default device needs a machine "
                    "without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_dataloading.main(profiler_argv(wai_root, 4, 2, 4, 1, 0))


# ---------------------------------------------------------------------------
# the block timers


def test_block_timers_match_jax():
    ours, theirs = PT.BlockTimeManager(), JT.BlockTimeManager()
    for name, reps in (("load", 3), ("step", 1)):
        for _ in range(reps):
            with PT.block_timer(name, ours):
                pass
            with JT.block_timer(name, theirs):
                pass
    for mgr in (ours, theirs):  # the same totals, so the same text
        mgr.timers["load"].total, mgr.timers["step"].total = 0.0123, 0.5
    assert str(ours) == str(theirs) == "load: 4.1ms(x3)  step: 500.0ms(x1)"
    assert ours.summary() == theirs.summary()
    with pytest.raises(RuntimeError, match="before start"):
        PT.Timer().stop()


def test_default_manager_and_verbose(capsys):
    with PT.block_timer("default_manager_probe", verbose=True) as t:
        pass
    assert PT.default_manager.timers["default_manager_probe"] is t
    assert t.count == 1 and t.total >= 0
    assert re.match(r"\[default_manager_probe\] \d+\.\d\d ms",
                    capsys.readouterr().out)


# ---------------------------------------------------------------------------
# the checkpoint inspector and converter


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A seeded SMALL model's state dict in the reference's layout, saved
    as the reference's torch file."""
    model = PW.random_normal_(MapAnything(
        MapAnythingConfig(dtype=torch.float32, **SMALL), device="cpu"),
        seed=3)
    sd = reference_state_dict(model.state_dict(), SMALL["trunk_indices"])
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({"model": sd}, path)
    return sd, str(path)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_inspect_state_dict_equals_jax(reference, depth):
    sd, _ = reference
    assert (PW.inspect_state_dict(sd, depth)
            == JW.inspect_state_dict(sd, depth))
    assert PW.strip_prefix(sd, "encoder.model.").keys() == JW.strip_prefix(
        sd, "encoder.model.").keys()


def assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_converter_mapanything(reference, tmp_path, monkeypatch):
    sd, path = reference
    out = str(tmp_path / "converted.pt")
    rc, text = run_printed(conv.main, ["--input", path, "--output", out,
                                       "--report", "--device", "cpu"],
                           OVERRIDES)
    assert rc == 0
    _, want = run_printed(jax_script("convert_torch_checkpoint").main,
                          argv=["--input", path, "--output",
                                str(tmp_path / "jax_params"), "--report"],
                          monkeypatch=monkeypatch)
    assert text.splitlines()[:-1] == want.splitlines()[:-1]
    assert text.splitlines()[-1] == f"wrote {out}"
    groups = JW.inspect_state_dict(sd, depth=2)
    assert [line.strip() for line in text.splitlines()[1:1 + len(groups)]] \
        == [f"{g}: {n}" for g, n in groups.items()]

    tree = JW.convert_mapanything_checkpoint(
        sd, trunk_indices=SMALL["trunk_indices"])
    tree = {k: v for k, v in tree.items() if not k.startswith("_")}
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **SMALL),
                        device="cpu")
    want_sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
               PW.from_jax_params(tree, model).items()}
    # the port's files hold no config: the whole architecture is given
    loaded = from_pretrained(out, torch.float32, SMALL, device="cpu")
    assert_bitwise(dict(loaded.named_parameters()), want_sd)
    assert_bitwise(loaded.state_dict(), torch.load(out, weights_only=True))


def test_converter_unmapped_keys(tmp_path):
    """A key no rule takes: reported, left out, the rest converted (the
    demos' tiny architecture, given as config_overrides)."""
    model = PW.random_normal_(MapAnything(MapAnythingConfig(
        dtype=torch.float32, **conv_tiny()), device="cpu"), seed=5)
    sd = reference_state_dict(model.state_dict(),
                              conv_tiny()["trunk_indices"])
    sd["mystery.weight"] = torch.zeros(3)
    path = tmp_path / "tiny.pt"
    torch.save(sd, path)
    out = str(tmp_path / "out.pt")
    rc, text = run_printed(conv.main, ["--input", str(path), "--output", out,
                                       "--device", "cpu"], conv_tiny())
    assert rc == 0 and "WARNING: 1 unmapped keys" in text
    loaded = from_pretrained(out, torch.float32, conv_tiny(), device="cpu")
    assert_bitwise(loaded.state_dict(), model.state_dict())


def conv_tiny():
    from mapanything_tpu_torch.demo_colmap import TINY_CONFIG

    return TINY_CONFIG


def test_converter_dinov2(reference, tmp_path, monkeypatch):
    sd, _ = reference
    hub = PW.strip_prefix(sd, "encoder.model.")  # a torch-hub DINOv2
    path = str(tmp_path / "dinov2.pth")
    torch.save(hub, path)
    out = str(tmp_path / "dinov2_port.pt")
    rc, text = run_printed(conv.main, ["--input", path, "--output", out,
                                       "--report", "--device", "cpu"])
    assert rc == 0
    _, want = run_printed(jax_script("convert_torch_checkpoint").main,
                          argv=["--input", path, "--output",
                                str(tmp_path / "jax_dinov2")],
                          monkeypatch=monkeypatch)
    lines = text.splitlines()
    groups = len(JW.inspect_state_dict(hub, depth=2))
    assert lines[:1] + lines[1 + groups:-1] == want.splitlines()[:-1]
    assert "converted DINOv2 encoder" in text

    params, used = JW.convert_dinov2(hub)
    model = DinoViT("test", device="cpu")
    want_sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
               PW.from_jax_params(params, model).items()}
    got = torch.load(out, weights_only=True)
    assert_bitwise(got, want_sd)
    model.load_state_dict(got)


def test_converter_refuses_a_port_file(tmp_path):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **SMALL),
                        device="cpu")
    path = str(tmp_path / "port.pt")
    torch.save(model.state_dict(), path)
    with pytest.raises(ValueError, match="already a file of this package"):
        conv.main(["--input", path, "--output", str(tmp_path / "o.pt"),
                   "--device", "cpu"])


def test_converter_runs_on_the_card_unless_asked(reference, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the check of the default device needs a machine "
                    "without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv.main(["--input", reference[1], "--output",
                   str(tmp_path / "o.pt")])


NEW_MODULES = ("demo_app", "profile_dataloading", "convert_torch_checkpoint",
               "utils.demo_core", "utils.mesh", "utils.colormaps")
# one fresh interpreter: the new modules' imports, then each CLI's --help
PROBE = """
import contextlib, io, json, sys
import importlib
mods = {name: importlib.import_module("mapanything_tpu_torch." + name)
        for name in NAMES}
bad = [m for m in ("matplotlib", "cv2", "gradio", "jax", "mapanything_tpu")
       if m in sys.modules]
helps = {}
for name in NAMES[:3]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            mods[name].main(["--help"])
        except SystemExit:
            pass
    helps[name] = buf.getvalue()
print(json.dumps({"imported": bad, "help": helps}))
"""


@pytest.fixture(scope="module")
def fresh_interpreter():
    proc = subprocess.run(
        [sys.executable, "-c", f"NAMES = {NEW_MODULES!r}" + PROBE], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", NEW_MODULES[:3])
def test_module_entry_points(fresh_interpreter, module):
    """Every flag of the JAX package's script, and --device."""
    text = fresh_interpreter["help"][module]
    with open(os.path.join(ROOT, "scripts", f"{module}.py")) as f:
        flags = set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))
    assert flags and not {f for f in flags if f not in text}
    assert "--device" in text
    proc = subprocess.run([sys.executable, "-m",
                           f"mapanything_tpu_torch.{module}", "--help"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120) if module == "demo_app" else None
    assert proc is None or (proc.returncode == 0 and "--ui" in proc.stdout)


def test_no_matplotlib_cv2_or_jax_in_the_new_modules(fresh_interpreter):
    """The new modules import without matplotlib, cv2, gradio or JAX."""
    assert fresh_interpreter["imported"] == []
