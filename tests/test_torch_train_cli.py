"""The training-data slice as a whole, on the CPU: a batch of the port's
train loader and one of the JAX package's, from the same WAI tree and seed
(bitwise equal), through the port's train step and JAX's loss at the tiny
config with the same weights (tests/torch_jax_init.py, load_jax_params),
images only, fp32, the JAX side under jax.default_matmul_precision
("highest"): loss and every parameter gradient within 1e-4 of the
reference's max-abs per tensor (tests/test_torch_train.py's limit). Then
the CLI, `python -m mapanything_tpu_torch.train`, at --tiny: two steps,
checkpoint-last, a resumed run, and the runs it refuses.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.data import loader as JL
from mapanything_tpu.data import wai_datasets as JD
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config as jax_images_only
from mapanything_tpu.train import losses as JLoss
from mapanything_tpu_torch.data import loader as PL
from mapanything_tpu_torch.data import wai_datasets as PD
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.data.wai import write_scene
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    images_only_config,
)
from mapanything_tpu_torch.train import loop as PLoop
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.train.__main__ import TINY_CONFIG, main
from mapanything_tpu_torch.train.checkpoints import load_train_state
from mapanything_tpu_torch.utils.weights import from_jax_params, load_jax_params
from torch_jax_init import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 42, 56  # 3 x 4 patches of 14
DATASET = dict(spec="eth3d", num_views=2, covisibility_thres=0.25,
               resolution=(W, H), seed=7)
# The gradient is discontinuous at a ReLU's kink: where a ReLU input lies
# within fp32 rounding of 0, the two packages' gradients may legitimately
# differ by its whole contribution. The weights (JAX's init perturbed by
# seeded noise, as tests/test_torch_train.py) must keep every ReLU input of
# the port's forward at least RELU_MARGIN of its layer's max away from 0;
# the test checks that. (Noise seed 12 on this batch puts one DPT ReLU
# input 1e-8 from the kink, and one tensor's gradient then differs by
# 1.9e-3; seeds 10-21 but 12 agree within 1e-5.)
PERTURB_SEED = 13
RELU_MARGIN = 1e-7


@pytest.fixture(scope="module")
def wai_root(tmp_path_factory):
    """Two scenes of six 64 x 80 frames (depth in EXR and in npy), a banded
    covisibility."""
    root = tmp_path_factory.mktemp("wai")
    rng = np.random.default_rng(0)
    d = np.abs(np.arange(6)[:, None] - np.arange(6)[None, :])
    covis = np.clip(1.0 - d / 3, 0, 1).astype(np.float32)
    for scene, fmt in (("scene_a", "exr"), ("scene_b", "npy")):
        frames = []
        for i in range(6):
            pose = np.eye(4)
            pose[:3, 3] = [0.1 * i, 0.0, 0.02 * i]
            frames.append({
                "frame_name": f"f{i}",
                "image": rng.integers(0, 255, (64, 80, 3), dtype=np.uint8),
                "depth": rng.uniform(1.0, 4.0, (64, 80)).astype(np.float32),
                "transform_matrix": pose})
        write_scene(root / scene, frames,
                    dict(fx=60.0, fy=60.0, cx=40.0, cy=32.0, w=80, h=64),
                    covis, depth_format=fmt)
    return str(root)


def first_batch(module, datasets, root, workers):
    loader = module.get_train_data_loader(
        4 @ datasets.WAIDataset(ROOT=root, **DATASET),
        max_num_of_imgs_per_gpu=4, num_workers=workers)
    loader.set_epoch(0)
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def _assert_close_max(out, ref, tol, name):
    """max |out - ref| <= tol * max |ref| (and finite)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    assert np.isfinite(out).all(), name
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: max abs err {err:.3g}"


def test_loader_batch_through_the_train_step_matches_jax(wai_root):
    batch = first_batch(PL, PD, wai_root, workers=2)
    jbatch = first_batch(JL, JD, wai_root, workers=0)
    for group in ("views", "gt"):
        assert sorted(batch[group]) == sorted(jbatch[group])
        for key, want in jbatch[group].items():
            np.testing.assert_array_equal(batch[group][key], want,
                                          err_msg=key)
    assert batch["views"]["img"].shape == (2, 2, H, W, 3)

    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32,
                                             **TINY_CONFIG))
    params = _perturb(init_params(jax_model, H, W), PERTURB_SEED)

    def loss_fn(p):
        preds = jax_model.apply(p, jbatch["views"], jax_images_only())
        return JLoss.overall_loss(jbatch["gt"], preds)

    with jax.default_matmul_precision("highest"):
        (ref_loss, ref_det), ref_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = load_jax_params(MapAnything(MapAnythingConfig(
        dtype=torch.float32, **TINY_CONFIG), device="cpu"), params)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, ref_grads), port)
    names = [n for n, _ in port.named_parameters()]
    margins = []
    relu = torch.nn.functional.relu

    def recording_relu(x, *args, **kw):  # each input's distance to 0
        a = x.detach().abs()
        margins.append(float(a.min() / a.max().clamp_min(1e-30)))
        return relu(x, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", recording_relu)
        loss, det, grads = PS.loss_and_grads(
            PS.make_loss_fn(port, images_only_config()),
            [p for _, p in port.named_parameters()],
            PLoop.to_device(batch, "cpu"))
    assert margins and min(margins) >= RELU_MARGIN, min(margins)
    _assert_close_max(loss.numpy(), np.asarray(ref_loss), 1e-4, "loss")
    for key in ref_det:
        _assert_close_max(det[key].detach().numpy(), np.asarray(ref_det[key]),
                          1e-4, key)
    for name, g in zip(names, grads):
        _assert_close_max(g.numpy(), ref_grads[name], 1e-4, f"d {name}")


def test_batch_has_the_synthetic_batch_contract(wai_root):
    """The step was built on make_synthetic_batch's batches: the loader's
    hold the same keys, dtypes and shapes."""
    got = PLoop.to_device(first_batch(PL, PD, wai_root, workers=0), "cpu")
    want = make_synthetic_batch(2, 2, H, W, device="cpu")
    for group in ("views", "gt"):
        assert sorted(got[group]) == sorted(want[group]), group
        for key, ref in want[group].items():
            assert got[group][key].dtype == ref.dtype, key
            assert got[group][key].shape == ref.shape, key


def cli_args(root, out, epochs=1, device=("--device", "cpu")):
    spec = ("4 @ WAIDataset(ROOT=wai_root, spec='eth3d', num_views=2, "
            "covisibility_thres=0.25, resolution=[(56, 42), (56, 28)], "
            "seed=7)")
    val = ("2 @ WAIDataset(ROOT=wai_root, spec='eth3d', num_views=2, "
           "covisibility_thres=0.25, resolution=(56, 42), seed=9)")
    return ["--wai_root", root, "--dataset_spec", spec,
            "--val_dataset_spec", val, "--tiny", *device,
            "--epochs", str(epochs), "--max_imgs_per_device", "4",
            "--warmup_steps", "1", "--print_freq", "1", "--num_workers", "2",
            "--output_dir", str(out)]


def test_cli_trains_checkpoints_and_resumes(wai_root, tmp_path, monkeypatch,
                                            capsys):
    steps = []
    make = PLoop.make_train_step

    def recording(*args, **kw):  # every step's loss and image shape
        step = make(*args, **kw)

        def run(state, batch, generator=None):
            state, metrics = step(state, batch, generator)
            steps.append((float(metrics["loss"]),
                          tuple(batch["views"]["img"].shape)))
            return state, metrics
        return run

    monkeypatch.setattr(PLoop, "make_train_step", recording)
    state = main(cli_args(wai_root, tmp_path))
    assert state.step == 2 and len(steps) == 2
    assert all(math.isfinite(loss) for loss, _ in steps)
    assert all(shape[:2] == (2, 2) for _, shape in steps)
    last = tmp_path / "checkpoint-last"
    assert last.exists() and (tmp_path / "checkpoint-best").exists()
    log = [json.loads(line) for line in (tmp_path / "log.txt").open()]
    assert log[-1]["epoch"] == 0 and log[-1]["steps"] == 2

    fresh = PS.create_train_state(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY_CONFIG),
                    device="cpu"), PS.OptimConfig())
    fresh, _, epoch = load_train_state(str(last), fresh)
    assert epoch == 1 and fresh.step == 2
    for (name, got), want in zip(fresh.model.state_dict().items(),
                                 state.model.state_dict().values()):
        assert torch.equal(got, want), name

    # a second run with one more epoch resumes there and takes 2 steps
    resumed = main(cli_args(wai_root, tmp_path, epochs=2))
    assert "resumed from" in capsys.readouterr().out
    assert resumed.step == 4 and len(steps) == 4
    assert all(math.isfinite(loss) for loss, _ in steps)


@pytest.mark.parametrize("how", ["tp", "world_size"])
def test_cli_refuses_parallel_runs(wai_root, tmp_path, monkeypatch, how):
    """Tensor and data parallelism are not ported (ROADMAP A11): the CLI
    raises rather than train unsynchronised replicas."""
    args = cli_args(wai_root, tmp_path)
    if how == "tp":
        args += ["--tp", "2"]
    else:
        monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 11"):
        main(args)


def test_cli_runs_on_the_card_unless_asked(wai_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the check of the default device needs a machine "
                    "without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(cli_args(wai_root, tmp_path, device=()))


def test_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "mapanything_tpu_torch.train",
                           "--help"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--dataset_spec" in proc.stdout and "--device" in proc.stdout


def write_640x480_scene(root) -> None:
    """One scene of four 640x480 frames, as chip_smoke.py's tree has."""
    rng = np.random.default_rng(4)
    frames = [{"frame_name": f"f{i}",
               "image": rng.integers(0, 255, (480, 640, 3), dtype=np.uint8),
               "depth": rng.uniform(1.0, 4.0, (480, 640)).astype(np.float32),
               "transform_matrix": np.eye(4)} for i in range(4)]
    write_scene(root / "scene", frames,
                dict(fx=576.0, fy=576.0, cx=320.0, cy=240.0, w=640, h=480),
                np.ones((4, 4), np.float32))


def test_loader_shapes_are_what_the_train_step_launches(tmp_path,
                                                        monkeypatch):
    """The attention shapes the loader's 2 x 4-view batches give the
    training forward (B, tokens, n_valid) in both buckets, which
    chip_smoke.py phase 10a holds the CUDA kernels to: the tiny model pads
    its tokens to 128 as the released one does, so they do not depend on
    the width."""
    import chip_smoke
    from mapanything_tpu_torch.models import aug_training_config
    from mapanything_tpu_torch.ops import flash_attention as fa

    write_640x480_scene(tmp_path)
    loader = PL.get_train_data_loader(
        8 @ PD.WAIDataset(ROOT=str(tmp_path), spec="eth3d", num_views=4,
                          covisibility_thres=0.25, seed=7,
                          resolution=chip_smoke.WAI_BUCKETS),
        max_num_of_imgs_per_gpu=8, num_workers=2)
    loader.set_epoch(0)
    by_height = {}
    for batch in loader:
        by_height.setdefault(batch["views"]["img"].shape[2], batch)

    seen = set()
    plain = fa.flash_attention_fwd_lse_plain

    def record(q, k, v, n_valid=None):
        seen.add((q.shape[0], q.shape[1], n_valid))
        return plain(q, k, v, n_valid)

    monkeypatch.setattr(fa, "flash_attention_fwd_lse_plain", record)
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY_CONFIG),
                        device="cpu", generator=torch.Generator().manual_seed(0))
    loss_fn = PS.make_loss_fn(model, aug_training_config())
    want = {392: {(8, 1152, 1037), (8, 1036, None), (2, 4224, 4145)},
            336: {(8, 896, 889), (8, 888, None), (2, 3584, 3553)}}
    assert sorted(by_height) == sorted(want)
    launched = set()
    for height, batch in by_height.items():
        seen.clear()
        loss, _ = loss_fn(PLoop.to_device(batch, "cpu"),
                          torch.Generator().manual_seed(0))
        assert torch.isfinite(loss) and loss.requires_grad
        assert seen == want[height], height
        launched |= seen
    assert {(shape[0], shape[1], n_valid)
            for _, shape, n_valid in chip_smoke.LOADER_SHAPES} == launched


def test_validation_shapes_are_what_the_cli_validation_launches(
        tmp_path, monkeypatch):
    """The lse-free forward's shapes (B, tokens, n_valid) in the CLI's
    validation pass over chip_smoke.py's validation spec, which phase 10a
    holds the CUDA kernel to."""
    import chip_smoke
    from mapanything_tpu_torch.ops import flash_attention as fa
    from mapanything_tpu_torch.train.__main__ import VAL_BATCH

    write_640x480_scene(tmp_path)
    dataset = PLoop.build_dataset_mix(
        chip_smoke.wai_spec(chip_smoke.VAL_SAMPLES,
                            chip_smoke.WAI_BUCKETS[:1], seed=9),
        wai_root=str(tmp_path))
    loader = PL.get_test_data_loader(dataset, batch_size=VAL_BATCH,
                                     num_workers=2)
    seen = []
    plain = fa.flash_attention_plain

    def record(q, k, v, n_valid=None):
        seen.append((q.shape[0], q.shape[1], n_valid))
        return plain(q, k, v, n_valid)

    monkeypatch.setattr(fa, "flash_attention_plain", record)
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY_CONFIG),
                        device="cpu", generator=torch.Generator().manual_seed(0))
    stats = PLoop.test_one_epoch(model, loader, device="cpu")
    assert math.isfinite(stats["loss_med"])
    assert len(loader) == chip_smoke.VAL_SAMPLES // VAL_BATCH
    assert {(shape[0], shape[1], n_valid)
            for _, shape, n_valid in chip_smoke.VALIDATION_SHAPES} == set(seen)
