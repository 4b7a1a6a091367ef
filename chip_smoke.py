#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. Builds the CUDA flash-attention kernel from mapanything_tpu_torch/csrc
     and prints the build time.
  2. Kernel vs plain PyTorch version, bf16, seeded normal inputs laid out as
     nn/layers.py::Attention passes them (strided views of one fused qkv
     tensor, rows at or past n_valid zeroed), at the five attention shapes
     of the main path (encoder, frame, 1-, 2- and 8-view global layers at
     518^2): max-abs and rel-L2 error over the real rows (limit 1e-2 each)
     and the median time of each.
  3. The slice end to end at full width: MapAnythingConfig() (DINOv2-L/14,
     24-layer trunk, dim 1024, DPT 256) in bf16 with seeded random weights
     (numpy normals x 0.02), synthetic 518x518 PNGs through load_images and
     InferencePipeline.infer(apply_mask=True, mask_edges=True) for 1 and 2
     views, 5 timed calls after 2 warm-up calls. Checks finite outputs of
     the expected shapes and exactly 48 kernel launches (24 encoder + 24
     trunk attentions) and 0 plain launches per forward; reruns once with
     attn_impl="math" (without the masks, whose 0.5-threshold on near-zero
     random logits would flip pixels) and checks the rel-L2 of pts3d and
     depth_along_ray (limit 1e-2); prints the median ms per infer call.
     Then traces 3 more calls with torch.profiler and prints the device
     time per call, the device ops per call, the busy share (device time
     over the median infer ms of the untraced calls) and the ten device ops
     that take the most time; a profiler that cannot trace the card leaves
     these unmeasured and fails nothing.

The last two lines are the kernels' JSON summary and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ERR_LIMIT = 1e-2
FORWARD_LAUNCHES = 48

# (name, (B, N, H, D), n_valid) of every attention shape on the main path
ATTENTION_SHAPES = [
    ("encoder_2view", (2, 1408, 16, 64), 1370),
    ("frame_2view", (2, 1369, 16, 64), None),
    ("global_1view", (1, 1408, 16, 64), 1370),
    ("global_2view", (1, 2816, 16, 64), 2739),
    ("global_8view", (1, 11008, 16, 64), 10953),
]


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def median_ms(fn, torch, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def attention_inputs(torch, shape, n_valid, seed):
    """bf16 q, k, v as nn/layers.py::Attention hands them to the kernel: the
    (B, N, H, D) views of one fused (B, N, 3, H, D) tensor (token stride
    3*H*D), with the rows at or past n_valid zeroed."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    if n_valid is not None:
        qkv[:, n_valid:] = 0
    return qkv.unbind(2)


def kernel_vs_plain(torch, fa):
    rows = []
    for name, shape, n_valid in ATTENTION_SHAPES:
        q, k, v = attention_inputs(torch, shape, n_valid, seed=len(rows))
        out = fa.flash_attention(q, k, v, n_valid=n_valid)
        ref = fa.flash_attention_plain(q, k, v, n_valid=n_valid)
        torch.cuda.synchronize()
        real = shape[1] if n_valid is None else n_valid
        o, r = out[:, :real].float(), ref[:, :real].float()
        row = {
            "shape": list(shape), "n_valid": n_valid,
            "max_abs_err": float((o - r).abs().max()),
            "rel_l2": rel_l2(o, r),
            "ms": median_ms(lambda: fa.flash_attention(q, k, v, n_valid),
                            torch),
            "plain_ms": median_ms(
                lambda: fa.flash_attention_plain(q, k, v, n_valid), torch,
                reps=10),
        }
        flops = fa.attention_flops(shape[0], shape[1], real, shape[2],
                                   shape[3])
        row["tflops"] = flops / row["ms"] / 1e9
        print(f"attention {name} {tuple(shape)} n_valid={n_valid}: "
              f"max_abs={row['max_abs_err']:.3e} rel_l2={row['rel_l2']:.3e} "
              f"kernel {row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s) "
              f"plain {row['plain_ms']:.4f} ms", flush=True)
        rows.append((name, row))
        del q, k, v, out, ref, o, r
        torch.cuda.empty_cache()
    return rows


def random_weights_(model, torch, seed: int = 0) -> None:
    """Every parameter ~ N(0, 0.02^2) from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            host = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            p.copy_(torch.from_numpy(host * np.float32(0.02)))


def write_images(folder: str, n: int) -> list[str]:
    import numpy as np
    import PIL.Image

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:518, 0:518] / 518.0
    paths = []
    for i in range(n):
        base = np.stack([np.sin(6 * xx + i), np.cos(5 * yy - i),
                         np.sin(4 * (xx + yy))], -1)
        img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 8, base.shape)
        path = os.path.join(folder, f"view{i}.png")
        PIL.Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
        paths.append(path)
    return paths


def check_outputs(out, num_views, torch) -> str | None:
    expect = {
        "pts3d": (1, 518, 518, 3), "depth_along_ray": (1, 518, 518, 1),
        "intrinsics": (1, 3, 3), "camera_poses": (1, 4, 4),
        "conf": (1, 518, 518), "mask": (1, 518, 518, 1),
        "metric_scaling_factor": (1,),
    }
    if len(out) != num_views:
        return f"{len(out)} views returned, expected {num_views}"
    for i, view in enumerate(out):
        for key, shape in expect.items():
            t = view[key]
            if tuple(t.shape) != shape:
                return f"view {i} {key}: shape {tuple(t.shape)} != {shape}"
            if t.dtype != torch.bool and not torch.isfinite(t).all():
                return f"view {i} {key}: non-finite values"
    return None


def profile_calls(torch, pipe, views, infer_ms, calls: int = 3) -> dict:
    """Device time per infer call from torch.profiler, and its share of
    `infer_ms`, the median wall time of the untraced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                pipe.infer(views, apply_mask=True, mask_edges=True)
            torch.cuda.synchronize()
    except RuntimeError as exc:  # a profiler without CUPTI access
        return {"not_measured": str(exc)[:200]}
    by_name: dict[str, float] = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / calls)
            n_ops += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": device_ms, "device_ops": n_ops / calls,
            "infer_ms": infer_ms, "busy_share": device_ms / infer_ms,
            "top_ops_ms": {name[:90]: ms for name, ms in top}}


def run_slice(torch, fa, model, pipe, load_images, folder, num_views,
              calls: int = 5):
    views = load_images(write_images(folder, num_views))
    for _ in range(2):  # warm-up
        pipe.infer(views, apply_mask=True, mask_edges=True)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = pipe.infer(views, apply_mask=True, mask_edges=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = fa.flash_attention.kernel_launches
    plain = fa.flash_attention.plain_launches
    res = {"views": num_views, "calls": calls, "kernel_launches": launches,
           "plain_launches": plain, "infer_ms": statistics.median(times),
           "infer_ms_all": times}
    bad = check_outputs(out, num_views, torch)
    if bad:
        return res, bad
    if launches != FORWARD_LAUNCHES * calls or plain != 0:
        return res, (f"{launches} kernel / {plain} plain launches in {calls} "
                     f"forwards, expected {FORWARD_LAUNCHES * calls} / 0")
    res["profile"] = profile_calls(torch, pipe, views, res["infer_ms"])

    flash = pipe.infer(views, apply_mask=False)
    model.set_attn_impl("math")
    try:
        math_out = pipe.infer(views, apply_mask=False)
    finally:
        model.set_attn_impl("auto")
    for key in ("pts3d", "depth_along_ray"):
        err = max(rel_l2(f[key], m[key]) for f, m in zip(flash, math_out))
        res[f"{key}_rel_l2_vs_math"] = err
        if not err <= ERR_LIMIT:
            return res, f"{key} rel-L2 vs math attention {err:.3e}"
    return res, None


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the GPU port")
    sys.path.insert(0, HERE)
    try:
        from mapanything_tpu_torch.data.image import load_images
        from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
        from mapanything_tpu_torch.ops import _build
        from mapanything_tpu_torch.ops import flash_attention as fa
        from mapanything_tpu_torch.utils.inference import InferencePipeline
    except ImportError as exc:
        return fail(f"the port is not importable next to this script: {exc}")

    # the fp32 islands compute in full fp32 (TF32 off for matmuls and convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)  # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    try:
        path, log = _build.build_library("flash_attn_fwd")
    except RuntimeError as exc:
        return fail(str(exc))
    print(f"built {os.path.relpath(path, HERE)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    attn = kernel_vs_plain(torch, fa)
    for name, row in attn:
        if not (row["max_abs_err"] <= ERR_LIMIT and row["rel_l2"] <= ERR_LIMIT):
            return fail(f"kernel disagrees with plain at {name}: {row}")

    t0 = time.perf_counter()
    model = MapAnything(MapAnythingConfig(), device="cuda")
    random_weights_(model, torch)
    model.eval()
    pipe = InferencePipeline(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    launches = 0
    results = []
    with tempfile.TemporaryDirectory() as folder:
        for num_views in (1, 2):
            res, bad = run_slice(torch, fa, model, pipe, load_images, folder,
                                 num_views)
            print(f"slice {num_views}-view: {json.dumps(res)}", flush=True)
            if bad:
                return fail(f"{num_views}-view slice: {bad}")
            launches += res["kernel_launches"]
            results.append(res)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")

    g2 = dict(attn)["global_2view"]
    summary = {"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "mapanything_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mapanything_tpu/ops/flash_attention.py:147",
        "also_replaces": "mapanything_tpu/ops/flash_attention.py:94",
        "launches": launches,
        "max_abs_err": max(row["max_abs_err"] for _, row in attn),
        "ms": g2["ms"],
        "plain_ms": g2["plain_ms"],
        "ms_at": "global_2view",
        "per_shape": {name: row for name, row in attn},
    }]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
