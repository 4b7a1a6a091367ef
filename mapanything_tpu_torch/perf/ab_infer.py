"""Wall time of `infer` and the forward wrapper's host cost, for the
checkout at ROOT: the A/B tool for changes whose effect on the host-bound
serving path is in question.

    python mapanything_tpu_torch/perf/ab_infer.py ROOT TAG

imports ROOT's ``mapanything_tpu_torch`` (any checkout since the first
slice: it uses only ``MapAnything``, ``InferencePipeline``, ``load_images``,
``random_normal_`` and ``ops/flash_attention.py``'s ``flash_attention`` and
``_fwd_cuda``) and prints one line ``AB {json}``: the host µs per call of
the forward's wrapper (the public ``flash_attention`` and the raw
``_fwd_cuda``) at the encoder and 2-view global shapes, median of 5 runs of
50 calls without a synchronise between them, and the median wall ms of 10
``infer`` calls (after 3 warm-up calls) at 1 and 2 views of 518^2. Compare
two checkouts in one run on one card, in turns (A, B, B, A): wall
times move with the host.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time


def write_images(folder: str, n: int) -> list[str]:
    """n seeded 518x518 PNGs (smooth patterns plus noise)."""
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


def host_us(torch, fn, runs: int = 5, calls: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def main(root: str, tag: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mapanything_tpu_torch.data.image import load_images
    from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.ops import flash_attention as fa
    from mapanything_tpu_torch.utils.inference import InferencePipeline
    from mapanything_tpu_torch.utils.weights import random_normal_

    res = {"tag": tag, "root": root}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, n, h, d), n_valid in (((2, 1408, 16, 64), 1370),
                                  ((1, 2816, 16, 64), 2739)):
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = qkv.unbind(2)
        with torch.inference_mode():
            res[f"host_us_flash_attention_{n}"] = host_us(
                torch, lambda: fa.flash_attention(q, k, v, n_valid))
            res[f"host_us_fwd_cuda_{n}"] = host_us(
                torch, lambda: fa._fwd_cuda(q, k, v, n_valid, with_lse=False))
    model = MapAnything(MapAnythingConfig())
    random_normal_(model)
    model.eval()
    pipe = InferencePipeline(model)
    with tempfile.TemporaryDirectory() as folder:
        for views in (1, 2):
            inputs = load_images(write_images(folder, views))
            for _ in range(3):
                pipe.infer(inputs, apply_mask=True, mask_edges=True)
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                pipe.infer(inputs, apply_mask=True, mask_edges=True)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            res[f"infer_ms_{views}v"] = statistics.median(times)
            res[f"infer_ms_{views}v_all"] = times
    return res


if __name__ == "__main__":
    print("AB " + json.dumps(main(sys.argv[1], sys.argv[2])), flush=True)
