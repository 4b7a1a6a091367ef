"""Tiny versions of the benchmark's cells, for the CPU tests: the same
families, entries and comparisons at widths and images a test run holds."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import core  # noqa: E402

CONFIGS = {
    "mapanything": dict(
        encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=2,
        trunk_dim=64, trunk_depth=4, trunk_num_heads=2, trunk_taps=[1, 2],
        dpt_feature_dim=32, dpt_out_channels=[16, 32, 64, 64],
        dpt_hidden_dims=[16, 8]),
    "modular-dust3r-l": dict(
        encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=2,
        decoder_dim=64, decoder_depth=2, decoder_num_heads=2),
}
TRAFFIC = {
    "mv64": dict(views=3, height=28, width=42),
    "pairs-b8": dict(batch=2, height=28, width=42),
    "pairs-b16": dict(batch=2, height=32, width=48),
    "train-2x4v": dict(height=28, width=42),
}


def cell(name: str, dtype: str = "bfloat16") -> core.Cell:
    """The cell `name` of BENCHMARK.json at tiny size, computing in
    `dtype`."""
    c = core.load_cell(name)
    c.config.update(CONFIGS[c.config_name], compute_dtype=dtype)
    traffic = name.split(".", 1)[1]
    c.traffic.update(TRAFFIC[traffic])
    return c


def run(c: core.Cell, seed: int, **kw) -> dict:
    """One run on the CPU (the look for a card skipped), 0.2 s window."""
    return core.run(c, seed, 0.2, False, "cpu", time.perf_counter(), **kw)


def cells() -> list:
    return [w["name"] for w in core.load_benchmark()["workloads"]]
