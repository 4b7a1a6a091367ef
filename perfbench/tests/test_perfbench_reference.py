"""The plain reference against the program at tiny sizes on the CPU, and
a run with no card."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from . import tiny


@pytest.mark.parametrize("name", tiny.cells())
def test_reference_agrees_with_the_program_in_fp32(name):
    """In float32 both sides compute one function: every number at
    rounding, a thousandth of its limit or less."""
    from perfbench.harness import compare

    limits = compare.load_limits(name)
    res = tiny.run(tiny.cell(name, "float32"), 11, limits={})
    for key, check in res["checks"].items():
        assert check["value"] <= 1e-3 * limits[key]["limit"], (key, check)


@pytest.mark.parametrize("name", tiny.cells())
def test_bfloat16_program_reads_below_the_fp8_control(name):
    res = tiny.run(tiny.cell(name), 12, limits={}, control="fp8")
    program = {k: c["value"] for k, c in res["checks"].items()}
    assert any(res["control"][k] > 3 * program[k] for k in program)


def test_run_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(tiny.ROOT / "perfbench" / "run.py"),
         "--workload", "mapanything.mv64", "--seed", "3000000005",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "needs 1 CUDA card" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench")
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "modular-dust3r-l.pairs-b16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    """The smallest cell once on the card, correct under its limits."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "modular-dust3r-l.pairs-b16", "--seed", "3000000006", "--seconds",
         "2", "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
