"""The benchmark's files: what they import, and that BENCHMARK.json's every
entry resolves to files found by name."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from . import tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import core

PERFBENCH = core.PERFBENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "mapanything_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    """Top-level names of the absolute imports of a file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PERFBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_imports_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "contextlib", "math", "torch"}


def test_entries_resolve():
    bench = core.load_benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        assert (PERFBENCH / "families" / f"{cfg['family']}.py").exists()
        assert (PERFBENCH / "reference" / f"{cfg['family']}.py").exists()
        assert cfg["reduced"] == c["reduced"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert callable(core.load_reader(m["name"]).read)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cell = core.load_cell(w["name"], bench)
        assert cell.traffic["entry"]
        assert core.compare.load_limits(w["name"]), "no limits file"
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A cell of an existing configuration with a new traffic mix and a new
    per-layer metric: new files and entries, no file edited."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.load_benchmark()
    traffic = json.loads((PERFBENCH / "traffic" / "pairs-b8.json").read_text())
    traffic["batch"] = 4
    (tmp_path / "perfbench" / "traffic" / "pairs-b4.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench" / "metrics" / "calls.new.py").write_text(
        "def read(run):\n    return len(run.latencies)\n")
    (tmp_path / "perfbench" / "limits" / "mapanything.pairs-b4.json").write_text(
        (PERFBENCH / "limits" / "mapanything.pairs-b8.json").read_text())
    bench["workloads"].append({"name": "mapanything.pairs-b4",
                               "config": "mapanything", "traffic": "pairs-b4",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls.new", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step", "moves": "views_per_s",
                               "workloads": ["mapanything.pairs-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from perfbench.harness import core\n"
            "c = core.load_cell('mapanything.pairs-b4')\n"
            "assert c.traffic['batch'] == 4\n"
            "assert 'calls.new' in [m['name'] for m in c.per_layer]\n"
            "assert core.compare.load_limits('mapanything.pairs-b4')\n"
            "class R: latencies = [1, 2, 3]\n"
            "print(core.load_reader('calls.new').read(R))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"
    for path in PERFBENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(PERFBENCH)
            assert (tmp_path / "perfbench" / rel).read_bytes() == path.read_bytes()
