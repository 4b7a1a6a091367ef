"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program
(mapanything_tpu_torch) and BENCHMARK.json. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
device, with --trace 1 breakdown, and last "checks", each compared number
beside its limit; the same numbers are the last lines of standard error.
The run needs as many CUDA cards as the cell asks for and fails without
them; it never falls back to the CPU. It also fails where JAX, Flax or the
JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mapanything_tpu")


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every cache inside the checkout, at fixed paths; no library loads JAX
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch
    from perfbench.harness import core

    cell = core.load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = core.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      T0)
    loaded = sorted({name.split(".")[0] for name in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    checks = {name: {k: _finite(v) for k, v in c.items()}
              for name, c in result["checks"].items()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
