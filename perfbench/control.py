"""Readings that a cell's limits are set from (perfbench/limits/<cell>.json).

    python3 perfbench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--fault NAME] [--first-seed N] [--seconds S] \
        [--out FILE]

In one process on the card: for each seed, a run of the cell as the
benchmark makes it (set-up, a short window at the cell's own load, the
same calls compared) gives the program's numbers; for the first
`--control-seeds` of them the reference computed in float8 e4m3, the
precision below the configuration's bfloat16, is put in the program's
place on the same inputs and gives the control's numbers. The lower
reading of a number is the largest the program gave, the upper the
smallest the control gave. With --fault (harness/faults.py), every seed's
run has that fault planted under the program's call instead, and its
numbers are the fault's readings. Each run, and each control, is judged
against the cell's limits file as the benchmark judges a run: a sound
program comes out correct, the control and every fault not. The
benchmark's own runs never run this.
Prints one JSON line per seed and a summary line with every verdict; with
--out, writes them there too.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.harness import faults  # noqa: E402


def summarise(program: list, control: list) -> dict:
    """{number: {"lower", "upper", "ratio"}} from the readings."""
    out = {}
    for name in program[0]:
        lower = max(r[name] for r in program)
        upper = min(r[name] for r in control) if control else None
        out[name] = {"lower": lower, "upper": upper,
                     "ratio": (upper / lower if upper is not None and lower > 0
                               else None)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_100_000_000)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--fault", choices=sorted(faults.FAULTS))
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    os.environ["USE_FLAX"] = "0"

    import torch
    from perfbench.harness import compare, core

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    limits = compare.load_limits(args.workload)
    label = args.fault or "program"
    lines, program, control = [], [], []
    verdicts = {label: [], "control": []}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        res = core.run(cell, seed, args.seconds, False, "cuda", t0,
                       control="fp8" if i < args.control_seeds else None,
                       wrap_call=faults.FAULTS.get(args.fault))
        readings = {k: c["value"] for k, c in res["checks"].items()}
        program.append(readings)
        verdicts[label].append(res["correct"])
        line = {"seed": seed, label: readings, "correct": res["correct"],
                "wall_s": time.perf_counter() - t0}
        if "control" in res:
            control.append(res["control"])
            ok, _ = compare.judge(res["control"], limits)
            verdicts["control"].append(ok)
            line["control"] = res["control"]
            line["control_correct"] = ok
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(),
               "limits": {k: v["limit"] for k, v in limits.items()},
               "correct": verdicts,
               "summary": summarise(program, control)}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
