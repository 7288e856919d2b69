"""Readings for the limits of `correct`: sound runs, the control, faults.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds <s> [--faults a,b [--fault-seed n]]

For each seed, one run of the cell as portbench/run.py makes it (set-up,
a window of --seconds, the checks), then the control: the reference
computed in TF32, one precision below the configuration's float32, put in
the program's place and compared by the same numbers. Then, for each of
`--faults` (`planted` below), one more run on `--fault-seed` (by default
the first seed) with that fault planted in the program. Prints one JSON line a run: {"seed", "fault",
"correct", "numbers", "control"}, and last the largest sound reading,
the smallest control reading and each fault's readings of each number.
Needs the card, as a run does.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def planted(fault: str | None):
    """Within: the program with `fault` planted (None: as it is).
    cp_first_iteration: the cut pursuit's solver stops after its first
    outer iteration; cp_reg_double: it solves at twice the configuration's
    regularisation (the merge and the heal keep theirs)."""
    if fault is None:
        yield
        return
    from superpoint_graph_tpu_torch import pipeline_big
    from superpoint_graph_tpu_torch.ops import cutpursuit_band

    orig = cutpursuit_band.solve

    def solve(f, src, tgt, w, nw, reg, *args, **kwargs):
        if fault == "cp_first_iteration":
            kwargs["max_iter"] = 1
        elif fault == "cp_reg_double":
            reg = 2.0 * reg
        else:
            raise ValueError(f"no fault {fault!r}")
        return orig(f, src, tgt, w, nw, reg, *args, **kwargs)

    cutpursuit_band.solve = pipeline_big.solve = solve
    try:
        yield
    finally:
        cutpursuit_band.solve = pipeline_big.solve = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seed", type=int)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import run

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    print("portbench toolchain: " + json.dumps(
        run.toolchain(torch.device("cuda", 0))), flush=True)
    lower, upper, faults = {}, {}, {}
    seeds = [int(x) for x in args.seeds.split(",") if x]
    fault_seed = seeds[0] if args.fault_seed is None else args.fault_seed
    runs = [(seed, None) for seed in seeds] + [
        (fault_seed, f) for f in args.faults.split(",") if f]
    for seed, fault in runs:
        with planted(fault):
            out = run.run_cell(args.workload, seed, args.seconds, False,
                               t_start=time.perf_counter(),
                               control=fault is None)
        numbers = {k: v["value"] for k, v in out["checks"].items()}
        if fault is None:
            for k, v in numbers.items():
                lower[k] = max(lower.get(k, v), v)
            for k, v in out["control"].items():
                upper[k] = min(upper.get(k, v), v)
        else:
            faults[fault] = numbers
        print(json.dumps({"seed": seed, "fault": fault,
                          "correct": out["correct"], "numbers": numbers,
                          "control": out.get("control"),
                          "metrics": out["metrics"],
                          "notes": out.get("notes")}), flush=True)
    print(json.dumps({"lower": lower, "upper": upper, "faults": faults}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
