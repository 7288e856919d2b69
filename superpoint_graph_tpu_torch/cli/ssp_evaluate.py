"""SSP partition evaluator: res.h5 files aggregated over folds.

Port of superpoint_graph_tpu/cli/ssp_evaluate.py (reference
supervized_partition/evaluate_partition.py:24-86): prints the n_sp / ASA
/ BR / BP table and writes results.txt. `summary` formats the table from
matrices in memory (ssp/evaluate.FinalEvaluator.matrices) as from files.
"""
from __future__ import annotations

import argparse
import os

from ..device import card_unless


def _line(label: str, r: dict) -> str:
    return (f"{label}: n_sp {r['n_sp']:.0f}  ASA {r['ASA']:.2f}  "
            f"BR {r['BR']:.2f}  BP {r['BP']:.2f}")


def summary(labelled: list) -> str:
    """The table of [(label, res matrices dict)]: one line a fold, then
    the overall line of the summed matrices."""
    from ..ssp.evaluate import aggregate_matrices

    lines = [_line(label, aggregate_matrices([m])) for label, m in labelled]
    lines.append(_line("overall", aggregate_matrices([m for _, m in labelled])))
    return "\n".join(lines)


def main(argv=None, device=None):
    """Aggregate <odir>/cv<fold>/res.h5 for each fold of --cvfold. The
    aggregation runs on the host; like every CLI of the port it asks for
    the card unless `device` names another."""
    from ..ssp.evaluate import read_res

    card_unless(device)
    p = argparse.ArgumentParser(description="aggregate SSP partition metrics")
    p.add_argument("--odir", default="results_partition")
    p.add_argument("--cvfold", default="123456")
    args = p.parse_args(argv)
    labelled = []
    for fold in args.cvfold:
        path = os.path.join(args.odir, f"cv{fold}", "res.h5")
        if os.path.isfile(path):
            labelled.append((path, read_res(path)))
        else:
            print(f"fold {fold}: missing {path}")
    if not labelled:
        raise SystemExit("no res.h5 files found")
    out = summary(labelled)
    print(out)
    with open(os.path.join(args.odir, "results.txt"), "w") as f:
        f.write(out + "\n")


if __name__ == "__main__":
    main()
