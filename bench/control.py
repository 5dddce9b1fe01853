#!/usr/bin/env python3
"""Run a cell's controls: the reference, with one defect, in the port's
place (``controls.py``), through the cell's own traffic and comparison.

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 3]

Prints one JSON line a seed and control with the numbers compared and
whether the run would read as correct.  The benchmark's own runs never run
this; it needs no card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_control(cell_, seed: int, seconds: float, control: str) -> dict:
    import numpy as np

    from bench import cell, controls, traffic

    data_ss, traffic_ss, warm_ss, sample_ss = cell.seed_streams(seed)
    col = cell.make_column(cell_.config, np.random.default_rng(data_ss))
    reader = controls.ControlReader(col, cell_.config["fragments"], control)
    sample = cell.Sample(cell_.traffic["check_requests"], np.random.default_rng(sample_ss))
    cell.warm_up(reader, cell_.traffic, len(col), np.random.default_rng(warm_ss),
                 lambda: None, sample)
    requests = traffic.Requests(cell_.traffic, len(col), np.random.default_rng(traffic_ss))
    fields, _ = cell.drive(reader, requests, seconds, lambda: None, sample, lambda: 0)
    correct, compared = cell.verdict(cell.judge(col, sample), len(sample.kept))
    return {"workload": cell_.name, "seed": seed, "control": control,
            "requests": len(fields["latencies_s"]), "checked": len(sample.kept),
            "correct": correct, "compared": {k: v["value"] for k, v in compared.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import controls, manifest

    cell_ = manifest.cell(args.workload)
    for seed in args.seeds:
        for control in controls.CONTROLS[cell_.traffic["kind"]]:
            print(json.dumps(run_control(cell_, seed, args.seconds, control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
