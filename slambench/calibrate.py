"""The readings that a configuration's limits are set from: per seed, the
numbers the configuration's family compares (``families/<name>.py``: the
program's graph, the reference, its precisions and ``gaps``) for the
program's answer (the lower reading), for the control's and for faults
planted in the program (the upper ones).

    python -m slambench.calibrate --workload CELL --seeds 1,2,3 \
        [--control] [--f32] [--faults stop_after_2,no_refresh]

For each seed, in one process: the cell's graph from that seed, one call
of the program through the cell's own driver and entry
(``drivers/<name>.py``, as the timed window calls it), the float64
reference, and with ``--control`` the family's control (SE(2): the
reference computed in float32 with TF32 products), put in the program's
place.  ``--faults`` (in-process cells) calls the program again with its
optimizer changed as each named fault says (``FAULTS``).
One JSON line per seed.  A remote cell keeps one server for all the
seeds.  Needs the CUDA device the cell asks for; the tests run it on the
CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from slambench import cells, generators, run


# faults planted in the program by its own options: a GN loop stopped
# after a few of the configuration's iterations, and a preconditioner
# built once and never refreshed
FAULTS = {
    "stop_after_2": {"iterations": 2},
    "stop_after_10": {"iterations": 10},
    "no_refresh": {"pcg_precond_refresh": 0},
}


def readings(cell, seeds, device, control: bool = False, f32: bool = False,
             faults=(), out=None):
    """One dict per seed: ``{"seed", "program": {...}, "control": {...},
    "float32": {...}}``, each the compared numbers (the family's ``gaps``);
    ``float32``: the reference in plain float32, a sound float32 solve
    that says how far rounding alone moves the numbers; ``faults``: the
    program with each named fault, under its name."""
    out = out or sys.stdout
    family = cells.family(cell)
    opt = cell.config["optimizer"]
    driver = cells.driver(cell)(cell, seeds[0], device)
    in_process = hasattr(driver, "gn")
    rows = []
    runs = []               # (seed, variant, problem) in the order called
    try:
        for seed in seeds:
            problem = generators.generate(cell.graph, seed, cell.root)
            graph = family.program_graph(problem["graph"])
            for variant in ("program",) + tuple(faults):
                if not in_process:
                    driver.graphs = [graph]
                else:
                    from toyslam_torch.config import OptimizerConfig
                    from toyslam_torch.optimizer import GaussNewton

                    driver.gn = GaussNewton(OptimizerConfig(
                        **{**opt, **FAULTS.get(variant, {})}))
                    driver.graphs = [driver.gn._prepare(graph).to(device)]
                driver.call()
                runs.append((seed, variant, problem))
    finally:
        driver.close(run.Readings())
    by_seed: dict = {}
    for (seed, variant, problem), (_, *answer) in zip(runs, driver.answers):
        by_seed.setdefault(seed, (problem, {}))[1][variant] = answer
    for seed, (problem, answers) in by_seed.items():
        g = problem["graph"]
        ref = family.optimize(g, opt, device, family.REFERENCE)
        row = {"seed": seed, "reference": {
            "iterations": ref.iterations_run, "errors": ref.errors}}
        for variant, answer in answers.items():
            row[variant] = family.gaps(
                g, problem["n_poses"], problem["n_landmarks"], opt, ref,
                [tuple(answer)], device)
            if answer[2] is not None:
                row[variant]["errors"] = answer[2].tolist()
        if control:
            ctl = family.optimize(g, opt, device, family.CONTROL)
            row["control"] = family.gaps(
                g, problem["n_poses"], problem["n_landmarks"], opt, ref,
                [(ctl.poses.cpu(), ctl.landmarks.cpu(),
                  torch.tensor(ctl.errors))], device)
        if f32:
            plain = family.optimize(g, opt, device, family.FLOAT32)
            row["float32"] = family.gaps(
                g, problem["n_poses"], problem["n_landmarks"], opt, ref,
                [(plain.poses.cpu(), plain.landmarks.cpu(),
                  torch.tensor(plain.errors))], device)
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="also the reference in plain float32")
    ap.add_argument("--faults", default="",
                    help="comma-separated names of FAULTS")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    readings(cell, [int(s) for s in args.seeds.split(",")],
             torch.device("cuda", 0), args.control, args.f32,
             [f for f in args.faults.split(",") if f])
    return 0


if __name__ == "__main__":
    sys.exit(main())
