#!/usr/bin/env python3
"""Readings behind a cell's limits, on the card: for each seed a whole
run of the cell (``runner.run_cell``) that also returns every number its
check reads, compared or not, and on the seeds listed second the
lower-precision control's readings of the same outputs.  Not run by the
benchmark's own runs.

    python3 portbench/readings.py <cell> <window s> <seeds,...> \\
        [<control seeds,...>]

One JSON line per seed on standard output.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import run
    run.fix_environment()
    from portbench.harness import manifest, runner
    cell_name, seconds = argv[0], float(argv[1])
    seeds = [int(s) for s in argv[2].split(",") if s]
    controls = {int(s) for s in (argv[3] if len(argv) > 3 else "").split(",")
                if s}
    bench = manifest.Benchmark.load(ROOT)
    cell = bench.cell(cell_name)
    for seed in seeds:
        t0 = time.perf_counter()
        out = runner.run_cell(bench, cell, seed=seed, seconds=seconds,
                              trace=False, t_start=t0, extra=True,
                              control=seed in controls)
        rec = {"seed": seed, "correct": out["correct"],
               "program": out["readings"], "control": out.get("control"),
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
