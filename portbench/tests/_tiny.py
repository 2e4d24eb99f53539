"""Tiny cells of the benchmark's configurations for the CPU tests: the
same drivers, references and limits at sizes a test run holds."""
import dataclasses
import json
import pathlib

from portbench.harness import manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]
FL_CELL = "ser-cnn.sigma-sweep-pop40"


def bench():
    return manifest.Benchmark.load(ROOT)


def fl_cell(**traffic):
    cell = bench().cell(FL_CELL)
    cfg = json.loads(json.dumps(cell.config))
    tr = json.loads(json.dumps(cell.traffic))
    cfg["model"].update(channels1=8, channels2=16, fc_dim=16, gn_groups=4)
    cfg["setting"]["batch_size"] = 16
    tr.update(num_clients=10, n_total=1100, max_updates=20, eval_every=10,
              **traffic)
    tr["engine"] = dict(tr["engine"], max_cohort=4)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def run(cell, seed=5, seconds=0.5, bench_=None):
    """The rest of a run on the CPU: set-up, window, release, check."""
    import time
    from portbench.harness import runner
    return runner.run_cell(bench_ or bench(), cell, seed=seed,
                           seconds=seconds, trace=False,
                           t_start=time.perf_counter(), device="cpu")
