#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix and per-layer metrics are files under
``portbench/`` found by name (``harness/manifest.py``).  The run builds
and warms the system under test (``src/repro_torch``, the PyTorch port;
never the JAX package), measures for ``--seconds``, checks what the timed
path produced against the plain reference under ``portbench/reference/``
and prints one JSON line last on standard output.  With ``--trace 0`` its
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones, read from a device trace of the window's first units of work
(``harness/trace.py``).

Exit codes: 0 a result was printed (``correct`` may still be false);
2 no card, or fewer than the cell asks for; 3 a module of JAX or of the
JAX package was loaded; 4 the harness or the program failed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def fix_environment(root: pathlib.Path = ROOT) -> None:
    """Caches at fixed paths inside the checkout, set before torch or
    triton is imported; the nvcc library lands in ``build/cuda/`` by the
    program's own rule (``repro_torch/kernels/build.py``)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(root / "build" / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    fix_environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    try:
        from portbench.harness import manifest
        bench = manifest.Benchmark.load(ROOT)
        cell = bench.cell(args.workload)
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"the cell asks for {cell.chips} cards, this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        import repro_torch  # noqa: F401  (fails where src/ is absent)
        from portbench.harness import runner
        result = runner.run_cell(bench, cell, seed=args.seed,
                                 seconds=args.seconds, trace=bool(args.trace),
                                 t_start=T_START)
    except Exception:
        traceback.print_exc()
        return 4
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
