"""Serial-driver throughput of two checkouts of the PyTorch port, in
alternating turns on one card.

    python scripts/torch_serial_ab.py PARENT_ROOT TREE_ROOT [--rounds 2]

Each turn is a fresh process that imports ``repro_torch`` from one
root's ``src`` and times, at ``chip_smoke.py`` [main]'s full width
(SERConfig, B = 128, sigma = 1, ``dp_path="pallas"``, window 120,
``max_cohort=4``, the serial driver):

* [main] cold: ``run_experiment`` FedAsync (40 updates, evals every 10)
  then FedAvg (2 rounds), corpus, arenas and step builds included;
* warm: one ``Session`` warmed by a 4-update run, then FedAsync and
  FedAvg ``WARM_TURNS`` times each (a warm FedAvg run is ~0.5 s, so it
  takes several to see past the host's spread).

Turns run in the order A B B A, ``--rounds`` times.  Every rate is member
local DP-SGD steps per second of wall (evals included), and each run's
params are hashed so that the two roots can be seen to compute the same
bits.  Prints one JSON line per turn and a summary; writes them to
``results/serial_ab.json`` when that directory can be made.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path


WARM_TURNS = 6


def _child(root: str) -> dict:
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.core.testbed import (
        TestbedConfig, build_partitions, run_experiment)
    from repro_torch.engine.cohort import steps_per_round
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.pytree import tree_leaves

    cfg = TestbedConfig(batch_size=128, sigma=1.0, dp_path="pallas")
    ecfg = EngineConfig(staleness_window=120.0, max_cohort=4)
    kw = {"fedasync": dict(max_updates=40, eval_every=10),
          "fedavg": dict(rounds=2, eval_every=1)}
    s_max = max(steps_per_round(tr["y"].shape[0], cfg.batch_size,
                                cfg.local_epochs)
                for tr, _ in build_partitions(cfg)[0])

    def digest(params):
        h = hashlib.sha256()
        for leaf in tree_leaves(params):
            h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, log = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return round(s_max * sum(log.cohort_sizes) / wall, 2), digest(params)

    out = {"root": root, "main": {}, "warm": {}, "digest": {}}
    for kind in ("fedasync", "fedavg"):
        rate, dig = timed(lambda: run_experiment(kind, cfg, engine_cfg=ecfg,
                                                 **kw[kind]))
        out["main"][kind] = rate
        out["digest"][kind] = dig
    sess = Session()
    sess.run(ExperimentSpec.from_legacy("fedasync", cfg, max_updates=4,
                                        eval_every=4, engine_cfg=ecfg))
    for kind in ("fedasync", "fedavg"):
        spec = ExperimentSpec.from_legacy(kind, cfg, engine_cfg=ecfg,
                                          **kw[kind])
        rates = []
        for _ in range(WARM_TURNS):
            rate, dig = timed(lambda: sess.run(spec))
            if dig != out["digest"][kind]:
                raise SystemExit(f"{root}: warm {kind} params differ from "
                                 f"the cold run's")
            rates.append(rate)
        out["warm"][kind] = rates
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(_child(args.child)), flush=True)
        return
    if len(args.roots) != 2:
        ap.error("give two roots: A (the parent) and B (the change)")
    env = dict(os.environ)
    env.setdefault("TRITON_CACHE_DIR",
                   str(Path(args.roots[1]).resolve() / "build" / "triton"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for _ in range(args.rounds):
        for label in ("A", "B", "B", "A"):
            root = args.roots[0 if label == "A" else 1]
            res = subprocess.run(
                [sys.executable, __file__, "--child", root], env=env,
                capture_output=True, text=True)
            if res.returncode != 0:
                sys.stderr.write(res.stderr[-4000:])
                raise SystemExit(f"turn {label} ({root}) failed")
            turn = json.loads(res.stdout.strip().splitlines()[-1])
            turn["label"] = label
            print(json.dumps(turn), flush=True)
            turns.append(turn)
    digests = {json.dumps(t["digest"], sort_keys=True) for t in turns}
    summary = {"card": smi, "order": [t["label"] for t in turns],
               "same_params_bits": len(digests) == 1}
    for label in ("A", "B"):
        mine = [t for t in turns if t["label"] == label]
        summary[label] = {
            "root": mine[0]["root"],
            "main": {k: [t["main"][k] for t in mine]
                     for k in ("fedasync", "fedavg")},
            "warm": {k: [r for t in mine for r in t["warm"][k]]
                     for k in ("fedasync", "fedavg")}}
    print(json.dumps(summary), flush=True)
    try:
        Path("results").mkdir(exist_ok=True)
        Path("results/serial_ab.json").write_text(
            json.dumps({"turns": turns, "summary": summary}, indent=1))
    except OSError:
        pass
    if not summary["same_params_bits"]:
        raise SystemExit("the two roots computed different params")


if __name__ == "__main__":
    main()
