"""End-to-end driver on the PyTorch port: the paper's experiment grid on
the simulated heterogeneous testbed (Speech Emotion Recognition, DP-SGD,
Moments Accountant), driven through the declarative API
(``examples/fl_ser_tradeoff.py``'s flags and lines).

    PYTHONPATH=src python examples/torch_fl_ser_tradeoff.py          # reduced
    PYTHONPATH=src python examples/torch_fl_ser_tradeoff.py --full   # paper scale
    PYTHONPATH=src python examples/torch_fl_ser_tradeoff.py --backend legacy
    PYTHONPATH=src python examples/torch_fl_ser_tradeoff.py --device cpu

One ``repro_torch.api.Session`` owns the whole grid: the FedAvg
reference run and the FedAsync alpha sweep share the generated dataset,
the device arenas and the built cohort step.  Each scenario is an
``ExperimentSpec``; ``session.sweep`` runs the alpha axis and its
``SweepResult.table()`` is the efficiency/fairness/privacy summary
(paper Sec. 4.2.4).  Results land in results/example_tradeoff_torch.json
(``--out``) with every run's full spec as provenance.
"""
import argparse
import json
import os

import numpy as np

from repro_torch.api import ExperimentSpec, RunBudget, Session, StrategySpec
from repro_torch.core.testbed import TestbedConfig
from repro_torch.data.synthetic_ser import SERDataConfig


def main(argv=None, rounds: int = 40, max_updates: int = 400,
         alphas=(0.2, 0.4, 0.6)):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale data (5882 clips, B=128)")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--target", type=float, default=0.75)
    ap.add_argument("--backend", choices=("cohort", "legacy"),
                    default="cohort", help="execution path (engine)")
    ap.add_argument("--window", type=float, default=0.0,
                    help="cohort staleness window in virtual seconds")
    ap.add_argument("--device", default="cuda",
                    help="where the runs execute (default: the card)")
    ap.add_argument("--out", default="results/example_tradeoff_torch.json")
    args = ap.parse_args(argv)

    from repro_torch.engine import EngineConfig
    engine = EngineConfig(
        staleness_window=args.window if args.backend == "cohort" else 0.0)

    data = SERDataConfig() if args.full else SERDataConfig(n_total=2940)
    bsz = 128 if args.full else 64
    base = ExperimentSpec(
        testbed=TestbedConfig(use_dp=True, sigma=args.sigma,
                              batch_size=bsz, data=data, seed=0),
        strategy=StrategySpec("fedavg"),
        run=RunBudget(rounds=rounds, max_updates=max_updates, eval_every=1,
                      target_acc=args.target),
        engine=engine,
        backend=args.backend,
    )
    session = Session(args.device)
    out = {"sigma": args.sigma, "backend": args.backend, "runs": {},
           "spec": base.to_dict()}

    print(f"[driver] FedAvg to {args.target:.0%} ({args.backend} backend) ...")
    _, log_avg = session.run(base)
    t_avg = log_avg.time_to_accuracy(args.target)
    out["runs"]["fedavg"] = {
        "time_to_target_s": t_avg, "acc": log_avg.global_acc[-1],
        "eps": {t: v[-1] for t, v in log_avg.eps_trajectory.items()},
    }
    print(f"  time-to-target {t_avg and round(t_avg)}s "
          f"acc {log_avg.global_acc[-1]:.3f}")

    # the alpha axis, one warm sweep: the session reuses the dataset,
    # arenas and built step the FedAvg run just made
    print(f"[driver] FedAsync alpha sweep {alphas} (warm session) ...")
    result = session.sweep(
        ExperimentSpec(
            testbed=base.testbed, backend=base.backend, engine=base.engine,
            strategy=StrategySpec("fedasync", alpha=0.4),
            run=RunBudget(max_updates=max_updates, eval_every=5,
                          target_acc=args.target)),
        axes={"strategy": [StrategySpec("fedasync", alpha=a)
                           for a in alphas]})

    for alpha, (spec, log) in zip(alphas, result):
        t = log.time_to_accuracy(args.target)
        fr = log.fairness()
        out["runs"][f"fedasync_a{alpha}"] = {
            "time_to_target_s": t, "acc": log.global_acc[-1],
            "speedup_vs_fedavg": (t_avg / t) if (t and t_avg) else None,
            "participation_pct": fr["participation_pct"],
            "privacy_disparity": fr["privacy_disparity"],
            "eps": {k: (v[-1] if v else 0)
                    for k, v in log.eps_trajectory.items()},
            "staleness": {k: float(np.mean(v)) for k, v in
                          log.staleness.items() if v},
            "spec": spec.to_dict(),
        }
        print(f"  alpha={alpha}: time-to-target {t and round(t)}s "
              f"speedup {t_avg and t and round(t_avg / t, 1)}x "
              f"high-end PP "
              f"{fr['participation_pct'].get('HW_T5', 0):.0f}%+"
              f"{fr['participation_pct'].get('HW_T4', 0):.0f}% "
              f"eps-disparity {fr['privacy_disparity']:.1f}x")

    out["sweep_table"] = result.table()
    out["session_stats"] = session.stats()
    print(f"[driver] session cache telemetry: {session.stats()}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(f"[driver] wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
