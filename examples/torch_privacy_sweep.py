"""Privacy sweep over the paper's noise grid on the PyTorch port, two
ways (``examples/privacy_sweep.py``'s flags and lines):

1. **Analytic** (default, instant): the Moments Accountant table behind
   the paper's Table 3 — per-tier epsilon as a function of sigma and the
   emergent update frequencies, no training.
2. **Measured** (``--train``): a trained sigma sweep through ONE
   ``repro_torch.api.Session`` — reduced-scale FedAsync runs whose
   per-tier epsilons come out of the actual RunLogs.  The session keeps
   the dataset partitions and the built cohort step warm across the grid
   (the step takes the noise scale as a runtime tensor), so the four
   sigma points cost one testbed generation and one step build.

    PYTHONPATH=src python examples/torch_privacy_sweep.py            # analytic
    PYTHONPATH=src python examples/torch_privacy_sweep.py --train    # + measured
    PYTHONPATH=src python examples/torch_privacy_sweep.py --train --device cpu
"""
import argparse

from repro_torch.core.accountant import compute_epsilon

Q = 0.136          # paper: q = B/|D_k|
DELTA = 1e-5
SIGMAS = (0.5, 1.0, 1.5, 2.0)
# update counts emergent from the tier clocks at alpha=0.2 (c.f. Fig. 5:
# high-end 62%, mid 16%, low-end <14%) over a 300-update async run,
# x ~7 DP steps per round
TIER_UPDATES = {"HW_T1": 9, "HW_T2": 11, "HW_T3": 26, "HW_T4": 120,
                "HW_T5": 134}
STEPS_PER_UPDATE = 7


def analytic():
    print(f"q={Q} delta={DELTA}  (paper Sec. 4.1.4)")
    header = "tier     updates | " + " | ".join(f"sig={s:<4}" for s in SIGMAS)
    print(header)
    print("-" * len(header))
    eps_by_sigma = {}
    for tier, ups in TIER_UPDATES.items():
        row = []
        for s in SIGMAS:
            eps = compute_epsilon(Q, s, ups * STEPS_PER_UPDATE, DELTA)
            row.append(eps)
            eps_by_sigma.setdefault(s, []).append(eps)
        print(f"{tier}  {ups:7d} | " + " | ".join(f"{e:7.2f}" for e in row))
    print("\nper-sigma disparity (max eps / min eps):")
    for s, es in eps_by_sigma.items():
        print(f"  sigma={s}: {max(es)/min(es):.1f}x "
              f"(paper reports ~5-6x at alpha>=0.4)")
    # FedAvg reference: uniform participation, ~60 rounds
    print("\nFedAvg uniform reference (60 rounds x 7 steps):")
    for s in SIGMAS:
        print(f"  sigma={s}: eps={compute_epsilon(Q, s, 420, DELTA):.2f} "
              f"on every tier")
    return eps_by_sigma


def trained(max_updates: int, device="cuda", eval_every: int = 20):
    from repro_torch.api import ExperimentSpec, RunBudget, Session, StrategySpec
    from repro_torch.core.testbed import TestbedConfig
    from repro_torch.data.synthetic_ser import SERDataConfig

    spec = ExperimentSpec(
        testbed=TestbedConfig(use_dp=True, sigma=SIGMAS[0], batch_size=64,
                              data=SERDataConfig(n_total=2940), seed=0),
        strategy=StrategySpec("fedasync", alpha=0.2),
        run=RunBudget(max_updates=max_updates, eval_every=eval_every))
    session = Session(device)
    print(f"\nmeasured sigma sweep (FedAsync alpha=0.2, "
          f"{max_updates} updates, one warm session) ...")
    result = session.sweep(spec, axes={"testbed.sigma": list(SIGMAS)})
    for point, log, wall in zip(result.points, result.logs, result.wall_s):
        eps = {t: (v[-1] if v else 0.0)
               for t, v in log.eps_trajectory.items()}
        disp = (max(eps.values()) / max(min(eps.values()), 1e-9)
                if eps else 0.0)
        by_tier = " ".join(f"{t.split('_')[1]}={e:.1f}"
                           for t, e in sorted(eps.items()))
        print(f"  sigma={point['testbed.sigma']}: eps {by_tier} "
              f"(disparity {disp:.1f}x, acc {log.global_acc[-1]:.3f}, "
              f"{wall:.1f}s)")
    print(f"  session cache telemetry: {session.stats()}")
    return result, session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="also run the measured (trained) sigma sweep "
                         "through one Session")
    ap.add_argument("--max-updates", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="where the trained sweep runs (default: the card)")
    args = ap.parse_args(argv)
    analytic()
    if args.train:
        trained(args.max_updates, args.device)


if __name__ == "__main__":
    main()
