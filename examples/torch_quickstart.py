"""Quickstart on the PyTorch port: 5 heterogeneous clients, DP-SGD,
FedAvg vs FedAsync (``examples/quickstart.py``'s run and lines).

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs a small simulated testbed and prints the trade-off triangle the
paper is about: convergence time, participation share, and per-client
privacy loss.
"""
import argparse

from repro_torch.core.testbed import TestbedConfig, run_experiment
from repro_torch.data.synthetic_ser import SERDataConfig


def main(argv=None, rounds: int = 6, max_updates: int = 60):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the runs execute (default: the card)")
    args = ap.parse_args(argv)
    cfg = TestbedConfig(use_dp=True, sigma=1.0, batch_size=64,
                        data=SERDataConfig(n_total=1600), seed=0)

    print("== FedAvg (synchronous, straggler-bound) ==")
    _, log_avg = run_experiment("fedavg", cfg, rounds=rounds,
                                device=args.device)
    print(f"  accuracy: {log_avg.global_acc[-1]:.3f}  "
          f"virtual time: {log_avg.times[-1]:.0f}s")
    eps = {t: v[-1] for t, v in log_avg.eps_trajectory.items()}
    print(f"  eps (uniform): {eps['HW_T1']:.2f} on every tier")

    print("== FedAsync (alpha=0.4, staleness-aware) ==")
    _, log_as = run_experiment("fedasync", cfg, max_updates=max_updates,
                               alpha=0.4, eval_every=5, device=args.device)
    print(f"  accuracy: {log_as.global_acc[-1]:.3f}  "
          f"virtual time: {log_as.times[-1]:.0f}s")
    print(f"  updates per tier: {log_as.update_counts}")
    eps = {t: (v[-1] if v else 0) for t, v in log_as.eps_trajectory.items()}
    print("  eps per tier:", {t: round(e, 2) for t, e in eps.items()})
    fr = log_as.fairness()
    print(f"  privacy disparity (max/min eps): {fr['privacy_disparity']:.1f}x")
    print(f"  Jain participation index: {fr['jain_participation']:.2f}")
    return log_avg, log_as


if __name__ == "__main__":
    main()
