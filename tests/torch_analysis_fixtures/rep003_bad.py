"""Seeded REP003 violation: the microbatch mean divides by the STATIC
``fl_cfg.n_micro`` in a tensor body whose batch shape carries the real
count."""
import torch


def local_phase(grads, fl_cfg):
    n_actual = grads.shape[0]
    total = torch.sum(grads, dim=0)
    return total / fl_cfg.n_micro, n_actual
