"""Seeded REP000 violation: a ``rep-noqa`` with no justification.  The
suppression does NOT take effect (REP003 still fires) and the bare
comment itself is a finding."""
import torch


def local_phase(batch, fl_cfg):
    n_actual = batch.shape[0]
    return torch.sum(batch) / fl_cfg.n_micro + n_actual  # rep-noqa: REP003
