"""Clean twin of rep003_bad: the mean uses the batch-derived count, and
the three legitimate static-count uses don't flag — a divisibility
guard, reshape-splitting arithmetic, and pure config-on-config math.
The last function holds a real violation under a justified
suppression."""
import torch
from torch.func import vmap


def local_phase(batch, fl_cfg):
    if batch.shape[0] % fl_cfg.n_micro:
        raise ValueError("batch not divisible into microbatches")
    n_actual = batch.shape[0]
    mean = torch.sum(batch, dim=0) / n_actual
    micro = batch.reshape(
        (fl_cfg.n_micro, batch.shape[0] // fl_cfg.n_micro)
        + tuple(batch.shape[1:]))
    head_dim = fl_cfg.d_model // fl_cfg.n_heads
    return mean, micro, head_dim


def member_means(batches, cfg):
    per = vmap(lambda b: b.sum(0) / b.shape[0])(batches)
    heads = cfg.d_model // cfg.n_heads
    return per, heads


def suppressed_phase(batch, fl_cfg):
    scale = batch.shape[0]
    return torch.sum(batch) / fl_cfg.n_micro + scale  # rep-noqa: REP003 -- exercising the justified-suppression path
