"""The paper's SER model (Sec. 3.1) as functional PyTorch (port of
``repro/models/ser_cnn.py``).

Two 1D conv blocks (kernel 5, SAME padding) + GroupNorm + ReLU + max-pool
2, then FC-128 and the 4-way output layer.  Params are a dict of tensors
in the reference's JAX shapes — conv ``w`` is (K, Cin, Cout), dense ``w``
is (din, dout) — so the flat layout the DP kernel sees matches the
reference; the layouts PyTorch's conv wants are made inside
:func:`apply_batch` only.

:func:`apply_batch` is the one forward pass: ``x`` (N, T, M) -> (N, C)
logits.  :func:`loss_fn` applies it to one example (``x[None]``), which
is what ``torch.func.vmap(torch.func.grad(...))`` maps over for
per-example DP-SGD.  The FL simulation trains in deterministic mode (no
dropout), as the reference does; :func:`apply` takes the reference's
train-mode dropout (``train=True`` with a ``torch.Generator``, or the
keep masks injected), which no FL path calls.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class SERConfig:
    time_frames: int = 64
    n_mels: int = 40
    channels1: int = 64
    channels2: int = 128
    kernel: int = 5
    gn_groups: int = 8
    fc_dim: int = 128
    num_classes: int = 4
    drop1: float = 0.3
    drop2: float = 0.4
    drop_fc: float = 0.5


def init(seed: int, cfg: SERConfig = SERConfig(), device="cpu"):
    """Uniform(+-1/sqrt(fan_in)) weights and zero biases, as the
    reference, drawn from a CPU ``torch.Generator`` seeded with ``seed``
    (so the same seed gives the same params on every device)."""
    gen = torch.Generator("cpu").manual_seed(int(seed))

    def uniform(shape, fan_in):
        scale = 1.0 / fan_in ** 0.5
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (u * 2.0 - 1.0) * scale

    def conv_init(cin, cout, ksz):
        return {"w": uniform((ksz, cin, cout), cin * ksz),
                "b": torch.zeros(cout)}

    def dense_init(din, dout):
        return {"w": uniform((din, dout), din), "b": torch.zeros(dout)}

    t_after = cfg.time_frames // 4  # two maxpools of 2
    params = {
        "conv1": conv_init(cfg.n_mels, cfg.channels1, cfg.kernel),
        "gn1": {"scale": torch.ones(cfg.channels1),
                "bias": torch.zeros(cfg.channels1)},
        "conv2": conv_init(cfg.channels1, cfg.channels2, cfg.kernel),
        "gn2": {"scale": torch.ones(cfg.channels2),
                "bias": torch.zeros(cfg.channels2)},
        "fc1": dense_init(t_after * cfg.channels2, cfg.fc_dim),
        "out": dense_init(cfg.fc_dim, cfg.num_classes),
    }
    return {k: {kk: v.to(device) for kk, v in sub.items()}
            for k, sub in params.items()}


def _conv1d(x, p):
    """x: (N, T, Cin) -> (N, T, Cout), SAME padding (kernel 5 -> 2)."""
    w = p["w"].permute(2, 1, 0)                     # (Cout, Cin, K)
    y = F.conv1d(x.transpose(1, 2), w, p["b"], padding=w.shape[-1] // 2)
    return y.transpose(1, 2)


def _group_norm(x, p, groups):
    """x: (N, T, C); statistics over (time x channels-in-group), population
    variance, eps 1e-5 (reference ser_cnn.py:82)."""
    n, t, c = x.shape
    xg = x.reshape(n, t, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return xg.reshape(n, t, c) * p["scale"] + p["bias"]


def _maxpool2(x):
    n, t, c = x.shape
    return x.reshape(n, t // 2, 2, c).amax(dim=2)


def _dropout(x, rate, site, drop):
    """The reference's ``_dropout``: ``x / (1 - rate)`` where the keep
    mask is set, else 0.  ``drop`` is None (no dropout: eval mode, or no
    source), a ``torch.Generator`` (the mask drawn with probability
    ``1 - rate`` of keeping, on the generator's device) or the masks of
    the three sites, of which ``site`` is this one."""
    if drop is None or rate == 0.0:
        return x
    if isinstance(drop, torch.Generator):
        keep = torch.rand(x.shape, generator=drop,
                          device=drop.device) < 1.0 - rate
    else:
        keep = torch.as_tensor(drop[site]).reshape(x.shape)
    return torch.where(keep.to(x.device), x / (1.0 - rate), 0.0)


def apply_batch(params, x, cfg: SERConfig = SERConfig(), drop=None):
    """x: (N, time_frames, n_mels) -> logits (N, num_classes).  ``drop``:
    the train-mode dropout's source (:func:`_dropout`; None: none)."""
    h = _conv1d(x, params["conv1"])
    h = _maxpool2(F.relu(_group_norm(h, params["gn1"], cfg.gn_groups)))
    h = _dropout(h, cfg.drop1, 0, drop)
    h = _conv1d(h, params["conv2"])
    h = _maxpool2(F.relu(_group_norm(h, params["gn2"], cfg.gn_groups)))
    h = _dropout(h, cfg.drop2, 1, drop)
    # flatten over the (T/4, C2) row-major layout, as the reference
    h = h.reshape(h.shape[0], -1)
    h = F.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    h = _dropout(h, cfg.drop_fc, 2, drop)
    return h @ params["out"]["w"] + params["out"]["b"]


def apply(params, x, cfg: SERConfig = SERConfig(), train: bool = False,
          rng=None, masks=None):
    """x: (time_frames, n_mels) -> logits (num_classes,).  ``train=True``
    with ``rng`` (a ``torch.Generator``) applies the reference's dropout
    after each pooled conv block and after fc1, a keep mask drawn per
    site in that order; ``masks`` (the three sites' keep masks, each of
    the site's activation shape) injects them instead, as the parity
    tests inject the reference's ``jax.random.bernoulli`` draws (threefry
    cannot be replayed by ``torch.Generator``).  Otherwise, and with
    neither source, the deterministic forward."""
    drop = None
    if train:
        drop = masks if masks is not None else rng
    return apply_batch(params, x[None], cfg, drop)[0]


def loss_fn(params, example, cfg: SERConfig = SERConfig()):
    """Cross-entropy of ONE example (paper Eq. 2); vmap-able.  Labels are
    int64 (the engine casts the int32 data labels once at upload)."""
    logp = torch.log_softmax(apply(params, example["x"], cfg), dim=-1)
    return -logp.gather(0, example["y"].reshape(1)).squeeze(0)


def make_accuracy_fn(cfg: SERConfig = SERConfig(), batch: int = 512):
    """``acc(params, data)`` over a dict of numpy arrays or tensors, in
    chunks of ``batch`` examples on the params' device; returns a 0-d
    f32 tensor (the caller decides when to sync)."""
    def _acc(params, data):
        dev = params["out"]["w"].device
        x = torch.as_tensor(data["x"], device=dev)
        y = torch.as_tensor(data["y"], device=dev)
        correct = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for i in range(0, x.shape[0], batch):
                logits = apply_batch(params, x[i:i + batch], cfg)
                correct += (logits.argmax(-1) == y[i:i + batch]).sum()
        return correct / x.shape[0]

    return _acc


def param_count(params) -> int:
    return sum(l.numel() for sub in params.values() for l in sub.values())
