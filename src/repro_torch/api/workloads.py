"""Workload registry (port of ``repro/api/workloads.py``): the model
family behind a testbed, keyed by ``TestbedConfig.workload``.

A workload packages

  * ``init(seed, model_cfg, device) -> params``
  * ``loss(model_cfg) -> loss_fn(params, example) -> scalar`` (per example,
    mapped by ``torch.func.vmap(torch.func.grad(...))``)
  * ``accuracy(model_cfg) -> accuracy_fn(params, data) -> 0-d tensor``

Loss and accuracy closures are memoized per (workload, model_cfg) so
every testbed built from one config shares one closure object (the
engine's homogeneity check compares them).

Built-ins: ``"ser_cnn"`` (the paper's CNN, default) and ``"ser_linear"``
(multinomial logistic regression over the same patches).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Callable

import torch

from repro_torch.models import ser_cnn


@dataclass(frozen=True)
class Workload:
    name: str
    init: Callable                 # (seed, model_cfg, device) -> params
    loss: Callable                 # (model_cfg) -> loss_fn
    accuracy: Callable             # (model_cfg) -> accuracy_fn

    def shared_loss(self, model_cfg):
        return _shared_closure(self.name, "loss", model_cfg)

    def shared_accuracy(self, model_cfg):
        return _shared_closure(self.name, "accuracy", model_cfg)


_REGISTRY: dict = {}


@lru_cache(maxsize=None)
def _shared_closure(workload: str, kind: str, model_cfg):
    wl = get_workload(workload)
    return (wl.loss if kind == "loss" else wl.accuracy)(model_cfg)


def register_workload(name: str, *, init: Callable, loss: Callable,
                      accuracy: Callable, overwrite: bool = False) -> Workload:
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"workload {name!r} is already registered "
            "(pass overwrite=True to replace it)")
    wl = Workload(name=name, init=init, loss=loss, accuracy=accuracy)
    _REGISTRY[name] = wl
    if overwrite:
        _shared_closure.cache_clear()
    return wl


def get_workload(name: str) -> Workload:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown workload: {name!r} "
            f"(registered: {', '.join(sorted(_REGISTRY))})") from None


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

def _linear_init(seed, cfg, device="cpu"):
    gen = torch.Generator("cpu").manual_seed(int(seed))
    d = cfg.time_frames * cfg.n_mels
    scale = 1.0 / d ** 0.5
    w = (torch.rand((d, cfg.num_classes), generator=gen) * 2.0 - 1.0) * scale
    return {"w": w.to(device),
            "b": torch.zeros(cfg.num_classes, device=device)}


def _linear_logits(params, x):
    """x: (N, T, M) -> (N, C)."""
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


def _linear_loss(cfg):
    def loss_fn(params, example):
        logp = torch.log_softmax(_linear_logits(params, example["x"][None])[0],
                                 dim=-1)
        return -logp.gather(0, example["y"].reshape(1)).squeeze(0)
    return loss_fn


def _linear_accuracy(cfg):
    def _acc(params, data):
        dev = params["w"].device
        x = torch.as_tensor(data["x"], device=dev)
        y = torch.as_tensor(data["y"], device=dev)
        with torch.no_grad():
            hits = (_linear_logits(params, x).argmax(-1) == y)
        return hits.to(torch.float32).mean()
    return _acc


register_workload(
    "ser_cnn",
    init=ser_cnn.init,
    loss=lambda cfg: partial(ser_cnn.loss_fn, cfg=cfg),
    accuracy=ser_cnn.make_accuracy_fn,
)
register_workload(
    "ser_linear",
    init=_linear_init,
    loss=_linear_loss,
    accuracy=_linear_accuracy,
)
