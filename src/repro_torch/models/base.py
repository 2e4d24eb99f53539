"""Architecture config + model registry (port of ``repro/models/base.py``).

Every architecture is an :class:`ArchConfig`; families register a
:class:`Family` of plain functions here.  The fields, ``reduced()`` and
the input shapes are the JAX package's; ``pdtype`` is a ``torch.dtype``.
:func:`input_specs` gives ``meta``-device tensors where the JAX package
gives ``ShapeDtypeStruct`` stand-ins: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    source: str                  # citation bracket from the assignment
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full attention
    local_global_pattern: bool = False   # gemma2: alternate local/global
    attn_logit_softcap: float = 0.0      # gemma2: 50.0
    final_logit_softcap: float = 0.0     # gemma2: 30.0
    tie_embeddings: bool = False
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0            # per-expert hidden dim (qwen2-moe: 1408)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    expert_pad: int = 0          # pad expert weight arrays for even sharding
    # --- SSM / hybrid ------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0          # zamba2: shared attn block period
    slstm_every: int = 0         # xlstm: sLSTM block period (else mLSTM)
    # --- enc-dec / multimodal stubs -----------------------------------------
    n_enc_layers: int = 0        # whisper encoder depth
    enc_frames: int = 1500       # whisper: stub conv-frontend output length
    n_patches: int = 0           # vlm: stub vision-encoder output length
    max_seq: int = 8192
    # --- numerics ----------------------------------------------------------
    param_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return self.replace(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            d_head=max(32, d // heads),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            d_expert=min(self.d_expert, 256) if self.d_expert else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_frames=64,
            n_patches=16 if self.n_patches else 0,
            attn_every=2 if self.attn_every else 0,
            slstm_every=2 if self.slstm_every else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32,
            max_seq=512,
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Family:
    """Callable bundle implemented by each model family module."""

    name: str
    init_params: Callable        # (cfg, seed, device) -> params
    forward: Callable            # (params, inputs, cfg) -> logits
    loss: Callable               # (params, batch, cfg) -> scalar mean loss
    init_cache: Callable         # (cfg, batch, max_len, device) -> cache
    prefill: Callable            # (params, inputs, cfg, cache) -> (logits_last, cache)
    decode_step: Callable        # (params, cache, token, pos, cfg) -> (logits, cache)


_FAMILIES: dict = {}


def register_family(fam: Family):
    _FAMILIES[fam.name] = fam


def get_family(name: str) -> Family:
    if name not in _FAMILIES:
        # lazy import of family modules
        import repro_torch.models.transformer  # noqa: F401
        import repro_torch.models.moe  # noqa: F401
        import repro_torch.models.hybrid  # noqa: F401
        import repro_torch.models.xlstm  # noqa: F401
        import repro_torch.models.whisper  # noqa: F401
        import repro_torch.models.vlm  # noqa: F401
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r} "
                       f"(families: {', '.join(sorted(_FAMILIES))})")
    return _FAMILIES[name]


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """``meta`` tensors standing in for every model input of this
    arch/shape (no storage):

    train:   tokens+labels (B, S)   [+ modality stub embeddings]
    prefill: tokens (B, S)
    decode:  token (B, 1) + positions; the KV cache itself is created by
             ``init_cache`` (also shape-only with ``device="meta"``).
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    i32 = torch.int32
    out = {}
    if shape.kind == "train":
        out["tokens"] = spec((B, S), i32)
        out["labels"] = spec((B, S), i32)
    elif shape.kind == "prefill":
        out["tokens"] = spec((B, S), i32)
    else:  # decode
        out["token"] = spec((B, 1), i32)
        out["pos"] = spec((B,), i32)
    if cfg.family == "audio":
        # stub conv/mel frontend: precomputed encoder frame embeddings
        out["frames"] = spec((B, cfg.enc_frames, cfg.d_model), cfg.pdtype)
    if cfg.family == "vlm":
        # stub vision encoder + projector: precomputed patch embeddings
        out["patches"] = spec((B, cfg.n_patches, cfg.d_model), cfg.pdtype)
    return out
