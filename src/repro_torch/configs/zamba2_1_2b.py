"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b", family="hybrid", source="arXiv:2411.15242",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_conv=4, ssm_expand=2, ssm_chunk=128,
    attn_every=6,   # one shared attn+MLP application per 6 mamba layers
)
