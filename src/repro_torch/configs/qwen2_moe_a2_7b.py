"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-moe-a2.7b", family="moe", source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4, d_expert=1408,
    rope_theta=1000000.0,
)
