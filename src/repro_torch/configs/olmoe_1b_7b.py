"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe", source="arXiv:2409.02060",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, n_shared_experts=0, d_expert=1024,
)
