"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-coder-33b", family="dense", source="arXiv:2401.14196",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, rope_theta=100000.0,
)
