"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3.2-3b", family="dense", source="hf:meta-llama/Llama-3.2-1B",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500000.0, tie_embeddings=True,
)
