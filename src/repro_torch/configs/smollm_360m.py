"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="smollm-360m", family="dense", source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, tie_embeddings=True,
)
