"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi-3-vision-4.2b", family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    n_patches=576,   # stub ViT/projector output length (336px/14 -> 24x24)
    rope_theta=10000.0,
)
