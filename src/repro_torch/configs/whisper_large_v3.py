"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3", family="audio", source="arXiv:2212.04356",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    n_enc_layers=32, enc_frames=1500, mlp_variant="gelu",
    max_seq=32768,   # assignment decode_32k shape (whisper native ctx is 448)
)
