"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-2b", family="dense", source="arXiv:2408.00118",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab=256000,
    local_global_pattern=True, sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True, mlp_variant="geglu", rope_theta=10000.0,
)

# long_500k variant: every layer local (global layers fall back to the
# 4096-token sliding window) -> sub-quadratic decode over a window-bounded
# KV cache.  See DESIGN.md section 5.
CONFIG_LONG = CONFIG.replace(local_global_pattern=False, sliding_window=4096)
