"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="xlstm-350m", family="ssm", source="arXiv:2405.04517",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0,        # assignment: no separate FFN; mLSTM carries up/down proj
    vocab=50304,
    slstm_every=8,  # xLSTM[7:1]: one sLSTM closes each period of 8
    ssm_chunk=128,
)
