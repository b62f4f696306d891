"""xLSTM-1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks, 4 heads,
d_ff=0 (blocks carry their own up/down projections). 7:1 mLSTM:sLSTM."""
from repro_torch.common.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_mlstm=2.0,
                      proj_factor_slstm=1.333),
    source="arXiv:2405.04517",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    vocab_size=512, xlstm=XLSTMConfig(slstm_every=2),
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
