"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA (kv=2), RoPE.

The real model uses sliding-window attention (w=4096), which we keep: it is
what makes long_500k decode feasible for this arch (DESIGN.md §3.6).
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab_size=49152, rope_theta=1e5, sliding_window=4096,
    mlp_act="gelu",                      # starcoder2 uses gelu MLP
    source="arXiv:2402.19173",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, d_ff=512,
    vocab_size=512, sliding_window=32, attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
