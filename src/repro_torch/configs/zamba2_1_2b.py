"""Zamba2-1.2B [arXiv:2411.15242] — hybrid: Mamba2 backbone + one *shared*
attention block applied every 6 layers (weight reuse = the Zamba trick).
ssm_state=64. The shared attn uses sliding window 4096 in long-context
serving (TPU adaptation, DESIGN.md §3.6)."""
from repro_torch.common.config import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, sliding_window=4096,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
    hybrid=HybridConfig(attn_every=6, shared_attn_n_heads=32,
                        shared_attn_n_kv=32),
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, sliding_window=32,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                  chunk_size=16, n_groups=1),
    hybrid=HybridConfig(attn_every=2, shared_attn_n_heads=4,
                        shared_attn_n_kv=2),
    attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
