"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, GQA kv=8, SWA 4096.
(The 8x7B paper describes SWA; kept here as the assignment notes — it is
also what qualifies this arch for long_500k decode.)"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="dense",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, rope_theta=1e6, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  aux_loss_weight=0.01),
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, sliding_window=32, moe=MoEConfig(n_experts=4, top_k=2),
    attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
