"""Phi-3.5-MoE-42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct] —
16 experts, top-2 routing, GQA kv=8, d_ff=6400 per expert."""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, rope_theta=1e4,
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25,
                  aux_loss_weight=0.01),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=512, moe=MoEConfig(n_experts=4, top_k=2),
    attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
