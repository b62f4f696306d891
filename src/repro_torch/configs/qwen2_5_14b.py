"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family] — dense, GQA kv=8, QKV bias,
full attention, 152k vocab."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, rope_theta=1e6, qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=160, n_heads=8, n_kv_heads=2, d_ff=448,
    vocab_size=512, attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
