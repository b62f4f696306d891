"""Gemma-3-12B [hf:google/gemma-3-1b-pt family] — dense, GQA (kv=8),
5:1 local:global attention pattern (local window 1024, global full),
dual RoPE theta (10k local / 1M global), 128k context, 262k vocab."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab_size=262144, head_dim=240,
    rope_theta=1e4, rope_theta_global=1e6,
    local_global_ratio=5, local_window=1024,
    source="hf:google/gemma-3-1b-pt",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=6, d_model=120, n_heads=4, n_kv_heads=2, d_ff=256, head_dim=30,
    vocab_size=512, local_global_ratio=2, local_window=32,
    attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
