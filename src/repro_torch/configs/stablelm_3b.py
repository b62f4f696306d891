"""StableLM-3B (stablelm-2 family) [hf:stabilityai/stablelm-2-1_6b] —
dense, MHA-as-GQA (kv=32), RoPE, full attention."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
    vocab_size=512, attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
