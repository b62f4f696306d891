"""MusicGen-medium [arXiv:2306.05284] — decoder-only transformer over
EnCodec tokens (audio modality). The EnCodec tokenizer/codec is the stubbed
frontend (assignment carve-out): input_specs supplies token ids / frame
embeddings; this module is the 48-layer decoder that consumes them."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense", modality="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, rope_theta=1e4, mlp_act="gelu",
    source="arXiv:2306.05284",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=256, attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
