"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini
text backbone + CLIP vision tower. The vision encoder + projector are the
stubbed frontend (assignment carve-out): input_specs supplies projected
patch embeddings of shape (B, S, d_model); this module is the 32-layer
decoder consuming interleaved text/image embeddings."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="dense", modality="vision",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064, rope_theta=1e4,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
