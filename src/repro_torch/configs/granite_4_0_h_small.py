"""Granite-4.0-H-Small (huggingface.co/ibm-granite/granite-4.0-h-small,
config.json; 32B parameters, 9B active) — the port's own ``hybrid_moe``
family: 40 layers, 36 Mamba2 mixers and 4 GQA attention mixers without
position encoding (layers 5, 15, 25, 35), each followed by an MoE block
of 72 experts of width 768 (``intermediate_size``), top-10, with a
shared SwiGLU expert of width 1536. Embedding x12, each residual branch
x0.22, logits /16, softmax scale 1/128; the embedding and head are tied
in the published model."""
from repro_torch.common.config import HybridMoEConfig, MoEConfig, SSMConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352, max_seq_len=131072, norm_eps=1e-5,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
    layer_types=_PERIOD * 4, shared_d_ff=1536, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0,
    attention_multiplier=0.0078125,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
    vocab_size=512, moe=MoEConfig(n_experts=8, top_k=3),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                  chunk_size=16, n_groups=1),
    layer_types=("mamba", "mamba", "attention", "mamba"), shared_d_ff=48,
    attention_multiplier=1 / 16, attn_block_q=16, attn_block_kv=16,
    remat_policy="none", compute_dtype="float32", max_seq_len=128)
