"""The paper's own shared network (Table I): 5-layer FC MLP, 256-dim
RadComDynamic features, personalized linear heads per task."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-mlp", family="mlp", d_model=256, vocab_size=8,
    source="HOTA-FedGradNorm Table I",
)

SMOKE_CONFIG = CONFIG
