"""Configuration dataclasses, copied from the JAX package's
``repro.common.config`` so the port depends on nothing there.

``FLConfig`` describes the HOTA-FedGradNorm topology and channel,
``ModelConfig`` a backbone (the port builds the ``mlp`` family and the
dense LM family with its MoE layer), ``TrainConfig`` the step-level
knobs, ``ServeConfig`` and ``MeshConfig`` a serving run and a production
mesh, ``InputShape`` and ``INPUT_SHAPES`` the assigned input shapes
(``launch.steps.input_specs``, the dry run). Field names, defaults and
meanings are the reference's, so a config written for one package means
the same thing to the other. ``HybridMoEConfig`` alone is the port's own:
the Granite-4.0-H family, which the reference does not build.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD form) hyper-parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2           # d_inner = expand * d_model
    head_dim: int = 64        # SSD head dim
    chunk_size: int = 256     # SSD chunk length
    n_groups: int = 1         # B/C groups (GVA-style)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # every k-th block is an sLSTM block
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_kernel: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""
    attn_every: int = 6           # shared attn applied every k SSM layers
    shared_attn_n_heads: int = 32
    shared_attn_n_kv: int = 32


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | xlstm
    modality: str = "text"         # text | audio | vision (audio/vision = stub frontends)
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None          # default d_model // n_heads
    max_seq_len: int = 4096
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None   # gemma3 global layers
    qkv_bias: bool = False                  # qwen2.5
    mlp_act: str = "silu"                   # silu (SwiGLU) | gelu (plain MLP)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # attention pattern
    sliding_window: Optional[int] = None    # SWA width (starcoder2/mixtral: 4096)
    local_global_ratio: Optional[int] = None  # gemma3: 5 local per 1 global
    local_window: int = 1024                # window of "local" layers (gemma3)
    # family-specific
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "nothing_saveable"   # none | dots | nothing_saveable
    # attention implementation: blocked (scan online-softmax) | naive | pallas
    attn_impl: str = "blocked"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    # citation for provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch supports bounded-state long-context decode."""
        if self.family in ("ssm", "xlstm", "hybrid"):
            return True
        if self.sliding_window is not None:
            return True
        if self.local_global_ratio is not None:
            return True
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """The port's own ``hybrid_moe`` family (Granite-4.0-H): layer i's
    mixer is ``layer_types[i]`` ("mamba": Mamba2 of ``ssm``; "attention":
    GQA without position encoding, softmax scale
    ``attention_multiplier``), and every layer then has an MoE block of
    ``moe`` (experts of width ``d_ff``) with a shared SwiGLU expert of
    width ``shared_d_ff``. The embedding is scaled by
    ``embedding_multiplier``, each residual branch by
    ``residual_multiplier``, and the logits divided by
    ``logits_scaling``."""
    layer_types: Tuple[str, ...] = ()
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: Optional[float] = None

    def __post_init__(self):
        if len(self.layer_types) != self.n_layers or not set(
                self.layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"layer_types {self.layer_types} must name "
                             f"'mamba' or 'attention' for each of "
                             f"{self.n_layers} layers")


@dataclass(frozen=True)
class FLConfig:
    """HOTA-FedGradNorm topology + channel model (paper Secs. II-III)."""
    n_clusters: int = 4               # C
    n_clients: int = 4                # N per cluster
    sigma2: Tuple[float, ...] = ()    # per-cluster channel variance; () -> all 1.0
    h_threshold: float = 3.2e-2       # H_th (paper Sec. IV-B)
    noise_std: float = 1.0            # AWGN z ~ N(0,1)
    gamma: float = 0.6                # FedGradNorm restoring-force strength
    alpha: float = 8e-3               # F_grad learning rate (Alg 2)
    tau_h: int = 1                    # local head steps per round
    tau_w: int = 1                    # local shared-net steps per round
    weighting: str = "fedgradnorm"    # fedgradnorm | equal (paper baseline)
    ota: bool = True                  # over-the-air aggregation on/off
    p_min: float = 0.0                # clamp for loss weights before renorm
    # Flat-packed OTA: ravel the shared tree into one lane-aligned slab and
    # run eqs. 7-10 in a single fused Pallas kernel (repro.common.flatpack +
    # repro.kernels.ota_channel.ota_aggregate). False keeps the per-leaf jnp
    # path — the property-test oracle (different PRNG stream, same math).
    use_pallas_ota: bool = True
    # gradient-transmission implementation (same math — DESIGN.md §3.1):
    #  * "naive":   paper-literal — per-layer full-size weighted psum over
    #    clients (LAN) + full-size masked psum over clusters (MAC).
    #  * "scatter": psum_scatter the LAN sum into per-client regions, mask
    #    and MAC-reduce regions, slice the FSDP piece — ~3x fewer
    #    collective bytes, no full-size intermediates.
    # Channel keys fold (step, layer, leaf) only, so microbatch-averaged
    # estimates equal one MAC transmission per round (exact Alg. 1).
    ota_mode: str = "scatter"         # "scatter" | "naive"
    # Packed-slab section layout (DESIGN.md §3.13) — static, like ota_mode:
    # the Section partition decides the stream folds, so it changes every
    # channel draw and is pinned in checkpoint manifests. "toplevel" =
    # one section per layer stack (tail last); "tail" = the legacy
    # two-section layout. min_section_rows coalesces adjacent sub-
    # threshold trunk sections (rows of 128 lanes) to kill the chunk-
    # quantization RNG waste on many-tiny-leaf templates; 0 = uncoalesced
    # (bit-identical to the pre-autotuner layout). Set both via
    # repro.common.layout_tune.apply_layout, not by hand.
    ota_sections: str = "toplevel"    # "toplevel" | "tail"
    min_section_rows: int = 0         # coalescing threshold (slab rows)
    max_section_rows: int = 0         # section split cap (slab rows); 0=off
    # Streaming aggregation (DESIGN.md §3.15) — static, sim engine only:
    # fold arriving cluster contributions into the slab running sum one
    # cluster at a time (lax.scan over repro.core.ota.ota_stream_fold)
    # instead of drawing every cluster's streams at once. Same streams,
    # same math (equal up to float associativity — the cross-cluster
    # reduction order changes); peak aggregation memory drops from
    # (C × section) to one cluster's contribution + the running sum.
    ota_streaming: bool = False
    # Section-streaming aggregation (DESIGN.md §3.16) — static: make the
    # multi-section layout the unit of scheduling. The round walks the
    # Section partition one section at a time, drawing only that
    # section's gain/noise streams (the same per-section folds — bit-
    # identical draws), folding only its leaf runs, then releasing the
    # buffers, so peak live streams are ONE section (bounded by
    # max_section_rows above), never the (P,) or (C,P) slab. Composes
    # with ota_streaming: the cluster scan then runs inside each
    # section. Requires a multi-section layout (ota_sections="toplevel").
    ota_sectioned: bool = False
    microbatches: int = 1             # gradient accumulation count
    # Fault injection (DESIGN.md §3.14). ``faults`` is the one static gate:
    # False keeps the legacy trace bit-exact (no participation draws, no
    # stale-model state in SimState); True threads the traced FaultParams
    # knobs below through the round. The rates themselves are traced
    # (FaultParams) so fault scenarios sweep without retracing.
    faults: bool = False              # static: enable fault plumbing
    dropout_rate: float = 0.0         # per-client drop probability
    blackout_rate: float = 0.0        # per-cluster blackout probability
    straggler_rate: float = 0.0       # per-client straggler probability
    staleness_rounds: int = 1         # straggler staleness depth τ (rounds)
    spike_norm: float = float("inf")  # guard: skip round if ‖ĝ‖ exceeds

    def cluster_sigma2(self, cluster: int) -> float:
        if not self.sigma2:
            return 1.0
        return self.sigma2[cluster % len(self.sigma2)]


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4                  # β in the paper
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    steps: int = 100
    seed: int = 0
    fl: FLConfig = field(default_factory=FLConfig)


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    prefill_len: int = 128
    cache_len: int = 256
    param_dtype: str = "bfloat16"


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")
    multi_pod: bool = False


# --- input shapes assigned to this paper ------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
