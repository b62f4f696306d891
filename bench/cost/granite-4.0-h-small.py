"""Closed-form work of a prefill of Granite-4.0-H (the ``hybrid_moe``
family), from the configuration's shapes alone (never from what the
program launches). ``cfg`` is the configuration file's dict (Hugging
Face's keys).

FLOPs count 2 per multiply-add. Per token, the matrix products are each
Mamba2 layer's in- and out-projections, each attention layer's Q, K, V
and O, and every layer's router, its k routed experts' SwiGLU (three
products of width ``intermediate_size``) and the shared expert's (width
``shared_intermediate_size``); the head runs on the last position only.
Attention (K8) computes q·k and p·v for each causal pair: 4·D·H per pair
and layer. The SSD's model FLOPs are those of its recurrence, per
position, head, channel and state entry: the decay and the input's
outer product into the state and the state's product with C, three
multiply-adds.
"""


def _dims(cfg):
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    return d, d_in, gn, cfg["mamba_n_heads"]


def _counts(cfg):
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return kinds.count("mamba"), kinds.count("attention"), len(kinds)


def mamba_params(cfg):
    """Matrix parameters of one Mamba2 mixer's projections."""
    d, d_in, gn, nh = _dims(cfg)
    return d * (2 * d_in + 2 * gn + nh) + d_in * d


def attention_params(cfg):
    d, h, kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    hd = d // h
    return 2 * d * h * hd + 2 * d * kv * hd


def active_moe_params(cfg):
    """Per token: the router, k routed experts and the shared expert."""
    d = cfg["hidden_size"]
    return (d * cfg["num_local_experts"]
            + 3 * d * cfg["intermediate_size"] * cfg["num_experts_per_tok"]
            + 3 * d * cfg["shared_intermediate_size"])


def attention_pairs(seq):
    return seq * (seq + 1) // 2


def gemm_flops(cfg, batch, seq):
    """The layers' projections and experts, and the head on the last
    position."""
    n_m, n_a, n = _counts(cfg)
    per_token = (n_m * mamba_params(cfg) + n_a * attention_params(cfg)
                 + n * active_moe_params(cfg))
    return 2 * batch * (per_token * seq
                        + cfg["hidden_size"] * cfg["vocab_size"])


def attention_flops(cfg, batch, seq):
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    _, n_a, _ = _counts(cfg)
    return (4 * hd * cfg["num_attention_heads"] * n_a * batch
            * attention_pairs(seq))


def attention_bound_s(cfg, batch, seq, flops_per_s, bytes_per_s):
    """Least time of K8 over the attention layers: per layer the larger
    of its FLOPs and its bytes (bfloat16 q, k, v read once, the output
    written once) over the peak."""
    d, h, kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    _, n_a, _ = _counts(cfg)
    if not n_a:
        return 0.0
    flops = attention_flops(cfg, batch, seq) / n_a
    nbytes = 2 * batch * seq * (d // h) * (2 * h + 2 * kv)
    return n_a * max(flops / flops_per_s, nbytes / bytes_per_s)


def ssd_flops(cfg, batch, seq):
    _, _, _, nh = _dims(cfg)
    n_m, _, _ = _counts(cfg)
    return (6 * n_m * batch * seq * nh * cfg["mamba_d_head"]
            * cfg["mamba_d_state"])


def ssd_bytes(cfg, batch, seq):
    """The SSD's float32 operands and result, each moved once per Mamba2
    layer: x and y (d_in per position), dt (a value per head), B and C."""
    _, d_in, gn, nh = _dims(cfg)
    n_m, _, _ = _counts(cfg)
    return 4 * n_m * batch * seq * (2 * d_in + nh + 2 * gn)


def prefill_flops(cfg, batch, seq):
    return (gemm_flops(cfg, batch, seq) + attention_flops(cfg, batch, seq)
            + ssd_flops(cfg, batch, seq))


def routed_expert_flops(cfg, batch, seq):
    """One layer's routed experts: 3 products of each of the T·k rows."""
    rows = batch * seq * cfg["num_experts_per_tok"]
    return 2 * rows * 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def routed_expert_bytes(cfg, batch, seq):
    """One layer's routed experts in bfloat16: all E experts' weights
    read once, and each routed row read in and written out once."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    rows = batch * seq * cfg["num_experts_per_tok"]
    return 2 * (3 * cfg["num_local_experts"] * d * f + 2 * rows * d)


def shared_expert_flops(cfg, batch, seq):
    return 2 * batch * seq * 3 * cfg["hidden_size"] * \
        cfg["shared_intermediate_size"]


def shared_expert_bytes(cfg, batch, seq):
    d, fs = cfg["hidden_size"], cfg["shared_intermediate_size"]
    return 2 * (3 * d * fs + 2 * batch * seq * d)


def expert_gemm_bound_s(cfg, batch, seq, flops_per_s, bytes_per_s):
    """Least time of the routed experts' products over the prefill: per
    layer the larger of their FLOPs and their bytes over the peak."""
    _, _, n = _counts(cfg)
    return n * max(routed_expert_flops(cfg, batch, seq) / flops_per_s,
                   routed_expert_bytes(cfg, batch, seq) / bytes_per_s)
