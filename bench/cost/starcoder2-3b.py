"""Closed-form work of a prefill of the dense decoder, from the
configuration's shapes alone (never from what the program launches).

FLOPs count 2 per multiply-add. The matrix products of a layer are the
Q, K, V and O projections and the MLP's up and down projections (a
gated MLP adds the gate's); the head runs on the last position only.
Attention, causal within the window W, computes q·k and p·v for each
visible pair: 4·D·H·Σ_i min(i + 1, W) per layer and sequence.
"""


def layer_matmul_params(cfg):
    d, h, kv, hd, f = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    mlp = (3 if cfg["mlp_act"] == "silu" else 2) * d * f
    return d * h * hd + 2 * d * kv * hd + h * hd * d + mlp


def visible_pairs(seq, window):
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def gemm_flops(cfg, batch, seq):
    """The layers' projections and the head on the last position."""
    return 2 * batch * (cfg["n_layers"] * layer_matmul_params(cfg) * seq
                        + cfg["d_model"] * cfg["vocab_size"])


def attention_flops(cfg, batch, seq):
    return (4 * cfg["head_dim"] * cfg["n_heads"] * cfg["n_layers"] * batch
            * visible_pairs(seq, cfg.get("sliding_window")))


def prefill_flops(cfg, batch, seq):
    return gemm_flops(cfg, batch, seq) + attention_flops(cfg, batch, seq)


def _projections(cfg):
    """(d_in, d_out) of every matrix product of one layer."""
    d, h, kv, hd, f = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    mlp = [(d, f), (f, d)] + ([(d, f)] if cfg["mlp_act"] == "silu" else [])
    return [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)] + mlp


def gemm_bound_s(cfg, batch, seq, flops_per_s, bytes_per_s):
    """Least time of the prefill's matrix products on a chip of these
    peaks: per product the larger of its FLOPs and its bytes (bfloat16
    weights, inputs and outputs each moved once) over the peak, summed
    over the layers' products and the head on the last position."""
    t = batch * seq
    layer = sum(max(2 * t * a * b / flops_per_s,
                    2 * (a * b + t * a + t * b) / bytes_per_s)
                for a, b in _projections(cfg))
    d, v = cfg["d_model"], cfg["vocab_size"]
    head = max(2 * batch * d * v / flops_per_s,
               (2 * d * v + 2 * batch * d + 4 * batch * v) / bytes_per_s)
    return cfg["n_layers"] * layer + head


def attention_bound_s(cfg, batch, seq, flops_per_s, bytes_per_s):
    """Least time of the layers' attention: per layer the larger of its
    FLOPs and its bytes (bfloat16 q, k, v read once, the output written
    once) over the peak."""
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = attention_flops(cfg, batch, seq) / cfg["n_layers"]
    nbytes = 2 * batch * seq * hd * (2 * h + 2 * kv)
    return cfg["n_layers"] * max(flops / flops_per_s, nbytes / bytes_per_s)
