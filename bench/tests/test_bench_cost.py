"""The closed-form work counts of ``bench/cost`` against independent
counts: the port's own aten-op count (``launch/op_cost``) of the
StarCoder2-3B smoke configuration's prefill, and PyTorch's FLOP counter
over one client's update of the Table-I network."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.lib import registry
from bench.tests.cells import ROOT

SC2 = registry.load_module(ROOT / "bench" / "cost" / "starcoder2-3b.py",
                           "cost_sc2")
MLP = registry.load_module(ROOT / "bench" / "cost" / "table1-mlp.py",
                           "cost_mlp")


def _cfg_dict(cfg):
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "mlp_act": cfg.mlp_act,
            "sliding_window": cfg.sliding_window}


def test_prefill_counts_equal_op_cost_on_the_smoke_config():
    from repro_torch.common.config import InputShape
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import op_cost, steps
    from repro_torch.models.model import build_model

    cfg = get_smoke_config("starcoder2_3b").replace(
        compute_dtype="bfloat16", attn_impl="pallas")
    b, s = 2, 80          # longer than the window of 32
    model = build_model(cfg)
    bb, head, _ = steps.abstract_serve_state(model, InputShape("p", s, b,
                                                               "prefill"))
    _, tot = op_cost.trace(steps.make_prefill_step(model, cache_len=s + 1),
                           bb, head,
                           torch.empty(b, s, dtype=torch.int32, device="meta"))
    c = _cfg_dict(cfg)
    assert SC2.gemm_flops(c, b, s) == tot.dot_flops
    assert SC2.attention_flops(c, b, s) == tot.kernel_flops
    assert tot.kernels == {"flash_attention": cfg.n_layers}


def test_visible_pairs_by_hand():
    assert SC2.visible_pairs(5, None) == 15
    assert SC2.visible_pairs(5, 2) == 1 + 2 * 4
    assert SC2.visible_pairs(8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096


def test_table1_round_by_hand_at_two_clusters():
    # Table I: 256-512-1024-2048-512-256, heads of 8 classes, B = 24
    w = 256 * 512 + 512 * 1024 + 1024 * 2048 + 2048 * 512 + 512 * 256
    assert w == 3_932_160
    fwd, wgrad, xgrad = 2 * 24 * w, 2 * 24 * w, 2 * 24 * (w - 256 * 512)
    head = 4 * 2 * 24 * 256 * 8    # 2 forwards, a weight and an input grad
    per_client = fwd + wgrad + xgrad + head
    assert per_client == 560_332_800
    dims = [256, 512, 1024, 2048, 512, 256]
    assert MLP.round_flops(2, 3, 24, dims, 8) == 6 * per_client


def test_table1_client_update_against_the_flop_counter():
    """One client's update in plain autograd: the head step (on features
    computed without gradients) and the ω step; the counter sees the
    features' forward twice, the closed form counts it once."""
    dims, b, n_cls = [8, 16, 32, 16, 8], 4, 8
    ws = [torch.randn(a, c, requires_grad=True)
          for a, c in zip(dims[:-1], dims[1:])]
    x = torch.randn(b, dims[0])
    hw = torch.randn(dims[-1], n_cls, requires_grad=True)

    def features():
        h = x
        for w in ws:
            h = torch.relu(h @ w)
        return h

    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            f = features()
        (f @ hw).logsumexp(-1).sum().backward()
        hw2 = hw.detach()
        (features() @ hw2).logsumexp(-1).sum().backward()
    recompute = 2 * b * sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    assert fc.get_total_flops() - recompute == MLP.round_flops(
        1, 1, b, dims, n_cls)
