"""The port's Granite-4.0-H family (``models/hybrid_moe.py``), its routed
MoE inference path and NoPE attention at a set scale, against the plain
reference ``bench/reference/hybrid_moe.py`` on the CPU, in float32.

- the smoke config (d_model 64; layers mamba, mamba, attention, mamba; 8
  experts top-3 with a shared expert; chunk 16) through
  ``make_prefill_step``, and a prefill followed by 4 decode steps through
  the cache, against the reference's full forward pass;
- the routed dropless MoE against the every-expert inference it replaced
  (each expert on every token, weighted by the top-k gates), with ties,
  an expert that no token chose and top-k equal to the expert count;
- the reference's blocked SSM against its token-by-token recurrence;
- NoPE attention at a set scale on every CPU path against the
  reference's attention, and the default scale bit for bit;
- ``get_config`` finds the port-only architecture and ``ARCH_IDS`` stays
  the reference's.

Tolerances: float32 on both sides, summed in other orders (the SSD's
chunks against the reference's blocks, grouped experts against a loop):
1e-4 of the largest logit for the model, 1e-5 for one block.
"""
import dataclasses
import math

import pytest
import torch

from bench.reference import hybrid_moe as R
from bench.reference import lm as ref_lm
from repro_torch import configs
from repro_torch.launch.serve import init_weights
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import build_model
from repro_torch.models.transformer import attn_branch
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MODEL_TOL = 1e-4
BLOCK_TOL = 1e-5
SMOKE = configs.get_smoke_config("granite-4.0-h-small")


def _close(got, want, tol):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * max(scale, 1e-30), \
        (float((got - want).abs().max()), scale)


def _ref_cfg(cfg):
    """The reference's configuration dict (Hugging Face's keys)."""
    s = cfg.ssm
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff,
            "shared_intermediate_size": cfg.shared_d_ff,
            "num_local_experts": cfg.moe.n_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "mamba_expand": s.expand, "mamba_d_head": s.head_dim,
            "mamba_n_heads": s.expand * cfg.d_model // s.head_dim,
            "mamba_d_state": s.d_state, "mamba_n_groups": s.n_groups,
            "layer_types": list(cfg.layer_types),
            "num_hidden_layers": cfg.n_layers,
            "attention_multiplier": cfg.attention_multiplier,
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "rms_norm_eps": cfg.norm_eps}


def _weights(cfg, seed=0):
    """(backbone, head) of the smoke model with its norms, a_log and
    dt_bias drawn away from their zero init, the head tied to the
    embedding, and the reference's flat dict of the same tensors."""
    bb, _ = init_weights(build_model(cfg), seed, "cpu")
    t = bb["trunk"]
    g = torch.Generator().manual_seed(seed + 1)
    for tree, names in ((t["mamba"], ("norm", "out_norm", "a_log",
                                      "dt_bias", "conv_b")),
                        (t["attention"], ("norm",)), (t["moe"], ("norm",)),
                        (bb["final"], ("norm",))):
        for n in names:
            tree[n] = torch.randn(tree[n].shape, generator=g) * 0.2
    m, a, e = t["mamba"], t["attention"], t["moe"]
    ref = {"embed": t["embed"], "mamba_norm": m["norm"], "w_in": m["w_in"],
           "conv_w": m["conv_w"], "conv_b": m["conv_b"],
           "a_log": m["a_log"], "dt_bias": m["dt_bias"],
           "d_skip": m["d_skip"], "out_norm": m["out_norm"],
           "w_out": m["w_out"], "attn_norm": a["norm"], "wq": a["wq"],
           "wk": a["wk"], "wv": a["wv"], "wo": a["wo"],
           "moe_norm": e["norm"], "router": e["router"],
           "w_gate": e["w_gate"], "w_up": e["w_up"], "w_down": e["w_down"],
           "shared_gate": e["shared"]["w_gate"],
           "shared_up": e["shared"]["w_up"],
           "shared_down": e["shared"]["w_down"],
           "final_norm": bb["final"]["norm"]}
    return bb, {"w": t["embed"].t()}, ref


def _tokens(b, s, seed=7):
    return torch.randint(0, SMOKE.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("impl", ["pallas", "blocked"])
@pytest.mark.parametrize("s", [64, 96])
def test_prefill_matches_the_reference(impl, s):
    cfg = SMOKE.replace(attn_impl=impl)
    bb, head, ref = _weights(cfg)
    toks = _tokens(2, s)
    logits, cache = make_prefill_step(build_model(cfg))(bb, head, toks)
    want = R.last_logits(ref, _ref_cfg(cfg), toks)
    _close(logits, want, MODEL_TOL)
    assert cache["mamba"]["ssm"].shape[0] == 3
    assert cache["attention"]["k"].shape[:3] == (1, 2, s + 1)


def test_prefill_then_decode_matches_the_full_forward():
    cfg = SMOKE.replace(attn_impl="pallas")
    model = build_model(cfg)
    bb, head, ref = _weights(cfg, seed=3)
    toks = _tokens(2, 72 + 4, seed=11)
    s = 72
    logits, cache = make_prefill_step(model, cache_len=s + 8)(
        bb, head, toks[:, :s])
    _close(logits, R.last_logits(ref, _ref_cfg(cfg), toks[:, :s]),
           MODEL_TOL)
    decode = make_decode_step(model)
    for j in range(4):
        pos = torch.full((2,), s + j, dtype=torch.int32)
        _, logits, cache = decode(bb, head, cache, toks[:, s + j:s + j + 1],
                                  pos)
        want = R.last_logits(ref, _ref_cfg(cfg), toks[:, :s + j + 1])
        _close(logits, want, MODEL_TOL)


def test_bfloat16_prefill_is_near_the_reference():
    """The smoke config in bfloat16 (the grouped GEMMs in bfloat16, the
    router's logits and the residual stream in float32) against the
    float32 reference, at bfloat16's scale."""
    cfg = SMOKE.replace(attn_impl="pallas", compute_dtype="bfloat16")
    bb, head, ref = _weights(cfg, seed=6)
    toks = _tokens(2, 64, seed=4)
    logits, _ = make_prefill_step(build_model(cfg))(bb, head, toks)
    want = R.last_logits(ref, _ref_cfg(cfg), toks)
    err = float(torch.linalg.vector_norm(logits.float() - want)
                / torch.linalg.vector_norm(want))
    assert err < 1e-2, err
    h = torch.randn(3, cfg.d_model).to(torch.bfloat16)
    router = bb["trunk"]["moe"]["router"][0]
    lg = M.router_logits({"router": router}, h)
    assert lg.dtype == torch.float32
    assert torch.equal(lg, h.float() @ router.float())


def test_decode_from_an_empty_cache():
    cfg = SMOKE.replace(attn_impl="pallas")
    model = build_model(cfg)
    bb, head, ref = _weights(cfg, seed=5)
    toks = _tokens(1, 6, seed=2)
    cache = model.init_cache(1, 8, torch.float32, device="cpu")
    decode = make_decode_step(model)
    for j in range(6):
        pos = torch.full((1,), j, dtype=torch.int32)
        _, logits, cache = decode(bb, head, cache, toks[:, j:j + 1], pos)
    _close(logits, R.last_logits(ref, _ref_cfg(cfg), toks), MODEL_TOL)


def _every_expert(p, h, gates_c):
    """The inference the routed path replaced: every expert on every
    token, weighted by its gate (0 off the top k), summed in float32."""
    y = torch.zeros(h.shape, dtype=torch.float32)
    for e in range(gates_c.shape[-1]):
        y += gates_c[..., e:e + 1] * M._expert(p, e, h).float()
    return y


def _moe_params(e, d, f, fs, seed):
    g = torch.Generator().manual_seed(seed)
    spec = M.moe_specs(SMOKE.replace(
        d_model=d, d_ff=f, moe=dataclasses.replace(SMOKE.moe, n_experts=e)),
        fs)
    p = {k: torch.randn(v.shape, generator=g) * 0.3
         for k, v in spec.items() if k != "shared"}
    if fs:
        p["shared"] = {k: torch.randn(v.shape, generator=g) * 0.3
                       for k, v in spec["shared"].items()}
    return p


@pytest.mark.parametrize("case", ["random", "ties", "unchosen",
                                  "top_k_all", "shared"])
def test_routed_moe_equals_every_expert(case):
    e, k, d, f = 8, 3, 32, 24
    if case == "top_k_all":
        k = e
    p = _moe_params(e, d, f, 20 if case == "shared" else 0, seed=4)
    if case == "ties":
        p["router"][:, 4:] = p["router"][:, :4]   # experts e and e + 4 tie
    if case == "unchosen":
        p["router"][:, 5] = -50.0     # a positive input never picks it
    cfg = SMOKE.replace(d_model=d, d_ff=f, moe=dataclasses.replace(
        SMOKE.moe, n_experts=e, top_k=k))
    x = torch.randn(2, 40, d, generator=torch.Generator().manual_seed(9))
    if case == "unchosen":
        x, p["norm"] = x.abs(), p["norm"].abs()
    got, _ = M.moe_branch(p, x, cfg, train=False)
    h = L.rms_norm(x, p["norm"], 1e-6)
    gates, mask, _ = M._route(h @ p["router"], k)
    if case == "ties":
        # the lower index of each tied pair wins
        assert bool((mask[..., :4] >= mask[..., 4:]).all())
    if case == "unchosen":
        assert float(mask[..., 5].sum()) == 0.0
    want = _every_expert(p, h, gates)
    if case == "shared":
        want = want + L.mlp_apply(p["shared"], h)
    _close(got, want, BLOCK_TOL)


def test_grouping_keeps_each_expert_s_slots_in_token_order():
    top = torch.tensor([[2, 0], [0, 1], [2, 1]])
    order, ends = M._group_slots(top, 4)
    assert order.tolist() == [1, 2, 3, 5, 0, 4]
    assert ends.tolist() == [2, 4, 6, 6]


def test_blocked_ssm_equals_the_recurrence():
    g = torch.Generator().manual_seed(1)
    bt, s, h, p, grp, n = 2, 50, 4, 3, 2, 5
    x = torch.randn(bt, s, h, p, generator=g)
    dt = torch.rand(bt, s, h, generator=g) * 0.5
    A = -torch.rand(h, generator=g) * 4
    B = torch.randn(bt, s, grp, n, generator=g)
    C = torch.randn(bt, s, grp, n, generator=g)
    want = R.ssm_steps(x, dt, A, B, C)
    _close(R._ssm_blocks(x, dt, A, B, C, block=16), want, BLOCK_TOL)
    _close(R._ssm_blocks(x, dt, A, B, C), want, BLOCK_TOL)


@pytest.mark.parametrize("impl", ["pallas", "naive", "blocked", "folded"])
def test_nope_attention_at_a_set_scale_matches_the_reference(impl):
    cfg = SMOKE.replace(attn_impl=impl)
    bb, _, ref = _weights(cfg, seed=8)
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    p = {k: v[0] for k, v in bb["trunk"]["attention"].items()}
    got, _ = attn_branch(p, x, cfg, positions=torch.arange(64), window=None,
                         theta=None, mode="train", scale=0.3)
    rp = R._layer(ref, R.ATTN_KEYS, 0)
    want = R._attn(rp, x, dict(_ref_cfg(cfg), attention_multiplier=0.3),
                   None, 16)
    _close(got, want, BLOCK_TOL)


def test_default_scale_is_bit_identical_on_the_starcoder2_prefill():
    """``flash_attention(scale=None)`` is 1/√D: the StarCoder2 smoke
    prefill gives the same bits with the default spelled out."""
    from repro_torch.kernels.flash_attention import ops
    cfg = configs.get_smoke_config("starcoder2-3b").replace(
        attn_impl="pallas")
    model = build_model(cfg)
    bb, head = init_weights(model, 0, "cpu")
    toks = _tokens(2, 80, seed=4)
    step = make_prefill_step(model)
    want, _ = step(bb, head, toks)
    flash = ops.flash_attention
    d = cfg.resolved_head_dim
    try:
        ops.flash_attention = lambda q, k, v, window=None, scale=None: flash(
            q, k, v, window=window, scale=1.0 / math.sqrt(d))
        got, _ = step(bb, head, toks)
    finally:
        ops.flash_attention = flash
    assert torch.equal(got, want)


def test_set_scale_matches_the_reference_attention_on_the_cpu_path():
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator().manual_seed(6)
    q = torch.randn(1, 48, 4, 16, generator=g)
    k, v = torch.randn(2, 1, 48, 2, 16, generator=g)
    got = ops.flash_attention(q, k, v, scale=1 / 16)
    want = ref_lm._attention(q * (math.sqrt(16) / 16), k, v, None, None, 16)
    _close(got, want, BLOCK_TOL)


def test_granite_is_found_and_the_reference_ids_stay():
    full = configs.get_config("granite-4.0-h-small")
    assert configs.get_config("granite_4_0_h_small") == full
    assert full.family == "hybrid_moe" and full.n_layers == 40
    assert [i for i, t in enumerate(full.layer_types)
            if t == "attention"] == [5, 15, 25, 35]
    assert (full.moe.n_experts, full.moe.top_k, full.d_ff,
            full.shared_d_ff) == (72, 10, 768, 1536)
    assert "granite_4_0_h_small" not in configs.ARCH_IDS
    assert "granite-4.0-h-small" not in configs.ALIASES
    assert "granite_4_0_h_small" not in configs.all_configs()
    assert len(configs.ARCH_IDS) == 11
    with pytest.raises(ValueError, match="layer_types"):
        full.replace(n_layers=20)
