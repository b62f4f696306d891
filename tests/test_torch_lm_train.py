"""The port's LM training pieces against the JAX package, on the CPU.

- ``data.lm.synthetic_lm_batches``: the reference's batches, array for
  array (numpy int32 on both sides);
- the training attention (``blocked``, ``folded`` and the ``attention``
  dispatch with its fallbacks), forward and gradient under ``jax.grad``,
  float32 within rtol 1e-5 (atol 1e-5 of the largest entry: the two
  libraries sum in other orders): windows None and 8, shapes on both
  sides of the folded fallback, and a window that masks whole key
  blocks (finite gradients on both sides);
- ``forward_logits(mode="train")``, the summed aux loss, ``lm_loss +
  aux`` and the gradient of the whole backbone and head for the eight
  dense-family smoke configs (the MoE pair drops by capacity in
  training; mixtral also at capacity factor 0.1, so tokens drop) and the
  zamba2 and xlstm ones (the shared block's gradient summed over its
  applications; the sLSTM's recurrence through time), with the
  reference's weights carried across (``convert.lm_params_from_numpy``):
  rtol 1e-4 (atol 1e-4 of a leaf's largest entry); the three remat
  policies give the same gradient;
- ``chunked_lm_loss`` on both branches (one piece, and the per-chunk
  recompute at S = 2·``LOSS_CHUNK``), value and gradient;
- ``lm_loss`` and ``cls_loss``; ``common.tree``'s arithmetic helpers;
  ``LM_100M`` against the reference example's model.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import hota_step as jax_hota_step
from repro.data.lm import synthetic_lm_batches as jax_batches
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.common.tree import tree_flatten_with_path, tree_leaves
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.hota_step import LOSS_CHUNK, chunked_lm_loss
from repro_torch.data.lm import synthetic_lm_batches
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, cls_loss, lm_loss
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCHS = ["starcoder2_3b", "stablelm_3b", "qwen2_5_14b", "gemma3_12b",
         "mixtral_8x22b", "phi3_5_moe_42b", "musicgen_medium",
         "phi3_vision_4_2b", "zamba2_1_2b", "xlstm_1_3b"]
# the smoke config's overrides of each case: mixtral at capacity factor
# 0.1 drops tokens in every group
TRAIN_CASES = {a: {} for a in ARCHS}
TRAIN_CASES["mixtral_8x22b_cf0.1"] = {"capacity_factor": 0.1}
B, S = 2, 64            # S = 64 crosses the smoke windows of 32


def _close(got, want, rtol, what=""):
    """Elementwise rtol, with an atol of rtol times the largest entry."""
    want = np.asarray(want)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("vocab,batch,seq,seed,s", [
    (512, 4, 64, 0, 1.1), (32_000, 3, 17, 5, 1.35), (100, 2, 8, 2, 1.05)])
def test_synthetic_lm_batches_match_reference(vocab, batch, seq, seed, s):
    got = synthetic_lm_batches(vocab, batch, seq, seed=seed, zipf_s=s)
    want = jax_batches(vocab, batch, seq, seed=seed, zipf_s=s)
    for _ in range(3):
        (gt, gl), (wt, wl) = next(got), next(want)
        assert gt.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


# (impl, B, S, H, KV, D, window, block_q, block_kv)
ATTN_CASES = {
    "blocked": ("blocked", 2, 64, 4, 2, 16, None, 16, 16),
    "blocked_w8": ("blocked", 2, 64, 4, 2, 16, 8, 16, 16),
    # window 8 < block 16: a band of 32 keys, whose first key block the
    # window masks whole for the band's last query block
    "blocked_band_masks_blocks": ("blocked", 1, 96, 4, 4, 8, 8, 16, 16),
    "blocked_ragged_naive": ("blocked", 2, 50, 4, 2, 16, 8, 16, 16),
    "folded": ("folded", 2, 64, 4, 2, 16, None, 16, 16),
    "folded_kv8": ("folded", 2, 64, 6, 2, 16, None, 16, 8),
    "folded_w8_falls_back": ("folded", 2, 64, 4, 2, 16, 8, 16, 16),
    "folded_odd_falls_back": ("folded", 2, 48, 4, 2, 16, None, 16, 16),
    "folded_ragged_falls_back": ("folded", 1, 40, 2, 1, 8, None, 16, 16),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_training_attention_matches_jax(case):
    impl, b, s, h, kv, d, w, bq, bkv = ATTN_CASES[case]
    r = np.random.default_rng(len(case))
    q, k, v, ct = (r.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))
    pos = np.arange(s)
    kw = dict(impl=impl, window=w, block_q=bq, block_kv=bkv)

    def jattn(q_, k_, v_):
        return JL.attention(q_, k_, v_, pos_q=pos, pos_kv=pos, **kw)

    def jloss(q_, k_, v_):
        return jnp.sum(jattn(q_, k_, v_) * ct)
    # compiled once: run eagerly, every op of the block loops compiles alone
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(jax.jit(jattn)(jq, jk, jv))
    want_g = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = L.attention(tq, tk, tv, pos_q=torch.arange(s),
                      pos_kv=torch.arange(s), **kw)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5, "forward")
    for name, t, g in zip("qkv", (tq, tk, tv), want_g):
        assert np.isfinite(np.asarray(g)).all()
        assert torch.isfinite(t.grad).all()
        _close(t.grad.numpy(), g, 1e-5, f"d{name}")


def test_folded_needs_an_even_block_count():
    q = torch.zeros((1, 48, 2, 8))
    pos = torch.arange(48)
    with pytest.raises(ValueError, match="even block count"):
        L.blocked_attention_folded(q, q[:, :, :1], q[:, :, :1], pos_q=pos,
                                   pos_kv=pos, block=16)


def _tokens(cfg, seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


def _smoke(get, case):
    """The smoke config of ``case``: an arch, or an arch with MoE
    overrides (``TRAIN_CASES``)."""
    arch = case.split("_cf")[0]
    cfg = get(arch)
    over = TRAIN_CASES[case]
    if over:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **over))
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_train(arch):
    """The reference's weights, batch, train-mode logits, aux, loss and
    its gradient in the backbone and head (numpy; computed once per arch
    for the module, and read only)."""
    cfg = _smoke(jax_smoke_config, arch)
    m = jax_build_model(cfg)
    # compiled once: the eager draws and gradient compile a program per op
    backbone = jax.jit(lambda k: jax_init_params(m.backbone_specs(), k))(
        jax.random.PRNGKey(0))
    head = jax.jit(lambda k: jax_init_params(m.head_specs(), k))(
        jax.random.PRNGKey(1))
    tokens, labels = _tokens(cfg, len(arch))

    def loss(bb, hd):
        logits, aux, _ = m.forward_logits(bb, hd, jnp.asarray(tokens),
                                          mode="train")
        return (jax_model.lm_loss(logits, jnp.asarray(labels)) + aux,
                (logits, aux))
    (val, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(backbone, head)
    np_ = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return {"backbone": np_(backbone), "head": np_(head), "tokens": tokens,
            "labels": labels, "logits": np.asarray(logits),
            "aux": float(aux), "loss": float(val), "grads": np_(grads)}


def _port_train(ref, cfg):
    model = build_model(cfg)
    bb = lm_params_from_numpy(ref["backbone"])
    hd = lm_params_from_numpy(ref["head"])
    leaves = tree_leaves(bb) + tree_leaves(hd)
    for t in leaves:
        t.requires_grad_(True)
    logits, aux, cache = model.forward_logits(
        bb, hd, torch.from_numpy(ref["tokens"]).long(), mode="train")
    assert cache is None
    if cfg.moe is None:
        assert float(aux) == 0.0
    else:
        np.testing.assert_allclose(float(aux.detach()), ref["aux"],
                                   rtol=1e-4)
    loss = lm_loss(logits, torch.from_numpy(ref["labels"])) + aux
    grads = torch.autograd.grad(loss, leaves)
    names = ["/".join(("bb",) + p) for p, _ in tree_flatten_with_path(bb)] \
        + ["/".join(("hd",) + p) for p, _ in tree_flatten_with_path(hd)]
    return logits.detach(), float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("arch", sorted(TRAIN_CASES))
def test_train_logits_loss_and_gradient_match_jax(arch):
    ref = _jax_train(arch)
    cfg = _smoke(configs.get_smoke_config, arch)
    logits, loss, grads = _port_train(ref, cfg)
    _close(logits.numpy(), ref["logits"], 1e-4, "logits")
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-4)
    want = {"/".join(("bb",) + p): v for p, v in tree_flatten_with_path(
        ref["grads"][0])}
    want.update({"/".join(("hd",) + p): v for p, v in tree_flatten_with_path(
        ref["grads"][1])})
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        _close(g.numpy(), want[name], 1e-4, name)
    # the remat policies recompute, they do not change the gradient
    for policy in ("dots", "nothing_saveable"):
        _, loss_p, grads_p = _port_train(ref, cfg.replace(
            remat_policy=policy))
        assert loss_p == loss
        for name, g in grads_p.items():
            torch.testing.assert_close(g, grads[name], rtol=1e-6, atol=1e-7,
                                       msg=f"{policy} {name}")


def test_unknown_remat_policy_is_refused():
    cfg = configs.get_smoke_config("stablelm_3b").replace(remat_policy="all")
    ref = _jax_train("stablelm_3b")
    with pytest.raises(ValueError, match="remat_policy"):
        _port_train(ref, cfg)


@pytest.mark.parametrize("s", [64, 2 * LOSS_CHUNK], ids=["whole", "chunked"])
def test_chunked_lm_loss_matches_jax(s):
    r = np.random.default_rng(s)
    d, v = 16, 40
    feats = r.standard_normal((2, s, d)).astype(np.float32)
    w = (r.standard_normal((d, v)) / 4).astype(np.float32)
    labels = r.integers(0, v, (2, s)).astype(np.int32)
    head_apply = jax_build_model(jax_smoke_config("stablelm_3b")).head_apply

    def jloss(hd, f):
        return jax_hota_step.chunked_lm_loss(hd, head_apply, f,
                                             jnp.asarray(labels))
    want, (g_hd, g_f) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {"w": jnp.asarray(w)}, jnp.asarray(feats))
    model = build_model(configs.get_smoke_config("stablelm_3b"))
    hd = {"w": torch.tensor(w, requires_grad=True)}
    f = torch.tensor(feats, requires_grad=True)
    got = chunked_lm_loss(hd, model.head_apply, f, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close(hd["w"].grad.numpy(), g_hd["w"], 1e-5, "head")
    _close(f.grad.numpy(), g_f, 1e-5, "feats")


def test_lm_and_cls_loss_match_jax():
    r = np.random.default_rng(9)
    logits = r.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = r.integers(0, 11, (3, 7)).astype(np.int32)
    for port, ref in ((lm_loss, jax_model.lm_loss),
                      (cls_loss, jax_model.cls_loss)):
        np.testing.assert_allclose(
            float(port(torch.from_numpy(logits), torch.from_numpy(labels))),
            float(ref(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_lm_100m_is_the_examples_model():
    """``experiments.train_lm_federated.LM_100M`` is the reference
    example's model (its source's ModelConfig literal), and its sizes are
    the ones the chip run reports: 94,224,000 shared floats in 11 leaves
    and a 20,480,000-float head."""
    import ast
    import pathlib

    from repro.common.config import ModelConfig as JMC
    from repro_torch.experiments.train_lm_federated import LM_100M
    from repro_torch.models.params import param_count
    src = pathlib.Path(__file__).parents[1] / "examples" / \
        "train_lm_federated.py"
    call = next(n for n in ast.walk(ast.parse(src.read_text()))
                if isinstance(n, ast.Call) and getattr(n.func, "id", "")
                == "ModelConfig")
    want = JMC(**{k.arg: ast.literal_eval(k.value) for k in call.keywords})
    assert want.__dict__ == LM_100M.__dict__
    model = build_model(LM_100M)
    omega = {"final": model.final_specs(), "trunk": model.trunk_specs()}
    assert param_count(omega) == 94_224_000
    assert len(tree_leaves(omega)) == 11
    assert param_count(model.head_specs()) == 20_480_000


def test_tree_arithmetic_matches_reference():
    """``common.tree``'s arithmetic helpers against ``repro.common.tree``
    on one nested tree (a float and an int leaf)."""
    from repro.common import tree as jt
    from repro_torch.common import tree as tt
    r = np.random.default_rng(3)
    a = {"w": r.standard_normal((3, 4)).astype(np.float32),
         "n": {"k": np.arange(5, dtype=np.int32)}}
    b = {"w": r.standard_normal((3, 4)).astype(np.float32),
         "n": {"k": np.arange(5, 10, dtype=np.int32)}}
    ta, tb = (tt.tree_map(torch.from_numpy, x) for x in (a, b))
    ja, jb = (jax.tree.map(jnp.asarray, x) for x in (a, b))
    assert tt.tree_size(ta) == jt.tree_size(ja) == 17
    assert tt.tree_bytes(ta) == jt.tree_bytes(ja)
    for got, want in (
            (tt.tree_add(ta, tb), jt.tree_add(ja, jb)),
            (tt.tree_scale(ta, 3), jt.tree_scale(ja, 3)),
            (tt.tree_axpy(2, ta, tb), jt.tree_axpy(2, ja, jb)),
            (tt.tree_zeros_like(ta), jt.tree_zeros_like(ja)),
            (tt.tree_cast(ta, torch.bfloat16),
             jt.tree_cast(ja, jnp.bfloat16))):
        g, w = tree_leaves(got), jax.tree.leaves(want)
        for x, y in zip(g, w):
            assert str(x.dtype).split(".")[-1] == str(y.dtype)
            np.testing.assert_array_equal(x.float().numpy(),
                                          np.asarray(y, np.float32))
