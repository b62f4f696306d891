"""The port's Mamba2 block (``repro_torch.models.mamba2``) and the pure
Mamba2 stack (the ``ssm`` family) against ``repro.models.mamba2`` and the
reference's model, on the CPU.

Inputs come from numpy with a seed; weights are the reference's
``init_params``, carried across with ``repro_torch.convert``. Each piece
is held against the reference in float32:

- ``_causal_conv`` with and without an incoming ``conv_state``,
  ``_segsum`` (its -inf entries included), and ``ssd_chunked`` on a chunk
  that divides S and one that does not (one whole-sequence chunk), at
  n_groups 1 and 2: outputs and final state rtol 1e-4 (atol 1e-4 of the
  largest entry: the two libraries sum in other orders), and its
  gradient in every input against ``jax.grad`` (rtol 1e-4);
- ``mamba2_apply`` in training, prefill and decode (from the reference's
  prefill cache) at n_groups 1 and 2, its caches (``ssm`` in bfloat16, as
  the reference casts it: within one bfloat16 step), and its gradient in
  every parameter and the input against ``jax.grad``;
- ``init_mamba_cache`` and the cache axes;
- ``tests/test_models.py``'s ``mamba2`` family config, on the port's own
  copy: train logits, prefill(S) + decode(1) against prefill(S + 1)
  below the reference's 0.02, causality, and the gradient of ``lm_loss``
  against ``jax.grad`` under the three remat policies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JMC
from repro.common.config import SSMConfig as JSSM
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models import mamba2 as JM
from repro_torch.common.config import ModelConfig, SSMConfig
from repro_torch.common.tree import (
    tree_flatten_with_path, tree_leaves, tree_unflatten,
)
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import mamba2 as M
from repro_torch.models.model import build_model, lm_loss
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-4
BF16_STEP = 2.0 ** -8    # one bfloat16 rounding step, relative

# tests/test_models.py's BASE and its "mamba2" family config
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, attn_block_q=16, attn_block_kv=16,
            remat_policy="none", compute_dtype="float32")
MAMBA2 = ModelConfig(family="ssm",
                     ssm=SSMConfig(d_state=16, head_dim=16, chunk_size=8),
                     **BASE)
JMAMBA2 = JMC(family="ssm", ssm=JSSM(d_state=16, head_dim=16, chunk_size=8),
              **BASE)


def close(got, want, rtol=RTOL, what=""):
    """Elementwise rtol, with an atol of rtol times the largest entry; a
    bfloat16 leaf within one bfloat16 step of the reference's."""
    if isinstance(got, torch.Tensor):
        if got.dtype == torch.bfloat16:
            rtol = max(rtol, BF16_STEP)
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def close_tree(got, want, what=""):
    g = {"/".join(map(str, p)): v for p, v in tree_flatten_with_path(got)}
    w = {"/".join(map(str, p)): v for p, v in tree_flatten_with_path(
        jax.tree.map(np.asarray, want))}
    assert g.keys() == w.keys(), what
    for k in w:
        close(g[k], w[k], what=f"{what} {k}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_init(specs, seed):
    """The reference's ``init_params(specs, PRNGKey(seed))``, compiled
    once (its eager draws compile a program per leaf shape)."""
    return jax.jit(lambda k: jax_init_params(specs, k))(
        jax.random.PRNGKey(seed))


def test_family_config_is_the_references():
    assert dataclasses.asdict(MAMBA2) == dataclasses.asdict(JMAMBA2)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    r = np.random.default_rng(1)
    xbc = r.standard_normal((2, 12, 10)).astype(np.float32)
    w = r.standard_normal((4, 10)).astype(np.float32)
    b = r.standard_normal((10,)).astype(np.float32)
    st = r.standard_normal((2, 3, 10)).astype(np.float32) if with_state \
        else None
    want, want_st = JM._causal_conv(
        jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = M._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    close(got, want, 1e-5)
    close(got_st, want_st, 1e-6)


def test_segsum_matches_jax():
    a = np.random.default_rng(2).standard_normal((2, 3, 8)).astype(
        np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(a)))
    got = M._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _ssd_inputs(s, g, seed):
    r = np.random.default_rng(seed)
    b, h, p, n = 2, 4, 8, 6
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(r.standard_normal((h,)) * 0.5).astype(np.float32)
    B = r.standard_normal((b, s, g, n)).astype(np.float32)
    C = r.standard_normal((b, s, g, n)).astype(np.float32)
    cty = r.standard_normal((b, s, h, p)).astype(np.float32)
    cts = r.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, B, C), (cty, cts)


SSD_CASES = {"chunk_divides_g1": (32, 1), "chunk_divides_g2": (32, 2),
             "whole_sequence_g1": (30, 1), "whole_sequence_g2": (30, 2)}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunked_and_gradient_match_jax(case):
    s, g = SSD_CASES[case]
    ins, (cty, cts) = _ssd_inputs(s, g, len(case))

    def jloss(*a):
        y, st = JM.ssd_chunked(*a, chunk=8)
        return jnp.sum(y * cty) + jnp.sum(st * cts)
    jins = [jnp.asarray(a) for a in ins]
    want_y, want_st = jax.jit(lambda *a: JM.ssd_chunked(*a, chunk=8))(*jins)
    want_g = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*jins)

    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    y, st = M.ssd_chunked(*tins, chunk=8)
    close(y, want_y, what="y")
    close(st, want_st, what="state")
    (torch.sum(y * torch.from_numpy(cty))
     + torch.sum(st * torch.from_numpy(cts))).backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C"), tins, want_g):
        close(t.grad, w, what=f"d{name}")


def _block(groups, seed=0):
    cfg = MAMBA2.replace(ssm=dataclasses.replace(MAMBA2.ssm,
                                                 n_groups=groups))
    jcfg = JMAMBA2.replace(ssm=dataclasses.replace(JMAMBA2.ssm,
                                                   n_groups=groups))
    params = jax_init(JM.mamba2_specs(jcfg), seed)
    # non-zero gates and norms, so every parameter moves the output
    r = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.1 * r.standard_normal(v.shape)).astype(
        np.float32) for k, v in params.items()}
    return cfg, jcfg, params


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_apply_modes_match_jax(groups):
    """Training (S = 25: one whole-sequence chunk), prefill (S = 24:
    three chunks) and a decode step from the reference's prefill cache:
    outputs and caches."""
    cfg, jcfg, params = _block(groups)
    x = np.random.default_rng(3).standard_normal((2, 25, 64)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = lm_params_from_numpy(params)

    def jax_apply(mode):
        return jax.jit(lambda p, xx, c=None: JM.mamba2_apply(
            p, xx, jcfg, mode=mode, cache=c))
    want_t, _ = jax_apply("train")(jp, jnp.asarray(x))
    got_t, c_t = M.mamba2_apply(tp, torch.from_numpy(x), cfg, mode="train")
    assert c_t is None
    close(got_t, want_t, what="train")
    want_p, want_c = jax_apply("prefill")(jp, jnp.asarray(x[:, :24]))
    got_p, got_c = M.mamba2_apply(tp, torch.from_numpy(x[:, :24]), cfg,
                                  mode="prefill")
    close(got_p, want_p, what="prefill")
    assert got_c["ssm"].dtype == torch.bfloat16
    assert got_c["conv"].dtype == torch.float32
    close_tree(got_c, want_c, "prefill cache")
    want_d, want_dc = jax_apply("decode")(jp, jnp.asarray(x[:, 24:]),
                                          want_c)
    c_in = lm_cache_from_numpy(_np(want_c))
    got_d, got_dc = M.mamba2_apply(tp, torch.from_numpy(x[:, 24:]), cfg,
                                   mode="decode", cache=c_in)
    close(got_d, want_d, what="decode")
    close_tree(got_dc, want_dc, "decode cache")
    # decode returns new states and leaves its input cache alone
    close_tree(c_in, want_c, "decode input cache")


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_apply_gradient_matches_jax(groups):
    cfg, jcfg, params = _block(groups, seed=4)
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 16, 64)).astype(np.float32)
    ct = r.standard_normal((2, 16, 64)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JM.mamba2_apply(p, xx, jcfg, mode="train")[0] * ct)
    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    (M.mamba2_apply(tp, tx, cfg, mode="train")[0]
     * torch.from_numpy(ct)).sum().backward()
    close(tx.grad, want_x, what="dx")
    for k, t in tp.items():
        close(t.grad, want_p[k], what=f"d{k}")


def test_init_mamba_cache_and_axes_match_jax():
    want = JM.init_mamba_cache(JMAMBA2, 3)
    got = M.init_mamba_cache(MAMBA2, 3, device="cpu", lead=(2,))
    for k, w in want.items():
        assert got[k].shape == (2,) + w.shape
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
        assert not got[k].any()
    assert got["ssm"][0].data_ptr() != got["ssm"][1].data_ptr()
    assert M.mamba_cache_axes() == JM.mamba_cache_axes()


# --------------------------------------------------------------------------
# the ssm family (tests/test_models.py's "mamba2")
# --------------------------------------------------------------------------

def family_setup(jcfg, cfg):
    """The reference's model, weights and (2, 32) tokens as
    ``tests/test_models.py`` draws them, and the port's model and weight
    copies."""
    m = jax_build_model(jcfg)
    params = jax_init(m.backbone_specs(), 0)
    head = jax_init(m.head_specs(), 1)
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 32), 0,
                              jcfg.vocab_size)
    extra = jax.random.randint(jax.random.PRNGKey(3), (2, 1), 0,
                               jcfg.vocab_size)
    return (m, params, head, toks, extra, build_model(cfg),
            lm_params_from_numpy(_np(params)), lm_params_from_numpy(
                _np(head)))


def check_family(jcfg, cfg):
    """Train logits, the decode bound, causality and the gradient under
    the three remat policies, for one family config."""
    m, params, head, toks, extra, pm, pb, ph = family_setup(jcfg, cfg)
    tt = torch.tensor(np.asarray(toks)).long()
    te = torch.tensor(np.asarray(extra)).long()
    def jloss(p):
        lg, a, _ = m.forward_logits(p, head, toks, mode="train")
        return jax_lm_loss(lg, toks) + a, lg
    want_g, want = jax.jit(jax.grad(jloss, has_aux=True))(params)
    # train logits
    got, aux, cache = pm.forward_logits(pb, ph, tt, mode="train")
    assert cache is None and float(aux) == 0.0
    close(got, want, what="train logits")
    # prefill(32) + decode(1) against prefill(33): the reference's bound
    with torch.no_grad():
        full, _, _ = pm.forward_logits(pb, ph, torch.cat([tt, te], 1),
                                       positions=torch.arange(33),
                                       mode="prefill")
        _, _, c = pm.forward_logits(pb, ph, tt, positions=torch.arange(32),
                                    mode="prefill")
        dec, _, _ = pm.forward_logits(pb, ph, te,
                                      positions=torch.full((2,), 32,
                                                           dtype=torch.int32),
                                      mode="decode", cache=c)
    assert float((full[:, -1] - dec[:, 0]).abs().max()) < 0.02
    # causality
    mut = tt.clone()
    mut[:, -1] = (mut[:, -1] + 1) % cfg.vocab_size
    with torch.no_grad():
        b_, _, _ = pm.forward_logits(pb, ph, mut, mode="train")
    np.testing.assert_array_equal(got[:, :-1].detach().numpy(),
                                  b_[:, :-1].numpy())
    assert not np.array_equal(got[:, -1].detach().numpy(), b_[:, -1].numpy())
    # the gradient of lm_loss against jax.grad, under each remat policy
    grads = {}
    for policy in ("none", "dots", "nothing_saveable"):
        pm_p = build_model(cfg.replace(remat_policy=policy))
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(pb)]
        bb = tree_unflatten(pb, leaves)
        lg, a, _ = pm_p.forward_logits(bb, ph, tt, mode="train")
        g = torch.autograd.grad(lm_loss(lg, tt) + a, leaves)
        grads[policy] = g
        for (path, _), gi, wi in zip(tree_flatten_with_path(pb), g,
                                     jax.tree.leaves(want_g)):
            close(gi, wi, what=f"{policy} d{'/'.join(path)}")
    for policy in ("dots", "nothing_saveable"):
        for a_, b_ in zip(grads[policy], grads["none"]):
            torch.testing.assert_close(a_, b_, rtol=1e-6, atol=1e-7)


def test_ssm_family_matches_jax():
    check_family(JMAMBA2, MAMBA2)


def test_ssm_family_caches_and_axes():
    jm = jax_build_model(JMAMBA2)
    pm = build_model(MAMBA2)
    assert pm.cache_axes() == jm.cache_axes()
    want = jm.init_cache(2, 9, jnp.float32)
    got = pm.init_cache(2, 9, torch.float32, device="cpu")
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape
    assert got["ssm"][0].data_ptr() != got["ssm"][1].data_ptr()
