"""The port's MoE block (``models/moe.py``) and the stub frontends'
``input_specs`` against the JAX package, on the CPU.

Inputs are numpy draws from fixed seeds; the reference's parameters
(``init_params`` of ``moe_specs``) are carried across with
``convert.lm_params_from_numpy``. Float32 throughout:

- ``_route`` (gates, mask, weights) within rtol 1e-5, the mask exactly,
  and ties broken toward the lower expert index as ``jax.lax.top_k``
  does (a zeroed router: every token keeps experts 0 and 1);
- ``moe_apply`` in training (capacity dropping) and inference (dropless)
  within rtol 1e-5 (atol 1e-5 of the largest entry: the two libraries
  sum in other orders), at one group and at two groups of
  ``GROUP_SIZE``, and its gradient in the parameters and the input
  against ``jax.grad`` at the same tolerance;
- the kept token set under capacity equal to the reference's, expert by
  expert (every other expert's ``w_down`` zeroed: a token moves exactly
  when that expert kept it), at a capacity factor where the reference's
  ``int(x + 0.999)`` is not ``ceil(x)``;
- ``tests/test_moe.py``'s invariants on the port: top-k support, the aux
  loss at least 0.99 of its weight, drops at ``capacity_factor=0.1``;
- ``launch.steps.input_specs`` for the four ``INPUT_SHAPES`` and text,
  audio and vision configs: the reference's shapes and dtypes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.common.config import ModelConfig as JModelConfig
from repro.common.config import MoEConfig as JMoEConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import input_specs as jax_input_specs
from repro.models import moe as JM
from repro.models.params import init_params as jax_init_params
from repro_torch.common.config import INPUT_SHAPES, ModelConfig, MoEConfig
from repro_torch.common.tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.steps import input_specs
from repro_torch.models import moe as M
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-5


def _cfgs(e=4, k=2, cf=1.25, d=32, f=48):
    kw = dict(family="dense", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2,
              d_ff=f, vocab_size=64, compute_dtype="float32")
    return (JModelConfig(**kw, moe=JMoEConfig(n_experts=e, top_k=k,
                                              capacity_factor=cf)),
            ModelConfig(**kw, moe=MoEConfig(n_experts=e, top_k=k,
                                            capacity_factor=cf)))


def _close(got, want, what=""):
    want = np.asarray(want)
    atol = RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _params(jcfg, seed, zero_router=False):
    p = jax.tree.map(np.asarray, jax_init_params(JM.moe_specs(jcfg),
                                                 jax.random.PRNGKey(seed)))
    p["norm"] = np.random.default_rng(seed).normal(
        size=p["norm"].shape).astype(np.float32) * 0.1
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _x(b, s, d, seed):
    return np.random.default_rng(seed + 100).normal(
        size=(b, s, d)).astype(np.float32)


def _both(jcfg, cfg, p, x, train):
    # compiled once: run eagerly, every op of the expert loop compiles alone
    want_y, want_aux = jax.jit(lambda pp, xx: JM.moe_apply(
        pp, xx, jcfg, train=train))(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x))
    got_y, got_aux = M.moe_apply(lm_params_from_numpy(p), torch.from_numpy(x),
                                 cfg, train=train)
    return (got_y.numpy(), float(got_aux)), (np.asarray(want_y),
                                             float(want_aux))


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((10, 8), 2), ((2, 3, 16, 4), 2),
                                     ((5, 16), 2), ((7, 8), 1)])
def test_route_matches_jax(shape, k):
    logits = np.random.default_rng(sum(shape)).normal(
        size=shape).astype(np.float32)
    want = [np.asarray(a) for a in JM._route(jnp.asarray(logits), k)]
    got = [a.numpy() for a in M._route(torch.from_numpy(logits), k)]
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)
    # the top-k support (tests/test_moe.py::test_route_topk_support)
    assert np.all(got[1].sum(-1) == k)
    np.testing.assert_allclose(got[0].sum(-1), 1.0, rtol=1e-5)
    assert np.all(got[0][got[1] == 0] == 0)


def test_route_ties_go_to_the_lower_index():
    # whole rows of equal logits, and ties at the k-th place only
    logits = np.zeros((3, 6), np.float32)
    logits[1] = [1.0, 2.0, 2.0, 2.0, 0.0, 2.0]
    logits[2] = [3.0, 1.0, 1.0, 0.5, 1.0, 1.0]
    want = np.asarray(JM._route(jnp.asarray(logits), 2)[1])
    got = M._route(torch.from_numpy(logits), 2)[1].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 1, 0, 0, 0, 0],
                                        [0, 1, 1, 0, 0, 0],
                                        [1, 1, 0, 0, 0, 0]])


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_zeroed_router_keeps_experts_0_and_1(train):
    """A zeroed router gives every token equal weights: the reference's
    top_k keeps experts 0 and 1 for every token, and so must the port."""
    jcfg, cfg = _cfgs(e=4, k=2)
    p = _params(jcfg, 3, zero_router=True)
    x = _x(2, 16, 32, 3)
    h = torch.from_numpy(x).reshape(2, 1, 16, 32)
    mask = M._route(h @ torch.zeros(32, 4), 2)[1]
    assert torch.equal(mask, torch.tensor([1.0, 1.0, 0.0, 0.0]).expand(
        2, 1, 16, 4))
    (gy, ga), (wy, wa) = _both(jcfg, cfg, p, x, train)
    _close(gy, wy)
    np.testing.assert_allclose(ga, wa, rtol=RTOL)


# --------------------------------------------------------------------------
# the block, both modes
# --------------------------------------------------------------------------

# (experts, top_k, capacity factor, batch, seq): one group (S < 512),
# two groups of 512, drops at cf 0.1, and top-1
CASES = {
    "e4k2": (4, 2, 1.25, 2, 16),
    "e4k2_groups": (4, 2, 1.25, 1, 1024),
    "e8k2_cf0.1": (8, 2, 0.1, 2, 32),
    "e2k1_cf0.1": (2, 1, 0.1, 1, 32),
    "e16k2": (16, 2, 1.25, 1, 48),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, train):
    e, k, cf, b, s = CASES[case]
    jcfg, cfg = _cfgs(e=e, k=k, cf=cf)
    p = _params(jcfg, e + s)
    x = _x(b, s, 32, e + s)
    (gy, ga), (wy, wa) = _both(jcfg, cfg, p, x, train)
    assert gy.shape == x.shape and np.all(np.isfinite(gy))
    _close(gy, wy, case)
    np.testing.assert_allclose(ga, wa, rtol=RTOL)


@pytest.mark.parametrize("case", ["e4k2", "e8k2_cf0.1", "e4k2_groups"])
def test_moe_gradient_matches_jax(case):
    """The gradient of <y, ct> + aux in every parameter and in x, train
    mode: the router's reaches it only through the gates and the aux."""
    e, k, cf, b, s = CASES[case]
    jcfg, cfg = _cfgs(e=e, k=k, cf=cf)
    p = _params(jcfg, e + s)
    x = _x(b, s, 32, e + s)
    ct = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jloss(pp, xx):
        y, aux = JM.moe_apply(pp, xx, jcfg, train=True)
        return jnp.sum(y * ct) + aux
    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    pt = lm_params_from_numpy(p)
    for t in tree_leaves(pt):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_apply(pt, xt, cfg, train=True)
    loss = (y * torch.from_numpy(ct)).sum() + aux
    grads = torch.autograd.grad(loss, tree_leaves(pt) + [xt])
    names = ["/".join(q) for q, _ in tree_flatten_with_path(pt)] + ["x"]
    wants = [np.asarray(w) for w in jax.tree.leaves(want[0])] \
        + [np.asarray(want[1])]
    for name, g, w in zip(names, grads, wants):
        assert np.any(w != 0), name
        _close(g.numpy(), w, name)


def _kept(apply_fn, p, x, e_keep, n_exp):
    """Tokens whose output moves when only expert ``e_keep`` computes."""
    q = {kk: np.array(v) for kk, v in p.items()}
    for e in range(n_exp):
        if e != e_keep:
            q["w_down"][e] = 0.0
    y = apply_fn(q, x)
    return np.abs(y - x).sum(-1) > 0


@pytest.mark.parametrize("cf", [0.1, 0.2500625], ids=["cf0.1", "int_not_ceil"])
def test_kept_token_set_matches_jax(cf):
    """Expert by expert, the tokens it keeps under capacity are the
    reference's. At cf 0.2500625, top-1 over 2 experts and 16 tokens
    give x = 2.0005: the reference's cap is int(x + 0.999) = 2, where
    ceil would give 3."""
    e, k, s = 2, 1, 16
    jcfg, cfg = _cfgs(e=e, k=k, cf=cf)
    cap = M.capacity(k, s, e, cf)
    assert cap == max(int(k * s / e * cf + 0.999), 1)
    if cf > 0.25:
        assert cap == 2 and math.ceil(k * s / e * cf) == 3
    p = _params(jcfg, 11)
    x = _x(2, s, 32, 11)

    def jax_fn(q, xx):
        return np.asarray(JM.moe_apply(jax.tree.map(jnp.asarray, q),
                                       jnp.asarray(xx), jcfg, train=True)[0])

    def port_fn(q, xx):
        return M.moe_apply(lm_params_from_numpy(q), torch.from_numpy(xx),
                           cfg, train=True)[0].numpy()
    routed = 0
    for ex in range(e):
        want = _kept(jax_fn, p, x, ex, e)
        np.testing.assert_array_equal(_kept(port_fn, p, x, ex, e), want)
        assert want.sum(-1).max() == cap       # every queue fills to cap
        routed += int(want.sum())
    assert routed < 2 * s * k                  # and some tokens drop


@pytest.mark.parametrize("ratio,want", [((1, 1, 1, 2.0005), 2),
                                        ((1, 1, 1, 2.0011), 3),
                                        ((2, 512, 8, 1.25), 160),
                                        ((2, 32, 8, 0.1), 1),
                                        ((1, 4, 8, 0.01), 1)])
def test_capacity_is_the_references_expression(ratio, want):
    k, g, e, cf = ratio
    assert M.capacity(k, g, e, cf) == want == max(int(k * g / e * cf
                                                       + 0.999), 1)


def test_aux_loss_and_drops_invariants():
    """tests/test_moe.py's bounds on the port: the Switch aux loss is at
    least 0.99 of its weight, and at capacity factor 0.1 some tokens
    pass untouched while others are routed."""
    jcfg, cfg = _cfgs(e=4)
    p = lm_params_from_numpy(_params(jcfg, 0))
    x = torch.from_numpy(_x(2, 64, 32, 0))
    _, aux = M.moe_apply(p, x, cfg)
    assert float(aux) >= cfg.moe.aux_loss_weight * 0.99
    jcfg, cfg = _cfgs(e=2, k=1, cf=0.1)
    p = lm_params_from_numpy(_params(jcfg, 0))
    x = torch.from_numpy(_x(1, 32, 32, 1))
    y, aux = M.moe_apply(p, x, cfg)
    deltas = (y - x).abs().sum(-1)[0]
    assert int((deltas < 1e-6).sum()) > 0 and int((deltas > 1e-6).sum()) > 0
    assert float(aux) >= 0


def test_inference_is_length_invariant():
    """Dropless inference: a token's output does not depend on the other
    tokens of its group (the prefix of a longer input gives the same)."""
    jcfg, cfg = _cfgs(e=4, cf=0.1)
    p = lm_params_from_numpy(_params(jcfg, 5))
    x = torch.from_numpy(_x(1, 40, 32, 5))
    a, _ = M.moe_apply(p, x, cfg, train=False)
    b, _ = M.moe_apply(p, x[:, :17], cfg, train=False)
    torch.testing.assert_close(a[:, :17], b, rtol=1e-6, atol=1e-6)


def test_moe_specs_are_the_references():
    jcfg, cfg = _cfgs(e=8)
    want = JM.moe_specs(jcfg)
    got = M.moe_specs(cfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert (g.shape, g.axes, g.init, g.scale) == (w.shape, w.axes,
                                                      w.init, w.scale), name


# --------------------------------------------------------------------------
# the stub frontends' inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(JAX_INPUT_SHAPES))
@pytest.mark.parametrize("arch", ["starcoder2_3b", "musicgen_medium",
                                  "phi3_vision_4_2b"])
def test_input_specs_match_jax(arch, shape):
    want = jax_input_specs(jax_smoke_config(arch), JAX_INPUT_SHAPES[shape])
    got = input_specs(get_smoke_config(arch), INPUT_SHAPES[shape])
    assert INPUT_SHAPES[shape].__dict__ == JAX_INPUT_SHAPES[shape].__dict__
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].device.type == "meta", name
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert str(got[name].dtype).replace("torch.", "") == str(w.dtype), \
            name
