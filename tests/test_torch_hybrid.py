"""The port's Zamba2-style hybrid (``repro_torch.models.hybrid``), the
parameter hook's call sequence and axes registry of every family, the
caches' axes, and the list nodes of ``common.tree``, against the
reference on the CPU.

- ``tests/test_models.py``'s ``zamba2-hybrid`` family config (5 Mamba2
  layers, the shared block after every 2nd: 2 applications, window 16),
  on the port's own copy: train logits rtol 1e-4, prefill(S) + decode(1)
  against prefill(S + 1) below the reference's 0.02, causality, and the
  gradient of ``lm_loss`` against ``jax.grad`` (rtol 1e-4) under the three
  remat policies: the shared block's leaves receive the sum of both
  applications' cotangents;
- the hook's (klass, *tags) call sequence, recorded with an identity
  hook and pinned to the reference's order (its tags are tracers under
  ``lax.scan``: ``tests/test_torch_dist_hybrid.py``'s per-leaf step holds
  the keys they fold against the reference's): zamba2's smoke config
  ("embed", then "shared_attn" and "shared_mlp" once each, then
  ("mamba", i) with the global layer index), xlstm's (("mlstm", si, i),
  ("slstm", si)) and the ``ssm`` stack's (("layers", i)); the shared
  block's hooked tensors feed every application;
- ``build_axes_registry`` and ``Model.cache_axes`` equal to the
  reference's for every LM smoke config and every family config;
- ``init_hybrid_cache``: the reference's shapes and dtypes, every
  layer's and application's state in its own storage;
- ``common.tree``: a list is a node, its elements in index order as
  ``jax.tree`` flattens them; no parameter tree holds a list, so the leaf
  order that keys the channel streams is unchanged for every config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import HybridConfig as JHY
from repro.common.config import ModelConfig as JMC
from repro.common.config import SSMConfig as JSSM
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hota import build_axes_registry as jax_registry
from repro.models import build_model as jax_build_model
from repro_torch import configs, rng
from repro_torch.common.config import HybridConfig, ModelConfig, SSMConfig
from repro_torch.common.tree import (
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.hota import build_axes_registry
from repro_torch.models.hybrid import init_hybrid_cache
from repro_torch.models.model import build_model
from repro_torch.models.params import init_params
from tests.test_torch_ssm import (
    BASE, JMAMBA2, MAMBA2, _np, check_family, jax_init,
)
from tests.test_torch_xlstm import JXLSTM, XLSTM
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

HYBRID = ModelConfig(
    family="hybrid", ssm=SSMConfig(d_state=16, head_dim=16, chunk_size=8),
    hybrid=HybridConfig(attn_every=2, shared_attn_n_heads=4,
                        shared_attn_n_kv=2),
    sliding_window=16, **{**BASE, "n_layers": 5})
JHYBRID = JMC(
    family="hybrid", ssm=JSSM(d_state=16, head_dim=16, chunk_size=8),
    hybrid=JHY(attn_every=2, shared_attn_n_heads=4, shared_attn_n_kv=2),
    sliding_window=16, **{**BASE, "n_layers": 5})
# (name, port config, reference config) of every LM config
LM_ARCHS = [a for a in configs.ARCH_IDS if a != "paper_mlp"]
FAMILIES = [("zamba2-hybrid", HYBRID, JHYBRID), ("xlstm", XLSTM, JXLSTM),
            ("mamba2", MAMBA2, JMAMBA2)]
ALL = [(a, configs.get_smoke_config(a), jax_smoke_config(a))
       for a in LM_ARCHS] + FAMILIES


def test_family_config_is_the_references():
    assert dataclasses.asdict(HYBRID) == dataclasses.asdict(JHYBRID)


def test_hybrid_family_matches_jax():
    check_family(JHYBRID, HYBRID)


def _hook_sequence(cfg):
    """The (klass, *tags) calls of an identity hook in one training pass."""
    seq = []

    def hook(lp, klass, *tags):
        seq.append((klass,) + tuple(int(t) for t in tags))
        return lp
    m = build_model(cfg)
    m.trunk_apply(init_params(m.trunk_specs(), rng.PRNGKey(0)),
                  torch.zeros((1, 4), dtype=torch.long), mode="train",
                  param_hook=hook)
    return seq


@pytest.mark.parametrize("name", ["zamba2_1_2b", "xlstm_1_3b", "mamba2"])
def test_hook_sequence_is_the_references(name):
    """The reference's order: ``hybrid_trunk_apply`` hooks the embedding,
    then the shared block once (before the first segment), then each
    Mamba2 layer with its global index; ``xlstm_trunk_apply`` the
    mLSTMs of super-block si as ("mlstm", si, i), then ("slstm", si);
    the ``ssm`` stack's ``_scan_stack`` each layer as ("layers", i)."""
    cfg = MAMBA2 if name == "mamba2" else configs.get_smoke_config(name)
    got = _hook_sequence(cfg)
    if cfg.family == "hybrid":
        want = [("embed",), ("shared_attn",), ("shared_mlp",)] + [
            ("mamba", i) for i in range(cfg.n_layers)]
    elif cfg.family == "xlstm":
        k = cfg.xlstm.slstm_every
        want = [("embed",)] + [
            tag for si in range(cfg.n_layers // k)
            for tag in [("mlstm", si, i) for i in range(k - 1)]
            + [("slstm", si)]]
    else:
        want = [("embed",)] + [("layers", i) for i in range(cfg.n_layers)]
    assert got == want


def test_shared_block_is_hooked_once_for_every_application():
    """The hook's copy of the shared block feeds both applications: the
    gradient reaching the hooked tensors is the sum over the use sites,
    and the model run without the hook gives the same gradient."""
    m = build_model(HYBRID)
    jm = jax_build_model(JHYBRID)
    params = lm_params_from_numpy(_np(jax_init(jm.trunk_specs(), 0)))
    tokens = torch.randint(0, HYBRID.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    seen = {}

    def hook(lp, klass, *tags):
        if klass in ("shared_attn", "shared_mlp"):
            lp = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          lp)
            assert klass not in seen
            seen[klass] = lp
        return lp
    h, _, _ = m.trunk_apply(params, tokens, mode="train", param_hook=hook)
    hooked = tree_leaves(seen["shared_attn"]) + tree_leaves(
        seen["shared_mlp"])
    g_hook = torch.autograd.grad(h.square().sum(), hooked)
    plain = tree_map(lambda t: t.clone().requires_grad_(True), params)
    h2, _, _ = m.trunk_apply(plain, tokens, mode="train")
    g_plain = torch.autograd.grad(
        h2.square().sum(), tree_leaves(plain["shared_attn"])
        + tree_leaves(plain["shared_mlp"]))
    assert torch.equal(h, h2)
    for a, b in zip(g_hook, g_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name,cfg,jcfg", ALL, ids=[a[0] for a in ALL])
def test_axes_registry_and_cache_axes_are_the_references(name, cfg, jcfg):
    m, jm = build_model(cfg), jax_build_model(jcfg)
    assert build_axes_registry(m) == jax_registry(jm)
    assert m.cache_axes() == jm.cache_axes()


def test_init_hybrid_cache_matches_jax():
    jm = jax_build_model(JHYBRID)
    want = _np(jm.init_cache(2, 40, jnp.float32))
    got = init_hybrid_cache(HYBRID, 2, 40, torch.float32, "cpu")
    flat_w = dict(("/".join(map(str, p)), v) for p, v in
                  tree_flatten_with_path(want))
    flat_g = dict(("/".join(map(str, p)), v) for p, v in
                  tree_flatten_with_path(got))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert str(flat_g[k].dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(flat_g[k].numpy(), w)
    assert len(got["attn"]) == 2
    assert got["attn"][0]["k"].data_ptr() != got["attn"][1]["k"].data_ptr()
    assert got["mamba"]["ssm"][0].data_ptr() != \
        got["mamba"]["ssm"][1].data_ptr()


def test_tree_lists_are_nodes_in_index_order():
    tree = {"b": [np.float32(1), {"y": np.float32(2), "x": np.float32(3)}],
            "a": np.float32(4), "c": [[np.float32(5)], np.float32(6)]}
    want_leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = tree_flatten_with_path(tree)
    assert [float(v) for _, v in got] == [float(v) for _, v in want_leaves]
    assert [p for p, _ in got] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        for p, _ in want_leaves]
    doubled = tree_map(lambda v: 2 * v, tree)
    assert isinstance(doubled["b"], list) and isinstance(doubled["c"][0],
                                                         list)
    assert [float(v) for v in tree_leaves(doubled)] == [
        2 * float(v) for v in jax.tree.leaves(tree)]
    back = tree_unflatten(tree, list(range(6)))
    assert back == {"a": 0, "b": [1, {"x": 2, "y": 3}], "c": [[4], 5]}
    # tuples (shape stand-ins of layout templates) stay leaves
    assert tree_leaves({"s": (3, 4)}) == [(3, 4)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_parameter_trees_hold_no_list(arch):
    """The leaf order that keys every channel stream is the dicts' alone:
    no parameter tree of any config holds a list, and the port's leaf
    paths are the reference's flatten order."""
    m, jm = build_model(configs.get_config(arch)), jax_build_model(
        jax_config(arch))
    specs = {"final": m.final_specs(), "trunk": m.trunk_specs(),
             "head": m.head_specs(8 if arch == "paper_mlp" else None)}

    def no_list(node):
        assert not isinstance(node, list)
        if isinstance(node, dict):
            for v in node.values():
                no_list(v)
    no_list(specs)
    jspecs = {"final": jm.final_specs(), "trunk": jm.trunk_specs(),
              "head": jm.head_specs(8 if arch == "paper_mlp" else None)}
    want = [tuple(k.key for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: hasattr(x, "shape"))[0]]
    assert [p for p, _ in tree_flatten_with_path(specs)] == want
