"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and the xlstm
family against ``repro.models.xlstm`` and the reference's model, on the
CPU.

Inputs come from numpy with a seed; weights are the reference's
``init_params`` (its zero gates and norms moved, so every parameter
moves the output), carried across with ``repro_torch.convert``. In
float32, outputs rtol 1e-4 (atol 1e-4 of the largest entry), caches too
(C, n, c, h in bfloat16 as the reference casts them: within one
bfloat16 step), gradients against ``jax.grad`` rtol 1e-4:

- ``_mlstm_chunked`` over 512 steps at a narrow width (two chunks of
  ``CHUNK`` = 256, the stabiliser m carried from one to the next), with
  and without an incoming state, and its gradient; a length that
  ``CHUNK`` does not divide (one whole-sequence chunk);
- ``_mlstm_decode``; ``mlstm_apply`` and ``slstm_apply`` in training,
  prefill and decode (from the reference's prefill cache), and their
  gradients;
- the caches and their axes;
- ``tests/test_models.py``'s ``xlstm`` family config (8 blocks, an sLSTM
  every 4th), on the port's own copy: train logits, prefill(S) +
  decode(1) against prefill(S + 1) below the reference's 0.02,
  causality, and the gradient under the three remat policies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JMC
from repro.common.config import XLSTMConfig as JXL
from repro.models import xlstm as JX
from repro_torch.common.config import ModelConfig, XLSTMConfig
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import xlstm as X
from tests.test_torch_ssm import (
    BASE, _np, check_family, close, close_tree, jax_init,
)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

XLSTM = ModelConfig(family="xlstm", xlstm=XLSTMConfig(slstm_every=4),
                    **{**BASE, "n_layers": 8})
JXLSTM = JMC(family="xlstm", xlstm=JXL(slstm_every=4),
             **{**BASE, "n_layers": 8})


def test_family_config_is_the_references():
    assert dataclasses.asdict(XLSTM) == dataclasses.asdict(JXLSTM)


def _mlstm_inputs(s, seed, with_state):
    r = np.random.default_rng(seed)
    b, h, d = 1, 2, 8
    q, k, v = (r.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    k = (k / np.sqrt(d)).astype(np.float32)
    log_i = r.standard_normal((b, s, h)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-r.standard_normal((b, s, h)) - 2)))
    ins = [q, k, v, log_i, log_f.astype(np.float32)]
    if with_state:
        ins += [r.standard_normal((b, h, d, d)).astype(np.float32),
                r.standard_normal((b, h, d)).astype(np.float32),
                r.standard_normal((b, h)).astype(np.float32)]
    return ins


MLSTM_CASES = {"two_chunks": (512, False), "two_chunks_state": (512, True),
               "whole_sequence_state": (40, True)}


@pytest.mark.parametrize("case", sorted(MLSTM_CASES))
def test_mlstm_chunked_and_gradient_match_jax(case):
    s, with_state = MLSTM_CASES[case]
    ins = _mlstm_inputs(s, len(case), with_state)
    r = np.random.default_rng(7)
    ct = r.standard_normal(ins[0].shape).astype(np.float32)
    cts = [r.standard_normal(sh).astype(np.float32)
           for sh in ((1, 2, 8, 8), (1, 2, 8), (1, 2))]

    def split(a):
        return a[:5], (tuple(a[5:]) if with_state else None)

    def jrun(*a):
        x, st = split(a)
        return JX._mlstm_chunked(*x, st)

    def jloss(*a):
        y, (C, n, m) = jrun(*a)
        return (jnp.sum(y * ct) + jnp.sum(C * cts[0]) + jnp.sum(n * cts[1])
                + jnp.sum(m * cts[2]))
    jins = [jnp.asarray(a) for a in ins]
    want_y, want_st = jax.jit(jrun)(*jins)
    want_g = jax.jit(jax.grad(jloss, argnums=tuple(range(len(ins)))))(*jins)

    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    x, st = split(tins)
    y, (C, n, m) = X._mlstm_chunked(*x, st)
    close(y, want_y, what="y")
    for name, g, w in zip("Cnm", (C, n, m), want_st):
        close(g, w, what=name)
    (torch.sum(y * torch.from_numpy(ct)) + torch.sum(C * torch.from_numpy(
        cts[0])) + torch.sum(n * torch.from_numpy(cts[1]))
     + torch.sum(m * torch.from_numpy(cts[2]))).backward()
    for i, (t, w) in enumerate(zip(tins, want_g)):
        close(t.grad, w, what=f"d input {i}")


def test_mlstm_decode_matches_jax():
    ins = _mlstm_inputs(1, 3, True)
    q, k, v, li, lf = (a[:, 0] for a in ins[:5])
    st = ins[5:]
    want_y, want_st = JX._mlstm_decode(*map(jnp.asarray, (q, k, v, li, lf)),
                                       tuple(map(jnp.asarray, st)))
    got_y, got_st = X._mlstm_decode(*map(torch.from_numpy, (q, k, v, li, lf)),
                                    tuple(map(torch.from_numpy, st)))
    close(got_y, want_y, what="y")
    for g, w in zip(got_st, want_st):
        close(g, w)


def _block_params(specs, seed):
    params = jax_init(specs, seed)
    r = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.1 * r.standard_normal(v.shape)).astype(
        np.float32) for k, v in params.items()}


BLOCKS = {"mlstm": (JX.mlstm_specs, JX.mlstm_apply, X.mlstm_apply),
          "slstm": (JX.slstm_specs, JX.slstm_apply, X.slstm_apply)}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_modes_match_jax(block):
    """Training (S = 20), prefill (S = 19) and one decode step from the
    reference's prefill cache: outputs and caches; decode leaves its
    input cache alone."""
    jspecs, japply, tapply = BLOCKS[block]
    params = _block_params(jspecs(JXLSTM), 1)
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = lm_params_from_numpy(params)

    def jrun(mode):
        return jax.jit(lambda p, xx, c=None: japply(p, xx, JXLSTM, mode=mode,
                                                    cache=c))
    want_t, _ = jrun("train")(jp, jnp.asarray(x))
    got_t, c_t = tapply(tp, torch.from_numpy(x), XLSTM, mode="train")
    assert c_t is None
    close(got_t, want_t, what="train")
    want_p, want_c = jrun("prefill")(jp, jnp.asarray(x[:, :19]))
    got_p, got_c = tapply(tp, torch.from_numpy(x[:, :19]), XLSTM,
                          mode="prefill")
    close(got_p, want_p, what="prefill")
    close_tree(got_c, want_c, "prefill cache")
    for k, w in _np(want_c).items():
        assert str(got_c[k].dtype).split(".")[-1] == str(w.dtype), k
    want_d, want_dc = jrun("decode")(jp, jnp.asarray(x[:, 19:]), want_c)
    c_in = lm_cache_from_numpy(_np(want_c))
    got_d, got_dc = tapply(tp, torch.from_numpy(x[:, 19:]), XLSTM,
                           mode="decode", cache=c_in)
    close(got_d, want_d, what="decode")
    close_tree(got_dc, want_dc, "decode cache")
    close_tree(c_in, want_c, "decode input cache")


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_gradient_matches_jax(block):
    jspecs, japply, tapply = BLOCKS[block]
    params = _block_params(jspecs(JXLSTM), 4)
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 16, 64)).astype(np.float32)
    ct = r.standard_normal((2, 16, 64)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(japply(p, xx, JXLSTM, mode="train")[0] * ct)
    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    (tapply(tp, tx, XLSTM, mode="train")[0]
     * torch.from_numpy(ct)).sum().backward()
    close(tx.grad, want_x, what="dx")
    for k, t in tp.items():
        close(t.grad, want_p[k], what=f"d{k}")


def test_caches_and_axes_match_jax():
    want = _np(JX.init_xlstm_cache(JXLSTM, 3))
    got = X.init_xlstm_cache(XLSTM, 3, device="cpu")
    for part in ("mlstm", "slstm"):
        for k, w in want[part].items():
            g = got[part][k]
            assert tuple(g.shape) == w.shape, (part, k)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (part, k)
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
    # materialised: every layer its own storage
    assert got["mlstm"]["C"][0, 0].data_ptr() != \
        got["mlstm"]["C"][0, 1].data_ptr()
    assert X.xlstm_cache_axes() == JX.xlstm_cache_axes()
    assert X.mlstm_cache_axes() == JX.mlstm_cache_axes()
    assert X.slstm_cache_axes() == JX.slstm_cache_axes()


def test_xlstm_family_matches_jax():
    check_family(JXLSTM, XLSTM)
