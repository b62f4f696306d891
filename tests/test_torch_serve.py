"""The port's LM serving path against the JAX package's, on the smoke
configs of every LM: the dense family's text, MoE layer (mixtral,
phi-3.5-moe: dropless inference) and audio and vision stub frontends
(musicgen's token ids; phi-3-vision also from float embeddings), the
Zamba2 hybrid and xLSTM.

Both sides run ``attn_impl="pallas"``: JAX's flash attention kernel in
interpret mode (as its suite runs it on the CPU), the port's K8 through
its plain version. The reference's ``init_params`` weights are carried
across with ``repro_torch.convert``. Prefill logits, every cache leaf and
each of 4 decode steps agree to rtol 1e-4 (float32 compute; the two
libraries sum in other orders); greedy tokens agree exactly. The state
families' caches hold bfloat16 leaves (the Mamba2 and xLSTM states, cast
so by the reference): those agree within one bfloat16 step, each decode
step starts from the reference's cache of the step before
(``convert.lm_cache_from_numpy``; a bfloat16 rounding that went the
other way would otherwise move the next step's logits by more than
float32's tolerance), and prefill(S) + decode(1) holds the reference's
own bound against prefill(S + 1) (``tests/test_models.py``: 0.02).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import (
    make_decode_step as jax_decode_step, make_prefill_step as jax_prefill_step,
)
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch import configs
from repro_torch.common.tree import tree_flatten_with_path
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels.flash_attention import ops as k8
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import build_model
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCHS = ["starcoder2_3b", "stablelm_3b", "qwen2_5_14b", "gemma3_12b",
         "mixtral_8x22b", "phi3_5_moe_42b", "musicgen_medium",
         "phi3_vision_4_2b", "zamba2_1_2b", "xlstm_1_3b"]
# the families whose caches hold a state rounded to bfloat16
STATE_ARCHS = ("zamba2_1_2b", "xlstm_1_3b")
B, S, STEPS = 2, 40, 4          # S=40 crosses the smoke windows of 32
CACHE_LEN = S + STEPS + 1
RTOL, ATOL = 1e-4, 1e-5
BF16_STEP = 2.0 ** -8           # one bfloat16 rounding step, relative
DECODE_BOUND = 0.02             # tests/test_models.py's, for the state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's weights, prompt, prefill and 4 greedy decode steps
    (numpy), with the kernel attention."""
    cfg = jax_smoke_config(arch).replace(attn_impl="pallas")
    m = jax_build_model(cfg)
    # compiled once: the eager draws compile a program per leaf shape
    backbone = jax.jit(lambda k: jax_init_params(m.backbone_specs(), k))(
        jax.random.PRNGKey(0))
    head = jax.jit(lambda k: jax_init_params(m.head_specs(), k))(
        jax.random.PRNGKey(1))
    r = np.random.default_rng(len(arch))
    tokens = r.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    prefill_full = jax.jit(lambda bb, hd, t: m.forward_logits(
        bb, hd, t, positions=jnp.arange(t.shape[1]), mode="prefill",
        cache_len=CACHE_LEN))
    logits, _, cache = prefill_full(backbone, head, jnp.asarray(tokens))
    last, cache_step = jax.jit(jax_prefill_step(m, cache_len=CACHE_LEN))(
        backbone, head, jnp.asarray(tokens))
    decode = jax.jit(jax_decode_step(m))
    nxt = jnp.argmax(last, axis=-1).astype(jnp.int32)
    toks, steps = [np.asarray(nxt)], []
    pos = jnp.full((B,), S, jnp.int32)
    c = cache_step
    for _ in range(STEPS):
        nxt, lg, c = decode(backbone, head, c, nxt[:, None], pos)
        steps.append((np.asarray(lg), _np(c)))
        toks.append(np.asarray(nxt))
        pos = pos + 1
    return {"backbone": _np(backbone), "head": _np(head),
            "tokens": tokens, "logits": np.asarray(logits),
            "cache": _np(cache), "last": np.asarray(last),
            "steps": steps, "greedy": np.stack(toks, axis=1)}


def _port(arch):
    ref = reference(arch)
    cfg = configs.get_smoke_config(arch).replace(attn_impl="pallas")
    model = build_model(cfg)
    return (ref, model, lm_params_from_numpy(ref["backbone"]),
            lm_params_from_numpy(ref["head"]))


def _check_cache(got, want, where):
    """Every leaf: positions exactly, floats within rtol 1e-4, a bfloat16
    leaf within one bfloat16 step (atol: that step of the leaf's largest
    entry)."""
    flat_g = {"/".join(map(str, p)): v for p, v in
              tree_flatten_with_path(got)}
    flat_w = {"/".join(map(str, p)): v for p, v in
              tree_flatten_with_path(want)}
    assert flat_g.keys() == flat_w.keys(), where
    for name, w in flat_w.items():
        g = flat_g[name]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (where, name)
        g, w = g.float().numpy() if g.is_floating_point() else g.numpy(), \
            np.asarray(w, np.float32 if g.is_floating_point() else w.dtype)
        assert g.shape == w.shape, (where, name)
        if name.endswith("pos"):
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")
        elif flat_g[name].dtype == torch.bfloat16:
            np.testing.assert_allclose(
                g, w, rtol=BF16_STEP,
                atol=BF16_STEP * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{where} {name}")


def test_smoke_configs_are_the_references():
    """All eleven configs (the ten LMs and the paper's MLP) are the
    reference's, full size and smoke, by id and by alias, in the
    reference's order; ``all_configs`` gives every full-size one, and no
    architecture is refused."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import all_configs as jax_all_configs
    assert configs.ARCH_IDS == JAX_ARCH_IDS and len(configs.ARCH_IDS) == 11
    assert sorted(ARCHS + ["paper_mlp"]) == sorted(configs.ARCH_IDS)
    assert configs.ALIASES == jax_aliases()
    aliases = {v: k for k, v in configs.ALIASES.items()}
    for arch in configs.ARCH_IDS:
        for name in (arch, aliases[arch]):
            for port, ref in ((configs.get_config, jax_config),
                              (configs.get_smoke_config, jax_smoke_config)):
                assert dataclasses.asdict(port(name)) == \
                    dataclasses.asdict(ref(name))
    got, want = configs.all_configs(), jax_all_configs()
    assert list(got) == list(want)
    for arch in want:
        assert dataclasses.asdict(got[arch]) == dataclasses.asdict(
            want[arch])
    assert configs.get_config("paper-mlp").family == "mlp"
    assert configs.get_config("mixtral-8x22b").moe.n_experts == 8
    assert configs.get_config("phi-3-vision-4.2b").modality == "vision"
    assert configs.get_config("zamba2-1.2b").family == "hybrid"
    assert configs.get_config("xlstm-1.3b").family == "xlstm"
    assert not hasattr(configs, "NOT_PORTED")
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get_config("no-such-arch")


def jax_aliases():
    from repro.configs import ALIASES
    return ALIASES


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch):
    ref, model, backbone, head = _port(arch)
    tokens = torch.from_numpy(ref["tokens"]).long()
    logits, _, cache = model.forward_logits(
        backbone, head, tokens, positions=torch.arange(S), mode="prefill",
        cache_len=CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=RTOL,
                               atol=ATOL)
    _check_cache(cache, ref["cache"], "prefill")
    # the serve step's last-position-only head gives the same logits
    last, _ = make_prefill_step(model, cache_len=CACHE_LEN)(backbone, head,
                                                            tokens)
    np.testing.assert_allclose(last.numpy(), ref["last"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Four decode steps; a state family's each from the reference's
    cache of the step before."""
    ref, model, backbone, head = _port(arch)
    _, cache = make_prefill_step(model, cache_len=CACHE_LEN)(
        backbone, head, torch.from_numpy(ref["tokens"]).long())
    decode = make_decode_step(model)
    pos = torch.full((B,), S, dtype=torch.int32)
    ref_caches = [ref["cache"]] + [c for _, c in ref["steps"]]
    for i, (want_logits, want_cache) in enumerate(ref["steps"]):
        if arch in STATE_ARCHS:
            cache = lm_cache_from_numpy(ref_caches[i])
        tok = torch.from_numpy(ref["greedy"][:, i:i + 1]).long()
        nxt, logits, cache = decode(backbone, head, cache, tok, pos)
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        _check_cache(cache, want_cache, f"step {i}")
        np.testing.assert_array_equal(nxt.numpy(), ref["greedy"][:, i + 1])
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_jax(arch):
    ref, _, backbone, head = _port(arch)
    before = k8.counter.count
    res = serve_mod.serve(configs.get_smoke_config(arch), B, S, STEPS + 1,
                          device="cpu", weights=(backbone, head),
                          prompt=torch.from_numpy(ref["tokens"]).long(),
                          log=lambda msg: None)
    np.testing.assert_array_equal(res.tokens.numpy(), ref["greedy"])
    np.testing.assert_allclose(res.prefill_logits.numpy(), ref["last"],
                               rtol=RTOL, atol=ATOL)
    assert len(res.decode_s) == STEPS
    assert k8.counter.count == before    # CPU: K8's plain version


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """prefill(S) + decode(1) must agree with prefill(S + 1): within rtol
    1e-4, or the reference's bound where the prefill rounds a state to
    bfloat16 in the cache."""
    ref, model, backbone, head = _port(arch)
    tokens = torch.from_numpy(ref["tokens"]).long()
    extra = torch.from_numpy(ref["greedy"][:, :1]).long()
    full, _, _ = model.forward_logits(
        backbone, head, torch.cat([tokens, extra], dim=1), mode="prefill")
    _, cache = make_prefill_step(model, cache_len=CACHE_LEN)(backbone, head,
                                                            tokens)
    _, dec, _ = make_decode_step(model)(backbone, head, cache, extra,
                                        torch.full((B,), S,
                                                   dtype=torch.int32))
    if arch in STATE_ARCHS:
        assert float((dec - full[:, -1]).abs().max()) < DECODE_BOUND
    else:
        np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_causality(arch):
    """Changing a future token must not change past logits."""
    ref, model, backbone, head = _port(arch)
    tokens = torch.from_numpy(ref["tokens"]).long()
    mutated = tokens.clone()
    mutated[:, -1] = (mutated[:, -1] + 1) % model.cfg.vocab_size
    a, _, _ = model.forward_logits(backbone, head, tokens, mode="prefill")
    b, _, _ = model.forward_logits(backbone, head, mutated, mode="prefill")
    np.testing.assert_array_equal(a[:, :-1].numpy(), b[:, :-1].numpy())
    assert not np.array_equal(a[:, -1].numpy(), b[:, -1].numpy())


def test_init_cache_is_on_the_card_by_default():
    """An empty cache lands on the card unless the CPU is asked for; with
    no card, the default raises instead of quietly building on the CPU."""
    model = build_model(configs.get_smoke_config("starcoder2_3b"))
    if torch.cuda.is_available():
        assert model.init_cache(B, 9)["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            model.init_cache(B, 9)
    assert model.init_cache(B, 9, device="cpu")["k"].device.type == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    """An empty cache has the reference's leaves, shapes and dtypes, and a
    decode step from it matches the reference's decode from scratch."""
    ref, model, backbone, head = _port(arch)
    jm = jax_build_model(jax_smoke_config(arch).replace(attn_impl="pallas"))
    want = _np(jm.init_cache(B, 9, jnp.float32))
    got = model.init_cache(B, 9, torch.float32, device="cpu")
    _check_cache(got, want, "init")
    tok = ref["tokens"][:, :1]
    pos = np.zeros((B,), np.int32)
    _, want_logits, want_cache = jax.jit(jax_decode_step(jm))(
        jax.tree.map(jnp.asarray, ref["backbone"]),
        jax.tree.map(jnp.asarray, ref["head"]), jax.tree.map(
            jnp.asarray, want), jnp.asarray(tok), jnp.asarray(pos))
    _, logits, cache = make_decode_step(model)(
        backbone, head, got, torch.from_numpy(tok).long(),
        torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    _check_cache(cache, _np(want_cache), "decode from scratch")


def test_bf16_compute_runs_the_cache_in_bf16():
    cfg = configs.get_smoke_config("starcoder2_3b").replace(
        compute_dtype="bfloat16")
    res = serve_mod.serve(cfg, 1, 36, 3, seed=3, device="cpu",
                          log=lambda msg: None)
    assert res.tokens.shape == (1, 3)
    assert torch.isfinite(res.last_logits).all()
    model = serve_mod.serving_model(cfg)
    backbone, head = serve_mod.init_weights(model, 3, "cpu")
    _, cache = make_prefill_step(model, cache_len=40)(
        backbone, head, serve_mod.draw_prompt(cfg, 1, 36, 3))
    assert cache["k"].dtype == torch.bfloat16
    assert cache["k"].shape == (2, 1, 32, 2, 32)   # ring of the window


def test_serve_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.serve(configs.get_smoke_config("stablelm_3b"), 1, 4, 2,
                        device="cuda", log=lambda msg: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.main(["--arch", "stablelm-3b", "--batch", "1",
                        "--prefill-len", "4", "--decode-steps", "2"])


@functools.lru_cache(maxsize=None)
def reference_embeds(arch):
    """The reference's train-mode logits from float embeddings (the vision
    stub frontend, as ``tests/test_models.py::test_embeds_input_vlm_path``)
    and its prefill logits and cache from them (numpy)."""
    ref = reference(arch)
    m = jax_build_model(jax_smoke_config(arch).replace(attn_impl="pallas"))
    bb = jax.tree.map(jnp.asarray, ref["backbone"])
    hd = jax.tree.map(jnp.asarray, ref["head"])
    embeds = np.random.default_rng(3).normal(
        size=(B, S, m.cfg.d_model)).astype(np.float32)
    train, _, _ = jax.jit(lambda b, h, e: m.forward_logits(
        b, h, e, mode="train"))(bb, hd, jnp.asarray(embeds))
    last, cache = jax.jit(jax_prefill_step(m, cache_len=CACHE_LEN))(
        bb, hd, jnp.asarray(embeds))
    return {"embeds": embeds, "train": np.asarray(train),
            "last": np.asarray(last), "cache": _np(cache)}


def test_vision_embeddings_match_jax():
    """Phi-3-vision's stub frontend: (B, S, d_model) float embeddings in
    place of token ids, in training and prefill; and the prefill of the
    embedding table's rows equals the prefill of the tokens bit for bit."""
    arch = "phi3_vision_4_2b"
    want = reference_embeds(arch)
    ref, model, backbone, head = _port(arch)
    embeds = torch.from_numpy(want["embeds"])
    logits, aux, _ = model.forward_logits(backbone, head, embeds,
                                          mode="train")
    assert logits.shape == (B, S, model.cfg.vocab_size) and float(aux) == 0
    np.testing.assert_allclose(logits.detach().numpy(), want["train"],
                               rtol=RTOL, atol=ATOL)
    prefill = make_prefill_step(model, cache_len=CACHE_LEN)
    last, cache = prefill(backbone, head, embeds)
    np.testing.assert_allclose(last.numpy(), want["last"], rtol=RTOL,
                               atol=ATOL)
    _check_cache(cache, want["cache"], "embeddings prefill")
    tokens = torch.from_numpy(ref["tokens"]).long()
    rows = backbone["trunk"]["embed"][tokens]
    a, ca = prefill(backbone, head, rows)
    b, cb = prefill(backbone, head, tokens)
    assert torch.equal(a, b)
    for x, y in zip(tree_flatten_with_path(ca), tree_flatten_with_path(cb)):
        assert torch.equal(x[1], y[1])
