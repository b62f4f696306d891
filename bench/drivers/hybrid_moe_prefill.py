"""Driver of the Granite-4.0-H prefill cells: closed-loop prefills of the
port's ``hybrid_moe`` family through ``repro_torch.launch.steps.
make_prefill_step`` on ``models.model.Model`` (Mamba2 mixers, NoPE
attention through K8, routed MoE blocks with a shared expert), one batch
of requests in flight.

The traffic cycle, its seeded order and token ids, the request timing,
the end-to-end arithmetic and the sample of compared requests are
``lm_prefill``'s (``PrefillRun``). Once a whole cycle is served, the
window ends only at the end of a cycle, the first whose next cycle
would end past ``seconds`` (judged by the cycles served so far), so
that every seed times the traffic's whole cycle, its mean length
included: a 51-s window that ended inside the second cycle would time
1.3 cycles, and the seed would pick which prompts come round twice. A
window that ends before its first cycle does (a traced run's) ends at
``seconds``, as ``lm_prefill``'s does. Set-up builds the configuration first,
so a program without the family fails at once, then draws every weight
on the device from the seed in bfloat16 (the layout of
``bench/reference/hybrid_moe``; the program's trees hold the same
tensors, and the head is the embedding's transpose), builds the step and
warms up every length of the cycle once. After the window the reference
recomputes the logits of the sampled requests in float32.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import torch

from bench.drivers.lm_prefill import PrefillRun
from bench.lib.harness import limits
from bench.reference import compare
from bench.reference import hybrid_moe as ref_hm
from bench.reference.lm import fp8_e4m3

NORM_STD = 0.05


def make(cell, seed, device, spans):
    return HybridMoEPrefillRun(cell, seed, device, spans)


def model_config(c):
    """The port's ``HybridMoEConfig`` of the configuration file ``c``
    (Hugging Face's keys)."""
    from repro_torch.common.config import (
        HybridMoEConfig, MoEConfig, SSMConfig,
    )
    d, heads = c["hidden_size"], c["num_attention_heads"]
    if c["mamba_n_heads"] * c["mamba_d_head"] != c["mamba_expand"] * d:
        raise ValueError("mamba_n_heads * mamba_d_head must be "
                         "mamba_expand * hidden_size")
    return HybridMoEConfig(
        name=c["name"], family="hybrid_moe",
        n_layers=c["num_hidden_layers"], d_model=d, n_heads=heads,
        n_kv_heads=c["num_key_value_heads"], head_dim=d // heads,
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        norm_eps=c["rms_norm_eps"], tie_embeddings=True,
        moe=MoEConfig(n_experts=c["num_local_experts"],
                      top_k=c["num_experts_per_tok"]),
        ssm=SSMConfig(d_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"],
                      expand=c["mamba_expand"], head_dim=c["mamba_d_head"],
                      chunk_size=c["mamba_chunk_size"],
                      n_groups=c["mamba_n_groups"]),
        layer_types=tuple(c["layer_types"][:c["num_hidden_layers"]]),
        shared_d_ff=c["shared_intermediate_size"],
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        attention_multiplier=float(c["attention_multiplier"]),
        compute_dtype=c["compute_dtype"], param_dtype=c["param_dtype"],
        attn_impl=c["attn_impl"])


class HybridMoEPrefillRun(PrefillRun):
    def _weights(self) -> Dict[str, torch.Tensor]:
        """Every weight drawn on the device from the seed, a layer at a
        time, stored in bfloat16 (see the configuration's ``assumed``)."""
        c, dev, mc = self.cfg, self.device, self.mc
        d, v, e = mc.d_model, mc.vocab_size, mc.moe.n_experts
        f, fs = mc.d_ff, mc.shared_d_ff
        h, kv, hd = mc.n_heads, mc.n_kv_heads, mc.resolved_head_dim
        s = mc.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        conv = d_in + 2 * s.n_groups * s.d_state
        n_m = mc.layer_types.count("mamba")
        n_a = mc.n_layers - n_m
        # q and k at D^(1/4) times N(0, 1/d)'s deviation: the published
        # softmax scale 1/D then gives scores of unit variance, as 1/sqrt(D)
        # does at N(0, 1/d)
        qk_std = hd ** 0.25 * d ** -0.5
        g = torch.Generator(device=dev)
        g.manual_seed(self.seed + 3)

        def draw(n, shape, sample):
            out = torch.empty((n,) + shape, dtype=torch.bfloat16,
                              device=dev)
            for i in range(n):
                out[i] = sample(shape)
            return out

        def normal(std):
            return lambda shape: torch.randn(shape, generator=g,
                                             device=dev) * std

        def uniform(lo, hi):
            return lambda shape: lo + (hi - lo) * torch.rand(
                shape, generator=g, device=dev)

        def dt_bias(shape):
            dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1))(shape))
            return dt + torch.log(-torch.expm1(-dt))   # softplus⁻¹(dt)

        w = {"embed": draw(1, (v, d), normal(
            1.0 / c["embedding_multiplier"]))[0]}
        w.update(
            mamba_norm=draw(n_m, (d,), normal(NORM_STD)),
            w_in=draw(n_m, (d, 2 * d_in + 2 * s.n_groups * s.d_state + nh),
                      normal(d ** -0.5)),
            conv_w=draw(n_m, (s.d_conv, conv), normal(s.d_conv ** -0.5)),
            conv_b=draw(n_m, (conv,), normal(NORM_STD)),
            a_log=draw(n_m, (nh,), uniform(0.0, math.log(16.0))),
            dt_bias=draw(n_m, (nh,), dt_bias),
            d_skip=draw(n_m, (nh,), lambda shape: torch.ones(shape)),
            out_norm=draw(n_m, (d_in,), normal(NORM_STD)),
            w_out=draw(n_m, (d_in, d), normal(d_in ** -0.5)),
            attn_norm=draw(n_a, (d,), normal(NORM_STD)),
            wq=draw(n_a, (d, h, hd), normal(qk_std)),
            wk=draw(n_a, (d, kv, hd), normal(qk_std)),
            wv=draw(n_a, (d, kv, hd), normal(d ** -0.5)),
            wo=draw(n_a, (h, hd, d), normal((h * hd) ** -0.5)),
            moe_norm=draw(mc.n_layers, (d,), normal(NORM_STD)),
            router=draw(mc.n_layers, (d, e), normal(d ** -0.5)),
            w_gate=draw(mc.n_layers, (e, d, f), normal(d ** -0.5)),
            w_up=draw(mc.n_layers, (e, d, f), normal(d ** -0.5)),
            w_down=draw(mc.n_layers, (e, f, d), normal(f ** -0.5)),
            shared_gate=draw(mc.n_layers, (d, fs), normal(d ** -0.5)),
            shared_up=draw(mc.n_layers, (d, fs), normal(d ** -0.5)),
            shared_down=draw(mc.n_layers, (fs, d), normal(fs ** -0.5)),
            final_norm=draw(1, (d,), normal(NORM_STD))[0])
        return w

    # --------------------------------------------------------------- program
    def setup(self):
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models.model import build_model

        self.mc = model_config(self.cfg)
        model = build_model(self.mc)
        self.w = w = self._weights()
        self._prompts()
        moe = {"norm": w["moe_norm"], "router": w["router"],
               "w_gate": w["w_gate"], "w_up": w["w_up"],
               "w_down": w["w_down"],
               "shared": {"w_gate": w["shared_gate"], "w_up": w["shared_up"],
                          "w_down": w["shared_down"]}}
        self.backbone = {
            "trunk": {
                "embed": w["embed"],
                "mamba": {"norm": w["mamba_norm"], "w_in": w["w_in"],
                          "conv_w": w["conv_w"], "conv_b": w["conv_b"],
                          "a_log": w["a_log"], "dt_bias": w["dt_bias"],
                          "d_skip": w["d_skip"], "out_norm": w["out_norm"],
                          "w_out": w["w_out"]},
                "attention": {"norm": w["attn_norm"], "wq": w["wq"],
                         "wk": w["wk"], "wv": w["wv"], "wo": w["wo"]},
                "moe": moe},
            "final": {"norm": w["final_norm"]}}
        self.head = {"w": w["embed"].t()}
        self.step = make_prefill_step(model)
        seen = set()
        for toks in self.cycle:          # every shape of the cycle once
            if toks.shape not in seen:
                seen.add(toks.shape)
                self._request(toks)
        self.k = 0

    # ---------------------------------------------------------------- window
    def window(self, seconds: float):
        self.done = []
        n = len(self.cycle)
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            whole, part = divmod(len(self.done), n)
            if whole and not part:
                if el * (whole + 1) / whole > seconds:
                    break
            elif not whole and el >= seconds:
                break
            r = self._request(self.cycle[self.k % n])
            r["index"] = self.k % n
            self.k += 1
            self.done.append(r)
        self.elapsed = time.perf_counter() - t0

    # ----------------------------------------------------------------- check
    def check(self, control: bool = False):
        """``lm_prefill``'s comparison against this configuration's
        reference: the widest gap of a served token below the reference's
        best, and the worst relative L2 error of the logits. With
        ``control`` the reference computed in float8 e4m3 stands in the
        program's place."""
        lim = limits(self.cell)
        gap = err = 0.0
        for i in self.sample():
            r = self.done[i]
            toks = torch.from_numpy(self.cycle[r["index"]]).to(self.device)
            ref = ref_hm.last_logits(self.w, self.cfg, toks)
            logits, first = r["logits"], r["first"]
            if control:
                logits = ref_hm.last_logits(self.w, self.cfg, toks,
                                            quant=fp8_e4m3)
                first = logits.argmax(dim=-1)
            gap = max(gap, compare.token_gap(ref, first.to(ref.device)))
            err = max(err, compare.logits_error(logits, ref))
        return {"token_gap": (gap, lim["token_gap"]),
                "logits_error": (err, lim["logits_error"])}
