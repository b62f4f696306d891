"""Driver of the serving cells that serve each request to its first
token: closed-loop prefills through ``repro_torch.launch.steps.
make_prefill_step`` on ``models.model.Model`` (the kernel attention,
K8), one batch of requests in flight.

The traffic is a cycle of prompt lengths at evenly spaced quantiles of
its distribution, rounded to its quantum, so that every seed serves the
same sizes. The sorted lengths fall into ``STRATA`` equal groups, and
each stretch of ``STRATA`` requests serves one length of every group, so
that a window that ends inside a cycle has served the mix; the seed
orders the lengths inside each group and the groups inside each
stretch, and draws the token ids. Set-up
draws the weights on the device from the seed, builds the step and warms
up every length of the cycle once. A request is timed from its issue
(before its token ids are copied to the card) to its first tokens on the
host. After the window the reference recomputes the logits of a sample
of the finished requests, the longest among them, drawn from the seed.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from bench.lib.harness import limits
from bench.reference import compare
from bench.reference import lm as ref_lm

STRATA = 8


def make(cell, seed, device, spans):
    return PrefillRun(cell, seed, device, spans)


def cycle_lengths(traffic) -> List[int]:
    """The prompt lengths of one cycle, before the seed orders them:
    quantiles of the distribution over [length_min, length_max], rounded
    to the quantum."""
    n, q = traffic["cycle"], traffic["length_quantum"]
    lo, hi = traffic["length_min"], traffic["length_max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if traffic["distribution"] == "log-uniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            x = lo + u * (hi - lo)
        out.append(int(min(hi, max(lo, q * round(x / q)))))
    return out


class PrefillRun:
    def __init__(self, cell, seed, device, spans):
        self.cell, self.cfg, self.trf = cell, cell.config, cell.traffic
        self.seed, self.device, self.span = int(seed), device, spans
        self.attempted = self.failed = 0
        self.done: List[Dict] = []

    # ---------------------------------------------------------------- inputs
    def _weights(self) -> Dict[str, torch.Tensor]:
        """Every weight drawn on the device from the seed, one call per
        stacked leaf: matrices N(0, 1/fan_in), the embedding N(0, 1), norm
        scales N(0, 0.05²) (applied as 1 + w)."""
        c, dev = self.cfg, self.device
        L, d, h, kv, hd = (c["n_layers"], c["d_model"], c["n_heads"],
                           c["n_kv_heads"], c["head_dim"])
        f, v = c["d_ff"], c["vocab_size"]
        g = torch.Generator(device=dev)
        g.manual_seed(self.seed + 3)

        def normal(shape, std):
            return torch.randn(shape, generator=g, device=dev) * std
        return {"embed": normal((v, d), 1.0),
                "attn_norm": normal((L, d), 0.05),
                "wq": normal((L, d, h, hd), d ** -0.5),
                "wk": normal((L, d, kv, hd), d ** -0.5),
                "wv": normal((L, d, kv, hd), d ** -0.5),
                "wo": normal((L, h, hd, d), (h * hd) ** -0.5),
                "mlp_norm": normal((L, d), 0.05),
                "w_up": normal((L, d, f), d ** -0.5),
                "w_down": normal((L, f, d), f ** -0.5),
                "final_norm": normal((d,), 0.05),
                "head": normal((d, v), d ** -0.5)}

    def _prompts(self):
        rng = np.random.default_rng([self.seed, 5])
        lengths = sorted(cycle_lengths(self.trf))
        per = len(lengths) // STRATA
        inner = [rng.permutation(per) for _ in range(STRATA)]
        order = [s * per + inner[s][t] for t in range(per)
                 for s in rng.permutation(STRATA)]
        b, v = self.trf["batch"], self.cfg["vocab_size"]
        self.cycle = [rng.integers(0, v, size=(b, lengths[i]), dtype=np.int64)
                      for i in order]

    # --------------------------------------------------------------- program
    def setup(self):
        from repro_torch.common.config import ModelConfig
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models.model import build_model

        c = self.cfg
        self.w = self._weights()
        self._prompts()
        mc = ModelConfig(
            name=c["name"], family="dense", n_layers=c["n_layers"],
            d_model=c["d_model"], n_heads=c["n_heads"],
            n_kv_heads=c["n_kv_heads"], head_dim=c["head_dim"],
            d_ff=c["d_ff"], vocab_size=c["vocab_size"],
            rope_theta=c["rope_theta"], sliding_window=c["sliding_window"],
            mlp_act=c["mlp_act"], norm_eps=c["norm_eps"],
            compute_dtype=c["compute_dtype"], param_dtype="float32",
            attn_impl=c["attn_impl"])
        w = self.w
        self.backbone = {
            "trunk": {"embed": w["embed"], "layers": {
                "attn": {"norm": w["attn_norm"], "wq": w["wq"],
                         "wk": w["wk"], "wv": w["wv"], "wo": w["wo"]},
                "mlp": {"norm": w["mlp_norm"], "w_up": w["w_up"],
                        "w_down": w["w_down"]}}},
            "final": {"norm": w["final_norm"]}}
        self.head = {"w": w["head"]}
        self.step = make_prefill_step(build_model(mc))
        seen = set()
        for toks in self.cycle:          # every shape of the cycle once
            if toks.shape not in seen:
                seen.add(toks.shape)
                self._request(toks)
        self.k = 0

    def _request(self, toks: np.ndarray) -> Dict:
        t0 = time.perf_counter()
        x = torch.from_numpy(toks).to(self.device)
        with self.span("step"):
            logits, _ = self.step(self.backbone, self.head, x)
        with self.span("sync"):
            first = logits.argmax(dim=-1).cpu()
        return {"ttft": time.perf_counter() - t0, "logits": logits,
                "first": first, "shape": toks.shape}

    # ---------------------------------------------------------------- window
    def window(self, seconds: float):
        self.done = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            toks = self.cycle[self.k % len(self.cycle)]
            r = self._request(toks)
            r["index"] = self.k % len(self.cycle)
            self.k += 1
            self.done.append(r)
        self.elapsed = time.perf_counter() - t0

    def end_to_end(self):
        self.attempted = sum(r["shape"][0] for r in self.done)
        self.failed = sum(r["shape"][0] for r in self.done
                          if not bool(torch.isfinite(r["logits"]).all()))
        ttft = [r["ttft"] for r in self.done]
        tokens = sum(r["shape"][0] * r["shape"][1] for r in self.done)
        return {"ttft_ms_p95": float(np.percentile(ttft, 95)) * 1e3,
                "tokens_per_s": tokens / self.elapsed}

    def layer_inputs(self):
        return {"requests": [(r["shape"][0], r["shape"][1], r["ttft"])
                             for r in self.done]}

    def release(self):
        del self.step, self.backbone, self.head

    # ----------------------------------------------------------------- check
    def sample(self) -> List[int]:
        """Indices of the compared requests: the longest finished one and
        ``check_requests`` - 1 more drawn from the seed."""
        n = len(self.done)
        longest = max(range(n), key=lambda i: self.done[i]["shape"][1])
        rest = [i for i in range(n) if i != longest]
        rng = np.random.default_rng([self.seed, 6])
        k = min(len(rest), self.trf["check_requests"] - 1)
        return [longest] + sorted(rng.choice(rest, size=k,
                                             replace=False).tolist())

    def check(self, control: bool = False):
        """The sampled requests' served tokens and logits against the
        reference's: the widest gap of a served token below the
        reference's best, and the worst relative L2 error of the logits.
        With ``control`` the reference computed in float8 e4m3 (the
        precision below bfloat16) stands in the program's place, its
        first token the argmax of its own logits."""
        lim = limits(self.cell)
        gap = err = 0.0
        for i in self.sample():
            r = self.done[i]
            toks = torch.from_numpy(self.cycle[r["index"]]).to(self.device)
            ref = ref_lm.last_logits(self.w, self.cfg, toks)
            logits, first = r["logits"], r["first"]
            if control:
                logits = ref_lm.last_logits(self.w, self.cfg, toks,
                                            quant=ref_lm.fp8_e4m3)
                first = logits.argmax(dim=-1)
            gap = max(gap, compare.token_gap(ref, first.to(ref.device)))
            err = max(err, compare.logits_error(logits, ref))
        return {"token_gap": (gap, lim["token_gap"]),
                "logits_error": (err, lim["logits_error"])}

    def control(self):
        return self.check(control=True)
