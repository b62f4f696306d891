"""Driver of the scenario-bank cells: closed-loop rounds of
``repro_torch.core.sweep.ScenarioBank`` over ``core.sim.HotaSim``.

Set-up makes the data, the weights and the round keys from the seed,
builds the bank on the configuration's engine, puts the benchmark's
weights into every scenario's state and drives the bank through its
first ``check_rounds`` rounds by the window's own round (batcher draw,
host-to-device copy, ``bank.step``, the metrics read back, as the
figure sweeps run it). Those rounds are also the warm-up. The window
runs more of the same rounds on the same state. Afterwards the reference
replays the first rounds from the same weights, data, batch seed and
keys, and the program's losses, first gradients and parameter changes
are compared with it (``bench/reference/compare.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench.lib.harness import limits
from bench.reference import compare, radcom
from bench.reference import hota as ref_hota

B1 = 0.9


def make(cell, seed, device, spans):
    return HotaBankRun(cell, seed, device, spans)


def scenarios(traffic) -> List[Dict]:
    """(sigma2, fedgradnorm) of each scenario: σ² of the first clusters as
    listed, the rest at ``sigma2_rest``."""
    c = traffic["n_clusters"]
    out = []
    for sc in traffic["scenarios"]:
        head = list(sc["sigma2_head"])
        out.append({"sigma2": head + [traffic["sigma2_rest"]] * (c - len(head)),
                    "fedgradnorm": sc["weighting"] == "fedgradnorm"})
    return out


class HotaBankRun:
    def __init__(self, cell, seed, device, spans):
        self.cell, self.cfg, self.trf = cell, cell.config, cell.traffic
        self.seed, self.device, self.span = int(seed), device, spans
        self.scen = scenarios(self.trf)
        self.attempted = self.failed = 0
        self.rounds = 0

    # ---------------------------------------------------------------- inputs
    def _inputs(self):
        cfg, trf, seed = self.cfg, self.trf, self.seed
        data = radcom.make_dataset(seed, cfg["n_points"], cfg["dims"][0])
        self.parts = radcom.partition(data, trf["n_clusters"],
                                      trf["n_clients"], seed + 1)
        del data
        self.batch_seed = seed + 2
        base = np.random.default_rng([seed, 4]).integers(
            0, 2 ** 32, size=2, dtype=np.uint64)
        self.key_base = (int(base[0]), int(base[1]))
        self.init = self._weights()

    def key(self, k: int) -> torch.Tensor:
        return torch.tensor([self.key_base[0],
                             (self.key_base[1] + k) % 2 ** 32],
                            dtype=torch.int64)

    def _weights(self) -> Dict[str, torch.Tensor]:
        """ω and the per-client heads, drawn on the device from the seed
        in three calls: weights N(0, 1/fan_in), biases N(0, 0.01²)."""
        dims, dev = self.cfg["dims"], self.device
        c, n = self.trf["n_clusters"], self.trf["n_clients"]
        cmax = max(radcom.N_CLASSES[t] for t in radcom.TASKS)
        g = torch.Generator(device=dev)
        g.manual_seed(self.seed + 3)
        sizes = [a * b + b for a, b in zip(dims[:-1], dims[1:])]
        flat = torch.randn(sum(sizes), generator=g, device=dev)
        names = [f"trunk/fc{i}" for i in range(len(dims) - 2)] + ["final"]
        out, off = {}, 0
        for name, din, dout in zip(names, dims[:-1], dims[1:]):
            out[name + "/w"] = (flat[off:off + din * dout].reshape(din, dout)
                                / din ** 0.5)
            off += din * dout
            out[name + "/b"] = flat[off:off + dout] * 0.01
            off += dout
        d = dims[-1]
        out["head/w"] = torch.randn((c, n, d, cmax), generator=g,
                                    device=dev) / d ** 0.5
        out["head/b"] = torch.randn((c, n, cmax), generator=g,
                                    device=dev) * 0.01
        return out

    # --------------------------------------------------------------- program
    def setup(self):
        from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
        from repro_torch.core.sim import HotaSim
        from repro_torch.core.sweep import ScenarioBank
        from repro_torch.data.federated import FederatedBatcher
        from repro_torch.models.model import build_model
        from repro_torch import rng

        cfg, trf = self.cfg, self.trf
        self._inputs()
        eng = cfg["engine"]
        fl = FLConfig(n_clusters=trf["n_clusters"],
                      n_clients=trf["n_clients"],
                      h_threshold=cfg["h_threshold"],
                      noise_std=cfg["noise_std"], gamma=cfg["gamma"],
                      alpha=cfg["alpha"], tau_h=cfg["tau_h"],
                      tau_w=cfg["tau_w"], ota_sections=eng["ota_sections"],
                      ota_streaming=eng["ota_streaming"],
                      ota_sectioned=eng["ota_sectioned"])
        n_cls = [radcom.N_CLASSES[radcom.TASKS[i % 3]]
                 for i in range(trf["n_clients"])]
        self.n_classes = n_cls
        model = build_model(ModelConfig(family="mlp"), tuple(cfg["dims"]))
        sim = HotaSim(model, fl, TrainConfig(lr=cfg["lr"]), n_cls,
                      max_classes=max(radcom.N_CLASSES.values()),
                      device=self.device)
        specs = [dict(weighting="fedgradnorm" if s["fedgradnorm"]
                      else "equal", sigma2=tuple(s["sigma2"]))
                 for s in self.scen]
        self.bank = ScenarioBank(sim, specs)
        self.states = self.bank.init(rng.PRNGKey(0))
        self._load_weights()
        self.batcher = FederatedBatcher(self.parts, cfg["batch"],
                                        seed=self.batch_seed)
        self.prog_loss = []
        for k in range(self.trf["check_rounds"]):
            loss = self._round(k)
            self.prog_loss.append(torch.from_numpy(loss))
            if k == 0:
                self.prog_grad1 = self._grads()
        self.prog_params = self._params()

    def _leaves(self, tree, prefix):
        from repro_torch.common.tree import tree_flatten_with_path
        return [(prefix + "/".join(p), t)
                for p, t in tree_flatten_with_path(tree)]

    def _load_weights(self):
        st = self.states
        for name, leaf in self._leaves(st.omega, ""):
            leaf.copy_(self.init[name].expand_as(leaf))
        for name, leaf in self._leaves(st.heads, "head/"):
            leaf.copy_(self.init[name].expand_as(leaf))

    def _grads(self):
        """The first round's gradients as the optimizers hold them: the
        first moment after one step over (1 - β1), per scenario."""
        st = self.states
        mu = st.ps_opt.mu / np.float32(1.0 - B1)
        out, off = {}, 0
        for name, leaf in self._leaves(st.omega, ""):
            size = leaf[0].numel()
            out[name] = mu[:, off:off + size].reshape(leaf.shape).clone()
            off += size
        for name, leaf in self._leaves(st.head_opt.mu, "head/"):
            out[name] = (leaf / np.float32(1.0 - B1)).clone()
        return out

    def _params(self):
        st = self.states
        return {name: leaf.clone() for name, leaf in
                self._leaves(st.omega, "") + self._leaves(st.heads, "head/")}

    def _round(self, k: int) -> np.ndarray:
        """One bank round as the figure sweeps run it; returns the (S, C,
        N) losses read back."""
        with self.span("batch"):
            xb, yb = self.batcher.next_stacked()
            x = torch.from_numpy(xb).to(self.device)
            y = torch.from_numpy(yb).to(self.device)
        with self.span("step"):
            self.states, m = self.bank.step(self.states, x, y, self.key(k))
        with self.span("sync"):
            loss = m["loss"].cpu().numpy()
            m["p"].cpu()
        return loss

    # ---------------------------------------------------------------- window
    def window(self, seconds: float):
        k0 = self.trf["check_rounds"] + self.rounds
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < seconds:
            loss = self._round(k0 + done)
            done += 1
            if not np.isfinite(loss).all():
                self.failed += len(self.scen)
        self.elapsed = time.perf_counter() - t0
        self.rounds += done
        self.attempted += done * len(self.scen)

    def end_to_end(self):
        return {"rounds_per_s": self.attempted / self.elapsed}

    def layer_inputs(self):
        return {"scenario_rounds": self.attempted, "bank_rounds": self.rounds,
                "n_scenarios": len(self.scen),
                "n_clusters": self.trf["n_clusters"],
                "n_clients": self.trf["n_clients"],
                "batch": self.cfg["batch"], "dims": self.cfg["dims"],
                "n_classes": max(radcom.N_CLASSES.values())}

    def release(self):
        del self.states, self.bank, self.batcher

    # ----------------------------------------------------------------- check
    def reference(self, tf32: bool = False):
        rounds, cfg = self.trf["check_rounds"], self.cfg
        return ref_hota.run(
            self.init, cfg["dims"], self.n_classes, self.scen,
            radcom.batches(self.parts, cfg["batch"], self.batch_seed, rounds),
            [self.key(k).numpy() for k in range(rounds)], lr=cfg["lr"],
            h_th=cfg["h_threshold"], noise_std=cfg["noise_std"],
            gamma=cfg["gamma"], alpha=cfg["alpha"], tf32=tf32)

    def check(self):
        self.ref = self.reference()
        return numbers(self.prog_loss, self.prog_grad1, self.prog_params,
                       self.init, self.ref, limits(self.cell))

    def control(self):
        """The numbers of the reference computed with TF32 matrix products
        (the precision below the configuration's), put in the program's
        place; ``check`` runs first."""
        ctl = self.ctl = self.reference(tf32=True)
        s = range(len(ctl))
        loss = [torch.stack([ctl[i]["loss"][k] for i in s])
                for k in range(len(ctl[0]["loss"]))]
        grad1 = {k: torch.stack([ctl[i]["grad1"][k] for i in s])
                 for k in ctl[0]["grad1"]}
        params = {k: torch.stack([ctl[i]["params"][k] for i in s])
                  for k in ctl[0]["params"]}
        return numbers(loss, grad1, params, self.init, self.ref,
                       limits(self.cell))


def numbers(prog_loss, prog_grad1, prog_params, init, ref, lim):
    """The three compared numbers of a bank against the reference's
    ``ref`` (one dict per scenario), each with its limit: the first
    round's losses, the first round's gradients and the parameters'
    change over the compared rounds."""
    loss = compare.loss_gap(prog_loss[:1],
                            [torch.stack([r["loss"][0] for r in ref])])
    grad = change = 0.0
    for s, r in enumerate(ref):
        keep = compare.kept_leaves(r["grad1"])
        grad = max(grad, compare.leaf_gap(
            {k: v[s] for k, v in prog_grad1.items()}, r["grad1"], keep))
        change = max(change, compare.leaf_gap(
            {k: prog_params[k][s] - init[k] for k in keep},
            {k: r["params"][k] - init[k] for k in keep}, keep))
    return {"loss": (loss, lim["loss"]), "grad": (grad, lim["grad"]),
            "change": (change, lim["change"])}
