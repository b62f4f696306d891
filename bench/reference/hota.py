"""Plain PyTorch reference of a scenario bank's rounds of hierarchical
over-the-air FedGradNorm (Algorithms 1 and 2 of arXiv:2212.07414).

One round of one scenario, for every cluster l and client i of the
federation (C x N), with the shared MLP ω (ReLU after every layer) and a
linear head per client whose classes past the client's own count are
masked out of the softmax:

1. the client takes one Adam step on its head against the features of ω
   on its batch (mean cross-entropy over the batch);
2. with the new head, the gradient g_li of its loss with respect to ω,
   and that loss F_li;
3. the cluster's server runs FedGradNorm: the masked norms n_li of the
   last shared layer's gradients under the cluster's eq.-7 mask, the
   weights p of one Adam step (rate α) on F_grad = Σ_i |p_i n_i - Ḡ r_i^γ|
   with Ḡ and r_i = F̃_i / mean F̃ held fixed, F̃ = F / F at the first
   round, then p clamped and renormalized to sum N; "equal" keeps p = 1;
4. over the air: y = Σ_l M_l ∘ Σ_i p_li g_li + z, ĝ = y / (|M| N) where
   |M| > 0, else 0. The mask of cluster l passes an entry when the
   uniform of its gain word lies below P(|H|² ≥ H_th) for H ~ N(0, σ²_l),
   and z is N(0, 1)·noise_std by Box-Muller on the two 16-bit halves of
   its noise word;
5. Adam on ω with ĝ.

The words come from the round key by the schedule in ``threefry``: the
channel key folds ``SIM_CHAN_FOLD`` into the round key; the layer stacks
of ω are sections (trunk layer s under fold ``SECTION_FOLD + s``, the
last shared layer under ``TAIL_FOLD``), each leaf starting at a multiple
of 1,024 entries of its section (bias, then weight); cluster l's gain
stream of a section is keyed ``fold_in(fold_in(chan_key, fold), l)``,
the section's noise stream ``fold_in(fold_in(chan_key, NOISE_FOLD),
fold)``. Every scenario of the bank sees the same batch and words.

All arithmetic is float32; matrix products run without TF32 unless the
caller asks for it (the control of the comparison).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from bench.reference import threefry as tf

SIM_CHAN_FOLD = 0x7FFF0003
NOISE_FOLD = 0x7FFFFFFF
TAIL_FOLD = 0x7FFF0002
SECTION_FOLD = 0x7FFF0100
ROW_QUANTUM = 1024
B1, B2, EPS = 0.9, 0.999, 1e-8


def layer_names(dims) -> List[str]:
    """The layers of ω in stream order: the trunk's (sorted as the
    program's tree sorts keys) and then the last shared layer."""
    trunk = sorted(f"trunk/fc{i}" for i in range(len(dims) - 2))
    return trunk + ["final"]


def leaf_layout(dims):
    """(leaf name, section index, section fold, offset in section, shape)
    for every leaf of ω, and the ω layers in forward order."""
    names = layer_names(dims)
    forward = [f"trunk/fc{i}" for i in range(len(dims) - 2)] + ["final"]
    shapes = {name: (dims[i], dims[i + 1]) for i, name in enumerate(forward)}
    out = []
    for s, name in enumerate(names):
        fold = TAIL_FOLD if name == "final" else SECTION_FOLD + s
        din, dout = shapes[name]
        w_off = -(-dout // ROW_QUANTUM) * ROW_QUANTUM
        out.append((name + "/b", s, fold, 0, (dout,)))
        out.append((name + "/w", s, fold, w_off, (din, dout)))
    return out, forward


def _masked_ce(logits, y, n_valid):
    """Mean cross-entropy over the batch axis and dL/dlogits per client:
    logits (K, N, B, c), y (K, N, B), n_valid (N,)."""
    c = logits.shape[-1]
    valid = torch.arange(c, device=logits.device) < n_valid[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(y, c).to(logits.dtype)
    loss = -(logp * onehot).sum(-1).mean(-1)
    dlogits = (torch.exp(logp) - onehot) / logits.shape[-2]
    return loss, torch.where(valid, dlogits, torch.zeros_like(dlogits))


def _adam(p, g, m, v, t, lr):
    m = B1 * m + (1.0 - B1) * g
    v = B2 * v + (1.0 - B2) * g * g
    mhat = m / (1.0 - B1 ** t)
    vhat = v / (1.0 - B2 ** t)
    return p - lr * mhat / (torch.sqrt(vhat) + EPS), m, v


def _p_pass(sigma2, h_th):
    s = torch.clamp(sigma2, min=1e-30)
    return torch.special.erfc(torch.sqrt(h_th / (2.0 * s)))


def _gaussian(words):
    hi = (words >> 16).to(torch.float32)
    lo = (words & 0xFFFF).to(torch.float32)
    u1 = (hi + 1.0) * (1.0 / 65536.0)
    u2 = lo * (1.0 / 65536.0)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32,
                          device=words.device)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def _uniform(words):
    return words.to(torch.float32) * (2.0 ** -32)


class _Round:
    """The words of one round, shared by every scenario of the bank."""

    def __init__(self, key, layout, n_clusters, device):
        chan = tf.fold_in(key, SIM_CHAN_FOLD)
        noise = tf.fold_in(chan, NOISE_FOLD)
        self.gain, self.noise = {}, {}
        for name, _, fold, off, shape in layout:
            n = math.prod(shape)
            ckeys = tf.fold_in(tf.fold_in(chan, fold)[None, :],
                               np.arange(n_clusters))
            self.gain[name] = tf.stream_words(ckeys, off, n, device).to(
                torch.int32)
            self.noise[name] = _gaussian(
                tf.stream_words(tf.fold_in(noise, fold), off, n, device)[0])

    def mask(self, name, clusters: slice, sigma2, h_th):
        """(K, n) float 0/1 masks of the clusters in ``clusters``."""
        u = _uniform(self.gain[name][clusters].to(torch.int64) & tf.MASK32)
        return (u < _p_pass(sigma2[clusters], h_th)[:, None]).to(
            torch.float32)


def run(init: Dict[str, torch.Tensor], dims, n_classes, scenarios, batches,
        keys, *, lr, h_th, noise_std, gamma, alpha, p_min=0.0,
        cluster_block: int = 10, tf32: bool = False):
    """The bank's rounds from ``init`` over ``batches`` and round ``keys``.

    ``init`` maps ω leaf names ("trunk/fc0/w", ..., "final/b") and the
    heads ("head/w" (C, N, d, c), "head/b" (C, N, c)) to float32 tensors
    on the device the reference runs on; ``scenarios`` are dicts with
    ``sigma2`` (C values) and ``fedgradnorm`` (bool). Returns one dict per
    scenario: ``loss`` (one (C, N) tensor per round), ``grad1`` (the first
    round's gradient as each optimizer gets it: ĝ per ω leaf, the head
    gradients per client) and ``params`` (the leaves after the last
    round)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _run(init, dims, n_classes, scenarios, batches, keys, lr=lr,
                    h_th=h_th, noise_std=noise_std, gamma=gamma, alpha=alpha,
                    p_min=p_min, cluster_block=cluster_block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(init, dims, n_classes, scenarios, batches, keys, *, lr, h_th,
         noise_std, gamma, alpha, p_min, cluster_block):
    dev = init["head/w"].device
    layout, forward = leaf_layout(dims)
    c, n = init["head/w"].shape[:2]
    n_valid = torch.tensor(n_classes, device=dev)
    h_th = torch.tensor(h_th, dtype=torch.float32, device=dev)
    states = []
    for sc in scenarios:
        st = {"params": {k: v.clone() for k, v in init.items()},
              "m": {k: torch.zeros_like(v) for k, v in init.items()},
              "v": {k: torch.zeros_like(v) for k, v in init.items()},
              "p": torch.ones((c, n), device=dev),
              "fm": torch.zeros((c, n), device=dev),
              "fv": torch.zeros((c, n), device=dev), "f0": None,
              "sigma2": torch.tensor(sc["sigma2"], dtype=torch.float32,
                                     device=dev),
              "fgn": bool(sc["fedgradnorm"]), "loss": [], "grad1": None}
        states.append(st)
    for t, ((xb, yb), key) in enumerate(zip(batches, keys), start=1):
        words = _Round(key, layout, c, dev)
        x = torch.as_tensor(xb, device=dev)
        y = torch.as_tensor(yb, device=dev).to(torch.int64)
        for st in states:
            _scenario_round(st, t, x, y, words, layout, forward, n_valid,
                            h_th, noise_std, gamma, alpha, p_min, lr,
                            cluster_block)
        del words
    return [{"loss": st["loss"], "grad1": st["grad1"],
             "params": st["params"]} for st in states]


def _scenario_round(st, t, x, y, words, layout, forward, n_valid, h_th,
                    noise_std, gamma, alpha, p_min, lr, block):
    P = st["params"]
    c, n = P["head/w"].shape[:2]
    acc = {name: torch.zeros(shape, device=x.device)
           for name, _, _, _, shape in layout}
    cnt = {name: torch.zeros(shape, device=x.device)
           for name, _, _, _, shape in layout}
    losses, head_grads = [], {"head/w": [], "head/b": []}
    new_heads = {"head/w": [], "head/b": []}
    f0_all, p_all, fm_all, fv_all = [], [], [], []
    for c0 in range(0, c, block):
        cl = slice(c0, min(c0 + block, c))
        xs, ys = x[cl], y[cl]
        # forward of the shared ω, the activations kept for the backward
        hs, zs = [xs], []
        for name in forward:
            z = hs[-1] @ P[name + "/w"] + P[name + "/b"]
            zs.append(z)
            hs.append(torch.relu(z))
        feats = hs[-1]
        # 1. the head's Adam step (per client)
        hw, hb = P["head/w"][cl], P["head/b"][cl]
        _, dl = _masked_ce(feats @ hw + hb[..., None, :], ys, n_valid)
        g_hw = feats.transpose(-1, -2) @ dl
        g_hb = dl.sum(-2)
        hw, mw, vw = _adam(hw, g_hw, st["m"]["head/w"][cl],
                           st["v"]["head/w"][cl], t, lr)
        hb, mb, vb = _adam(hb, g_hb, st["m"]["head/b"][cl],
                           st["v"]["head/b"][cl], t, lr)
        st["m"]["head/w"][cl], st["v"]["head/w"][cl] = mw, vw
        st["m"]["head/b"][cl], st["v"]["head/b"][cl] = mb, vb
        new_heads["head/w"].append(hw)
        new_heads["head/b"].append(hb)
        head_grads["head/w"].append(g_hw)
        head_grads["head/b"].append(g_hb)
        # 2. each client's gradient of its loss under the new head
        loss, dl = _masked_ce(feats @ hw + hb[..., None, :], ys, n_valid)
        dh = dl @ hw.transpose(-1, -2)
        grads = {}
        for i in range(len(forward) - 1, -1, -1):
            name = forward[i]
            dz = dh * (zs[i] > 0)
            grads[name + "/w"] = hs[i].transpose(-1, -2) @ dz
            grads[name + "/b"] = dz.sum(-2)
            if i:
                dh = dz @ P[name + "/w"].transpose(-1, -2)
        # 3. FedGradNorm on the masked norms of the last shared layer
        sq = torch.zeros(loss.shape, device=x.device)
        for name in ("final/b", "final/w"):
            m = words.mask(name, cl, st["sigma2"], h_th)
            g = grads[name].reshape(grads[name].shape[:2] + (-1,))
            sq = sq + ((g * m[:, None, :]) ** 2).sum(-1)
        norms = torch.sqrt(sq)
        f0 = loss if st["f0"] is None else st["f0"][cl]
        p = st["p"][cl]
        fm, fv = st["fm"][cl], st["fv"][cl]
        if st["fgn"]:
            ratios = loss / torch.clamp(f0, min=1e-12)
            r = ratios / torch.clamp(ratios.mean(-1, keepdim=True),
                                     min=1e-12)
            target = torch.pow(torch.clamp(r, min=1e-12), gamma)
            gbar = (p * norms).mean(-1, keepdim=True)
            gp = torch.sign(p * norms - gbar * target) * norms
            p, fm, fv = _adam(p, gp, fm, fv, t, alpha)
            p = torch.clamp(p, min=p_min + 1e-6)
            p = p * (n / torch.clamp(p.sum(-1, keepdim=True), min=1e-12))
        losses.append(loss)
        f0_all.append(f0)
        p_all.append(p)
        fm_all.append(fm)
        fv_all.append(fv)
        # 4. the clusters' masked sum on the air
        for name, _, _, _, shape in layout:
            m = words.mask(name, cl, st["sigma2"], h_th)
            wg = torch.einsum("kn,kn...->k...", p, grads[name]).reshape(
                m.shape)
            acc[name] += (m * wg).sum(0).reshape(shape)
            cnt[name] += m.sum(0).reshape(shape)
        del grads, hs, zs
    st["loss"].append(torch.cat(losses))
    st["f0"] = torch.cat(f0_all)
    st["p"], st["fm"], st["fv"] = (torch.cat(p_all), torch.cat(fm_all),
                                   torch.cat(fv_all))
    ghat = {}
    for name, _, _, _, shape in layout:
        yv = acc[name] + (words.noise[name] * noise_std).reshape(shape)
        k = cnt[name]
        ghat[name] = torch.where(k > 0, yv / (torch.clamp(k, min=1.0) * n),
                                 torch.zeros_like(yv))
    if st["grad1"] is None:
        st["grad1"] = dict(ghat)
        st["grad1"].update({k: torch.cat(v) for k, v in head_grads.items()})
    # 5. Adam on ω
    for name, g in ghat.items():
        P[name], st["m"][name], st["v"][name] = _adam(
            P[name], g, st["m"][name], st["v"][name], t, lr)
    for k, v in new_heads.items():
        P[k] = torch.cat(v)
