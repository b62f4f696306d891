"""Faults that can be planted under a cell's timed path, to show that the
comparison catches them: each is a context manager that patches the
program for as long as it is open.

* ``frozen_state``: the bank's step returns its state unchanged;
* ``half_batch``: each round trains on the first half of every client's
  batch, the mean taken over it;
* ``altered_token``: the prefill's logits are changed where they are
  produced so that another token comes first;
* ``half_served``: the prefill computes the first half of the batch and
  hands its logits to the other half too.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def frozen_state():
    from repro_torch.core.sweep import ScenarioBank

    def make(step):
        def frozen(self, states, xb, yb, key):
            return states, step(self, states, xb, yb, key)[1]
        return frozen
    return _patched(ScenarioBank, "step", make)


def half_batch():
    from repro_torch.core.sim import HotaSim

    def make(step):
        def half(self, state, xb, yb, *a, **k):
            b = xb.shape[2] // 2
            return step(self, state, xb[:, :, :b], yb[:, :, :b], *a, **k)
        return half
    return _patched(HotaSim, "step_with_channel", make)


def _prefill(wrap):
    from repro_torch.launch import steps

    def make(make_step):
        def patched(*a, **k):
            return wrap(make_step(*a, **k))
        return patched
    return _patched(steps, "make_prefill_step", make)


def altered_token():
    def wrap(step):
        def altered(backbone, head, tokens):
            logits, cache = step(backbone, head, tokens)
            nxt = (logits.argmax(-1) + 1) % logits.shape[-1]
            logits = logits.clone()
            logits[torch.arange(logits.shape[0]), nxt] = logits.max() + 1.0
            return logits, cache
        return altered
    return _prefill(wrap)


def half_served():
    def wrap(step):
        def half(backbone, head, tokens):
            b = tokens.shape[0] // 2
            logits, cache = step(backbone, head, tokens[:b])
            return torch.cat([logits, logits]), cache
        return half
    return _prefill(wrap)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_token": altered_token, "half_served": half_served}
