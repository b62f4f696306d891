"""Divergence recovery for training runs (``RoundGuard``).

Port of ``RoundGuard`` from ``repro.launch.train``. The training driver
of that module (``main``: an LM smoke config on a debug mesh with the LM
loss) waits for the distributed LM step, ROADMAP Queue 1 item 13.5.
"""
from __future__ import annotations

from repro_torch.checkpoint.store import latest_step, restore_checkpoint


class RoundGuard:
    """Host-side divergence recovery (DESIGN.md §3.14).

    The guard inside a faulted round already turns a non-finite or
    spiking round into a bit-exact skip (the state frozen, the
    ``skipped`` metric set). This class watches that metric across
    rounds: after ``patience`` skipped rounds in a row it restores the
    state from the newest complete checkpoint in ``ckpt_dir`` (the skip
    handles transients, the restore a wedged run). A clean round resets
    the streak. ``abstract_state`` is the state's structure (tensors or
    ``meta`` tensors, e.g. ``HotaSim.abstract_state()``); restored leaves
    go to ``device`` (default: their like leaf's)."""

    def __init__(self, ckpt_dir: str, abstract_state, device=None,
                 patience: int = 3):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.ckpt_dir = ckpt_dir
        self.abstract_state = abstract_state
        self.device = device
        self.patience = patience
        self.streak = 0
        self.n_restores = 0

    def observe(self, skipped, state):
        """Feed one round's ``skipped`` metric; returns ``(state,
        restored)``: the restored state when the streak reached
        ``patience`` and a complete checkpoint exists, else ``state``
        untouched. Reads ``skipped`` on the host (one synchronization per
        round)."""
        if float(skipped) < 0.5:
            self.streak = 0
            return state, False
        self.streak += 1
        if self.streak < self.patience:
            return state, False
        self.streak = 0
        step = None if not self.ckpt_dir else latest_step(self.ckpt_dir)
        if step is None:          # nothing to restore from: keep going
            return state, False
        self.n_restores += 1
        return restore_checkpoint(self.ckpt_dir, step, self.abstract_state,
                                  device=self.device), True
