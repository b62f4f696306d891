"""Program spans: named ranges of the port's layers in a profiler trace.

``with span("sim.fgn"):`` marks the work inside the block as the range
``repro.sim.fgn`` while a ``torch.profiler`` records. The range lands in
the same kineto trace as the device's kernels, so a reader of the trace
takes both on one clock. A span's parent is the innermost ``repro.*``
range that encloses it on the calling thread; the top-level span of a
round or request (``repro.bank.step``, ``repro.prefill``) is its
identifier. The profiler keeps the ranges in memory and hands them over
with its events when it stops; nothing else records them.

With no profiler running, ``span`` returns one shared no-op context: one
flag check, nothing allocated, no clock read.

The spans and what they cover:

    repro.data.next_stacked   FederatedBatcher.next_stacked: the loop over
                              C·N clients and the stacking
    repro.bank.step           ScenarioBank.step: the shared stream draw,
                              every scenario's round, the restack
    repro.sim.round           HotaSim.step_with_channel: one round
    repro.sim.client_update   head steps, ω copies, τ_ω local steps
    repro.sim.fgn             final-layer masks, K2 norms, Alg. 2
    repro.sim.aggregate       the OTA fold on the sim's engine
    repro.sim.adam            the PS's Adam update of ω
    repro.prefill             the prefill step of launch/steps
    repro.tf.attn             models/transformer attn_apply (and the
                              hybrid_moe family's attention mixers)
    repro.tf.mlp              models/transformer mlp_block_apply
    repro.mamba               models/mamba2 mamba2_mixer: from the norm
                              to the out-projection, the SSD included
    repro.moe                 models/moe moe_branch: the whole block,
                              routed and shared experts
    repro.moe.route           router logits, ranking, and in inference
                              the slots' grouping by expert and offsets
    repro.moe.experts         the routed experts (grouped GEMMs on the
                              card) and the combine
"""
from __future__ import annotations

from contextlib import nullcontext

from torch.autograd import DeviceType, profiler as _profiler

PREFIX = "repro."
_OFF = nullcontext()


def span(name: str):
    """A ``repro.<name>`` range while a ``torch.profiler`` records, else
    a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(PREFIX + name)


def device_work(averages):
    """The CUDA entries of a profiler's ``key_averages()`` that are work
    on the card: kernels, copies and fills. On the card kineto also
    records a device-side copy of every host range (a span included) as
    a CUDA entry whose time is not work on the card: on an H100 a Table-I
    round's ``repro.sim.round`` read 28.7 ms against its kernels' 3.95
    ms. A sum of device time that kept those copies would count far more
    than the card did."""
    return [e for e in averages
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
