"""Roofline terms and the memory summary of a traced step (the port's
counterpart of ``repro.launch.hlo_analysis``).

Terms, per device per step:
    compute term    = FLOPs / peak FLOP/s per card
    memory term     = bytes / HBM bytes/s per card
    collective term = collective bytes / link bytes/s per card

FLOPs, bytes and collective bytes come from ``launch.op_cost`` (the aten
ops one rank's step dispatches), the memory summary from the same trace.

Hardware constants: the NVIDIA H100 SXM5 80GB's datasheet values, dense
bfloat16 on the tensor cores, HBM3, and NVLink 4 per direction (in place
of the TPU's ICI link); a card run below its 700 W limit reaches less.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.launch.op_cost import CostTotals

H100_BF16_FLOPS_PER_S = 989e12   # H100 SXM5 datasheet, dense bf16
H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM5 datasheet, HBM3
H100_NVLINK_BYTES_PER_S = 450e9  # H100 SXM5 datasheet, NVLink per direction
H100_HBM_BYTES = 80e9            # H100 SXM5 80GB

PEAK_FLOPS = H100_BF16_FLOPS_PER_S
HBM_BW = H100_HBM_BYTES_PER_S
LINK_BW = H100_NVLINK_BYTES_PER_S


@dataclass
class Roofline:
    flops: float                 # per device per step
    bytes_accessed: float
    coll_bytes: Dict[str, float]
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def extract_roofline(totals: CostTotals) -> Roofline:
    """The terms of a traced step; the memory term takes the major op
    classes' bytes (``op_cost``), as the reference's dry run does."""
    return Roofline(flops=totals.flops, bytes_accessed=totals.bytes_major,
                    coll_bytes=dict(totals.coll_bytes))


def memory_summary(totals: CostTotals) -> dict:
    """The step's bytes per device: its arguments (the rank's shards of
    state and inputs), outputs, the outputs that alias an argument (a
    donated state or cache updated in place), the peak of live storage it
    allocated (views once; the outputs while alive) and their total
    (arguments + that peak)."""
    return {
        "argument_bytes": totals.argument_bytes,
        "output_bytes": totals.output_bytes,
        "alias_bytes": totals.alias_bytes,
        "temp_bytes": totals.temp_bytes,
        "total_bytes": totals.total_bytes,
    }


def model_flops(n_params_active: float, n_tokens: float,
                train: bool) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward."""
    per_tok = 6.0 if train else 2.0
    return per_tok * n_params_active * n_tokens
