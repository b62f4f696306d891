"""Data sets and batchers (port of ``repro.data``)."""
from repro_torch.data.federated import FederatedBatcher
from repro_torch.data.lm import synthetic_lm_batches
from repro_torch.data.radcom import (
    TASKS, RadComConfig, client_partition, make_radcom_dataset,
)

__all__ = [
    "RadComConfig", "TASKS", "make_radcom_dataset", "client_partition",
    "synthetic_lm_batches", "FederatedBatcher",
]
