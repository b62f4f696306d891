"""The paper-scale experimental setup, in one place.

Port of ``repro.core.paper_setup``: synthetic RadComDynamic -> cluster /
client partition -> ``FederatedBatcher`` -> Table-I MLP -> ``HotaSim``,
with the same seeds, so both packages see the same data.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.sim import HotaSim
from repro_torch.data.federated import FederatedBatcher
from repro_torch.data.radcom import (
    N_CLASSES, RadComConfig, TASKS, client_partition, make_radcom_dataset,
)
from repro_torch.models.model import build_model


def paper_mlp_setup(
    fl: FLConfig,
    batch: int = 24,
    n_points: Optional[int] = None,
    seed: int = 0,
    lr: float = 3e-4,
    device="cuda",
) -> Tuple[HotaSim, FederatedBatcher]:
    """Build the paper's (sim, batcher) for a topology/channel config.

    ``n_points`` overrides the RadComDynamic dataset size (None = the
    paper-scale default); ``seed`` seeds the partition and the batcher
    stream (seed + 1). The sim runs on ``device`` (the card by default;
    raises when there is none, unless ``device="cpu"``)."""
    dev = resolve_device(device)
    rc = RadComConfig(n_points=n_points) if n_points else RadComConfig()
    data = make_radcom_dataset(rc)
    parts = client_partition(data, fl.n_clusters, fl.n_clients, seed=seed)
    batcher = FederatedBatcher(parts, batch, seed=seed + 1)
    n_cls = [N_CLASSES[TASKS[i % 3]] for i in range(fl.n_clients)]
    model = build_model(ModelConfig(family="mlp"))
    sim = HotaSim(model, fl, TrainConfig(lr=lr), n_cls, device=dev)
    return sim, batcher
