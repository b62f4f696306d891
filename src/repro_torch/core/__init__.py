"""The paper's contribution: HOTA-FedGradNorm (port of ``repro.core``).

* channel.py      — ChannelParams (the scenario axis)
* ota.py          — fading-MAC channel model + OTA aggregation (eqs. 3-10)
* fedgradnorm.py  — channel-sparsified FedGradNorm (Alg. 2, eqs. 5-6)
* sim.py          — paper-scale simulator (Alg. 1, batched over C x N)
* sweep.py        — ScenarioBank / ShardedScenarioBank / DistScenarioBank
* hota.py         — distributed machinery: the OTA-FSDP gather
* hota_slab.py    — slab-native whole-model gather
* hota_step.py    — the distributed training step on a rank mesh
* power.py        — eq. (4): expected transmit power + H_th calibration
"""
from repro_torch.core.channel import (
    ChannelParams, channel_params, cluster_channel, stack_channel_params,
)
from repro_torch.core.fedgradnorm import (
    FGNState, fgn_grad_p, fgn_init, fgn_targets, fgn_update,
    fgn_update_gated, fgrad_value, masked_tree_norm,
)
from repro_torch.core.ota import (
    final_layer_masks_packed, gain_mask, ota_aggregate_leaf,
    ota_aggregate_packed, ota_aggregate_tree, packed_gain_bits,
    power_allocation, sample_gain, transmit_signal, tree_channel,
)
from repro_torch.core.sim import HotaSim, SimState, masked_cls_loss
from repro_torch.core.sweep import (
    DistScenarioBank, ScenarioBank, ShardedScenarioBank,
)
from repro_torch.core.hota import (
    OTACtx, build_axes_registry, make_ota_gather, make_packed_final_gather,
    make_param_hook, packed_final_norm,
)
from repro_torch.core.hota_slab import (
    make_packed_omega_gather, packed_omega_key, sectioned_final_norm,
)
from repro_torch.core.hota_step import (
    HotaState, StepParts, make_hota_step_parts, make_hota_train_step,
)
from repro_torch.core.power import (
    calibrate_h_threshold, expected_transmit_power, pass_rate,
)

__all__ = [
    "ChannelParams", "channel_params", "cluster_channel",
    "stack_channel_params", "ScenarioBank", "ShardedScenarioBank",
    "FGNState", "fgn_init", "fgn_update", "fgn_update_gated", "fgn_grad_p",
    "fgn_targets", "fgrad_value", "masked_tree_norm", "gain_mask",
    "final_layer_masks_packed", "ota_aggregate_leaf", "ota_aggregate_packed",
    "ota_aggregate_tree", "packed_gain_bits", "power_allocation",
    "sample_gain", "transmit_signal", "tree_channel", "HotaSim", "SimState",
    "masked_cls_loss", "OTACtx", "build_axes_registry", "make_ota_gather",
    "make_packed_final_gather", "make_param_hook", "packed_final_norm",
    "make_packed_omega_gather", "packed_omega_key", "sectioned_final_norm",
    "HotaState", "StepParts", "make_hota_step_parts", "make_hota_train_step",
    "DistScenarioBank",
    "calibrate_h_threshold", "expected_transmit_power", "pass_rate",
]
