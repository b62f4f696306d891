"""Paper Fig. 4: diverse channel qualities — σ₁² ∈ {2, 0.25}, σ₂² = 0.75,
σ_l² = 1 for l ≥ 3.

Port of ``benchmarks/fig4_diverse_sigma.py``. Claim validated:
HOTA-FedGradNorm is both more robust and faster to train under
heterogeneous channel conditions. All four (σ₁², weighting) combinations
run as ONE ScenarioBank sweep.

    python -m repro_torch.experiments.fig4_diverse_sigma [steps] [flags]
"""
from __future__ import annotations

from typing import Dict

from repro_torch.experiments.paper_common import main, run_sweep, summarize


def experiments() -> Dict[str, Dict]:
    """The figure's four scenarios, by result name."""
    out = {}
    for s1, tag in [(2.0, "s1_2.0"), (0.25, "s1_0.25")]:
        sigma2 = (s1, 0.75) + (1.0,) * 8
        for w in ("fedgradnorm", "equal"):
            out[f"fig4_{tag}_{w}"] = dict(weighting=w, sigma2=sigma2)
    return out


def run(steps: int = 800, force: bool = False,
        ota_streaming: bool = False, ota_sectioned: bool = False,
        max_section_rows: int = 0, device="cuda", scenario_ranks: int = 1):
    results = run_sweep(experiments(), steps=steps, force=force,
                        ota_streaming=ota_streaming,
                        ota_sectioned=ota_sectioned,
                        max_section_rows=max_section_rows, device=device,
                        scenario_ranks=scenario_ranks)
    print(summarize(results, "Fig. 4 — diverse sigma"))
    return results


if __name__ == "__main__":
    main(run)
