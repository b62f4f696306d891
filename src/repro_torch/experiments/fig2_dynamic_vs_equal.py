"""Paper Fig. 2: HOTA-FedGradNorm vs naive equal weighting, σ_l² = 1 ∀l.

Port of ``benchmarks/fig2_dynamic_vs_equal.py``. Claim validated: the
dynamic weighting trains FASTER (lower loss at equal epoch) on most
tasks, and the hardest task's weight p rises before its loss drops
(Fig. 2d dynamics). Both scenarios run as ONE ScenarioBank sweep with
common random numbers, so the contrast is paired by construction.

    python -m repro_torch.experiments.fig2_dynamic_vs_equal [steps] [flags]
"""
from __future__ import annotations

from repro_torch.experiments.paper_common import main, run_sweep, summarize


def run(steps: int = 800, force: bool = False,
        ota_streaming: bool = False, ota_sectioned: bool = False,
        max_section_rows: int = 0, device="cuda", scenario_ranks: int = 1):
    results = run_sweep({
        "fig2_hota_fgn": dict(weighting="fedgradnorm"),
        "fig2_equal": dict(weighting="equal"),
    }, steps=steps, force=force, ota_streaming=ota_streaming,
        ota_sectioned=ota_sectioned, max_section_rows=max_section_rows,
        device=device, scenario_ranks=scenario_ranks)
    print(summarize(results, "Fig. 2 — dynamic vs equal (sigma²=1)"))
    return results


if __name__ == "__main__":
    main(run)
