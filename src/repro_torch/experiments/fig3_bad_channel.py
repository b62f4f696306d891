"""Paper Fig. 3: one bad channel — σ₁² = 0.5, σ_l² = 1 for l ≥ 2.

Port of ``benchmarks/fig3_bad_channel.py``. Claim validated: a single
degraded cluster hurts equal weighting much more than HOTA-FedGradNorm,
which compensates via the channel-masked F_grad. Both weightings run as
ONE ScenarioBank sweep (shared data, shared channel draws).

    python -m repro_torch.experiments.fig3_bad_channel [steps] [flags]
"""
from __future__ import annotations

from repro_torch.experiments.paper_common import main, run_sweep, summarize


def run(steps: int = 800, force: bool = False,
        ota_streaming: bool = False, ota_sectioned: bool = False,
        max_section_rows: int = 0, device="cuda", scenario_ranks: int = 1):
    sigma2 = (0.5,) + (1.0,) * 9
    results = run_sweep({
        "fig3_hota_fgn": dict(weighting="fedgradnorm", sigma2=sigma2),
        "fig3_equal": dict(weighting="equal", sigma2=sigma2),
    }, steps=steps, force=force, ota_streaming=ota_streaming,
        ota_sectioned=ota_sectioned, max_section_rows=max_section_rows,
        device=device, scenario_ranks=scenario_ranks)
    print(summarize(results, "Fig. 3 — bad channel sigma1²=0.5"))
    return results


def run_harsh(steps: int = 150, force: bool = False, device="cuda"):
    """Supplementary: harsher regime where the bad cluster matters —
    C=3 clusters (1/3 of data behind the bad channel), σ₁² = 0.05
    (pass rate ~0.43 at H_th=3.2e-2). Separate bank: C differs (static)."""
    sigma2 = (0.05, 1.0, 1.0)
    results = run_sweep({
        "fig3b_harsh_hota_fgn": dict(weighting="fedgradnorm", sigma2=sigma2),
        "fig3b_harsh_equal": dict(weighting="equal", sigma2=sigma2),
    }, steps=steps, n_clusters=3, force=force, device=device)
    print(summarize(results, "Fig. 3b — harsh channel sigma1²=0.05, C=3"))
    return results


if __name__ == "__main__":
    main(run)
