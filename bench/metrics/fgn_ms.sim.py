"""Host milliseconds per scenario round of FedGradNorm (the final
layer's masks, K2's masked norms and Alg. 2's ``fgn_update_gated`` in
``core/sim.HotaSim``), from the program's ``repro.sim.fgn`` spans."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.ms_per_scenario_round(ctx, "repro.sim.fgn")
