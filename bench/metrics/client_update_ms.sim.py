"""Host milliseconds per scenario round of the client update (head
steps, the per-client ω copies, the τ_ω local steps and their autograd
in ``core/sim.HotaSim._client_update``), from the program's
``repro.sim.client_update`` spans."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.ms_per_scenario_round(ctx, "repro.sim.client_update")
