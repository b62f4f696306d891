"""Host milliseconds per scenario round of the over-the-air fold
(``core/sim.HotaSim.aggregate``: K1 on the client-folded engine, the
stream draws where the engine draws inside), from the program's
``repro.sim.aggregate`` spans."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.ms_per_scenario_round(ctx, "repro.sim.aggregate")
