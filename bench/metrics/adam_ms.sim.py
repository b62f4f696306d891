"""Host milliseconds per scenario round of the PS's Adam update of ω
(``optim/adam.slab_adam_update``), from the program's ``repro.sim.adam``
spans."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.ms_per_scenario_round(ctx, "repro.sim.adam")
