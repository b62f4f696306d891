"""Runtime calls that block the host (a synchronize, an allocation or a
free: ``bench/lib/program_spans.STALL_CALLS``) per bank round, counted
inside the program's ``repro.bank.step`` spans."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.stalls_per_range(ctx.trace, "repro.bank.step")
