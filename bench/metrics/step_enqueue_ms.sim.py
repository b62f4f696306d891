"""Host milliseconds per scenario round from the call into
``core/sweep.ScenarioBank.step`` to its return, before the metrics are
read back (the host side of ``core/sim.HotaSim``), from the benchmark's
``step`` span."""


def read(ctx):
    n = ctx.counts.get("scenario_rounds", 0)
    if not n or "step" not in ctx.spans:
        return None
    return sum(ctx.spans["step"]) / n * 1e3
