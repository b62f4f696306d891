"""On the card, at each cell's own size: a sound run of the program keeps
every compared number within its limit, and the control, the reference
in the precision just below the configuration's (TF32 matrix products
for the float32 bank, float8 e4m3 for the bfloat16 prefill) put in the
program's place, exceeds at least one."""
import json

import pytest
import torch

from bench.lib import registry
from bench.lib.trace import Spans
from bench.tests.cells import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(card, workload):
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = registry.Cell(BENCH, workload)
    run = cell.driver().make(cell, 2 ** 31 + 5, card, Spans())
    run.setup()
    run.window(6.0)
    run.release()
    torch.cuda.empty_cache()
    sound = run.check()
    assert all(v <= lim for v, lim in sound.values()), sound
    control = run.control()
    assert any(v > lim for v, lim in control.values()), control
