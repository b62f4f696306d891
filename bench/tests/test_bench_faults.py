"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a small size, with each fault the cell can have planted in
the program (``bench/lib/faults.py``)."""
import time

import pytest
import torch

from bench.lib import faults, harness
from bench.tests.cells import small_cell


def _correct(workload):
    result, _ = harness.execute(small_cell(workload), 2 ** 31 + 99, 0.3,
                                False, torch.device("cpu"),
                                time.perf_counter())
    return result["correct"]


@pytest.mark.parametrize("workload", ["mlp-fig4-c100", "sc2-chat-batch"])
def test_sound_runs_are_correct(workload):
    assert _correct(workload)


@pytest.mark.parametrize("workload, fault", [
    ("mlp-fig4-c100", "frozen_state"),
    ("mlp-fig4-c100", "half_batch"),
    ("sc2-repo-prefill", "altered_token"),
    ("sc2-chat-batch", "altered_token"),
    ("sc2-chat-batch", "half_served"),
])
def test_planted_fault_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        assert not _correct(workload)
