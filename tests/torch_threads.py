"""Thread settings shared by the port's CPU tests.

The suite runs several worker processes at once, and some files start
four torch ranks and a JAX process beside them: torch's default of one
intra-op thread per core, and XLA's, oversubscribe the cores. A test
module takes the fixture by importing it (``from torch_threads import
one_torch_thread``); a JAX program that forces four host devices sets
``XLA_FLAGS`` to ``JAX_XLA_FLAGS``.
"""
import pytest
import torch

# the JAX side's 4 forced host devices, each running its programs on one
# thread
JAX_XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
                 "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread in this process, for the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
