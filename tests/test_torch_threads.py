"""One intra-op thread for the PyTorch port's CPU tests.

The suite runs in several pytest-xdist workers at once, and PyTorch's
default of one intra-op thread per core in every worker oversubscribes
the CPU: the port's dense-slice test files took 161 s at the default and
84 s at one thread (6 workers on 8 cores). No result depends on it:
every comparison runs both of its sides under the same setting.

A test module imports the fixture by name, which makes it autouse there
(and here, where the one test checks it).
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_one_thread_inside_a_test():
    assert torch.get_num_threads() == 1
