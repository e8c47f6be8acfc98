"""The port's test files import `_few_threads` (autouse): each test module
runs with two torch threads. With the default count, tiny ops under the
parallel test workers run many times slower."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
