"""One torch CPU thread for the port's heavier parity tests (a fixture
module: it holds no test of its own).

The suite runs six pytest workers on the machine's cores; torch's default of
one intra-op thread per core then makes the workers' thread pools spin
against each other, and a test of many small eager ops runs several times
slower than alone. Importing `one_torch_thread` into a test module runs that
module on one thread and restores the count after it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
