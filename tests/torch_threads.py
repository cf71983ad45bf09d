"""One PyTorch intra-op thread for the port's CPU parity tests.

The tier-1 suite runs six pytest-xdist workers on one host. With
PyTorch's default of one OpenMP thread per core, each worker's threads
spin against the other workers' (six concurrent copies of the reduced
dense-backbone round test took 168 s each with the default threads and
24 s with one thread, on eight cores). Import the fixture by name into a
test module to apply it to every test there; the previous thread count
is restored after each test.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
