"""One intra-op thread for the port's CPU tests.

The tier-1 run puts several pytest workers on one host, and torch's
default of a thread per core in each of them oversubscribes the cores
many times over: a test of ``tests/test_torch_rwkv.py`` that takes 10 s
alone took 285 s among six workers. At the tests' sizes one thread loses
little. Each ``tests/test_torch_*.py`` module imports :func:`one_thread`,
an autouse fixture, so its tests run on one thread and the module's
neighbours in the worker get the thread count back.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
