"""Shared pieces of the PyTorch/CUDA port's tests (``test_torch_*.py``).

Inputs come from ``numpy.random.default_rng`` seeds; JAX stays on the CPU
and data crosses between the two packages as python ints and numpy
arrays."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and the plain field arithmetic is many small tensor operations."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def rand_ints(n, modulus, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), 'little') % modulus
            for _ in range(n)]
