"""The batched inclusive prefix sum (``ops.idd_scan``): the port's plain
version against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) on the same numpy inputs, exactly.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it bitwise
against ``torch.cumsum`` and the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import idd_scan, ops
from repro_torch.kernels.idd_scan import LAUNCHES, idd_scan_cuda

# the shapes of tests/test_kernels.py::test_idd_scan_matches_cumsum
SHAPES = [(1, 128), (4, 1024), (2, 4096), (3, 2048)]


def _mask(shape, seed):
    return np.random.default_rng(seed).random(shape) < 0.3


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_plain_scan_equals_pallas_kernel(shape, dtype):
    x = _mask(shape, shape[1]).astype(dtype)
    want = np.asarray(jax_ops.idd_scan(jnp.asarray(x), use_pallas=True))
    got = idd_scan(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_scan_of_values_wraps_like_cumsum():
    """int32 values, not only bits: sums that pass 2**31 wrap as
    ``torch.cumsum``'s int32 sum does (the kernel's unsigned adds)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 256),
                                      dtype=np.int64).astype(np.int32))
    want = torch.cumsum(x, -1, dtype=torch.int32)
    assert torch.equal(ops.idd_scan(x), want)
    exact = np.cumsum(x.numpy().astype(np.int64), -1)
    assert np.array_equal(want.numpy(), exact.astype(np.int32))


@pytest.mark.parametrize("shape,dtype", [((2, 100), torch.int32),
                                         ((128,), torch.int32),
                                         ((2, 128), torch.int64),
                                         ((2, 128), torch.float32)])
def test_scan_rejects_what_the_reference_rejects(shape, dtype):
    with pytest.raises(ValueError):
        idd_scan(torch.zeros(shape, dtype=dtype))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        idd_scan_cuda(torch.zeros((2, 128), dtype=torch.int32))
    assert LAUNCHES.n == 0
