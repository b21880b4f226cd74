"""The ENEC gradient sync of the port (``optim/grad_compress.py``) against
the reference's, in one process (its multi-rank cases run in the gloo
world of ``tests/test_torch_train_mesh.py``):

  * ``wire_bytes_saved`` equal to the reference's on bf16, fp16 and f32
    gradients;
  * ``compressed_allreduce`` over an axis of one rank bitwise equal to the
    reference's inside a jitted ``shard_map`` on one device, with the same
    ``d2d_psum`` ledger (no byte, one op a stream array);
  * ``rank_ordered_sum`` summing in the order given from the first part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.core import search_for_array as jax_search_for_array
from repro.core.codec_api import Codec as JaxCodec
from repro.core.codec_api import use_codec as jax_use_codec
from repro.core.dtypes import format_for as jax_format_for
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.optim import grad_compress as jax_grad_compress
from repro_torch.core import search_for_array
from repro_torch.core.codec_api import Codec
from repro_torch.core.dtypes import format_for
from repro_torch.core.params import EnecParams
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.grad_compress import (compressed_allreduce,
                                             rank_ordered_sum,
                                             wire_bytes_saved)

DTYPES = ("bfloat16", "float16", "float32")
NUMEL, BLOCK = 9_000, 4096


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, as the suite runs it beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grad(dtype: str, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(NUMEL).astype(np.float32) * 1e-3
    x[::101] = -0.0
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(str(x.dtype).split(".")[1])


def _params(x: torch.Tensor) -> EnecParams:
    fmt = format_for(x.dtype)
    return search_for_array(x.view(fmt.bits_dtype).numpy(), fmt,
                            block_elems=BLOCK)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_bytes_saved_equals_reference(dtype):
    x = _grad(dtype)
    jx = _jax(x)
    jp = jax_search_for_array(np.asarray(jx), jax_format_for(jx.dtype),
                              block_elems=BLOCK)
    p = _params(x)
    assert (p.b, p.n, p.m, p.L, p.l) == (jp.b, jp.n, jp.m, jp.L, jp.l)
    assert wire_bytes_saved(x, p) == jax_grad_compress.wire_bytes_saved(
        jx, jp)
    # the estimate's ratio is the searched params' expected one
    assert wire_bytes_saved(x, p)["ratio"] > 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_rank_allreduce_equals_reference(dtype):
    x = _grad(dtype, seed=1)
    jx = _jax(x)
    p = _params(x)
    jp = jax_search_for_array(np.asarray(jx), jax_format_for(jx.dtype),
                              block_elems=BLOCK)
    jcodec = JaxCodec()
    with jax_use_codec(jcodec):     # jit: its eager decode takes 20 s
        want = jax.jit(shard_map(
            lambda a: jax_grad_compress.compressed_allreduce(
                a[0], "pod", jp, block_elems=BLOCK)[None],
            mesh=jax_make_mesh((1,), ("pod",)), in_specs=P("pod", None),
            out_specs=P("pod", None)))(jx[None])
    codec = Codec()
    got = compressed_allreduce(x, Mesh((1,), ("pod",)), "pod", p,
                               block_elems=BLOCK, codec=codec)
    want = np.asarray(jax.device_get(want))[0]
    assert got.dtype == x.dtype
    bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[
        x.element_size()]
    np.testing.assert_array_equal(got.view(bits[0]).numpy(),
                                  want.view(bits[1]))
    # the sum starts from the first rank's part: negative zeros stay
    assert torch.signbit(got[::101]).all()
    assert codec.link_stats()["d2d_psum"] == \
        jcodec.link_stats()["d2d_psum"] == \
        {"compressed_bytes": 0, "dense_bytes": 0, "ops": 5}


def test_rank_ordered_sum_is_the_ordered_f32_sum():
    parts = [torch.tensor([1e8, -0.0, 1.0], dtype=torch.float32),
             torch.tensor([1.0, -0.0, 1e8], dtype=torch.float32),
             torch.tensor([-1e8, -0.0, -1e8], dtype=torch.float32)]
    got = rank_ordered_sum(parts)
    assert got.tolist() == [0.0, 0.0, 0.0]      # 1.0 lost in both orders
    assert torch.signbit(got).tolist() == [False, True, False]
    bf = [p.to(torch.bfloat16) for p in parts]
    assert rank_ordered_sum(bf).dtype == torch.float32

