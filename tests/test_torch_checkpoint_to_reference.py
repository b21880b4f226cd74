"""A checkpoint the port writes, restored and served by
``repro.checkpoint`` on the smoke llama3_2_1b (kept apart from
test_torch_checkpoint.py, whose helpers it shares, so the two slow fused
serves run in parallel).

Tolerances: the restored dense tree is compared bit for bit; the
reference's logits from the port's checkpoint against its own fresh run
bitwise (the records are the bytes it would write itself).
"""
import jax
import numpy as np
import pytest
import torch

from repro.runtime.streaming import assign_weight_modes as jax_assign
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.runtime.streaming import tree_leaves
from test_torch_checkpoint import (LAYOUTS, MIN_BYTES, SHARDS,  # noqa: F401
                                   _jax_manager, _port_manager, _serve_jax,
                                   smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core: the smoke models' small ops spend
    more time synchronising a pool of threads than computing.  The bits
    compared here come from runs under the same setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_checkpoint_restores_and_serves_in_the_reference(
        smoke, tmp_path, layout):
    jmodel, jparams, cfg, model, params, prompts = smoke
    _port_manager(tmp_path, layout).save(2, {"params": params},
                                         blocking=True)
    jmgr = _jax_manager(tmp_path, layout)
    back, _ = jmgr.load({"params": jparams})
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back["params"])[0],
            jax.tree_util.tree_flatten_with_path(jparams)[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=str(pa))
    jtree, _ = jmgr.load_for_serving(jparams, mode=layout, prefix="params",
                                     min_bytes=MIN_BYTES, shards=SHARDS)
    got_logits, got_toks = _serve_jax(jmodel, jtree, prompts)
    want_logits, want_toks = _serve_jax(
        jmodel, jax_assign(jparams, mode=layout, min_bytes=MIN_BYTES,
                           shards=SHARDS), prompts)
    np.testing.assert_array_equal(got_toks, want_toks)
    np.testing.assert_array_equal(got_logits.view(np.uint32),
                                  want_logits.view(np.uint32))
    # and the port reads its own checkpoint back bit for bit
    dense, _ = CheckpointManager(tmp_path, device="cpu").load(
        {"params": params})
    for (name, a), (_, b) in zip(tree_leaves(dense["params"]),
                                 tree_leaves(params)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
