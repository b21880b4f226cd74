"""``convert.params_from_jax`` carries the JAX package's parameter tree
over to the port bit for bit and refuses a tree that does not fit."""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.lm import init_params, param_shapes
from repro_torch.runtime.streaming import tree_leaves


@pytest.fixture(scope="module")
def host_tree():
    cfg = jax_smoke_config("llama3_2_1b")
    return jax.device_get(jax_build_model(cfg).init(jax.random.key(0)))


def test_every_leaf_round_trips_bitwise(host_tree):
    cfg = get_smoke_config("llama3_2_1b")
    tree = params_from_jax(host_tree, "cpu", cfg=cfg)
    want = dict(tree_leaves(host_tree))
    got = dict(tree_leaves(tree))
    assert set(got) == set(want) == set(param_shapes(cfg))
    for path, leaf in got.items():
        ref = np.asarray(want[path])
        assert ref.dtype.name == "bfloat16", path
        # bf16 through an int16 view: the same 16 bits come back
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      ref.view(np.int16), err_msg=path)


def test_port_init_builds_the_same_layout():
    cfg = get_smoke_config("llama3_2_1b")
    tree = init_params(cfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in tree_leaves(tree)} == \
        param_shapes(cfg)


def test_missing_leaf_is_named(host_tree):
    bad = copy.deepcopy(host_tree)
    del bad["period"][0]["mlp"]["w_up"]
    with pytest.raises(KeyError, match="period/0/mlp/w_up"):
        params_from_jax(bad, "cpu", cfg=get_smoke_config("llama3_2_1b"))


def test_misshaped_leaf_is_named(host_tree):
    bad = copy.deepcopy(host_tree)
    bad["period"][0]["attn"]["wk"] = bad["period"][0]["attn"]["wk"][:, :, :8]
    with pytest.raises(ValueError, match="period/0/attn/wk"):
        params_from_jax(bad, "cpu", cfg=get_smoke_config("llama3_2_1b"))


@pytest.mark.parametrize("arch", ["qwen3_32b", "stablelm_3b", "minitron_4b"])
def test_dense_family_round_trips_bitwise(arch):
    """The rest of the dense family: qwen3_32b's per-head ``q_norm`` /
    ``k_norm`` (L, head_dim) and the untied heads carry over bit for bit,
    and the port's own init builds the same layout."""
    cfg = get_smoke_config(arch)
    host = jax.device_get(jax_build_model(jax_smoke_config(arch)).init(
        jax.random.key(1)))
    got = dict(tree_leaves(params_from_jax(host, "cpu", cfg=cfg)))
    want = dict(tree_leaves(host))
    assert set(got) == set(want) == set(param_shapes(cfg))
    assert ("period/0/attn/q_norm" in got) == cfg.qk_norm
    assert ("head" in got) == (not cfg.tie_embeddings)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      np.asarray(want[path]).view(np.int16),
                                      err_msg=path)
    tree = init_params(cfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in tree_leaves(tree)} == \
        param_shapes(cfg)
