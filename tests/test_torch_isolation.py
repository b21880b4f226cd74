"""The port stands alone: no module of ``src/repro_torch``, no example of
``examples_torch`` nor ``chip_smoke.py`` imports JAX or the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--tokens", "2"])


def test_model_init_defaults_to_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("llama3_2_1b")).init()


# the modules of the tree-level codec API, the Table III weight sets and
# the recurrent and prefix families, each scanned above
FAMILY_MODULES = ("core/__init__.py", "core/api.py", "core/stats.py",
                  "core/codec_api.py", "data/__init__.py",
                  "data/synthetic_weights.py", "models/ssm.py",
                  "models/xlstm.py", "models/layers.py", "models/lm.py",
                  "models/registry.py", "configs/xlstm_125m.py",
                  "configs/jamba_v0_1_52b.py", "configs/paligemma_3b.py")


@pytest.mark.parametrize("rel", FAMILY_MODULES)
def test_family_modules_are_scanned(rel):
    assert ROOT / "src" / "repro_torch" / rel in PORT_FILES


# the modules of the serving mesh, each scanned above
MESH_MODULES = ("launch/mesh.py", "runtime/sharding.py",
                "runtime/collectives.py")


@pytest.mark.parametrize("rel", MESH_MODULES)
def test_mesh_modules_are_scanned(rel):
    assert ROOT / "src" / "repro_torch" / rel in PORT_FILES


# the port's examples, each scanned above
EXAMPLES = ("quickstart.py", "compress_checkpoint.py", "serve_compressed.py",
            "serve_moe_streaming.py", "train_lm.py")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_are_scanned(name):
    assert ROOT / "examples_torch" / name in PORT_FILES


@pytest.mark.parametrize("arch", ["xlstm_125m", "jamba_v0_1_52b",
                                  "paligemma_3b"])
def test_family_init_and_cache_default_to_cuda(monkeypatch, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_step_state(2, 16)


def test_serve_on_cpu_when_asked():
    from repro_torch.launch import serve
    out = serve.main(["--smoke", "--device", "cpu", "--tokens", "3",
                      "--batch", "2", "--prompt-len", "8",
                      "--min-bytes", "1024"])
    assert tuple(out["tokens"].shape) == (2, 3)
    assert out["launches"] == {"enec_decode": 0, "decompress_matmul": 0,
                               "dense_tile_matmul": 0, "enec_encode": 0,
                               "idd_scan": 0, "decode_attention_kv": 0}
    assert torch.isfinite(out["logits"]).all()
