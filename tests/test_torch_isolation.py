"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and its entry points run
on CUDA unless the caller asks for the CPU."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
