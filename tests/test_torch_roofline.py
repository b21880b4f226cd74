"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's arithmetic: given a ``ChipSpec`` carrying the reference's own
constants (read from its module), ``model_flops_per_device``,
``model_min_bytes_per_device``, ``_recurrent_correction_flops``,
``_corrected`` and ``analyze_cell`` equal the reference's to 1e-12
relative on every cell and on the same fake records as
``tests/test_roofline.py``; the default chip is the H100 of the port's
measurements; ``main`` reads a dry-run directory into the reference's
JSON and markdown table.
"""
import json

import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline

# the reference's chip, read from its module (the port keeps no TPU figure)
REF_CHIP = roofline.ChipSpec(
    peak_flops=ref_roofline.PEAK_FLOPS, hbm_bw=ref_roofline.HBM_BW,
    link_bw=ref_roofline.ICI_BW, chips=ref_roofline.CHIPS,
    mesh_data=ref_roofline.MESH_DATA, mesh_model=ref_roofline.MESH_MODEL)
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _ref_counts_once():
    """The reference's roofline counts an arch's parameters (a
    ``jax.eval_shape`` of its init, seconds for the MoE giants) at every
    call; each arch's counts are taken once here, the same values."""
    counts = {}

    def once(fn):
        def counted(cfg):
            key = (fn.__name__, cfg)
            if key not in counts:
                counts[key] = fn(cfg)
            return counts[key]
        return counted

    with pytest.MonkeyPatch.context() as mp:
        for name in ("param_count", "active_param_count"):
            mp.setattr(ref_roofline, name, once(getattr(ref_roofline, name)))
        yield


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_terms_equal_the_references(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    assert _close(roofline.model_flops_per_device(cfg, sh, REF_CHIP),
                  ref_roofline.model_flops_per_device(rcfg, rsh))
    for ratio in (1.0, 1.37):
        assert _close(roofline.model_min_bytes_per_device(
            cfg, sh, weight_ratio=ratio, chip=REF_CHIP),
            ref_roofline.model_min_bytes_per_device(rcfg, rsh,
                                                    weight_ratio=ratio))
    assert _close(roofline._recurrent_correction_flops(cfg, sh, REF_CHIP),
                  ref_roofline._recurrent_correction_flops(rcfg, rsh))


def _fake_rec(p0f, p1f, periods, full=None, arch="llama3_2_1b",
              shape="train_4k"):
    """``tests/test_roofline.py``'s fake record."""
    def cell(f):
        return {"cost": {"flops": f, "bytes accessed": 10 * f},
                "collectives": {"total_wire_bytes": f / 100},
                "memory": {"peak_memory_in_bytes": 1 << 30}}
    e = {"status": "ok", "full": cell(full if full is not None else p1f)}
    if p0f is not None:
        e["p0"], e["p1"] = cell(p0f), cell(p1f)
    return {"arch": arch, "shape": shape, "n_periods": periods,
            "single": e, "multi": {"status": "ok"}, "layers_mode": "scan"}


RECS = [_fake_rec(1e9, 3e9, 16), _fake_rec(None, None, 16, full=7e9),
        _fake_rec(1e12, 2e12, 16),
        _fake_rec(None, None, 6, full=3.3e14, arch="jamba_v0_1_52b",
                  shape="prefill_32k"),
        _fake_rec(2e10, 5e10, 3, arch="xlstm_125m", shape="train_4k"),
        _fake_rec(None, None, 94, full=8.1e12,
                  arch="qwen3_moe_235b_a22b", shape="decode_32k"),
        _fake_rec(None, None, 4, full=1e6, arch="whisper_tiny",
                  shape="decode_32k")]


@pytest.mark.parametrize("i", range(len(RECS)))
def test_analyze_cell_equals_the_references(i):
    rec = RECS[i]
    for key in (("cost", "flops"), ("cost", "bytes accessed"),
                ("collectives", "total_wire_bytes")):
        assert _close(roofline._corrected(rec["single"], key,
                                          rec["n_periods"]),
                      ref_roofline._corrected(rec["single"], key,
                                              rec["n_periods"]))
    for ratio in (1.0, 1.37):
        got = roofline.analyze_cell(rec, weight_ratio=ratio, chip=REF_CHIP)
        want = ref_roofline.analyze_cell(rec, weight_ratio=ratio)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                assert _close(got[k], v), k
            else:
                assert got[k] == v, k


def test_skipped_and_failed_pass_through():
    skip = {"arch": "llama3_2_1b", "shape": "long_500k",
            "status": "skipped", "reason": "SKIP(full-attn)"}
    assert roofline.analyze_cell(skip) == ref_roofline.analyze_cell(skip)
    failed = {"arch": "llama3_2_1b", "shape": "train_4k",
              "single": {"status": "failed", "error": "boom"}}
    assert roofline.analyze_cell(failed) == ref_roofline.analyze_cell(failed)


def test_default_chip_is_the_h100():
    chip = roofline.H100
    assert (chip.peak_flops, chip.hbm_bw, chip.link_bw, chip.chips,
            chip.mesh_data, chip.mesh_model) == (989.4e12, 3.35e12, 450e9,
                                                 256, 16, 16)
    assert roofline.H100_NAME == "NVIDIA H100 80GB HBM3, 700.00 W"
    out = roofline.analyze_cell(RECS[0])
    assert out["compute_s"] == pytest.approx(out["flops"] / 989.4e12,
                                             abs=1e-6)
    assert out["memory_s"] == pytest.approx(out["bytes"] / 3.35e12,
                                            abs=1e-6)
    assert out["collective_s"] == pytest.approx(out["wire_bytes"] / 450e9,
                                                abs=1e-6)


def test_main_reads_a_dryrun_directory(tmp_path):
    """Baseline records only (variant and mesh records are compared
    apart), into the JSON rows and the reference's markdown table."""
    d = tmp_path / "dryrun"
    d.mkdir()
    for rec in RECS[:2]:
        (d / f"{rec['arch']}__{rec['shape']}__{id(rec)}.json").write_text(
            json.dumps(rec))
    (d / "llama3_2_1b__train_4k.json").write_text(json.dumps(RECS[2]))
    (d / "llama3_2_1b__long_500k.json").write_text(json.dumps(
        {"arch": "llama3_2_1b", "shape": "long_500k", "status": "skipped",
         "reason": "SKIP(full-attn)"}))
    out = tmp_path / "r.json"
    rows = roofline.main(["--dryrun-dir", str(d), "--out", str(out)])
    assert [r["status"] for r in rows] == ["skipped", "ok"]
    assert json.loads(out.read_text()) == rows
    md = out.with_suffix(".md").read_text().splitlines()
    assert md[0].startswith("| arch | shape | mode | compute_s")
    assert len(md) == 4 and "SKIP(full-attn)" in md[2]
