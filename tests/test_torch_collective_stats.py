"""The port's collective accounting (``repro_torch/launch/
collective_stats.py``) against the reference's HLO parse
(``repro/launch/hlo_stats.py``): ``wire_bytes`` equal for every kind the
reference knows at every group size 1..512, the port's ``broadcast``
costing what an all-gather of the same bytes costs, and
``collective_stats`` of records equal to the reference's parse of HLO
lines holding the same collectives; the dry-run's abstract mesh records
the gathers of ``launch/mesh.py`` and ``runtime/collectives.py``.
"""
import dataclasses
import random

import pytest
import torch

from repro.launch import hlo_stats
from repro_torch.core.api import abstract_compressed
from repro_torch.core.params import EnecParams
from repro_torch.launch import collective_stats
from repro_torch.launch.mesh import AbstractMesh, gather_whole
from repro_torch.runtime import collectives

REF_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", REF_KINDS)
def test_wire_bytes_equal_the_references(kind):
    for n in range(1, 513):
        for rb in (0, 1, 4096, 3 * 2**31 + 7):
            assert collective_stats.wire_bytes(kind, rb, n) \
                == hlo_stats.wire_bytes(kind, rb, n)


def test_broadcast_costs_an_all_gather_of_its_bytes():
    for n in range(1, 513):
        assert collective_stats.wire_bytes("broadcast", 1000, n) \
            == hlo_stats.wire_bytes("all-gather", 1000, n)
    # the n broadcasts of a gather, one shard each, cost one all-gather of
    # the whole
    n, shard = 16, 4096
    recs = [("broadcast", shard, n)] * n
    assert collective_stats.collective_stats(recs)["total_wire_bytes"] \
        == pytest.approx(hlo_stats.wire_bytes("all-gather", n * shard, n))


_DT = {"bf16": 2, "f32": 4, "s32": 4, "u8": 1}


def _hlo_line(i, kind, dtype, dims, n) -> str:
    shape = ",".join(map(str, dims))
    groups = 512 // n if 512 % n == 0 else 1
    return (f"  %c{i} = {dtype}[{shape}]{{1,0}} {kind}(%x{i}), "
            f"replica_groups=[{groups},{n}]<=[{groups * n}]")


@pytest.mark.parametrize("seed", range(4))
def test_collective_stats_equal_the_references_parse(seed):
    rng = random.Random(seed)
    records, lines = [], []
    for i in range(40):
        kind = rng.choice(REF_KINDS)
        dtype = rng.choice(tuple(_DT))
        dims = [rng.randint(1, 512), rng.randint(1, 4096)]
        n = rng.choice((2, 4, 8, 16, 32, 256, 512))
        lines.append(_hlo_line(i, kind, dtype, dims, n))
        records.append((kind, _DT[dtype] * dims[0] * dims[1], n))
    got = collective_stats.collective_stats(records)
    want = hlo_stats.collective_stats("\n".join(lines))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k]["count"] == v["count"]
            assert got[k]["result_bytes"] == v["result_bytes"]
            assert got[k]["wire_bytes"] == pytest.approx(v["wire_bytes"],
                                                         rel=1e-12)
        else:
            assert got[k] == pytest.approx(v, rel=1e-12)
    with pytest.raises(ValueError):
        collective_stats.collective_stats([("all-gatherz", 1, 2)])


def test_abstract_mesh_records_the_ports_gathers():
    """A dense gather (``gather_whole``) records one broadcast an owner of
    the axis; a placed stream tensor's gather (``gather_ct``) one
    all-gather of its packed rows, the NCCL branch; nothing runs."""
    mesh = AbstractMesh((2, 4), ("data", "model"), rank=5)
    assert mesh.coords == {"data": 1, "model": 1}
    assert mesh.axis_ranks("model") == (4, 5, 6, 7)
    assert mesh.axis_ranks("data") == (1, 5)
    t = torch.empty((8, 64), dtype=torch.bfloat16, device="meta")
    whole = gather_whole([t], [(None, "model")], mesh, link=None)[0]
    assert tuple(whole.shape) == (8, 256)
    assert mesh.records == [("broadcast", 8 * 64 * 2, 4)] * 4
    mesh.records.clear()
    ct = abstract_compressed((64, 16384), torch.bfloat16,
                             EnecParams(b=122, n=6, m=3, L=16, l=96),
                             shards=16)
    # rank 5's 4 of the 16 shards (collectives.place_ct's layout)
    placed = dataclasses.replace(ct, streams=ct.streams.map(
        lambda a: torch.empty((4,) + tuple(a.shape[1:]), dtype=a.dtype,
                              device="meta")))
    got = collectives.gather_ct(placed, mesh)
    assert tuple(got.streams.mask.shape) == tuple(ct.streams.mask.shape)
    [(kind, nbytes, n)] = mesh.records
    assert (kind, n) == ("all-gather", 4)
    assert nbytes >= 4 * sum(a.numel() * a.element_size()
                             for a in placed.streams)
