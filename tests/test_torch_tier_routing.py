"""The v2 mapper's tier routing on CPU tensors: with the first pass's
``max_pos`` cut so that every read overflows its widths, the reads go
through tier 2 and some of them on to the host, and every result still
equals per-read ``map_read``.  The counters ``tier2_width_reads``,
``tier2_hot_reads`` and ``tier2_host_reads`` of ``DEVICE_MAP_STATS`` say
which budget sent each read where, and the span ``map.tier1`` holds the
first pass, once a call, on the v2 path alone."""

import numpy as np
import pytest
import torch

from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome
from muchsalsa_tpu_torch.utils.timing import StageTimer

# the first pass's candidate width: reads of 230 b and more carry more
# candidates than this, and tier 2 (twice the width) holds those up to ~400 b
CUT_MAX_POS = 64
READ_LENGTHS = (230, 260, 300, 330, 360, 390, 450, 600, 900, 1200)
COUNTERS = ("tier2_width_reads", "tier2_hot_reads", "tier2_host_reads")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def unique_inputs(seed=5):
    """Four unitigs of one random genome; reads of ``READ_LENGTHS`` from it
    with 2 % noise."""
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, 8_000)
    unitigs = SequenceStore()
    for i, start in enumerate(range(0, 8_000, 2_000)):
        unitigs.add(f"u{i}", genome[start : start + 1_900])
    reads = SequenceStore()
    for i, n in enumerate(READ_LENGTHS):
        p = int(rng.integers(0, len(genome) - n))
        reads.add(f"r{i}", add_noise(rng, genome[p : p + n], 0.02))
    return unitigs, reads


def repeat_inputs(seed=52, copies=6, rep_len=400):
    """Unitigs sharing one repeat, so its minimizers have more index entries
    than the first pass's cap of 4; reads of the repeat and unique reads."""
    rng = np.random.default_rng(seed)
    rep = random_genome(rng, rep_len)
    unitigs = SequenceStore()
    for i in range(copies):
        g = random_genome(rng, 1_200)
        unitigs.add(f"u{i}", g[:200] + rep + g[200:])
    reads = SequenceStore()
    for i in range(3):
        reads.add(f"rep{i}", add_noise(rng, rep, 0.02))
    for i in range(copies):
        reads.add(f"uniq{i}", unitigs.sequence(i)[700:1_100])
    return unitigs, reads


INPUTS = {"unique": unique_inputs, "repeats": repeat_inputs}


def map_cut(name, timer=None, max_pos=CUT_MAX_POS):
    unitigs, reads = INPUTS[name]()
    cfg = MapperConfig()
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    got = mt.map_all_with_device(index, reads, cfg, max_pos=max_pos, device="cpu",
                                 timer=timer)
    want = [(rid, port_mapper.map_read(index, seq, cfg)) for rid, seq in reads.items()]
    return got, want, dict(mt.DEVICE_MAP_STATS)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_every_first_pass_overflows_and_every_result_equals_map_read(name):
    got, want, stats = map_cut(name)
    assert got == want and sum(len(m) for _r, m in got) >= 3
    assert stats["v2"] and stats["total_reads"] == len(want)
    assert stats["tier2_width_reads"] + stats["overflow_reads"] >= stats["total_reads"]
    assert stats["tier2_width_reads"] >= 1 and stats["tier2_host_reads"] >= 1
    assert stats["tier2_host_reads"] <= stats["overflow_reads"]
    assert stats["tier2_width_reads"] + stats["tier2_hot_reads"] >= stats["tier2_reads"]
    assert max(stats["tier2_width_reads"], stats["tier2_hot_reads"]) <= stats["tier2_reads"]
    if name == "repeats":
        assert stats["tier2_hot_reads"] >= 1


def test_counters_reset_and_stay_out_of_the_sums():
    map_cut("unique")
    cum = {k: mt.DEVICE_MAP_STATS_CUM.get(k, 0) for k in mt._CUM_KEYS}
    _got, _want, stats = map_cut("unique", max_pos=2048)
    assert all(stats[k] == 0 for k in COUNTERS)
    assert stats["tier2_reads"] == stats["overflow_reads"] == 0
    assert not set(COUNTERS) & set(mt._CUM_KEYS)
    assert {k: mt.DEVICE_MAP_STATS_CUM[k] for k in mt._CUM_KEYS} == cum | {
        "total_reads": cum["total_reads"] + len(READ_LENGTHS),
        "eager_batches": cum["eager_batches"] + stats["eager_batches"]}
    assert stats["eager_batches"] >= 1


@pytest.fixture(params=["v2", "meshed", "v1"])
def path(request, monkeypatch):
    if request.param == "v1":
        monkeypatch.setattr(mt, "build_device_tables", lambda *a, **k: None)
    if request.param == "meshed":
        cpu = torch.device("cpu")
        monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [cpu, cpu])
    return request.param


def test_tier1_span_holds_the_first_pass_once_a_call_on_v2_alone(path):
    timer = StageTimer(verbose=False)
    got, want, stats = map_cut("unique", timer)
    assert got == want
    assert stats["v2"] is (path != "v1") and stats["meshed"] is (path == "meshed")
    if path == "v1":
        assert "map.tier1" not in timer.calls
        assert all(stats[k] == 0 for k in COUNTERS)
        return
    assert timer.calls["map.tier1"] == 1 and timer.parents["map.tier1"] == {""}
    # the first pass's batches nest in map.tier1, tier 2's in map.tier2
    inside = {"map.tier1", "map.tier2"} if path == "v2" else {"map.tier1"}
    for name in ("map.read_pack", "map.dispatch", "map.collect"):
        assert timer.parents[name] == inside, name
