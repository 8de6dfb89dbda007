"""The v2 mapper's batches replayed from captured CUDA graphs, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  This
module imports no JAX, so on a machine with a card it runs as ``python -m
pytest --noconftest tests/test_torch_map_graphs_cuda.py -q``.  The graph
path's mappings must equal the host mapper's (``map_read``) and the CPU
device path's, exactly: across length buckets and tier 2, on a second call
over the same index, on an index of another table shape, through the dense
re-pull, and for consecutive batches of one graph.  A batch shape's first
batch launches op by op and its second captures the graph, in every call;
what the captured stages hold counts as allocated, as it does op by op.
"""

import numpy as np
import pytest
import torch

from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome, simulate
from muchsalsa_tpu_torch.utils.timing import StageTimer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def sim_stores(seed, genome_length, read_length, coverage=4.0, noise=0.06):
    sim = simulate(np.random.default_rng(seed), genome_length=genome_length,
                   coverage=coverage, read_length=read_length)
    rng = np.random.default_rng(seed + 1)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, noise))
    return unitigs, reads


def fresh(reads):
    """A new store of the same reads, so no packed batch is cached."""
    store = SequenceStore()
    for rid, seq in reads.items():
        store.add(reads.registry.name(rid), seq)
    return store


def table_shape(index):
    built = mt.build_device_tables(index.hashes, index.offsets, index.entry_unitig,
                                   index.entry_pos, index.entry_strand, device="cpu")
    return tuple(tuple(t.shape) for t in built[0])


def map_three_ways(dev, index, reads, cfg, **kw):
    """The graph path's result and counters, after holding the result to the
    CPU device path's and the host mapper's."""
    timer = StageTimer(verbose=False)
    on_card = mt.map_all_with_device(index, reads, cfg, device=dev, timer=timer, **kw)
    stats = dict(mt.DEVICE_MAP_STATS)
    on_cpu = mt.map_all_with_device(index, fresh(reads), cfg, device="cpu", **kw)
    cpu_stats = dict(mt.DEVICE_MAP_STATS)
    assert on_card == on_cpu
    assert on_card == [(rid, port_mapper.map_read(index, seq, cfg)) for rid, seq in reads.items()]
    assert {k: stats[k] for k in mt._COUNT_KEYS} == {k: cpu_stats[k] for k in mt._COUNT_KEYS}
    assert stats["v2"] and not stats["meshed"] and stats["device"].startswith("cuda")
    assert stats["eager_batches"] + stats["graph_batches"] == timer.calls["map.dispatch"] == (
        cpu_stats["eager_batches"])
    # each batch shape launches one batch op by op, and captures at most once
    assert stats["graph_captures"] <= stats["eager_batches"]
    assert stats["graph_captures"] <= stats["graph_batches"]
    return on_card, stats


def test_buckets_and_tier2_replay_graphs_and_equal_the_host(cuda):
    unitigs, reads = sim_stores(61, 40_000, 3_000)
    for i, n in enumerate((700, 1_500, 5_000)):     # more buckets
        reads.add(f"extra{i}", add_noise(np.random.default_rng(i), unitigs.sequence(i)[:n],
                                         0.05))
    cfg = MapperConfig()
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    assert len(mt._length_buckets(list(reads.items()))) >= 2
    got, stats = map_three_ways(cuda, index, reads, cfg, max_pos=256, batch_reads=8)
    assert stats["tier2_reads"] > 0 and sum(len(m) for _r, m in got) > 20
    assert stats["eager_batches"] >= 3          # two buckets' first pass and tier 2
    assert stats["graph_captures"] >= 1 and stats["graph_batches"] > stats["graph_captures"]


def test_a_second_call_captures_as_the_first_and_holds_as_much(cuda, monkeypatch):
    """A second call over the same index replays what it captures itself,
    and its peak of allocated memory is that of launching every batch op by
    op: the captured stages' memory is not hidden in the graph pool."""
    unitigs, reads = sim_stores(62, 40_000, 3_000)
    cfg = MapperConfig()
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    first, stats1 = map_three_ways(cuda, index, reads, cfg, max_pos=256, batch_reads=8)
    assert stats1["graph_batches"] > 0

    def peak(reads):
        torch.cuda.synchronize(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        got = mt.map_all_with_device(index, reads, cfg, device=cuda, max_pos=256,
                                     batch_reads=8)
        torch.cuda.synchronize(cuda)
        return got, dict(mt.DEVICE_MAP_STATS), torch.cuda.max_memory_allocated(cuda)

    second, stats2, graph_peak = peak(fresh(reads))
    assert second == first
    assert {k: stats2[k] for k in mt._CUM_KEYS} == {k: stats1[k] for k in mt._CUM_KEYS}
    monkeypatch.setattr(mt._StageGraphs, "run", lambda self, key, batch, stages: stages(*batch))
    eager, _stats, eager_peak = peak(fresh(reads))
    assert eager == first
    assert graph_peak >= 0.9 * eager_peak


def test_an_index_of_another_table_shape_captures_anew(cuda):
    cfg = MapperConfig()
    unitigs, reads = sim_stores(63, 30_000, 2_500)
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    _got, stats = map_three_ways(cuda, index, reads, cfg, batch_reads=8)
    assert stats["graph_captures"] > 0
    big_unitigs, big_reads = sim_stores(64, 400_000, 2_500, coverage=0.4)
    big = port_mapper.MinimizerIndex.build(big_unitigs, cfg)
    assert table_shape(big) != table_shape(index)
    _got, stats = map_three_ways(cuda, big, big_reads, cfg, batch_reads=8)
    assert stats["graph_captures"] > 0
    # and back: the first index captures again, and still maps as the host does
    _got, stats = map_three_ways(cuda, index, fresh(reads), cfg, batch_reads=8)
    assert stats["graph_captures"] > 0


def test_a_small_hit_budget_repulls_and_equals_the_host(cuda):
    rng = np.random.default_rng(65)
    unitigs = SequenceStore()
    for i in range(12):
        unitigs.add(f"u{i}", random_genome(rng, 700))
    reads = SequenceStore()
    for i in range(12):
        reads.add(f"r{i}", unitigs.sequence(i)[50:650])
    cfg = MapperConfig()
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    _got, stats = map_three_ways(cuda, index, reads, cfg, max_pos=256, hit_budget=2,
                                 batch_reads=4)
    # a replayed batch is re-pulled too, its anchors computed op by op
    assert stats["graph_batches"] == 2 and stats["dense_repulls"] == 3


def test_consecutive_batches_of_one_graph_keep_their_own_hits(cuda):
    """Sixteen reads of one bucket in batches of four: the first launches op
    by op and one graph replays three times, each batch's copy back queued
    before the next replay."""
    rng = np.random.default_rng(66)
    genome = random_genome(rng, 30_000)
    unitigs = SequenceStore()
    for i, start in enumerate(range(0, 30_000, 3_000)):
        unitigs.add(f"u{i}", genome[start : start + 2_900])
    reads = SequenceStore()
    for i in range(16):
        p = int(rng.integers(0, len(genome) - 2_200))
        reads.add(f"r{i}", add_noise(rng, genome[p : p + 2_200], 0.03))
    cfg = MapperConfig()
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    got, stats = map_three_ways(cuda, index, reads, cfg, batch_reads=4)
    assert len(mt._length_buckets(list(reads.items()))) == 1
    assert stats["eager_batches"] == stats["graph_captures"] == 1
    assert stats["graph_batches"] == 3
    mapped = [str(maps) for _rid, maps in got if maps]
    assert len(mapped) >= 13 and len(set(mapped)) == len(mapped)
