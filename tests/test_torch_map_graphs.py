"""The v2 mapper's launch counters and graph keys on CPU tensors.

On the CPU every v2 batch launches its six stages op by op
(``eager_batches``, one a ``map.dispatch`` span) and no graph is captured or
replayed; the meshed path counts its batches as eager too, and the v1 join
counts none.  ``_graph_key``, the key of a batch's captured graph on a CUDA
device, differs whenever a shape or constant of the stages does, and
``_StageGraphs`` launches a key's first batch op by op, captures on its
second and replays from then on, with a stand-in for the CUDA graph.  The
card's side is ``tests/test_torch_map_graphs_cuda.py``."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.ops.mapping_torch import DeviceTables
from muchsalsa_tpu_torch.ops.minimizer_torch import _one_hot_argmin
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome
from muchsalsa_tpu_torch.utils.timing import StageTimer

READ_LENGTHS = (230, 260, 300, 330, 360, 390, 450, 600, 900, 1200)
LAUNCH_KEYS = ("graph_batches", "eager_batches", "graph_captures")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(seed=7):
    """Four unitigs of one random genome; reads of ``READ_LENGTHS`` (two
    length buckets) from it with 2 % noise."""
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


def tier1_batches(reads, batch_reads):
    return sum(-(-len(members) // batch_reads) for _L, members in mt._length_buckets(
        list(reads.items())))


def map_on_cpu(batch_reads, max_pos):
    unitigs, reads = inputs()
    cfg = MapperConfig()
    index = port_mapper.MinimizerIndex.build(unitigs, cfg)
    timer = StageTimer(verbose=False)
    got = mt.map_all_with_device(index, reads, cfg, batch_reads=batch_reads, max_pos=max_pos,
                                 device="cpu", timer=timer)
    assert got == [(rid, port_mapper.map_read(index, seq, cfg)) for rid, seq in reads.items()]
    return reads, timer, dict(mt.DEVICE_MAP_STATS)


@pytest.mark.parametrize("batch_reads", [1, 3, 256])
def test_cpu_launches_every_v2_batch_op_by_op(batch_reads):
    reads, timer, stats = map_on_cpu(batch_reads, max_pos=2048)
    assert len(mt._length_buckets(list(reads.items()))) == 2
    assert stats["v2"] and stats["tier2_reads"] == 0
    assert stats["graph_batches"] == stats["graph_captures"] == 0
    assert stats["eager_batches"] == timer.calls["map.dispatch"] == tier1_batches(
        reads, batch_reads)


@pytest.mark.parametrize("batch_reads", [2, 256])
def test_cpu_counts_tier2_batches_as_eager_too(batch_reads):
    """With the first pass's widths cut, tier 2's batches are v2 batches
    too: each is counted, and none replays a graph."""
    reads, timer, stats = map_on_cpu(batch_reads, max_pos=64)
    assert stats["tier2_reads"] >= 1 and timer.calls["map.tier2"] == 1
    assert stats["graph_batches"] == stats["graph_captures"] == 0
    assert stats["eager_batches"] == timer.calls["map.dispatch"] > tier1_batches(
        reads, batch_reads)


@pytest.mark.parametrize("path", ["meshed", "v1"])
def test_meshed_batches_count_as_eager_and_the_v1_join_counts_none(path, monkeypatch):
    if path == "v1":
        monkeypatch.setattr(mt, "build_device_tables", lambda *a, **k: None)
    else:
        cpu = torch.device("cpu")
        monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [cpu, cpu])
    _reads, timer, stats = map_on_cpu(4, max_pos=2048)
    assert stats["meshed"] is (path == "meshed") and stats["v2"] is (path == "meshed")
    assert stats["graph_batches"] == stats["graph_captures"] == 0
    want = timer.calls["map.dispatch"] if path == "meshed" else 0
    assert stats["eager_batches"] == want


def test_launch_counters_are_summed_across_calls():
    mt.DEVICE_MAP_STATS_CUM.clear()
    _r, _t, first = map_on_cpu(3, max_pos=2048)
    _r, _t, second = map_on_cpu(3, max_pos=2048)
    assert set(LAUNCH_KEYS) <= set(mt._CUM_KEYS)
    assert {k: mt.DEVICE_MAP_STATS_CUM[k] for k in LAUNCH_KEYS} == {
        k: first[k] + second[k] for k in LAUNCH_KEYS}
    assert mt.DEVICE_MAP_STATS_CUM["eager_batches"] == 2 * first["eager_batches"] > 0


def tables(jr=1280, er=640):
    return DeviceTables(rp=torch.zeros(1 << 22, dtype=torch.int64),
                        jrows=torch.zeros((jr, 16), dtype=torch.int64),
                        erows=torch.zeros((er, 16), dtype=torch.int32))


BASE = dict(tables=None, hash_takes=1, L=10_240, budgets=(3_584, 2_048, 2_048), mph=4,
            batch_reads=256, hit_budget=4_096, cfg=MapperConfig(), max_hits=64)
CHANGES = {
    "L": dict(L=8_960),
    "max_sel": dict(budgets=(3_456, 2_048, 2_048)),
    "max_pos": dict(budgets=(3_584, 4_096, 2_048)),
    "trim": dict(budgets=(3_584, 2_048, 4_096)),
    "mph": dict(mph=16),
    "hash_takes": dict(hash_takes=2),
    "jrows": dict(tables=tables(jr=1536)),
    "erows": dict(tables=tables(er=768)),
    "batch_reads": dict(batch_reads=128),
    "hit_budget": dict(hit_budget=2_048),
    "k": dict(cfg=dataclasses.replace(MapperConfig(), k=13)),
    "w": dict(cfg=dataclasses.replace(MapperConfig(), w=7)),
    "max_hits": dict(max_hits=32),
}


def key(**change):
    kw = dict(BASE, tables=tables()) | change
    return mt._graph_key(**kw)


def test_graph_key_depends_on_shapes_not_on_tensors():
    assert key() == key()                   # new tensors of the same shapes
    assert key(budgets=[3_584, 2_048, 2_048]) == key()
    hash(key())


@pytest.mark.parametrize("what", sorted(CHANGES))
def test_graph_key_differs_when_a_shape_or_constant_differs(what):
    assert key(**CHANGES[what]) != key()


@pytest.mark.parametrize("seed", [0, 1])
def test_one_hot_argmin_marks_the_first_minimum(seed):
    """The comparison form equals the scatter of a host scalar that it
    replaced, ties included."""
    h = torch.from_numpy(np.random.default_rng(seed).integers(0, 6, (64, 9)))
    want = torch.zeros(h.shape, dtype=torch.bool)
    want[torch.arange(h.shape[0]), torch.argmin(h, dim=1)] = True
    got = _one_hot_argmin(h)
    assert torch.equal(got, want) and got.dtype == torch.bool
    assert bool((got.sum(dim=1) == 1).all())


class StandInGraph:
    """What a captured graph does on replay: the stages again, over the
    inputs it holds, into the output it holds."""

    def __init__(self, inputs, stages):
        self.inputs, self.stages = inputs, stages
        self.out = stages(*inputs)

    def replay(self):
        self.out.copy_(self.stages(*self.inputs))


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(mt, "DEVICE_MAP_STATS", dict.fromkeys(LAUNCH_KEYS, 0))
    monkeypatch.setattr(mt, "_graph_memory", lambda dev: (None, None))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())

    def capture(self, inputs, stages):
        graph = StandInGraph(inputs, stages)
        return graph, graph.out

    monkeypatch.setattr(mt._StageGraphs, "_capture", capture)
    return mt._StageGraphs(torch.device("cpu"))


@pytest.mark.parametrize("keys, want", [
    ("aaaa", dict(eager_batches=1, graph_captures=1, graph_batches=3)),
    ("a", dict(eager_batches=1, graph_captures=0, graph_batches=0)),
    ("aabaaa", dict(eager_batches=3, graph_captures=2, graph_batches=3)),
    ("abab", dict(eager_batches=4, graph_captures=0, graph_batches=0)),
])
def test_a_key_launches_op_by_op_then_captures_then_replays(stand_in_graphs, keys, want):
    """Each batch comes back with its own result, whichever way it ran; a
    batch of another key drops the graph, so a key met again starts over."""
    def stages(x, n):
        return x * n.sum()

    for i, key in enumerate(keys):
        batch = (torch.arange(5) + 10 * i, torch.full((2,), i + 1))
        got = stand_in_graphs.run(key, batch, stages).clone()
        assert torch.equal(got, stages(*batch))
    assert {k: mt.DEVICE_MAP_STATS[k] for k in LAUNCH_KEYS} == want
