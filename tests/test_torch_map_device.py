"""The port's device mapping (``map_all(device=True)``) against the JAX
package's mappers.

Simulated reads and repeat-rich unitig sets (numpy, from seeds) are mapped
by the port on CPU tensors and by the JAX package: its host ``map_all``,
its ``map_all(device=True)`` and its ``map_all_with_device`` on one CPU
device.  Each package maps its own stores, index and config, built from the
same sequences.  Tolerance: byte-equal PAF lines, equal ``Mapping`` values
and equal counters.
"""

import dataclasses

import numpy as np
import pytest
import torch

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.pipeline import mapper as jax_mapper
from muchsalsa_tpu.testing.simulate import add_noise, random_genome, simulate
from muchsalsa_tpu_torch import native
from muchsalsa_tpu_torch.config import MapperConfig as PortMapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore as PortStore
from muchsalsa_tpu_torch.ops.mapping_torch import pack_codes
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch as mt


def port_store(store):
    """The port's store of the same records, in the same id order."""
    out = PortStore()
    for rid, seq in store.items():
        out.add(store.registry.name(rid), seq)
    return out


def port_side(unitigs, reads):
    """(index, reads, config) of the port, built from the JAX package's
    stores' sequences."""
    cfg = PortMapperConfig()
    return port_mapper.MinimizerIndex.build(port_store(unitigs), cfg), port_store(reads), cfg


def values(per_read):
    """``(read id, [Mapping...])`` lists of either package as plain tuples."""
    return [(rid, [dataclasses.astuple(m) for m in maps]) for rid, maps in per_read]


def host_values(index, reads, cfg):
    """The JAX package's host ``map_read`` of every read, as plain tuples."""
    return values((rid, jax_mapper.map_read(index, seq, cfg)) for rid, seq in reads.items())


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX mapper on one device: its tier-2 ladder and dense pull run
    only off the mesh."""
    import jax

    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])


def sim_stores(seed, genome_length, coverage, read_length, noise=0.06):
    rng = np.random.default_rng(seed)
    sim = simulate(rng, genome_length=genome_length, coverage=coverage, read_length=read_length)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = SequenceStore()
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, noise))
    return unitigs, reads


def repeat_stores(seed=48, copies=6, rep_len=300):
    """``copies`` unitigs sharing one repeat, and reads of the bare repeat
    beside one unique read."""
    rng = np.random.default_rng(seed)
    rep = random_genome(rng, rep_len)
    store = SequenceStore()
    for i in range(copies):
        g = random_genome(rng, 600)
        store.add(f"u{i}", g[:200] + rep + g[200:])
    reads = SequenceStore()
    for i in range(4):
        reads.add(f"rep{i}", rep)
    reads.add("uniq", store.sequence(0)[:180])
    return store, reads


def names_of(unitigs, reads):
    return dict(unitig_names=lambda u: unitigs.registry.name(u),
                read_names=lambda r: reads.registry.name(r))


def stats_subset():
    return {k: mt.DEVICE_MAP_STATS[k] for k in mt._COUNT_KEYS}


def test_map_all_device_matches_jax_host_map_all():
    unitigs, reads = sim_stores(45, 25_000, 5.0, 4_000)
    reads.add("tiny", b"ACGTAC")  # shorter than k
    reads.add("long", add_noise(np.random.default_rng(2),
                                b"".join(unitigs.sequence(i) for i in unitigs.ids()[:6]), 0.03))
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    names = names_of(unitigs, reads)
    want = jax_mapper.map_all(index, reads, cfg, **names)
    p_index, p_reads, p_cfg = port_side(unitigs, reads)
    got = mt.map_all(p_index, p_reads, p_cfg, device=True, torch_device="cpu", **names)
    assert "\n".join(got).encode() == "\n".join(want).encode()
    assert len(got) > 50
    assert mt.DEVICE_MAP_STATS["v2"] and mt.DEVICE_MAP_STATS["device"] == "cpu"
    assert mt.DEVICE_MAP_STATS["total_reads"] == len(reads)
    assert mt.DEVICE_MAP_STATS["overflow_reads"] == 0


def test_map_all_device_matches_jax_device_map_all():
    unitigs, reads = sim_stores(50, 15_000, 4.0, 2_000, noise=0.05)
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    want = jax_mapper.map_all(index, reads, cfg, device=True)
    got = mt.map_all(*port_side(unitigs, reads), device=True, torch_device="cpu")
    assert got == want and len(got) > 20


def test_overflow_reads_fall_back_to_host_and_are_counted(one_jax_device):
    """test_mapping_jax.py::test_map_all_with_device_counts_overflow: eight
    repeat copies break a cap of 2, so each repeat read goes to tier 2 or
    to the host, with the JAX mapper's counters."""
    store, reads = repeat_stores(seed=48, copies=8, rep_len=400)
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    kw = dict(max_pos=256, max_per_hit=2)
    want = jax_mapper.map_all_with_device(index, reads, cfg, **kw)
    want_stats = {k: jax_mapper.DEVICE_MAP_STATS[k] for k in mt._COUNT_KEYS}
    got = mt.map_all_with_device(*port_side(store, reads), device="cpu", **kw)
    assert values(got) == values(want)
    assert stats_subset() == want_stats
    assert mt.DEVICE_MAP_STATS["tier2_reads"] + mt.DEVICE_MAP_STATS["overflow_reads"] >= 4
    assert values(got) == host_values(index, reads, cfg)


def test_tier2_rescues_repeat_reads(one_jax_device, monkeypatch):
    store, reads = repeat_stores()
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    kw = dict(max_pos=1024, max_per_hit=2)
    want = jax_mapper.map_all_with_device(index, reads, cfg, **kw)
    port = port_side(store, reads)
    got = mt.map_all_with_device(*port, device="cpu", **kw)
    assert values(got) == values(want)
    assert mt.DEVICE_MAP_STATS["tier2_reads"] >= 4
    assert mt.DEVICE_MAP_STATS["overflow_reads"] == 0
    assert values(got) == host_values(index, reads, cfg)

    # with tier 2 off the same reads go to the host
    monkeypatch.setenv("MS_TPU_MAP_TIER2", "0")
    assert mt.map_all_with_device(*port, device="cpu", **kw) == got
    assert mt.DEVICE_MAP_STATS["tier2_reads"] == 0
    assert mt.DEVICE_MAP_STATS["overflow_reads"] >= 4


def test_tier2_cap_clamped_to_saturation_bound(monkeypatch):
    monkeypatch.setenv("MS_TPU_MAP_TIER2", "64")
    store, reads = repeat_stores(seed=52)
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    out = mt.map_all_with_device(*port_side(store, reads), max_pos=1024, max_per_hit=2,
                                 device="cpu")
    assert mt.DEVICE_MAP_STATS["tier2_reads"] >= 4
    assert values(out) == host_values(index, reads, cfg)


def test_dense_budget_repull(one_jax_device):
    rng = np.random.default_rng(49)
    store = SequenceStore()
    for i in range(12):
        store.add(f"u{i}", random_genome(rng, 700))
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    reads = SequenceStore()
    for i in range(12):
        reads.add(f"r{i}", store.sequence(i)[50:650])

    port = port_side(store, reads)
    roomy = mt.map_all_with_device(*port, max_pos=256, max_per_hit=4, device="cpu")
    assert mt.DEVICE_MAP_STATS["dense_repulls"] == 0
    tight = mt.map_all_with_device(*port, max_pos=256, max_per_hit=4, hit_budget=2,
                                   device="cpu")
    assert mt.DEVICE_MAP_STATS["dense_repulls"] >= 1
    assert tight == roomy
    assert values(tight) == values(jax_mapper.map_all_with_device(
        index, reads, cfg, max_pos=256, max_per_hit=4, hit_budget=2))


def test_tier2_batches_not_cached_across_indexes():
    rng = np.random.default_rng(51)
    repA, repB = random_genome(rng, 300), random_genome(rng, 300)
    storeA, storeB = SequenceStore(), SequenceStore()
    for i in range(6):
        g = random_genome(rng, 600)
        storeA.add(f"a{i}", g[:200] + repA + g[200:])
        g2 = random_genome(rng, 600)
        storeB.add(f"b{i}", g2[:200] + repB + g2[200:])
    cfg = MapperConfig()
    idxA = jax_mapper.MinimizerIndex.build(storeA, cfg)
    idxB = jax_mapper.MinimizerIndex.build(storeB, cfg)
    reads = SequenceStore()
    reads.add("rA", repA)   # goes to tier 2 only against index A
    reads.add("rB", repB)   # goes to tier 2 only against index B
    reads.add("u", storeA.sequence(0)[:180])

    p_idxA, p_reads, p_cfg = port_side(storeA, reads)
    p_idxB = port_side(storeB, reads)[0]
    outA = mt.map_all_with_device(p_idxA, p_reads, p_cfg, max_pos=1024, max_per_hit=2,
                                  device="cpu")
    assert mt.DEVICE_MAP_STATS["tier2_reads"] == 1
    outB = mt.map_all_with_device(p_idxB, p_reads, p_cfg, max_pos=1024, max_per_hit=2,
                                  device="cpu")
    assert mt.DEVICE_MAP_STATS["tier2_reads"] == 1
    assert values(outA) == host_values(idxA, reads, cfg)
    assert values(outB) == host_values(idxB, reads, cfg)
    cache = getattr(p_reads, mt._CACHE_ATTR)["cpu"][1]
    assert cache and all(key[0] != "t2" and not isinstance(key[1], tuple) for key in cache)


def test_batch_cache_reuse_lru_cap_and_version(monkeypatch):
    unitigs, reads = sim_stores(53, 12_000, 6.0, 1_500)
    index, reads, cfg = port_side(unitigs, reads)
    unitigs = port_store(unitigs)
    first = mt.map_all_with_device(index, reads, cfg, batch_reads=16, device="cpu")
    cache = getattr(reads, mt._CACHE_ATTR)["cpu"][1]
    n_batches = len(cache)
    assert n_batches >= 2
    held = {key: tensors for key, (tensors, _sz) in cache.items()}
    assert mt.map_all_with_device(index, reads, cfg, batch_reads=16, device="cpu") == first
    assert all(cache[key][0] is held[key] for key in held)  # served from the cache

    # a store change empties it
    reads.add("late", unitigs.sequence(0))
    again = mt.map_all_with_device(index, reads, cfg, batch_reads=16, device="cpu")
    assert again[:-1] == first
    assert all(getattr(reads, mt._CACHE_ATTR)["cpu"][1][key][0] is not held[key]
               for key in held if key in getattr(reads, mt._CACHE_ATTR)["cpu"][1])

    # a cap of one batch keeps the most recent batch alone
    nbytes = next(iter(cache.values()))[1] if cache else 0
    one_mb = max(1, -(-nbytes // (1 << 20)))
    monkeypatch.setenv("MS_TPU_DEV_CACHE_MB", str(one_mb))
    fresh = port_store(reads)
    assert mt.map_all_with_device(index, fresh, cfg, batch_reads=16, device="cpu") == again
    assert len(getattr(fresh, mt._CACHE_ATTR)["cpu"][1]) <= max(1, (one_mb << 20) // nbytes)
    monkeypatch.setenv("MS_TPU_DEV_CACHE_MB", "0")
    empty_cap = port_store(reads)
    assert mt.map_all_with_device(index, empty_cap, cfg, batch_reads=16, device="cpu") == again
    assert not getattr(empty_cap, mt._CACHE_ATTR)["cpu"][1]


def test_cumulative_stats_accumulate():
    rng = np.random.default_rng(53)
    store = SequenceStore()
    for i in range(4):
        store.add(f"u{i}", random_genome(rng, 900))
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    reads = SequenceStore()
    for i in range(3):
        reads.add(f"r{i}", store.sequence(i)[50:850])
    port = port_side(store, reads)
    mt.DEVICE_MAP_STATS_CUM.clear()
    mt.map_all_with_device(*port, device="cpu")
    mt.map_all_with_device(*port, device="cpu")
    assert mt.DEVICE_MAP_STATS_CUM == {"total_reads": 6, "overflow_reads": 0,
                                       "tier2_reads": 0, "dense_repulls": 0,
                                       "graph_batches": 0, "eager_batches": 2,
                                       "graph_captures": 0}


def test_empty_store():
    store = SequenceStore()
    store.add("u0", random_genome(np.random.default_rng(1), 800))
    index, _, p_cfg = port_side(store, SequenceStore())
    assert mt.map_all_with_device(index, PortStore(), p_cfg, device="cpu") == []
    assert mt.map_all(index, PortStore(), p_cfg, device=True, torch_device="cpu") == []


def test_unpackable_index_maps_by_v1_on_the_device():
    """Where the v2 tables cannot be built (here: a cap past the count
    saturation bound), the v1 join maps the reads on the device: the JAX
    package's counters, fewer reads on the host than in all, and the host
    mapper's values."""
    store, reads = repeat_stores(seed=54)
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    jax_mapper.map_all_with_device(index, reads, cfg, max_per_hit=31)
    want_stats = {k: jax_mapper.DEVICE_MAP_STATS[k] for k in mt._COUNT_KEYS}
    out = mt.map_all_with_device(*port_side(store, reads), max_per_hit=31, device="cpu")
    assert mt.DEVICE_MAP_STATS["v2"] is False
    assert stats_subset() == want_stats
    assert mt.DEVICE_MAP_STATS["overflow_reads"] < mt.DEVICE_MAP_STATS["total_reads"] == len(reads)
    assert values(out) == host_values(index, reads, cfg)


def test_stats_start_clean_each_call():
    """``DEVICE_MAP_STATS`` is cleared in place at each call's start: a v2
    call after a v1 call on the same store carries none of the v1 call's
    keys."""
    stats = mt.DEVICE_MAP_STATS
    port = port_side(*repeat_stores(seed=54))
    mt.map_all_with_device(*port, max_per_hit=31, device="cpu")
    assert stats["v2"] is False and {"index_entries", "v1_setup_s"} <= set(stats)
    mt.map_all_with_device(*port, device="cpu")
    assert mt.DEVICE_MAP_STATS is stats and stats["v2"] is True
    assert not {"index_entries", "v1_setup_s"} & set(stats)


def test_v2_without_the_native_library_matches(monkeypatch):
    """Without the native library the v2 batches are packed from the
    shared codes fill and ``pack_codes``, tier 2's too: the same mappings
    and counters as with it."""
    unitigs, reads = sim_stores(56, 12_000, 5.0, 1_500)
    kw = dict(batch_reads=16, max_pos=64, device="cpu")
    with_lib = mt.map_all_with_device(*port_side(unitigs, reads), **kw)
    want = stats_subset()
    assert want["tier2_reads"] > 0
    packs = []
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(mt, "pack_codes", lambda *a, **k: packs.append(1) or pack_codes(*a, **k))
    assert mt.map_all_with_device(*port_side(unitigs, reads), **kw) == with_lib
    assert stats_subset() == want
    assert len(packs) == mt.DEVICE_MAP_STATS["eager_batches"] > 0  # every batch, once


def test_one_store_through_both_packages(one_jax_device):
    """The JAX and the port's batch caches live in separate attributes: a
    port store that the JAX package maps too, in turns, gets each package
    its own arrays."""
    unitigs, jax_reads = sim_stores(55, 12_000, 5.0, 2_000)
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    p_index, reads, p_cfg = port_side(unitigs, jax_reads)
    j1 = jax_mapper.map_all_with_device(index, reads, cfg)
    t1 = mt.map_all_with_device(p_index, reads, p_cfg, device="cpu")
    j2 = jax_mapper.map_all_with_device(index, reads, cfg)
    t2 = mt.map_all_with_device(p_index, reads, p_cfg, device="cpu")
    assert values(j1) == values(t1) == values(j2) == values(t2)
    assert reads._dev_batch_cache and getattr(reads, mt._CACHE_ATTR)["cpu"][1]
    for tensors, _sz in getattr(reads, mt._CACHE_ATTR)["cpu"][1].values():
        assert all(isinstance(t, torch.Tensor) for t in tensors)
    for arrays, _sz in reads._dev_batch_cache.values():
        assert not any(isinstance(a, torch.Tensor) for a in arrays)
