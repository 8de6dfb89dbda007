"""The port's v1 join (occupancy bitmap, rank table, ``map_reads_device``
and the mapper's v1 pass) against the JAX package's.

Hashes, simulated genomes and repeat sets are made with numpy from seeds;
the same arrays go through the JAX function (CPU) and its port (CPU
tensors).  Tolerance: exact equality of every bit, every field and every
counter.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.ops import mapping_jax as mj
from muchsalsa_tpu.ops import minimizer_jax
from muchsalsa_tpu.pipeline import mapper as jax_mapper
from muchsalsa_tpu.testing.simulate import add_noise, random_genome, simulate
from muchsalsa_tpu.utils.seq import encode_2bit
from muchsalsa_tpu_torch.config import MapperConfig as PortMapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore as PortStore
from muchsalsa_tpu_torch.ops import mapping_torch as mt
from muchsalsa_tpu_torch.ops import minimizer_torch
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch

MASK32 = 2**32 - 1


def bitmap_bits(t: torch.Tensor) -> np.ndarray:
    """The port's int32 bitmap words as the JAX package's uint32 words."""
    return t.numpy().view(np.uint32)


def edge_hashes():
    """0 and 2**32 - 1, and hashes that fold onto one bit of the 28-bit
    bitmap (equal in their low 28 bits), beside random ones, sorted."""
    rng = np.random.default_rng(3)
    low = rng.integers(0, 1 << 28, 40, dtype=np.uint64)
    same_bit = np.concatenate([low, low + (1 << 28), low + (5 << 28), low + (15 << 28)])
    rand = rng.integers(0, 1 << 32, 2_000, dtype=np.uint64)
    h = np.concatenate([[0, MASK32, (1 << 28) - 1, 1 << 28], same_bit, rand])
    return np.unique(h.astype(np.uint32))


@pytest.mark.parametrize("log2_bits", (28, 12, 5))
@pytest.mark.parametrize("case", ("edges", "random", "empty"))
def test_build_hash_bitmap_matches_jax(case, log2_bits):
    if case == "edges":
        h = edge_hashes()
    elif case == "random":
        h = np.unique(np.random.default_rng(4).integers(0, 1 << 32, 50_000, dtype=np.uint64)
                      .astype(np.uint32))
    else:
        h = np.zeros(0, np.uint32)
    want = np.asarray(minimizer_jax.build_hash_bitmap(h, log2_bits))
    got = minimizer_torch.build_hash_bitmap(h, log2_bits, device="cpu")
    assert got.shape == want.shape == (1 << (log2_bits - 5),)
    np.testing.assert_array_equal(bitmap_bits(got), want)
    if case == "edges" and log2_bits == 28:
        assert bitmap_bits(got)[0] & 1 and bitmap_bits(got)[-1] >> 31
        # 160 hashes folded onto 40 bits: each of those bits set once
        assert int(np.unpackbits(want.view(np.uint8)).sum()) < len(h)


def test_bitmap_probe_reads_every_bit():
    """An arithmetic shift of an int32 word and ``& 1`` reads bit 31 too."""
    h = edge_hashes()
    bitmap = minimizer_torch.build_hash_bitmap(h, device="cpu")
    folded = torch.from_numpy(h.astype(np.int64)) & ((1 << 28) - 1)
    probe = (bitmap[folded >> 5].to(torch.int64) >> (folded & 31)) & 1
    assert bool(probe.all())
    unset = folded ^ 1  # a neighbouring bit that no hash sets
    present = set(folded.tolist())
    miss = torch.tensor([f for f in unset.tolist() if f not in present])
    assert not bool(((bitmap[miss >> 5].to(torch.int64) >> (miss & 31)) & 1).any())


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


def adversarial_stores():
    """tests/test_mapping_jax.py::test_device_mapper_random_adversarial."""
    rng = np.random.default_rng(46)
    store = SequenceStore()
    rep = random_genome(rng, 250)
    for i in range(30):
        g = random_genome(rng, int(rng.integers(300, 900)))
        if i % 3 == 0:
            g = g[:100] + rep + g[100:]  # planted repeat
        store.add(f"u{i}", g)
    reads = SequenceStore()
    for i in range(20):
        seq = store.sequence(int(rng.integers(0, 30)))
        s = int(rng.integers(0, max(1, len(seq) - 200)))
        reads.add(f"r{i}", seq[s : s + int(rng.integers(150, 400))])
    reads.add("rep_read", rep + rep)  # hits the repeat everywhere
    return store, reads


def six_copies():
    """tests/test_mapping_jax.py::test_device_mapper_overflow_flag: every
    minimizer of the read has six index entries."""
    unit = random_genome(np.random.default_rng(10), 400)
    store = SequenceStore()
    for i in range(6):
        store.add(f"u{i}", unit)
    reads = SequenceStore()
    reads.add("r0", unit)
    return store, reads


def no_hits():
    """tests/test_mapping_jax.py::test_device_mapper_no_hits_and_empty."""
    store = SequenceStore()
    store.add("u0", random_genome(np.random.default_rng(9), 1500))
    reads = SequenceStore()
    reads.add("r0", random_genome(np.random.default_rng(777), 3000))
    reads.add("r1", b"ACGT")  # shorter than k
    reads.add("r2", b"")
    return store, reads


@pytest.fixture(scope="module")
def sim_data():
    return sim_stores(42, 30_000, 6.0, 5_000, noise=0.05)


@pytest.fixture(scope="module")
def sim_data_b():
    return sim_stores(43, 20_000, 5.0, 4_000)


def test_build_join_tables_matches_jax(sim_data):
    index = jax_mapper.MinimizerIndex.build(sim_data[0], MapperConfig())
    j_bitmap, j_rank, j_rounds = mj.build_join_tables(index.hashes)
    bitmap, rank, rounds = mt.build_join_tables(index.hashes, device="cpu")
    assert rounds == j_rounds
    assert rank.dtype == torch.int32 and rank.shape == (2**mt.RANK_LOG2 + 1,)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
    np.testing.assert_array_equal(bitmap_bits(bitmap), np.asarray(j_bitmap))


@pytest.mark.parametrize("case", ("crowded_bucket", "edges", "empty"))
def test_build_join_tables_rank_and_rounds(case):
    if case == "crowded_bucket":
        # 300 hashes in one rank bucket: 9 rounds
        h = (np.uint32(77) << np.uint32(32 - mt.RANK_LOG2)) | np.arange(300, dtype=np.uint32)
    elif case == "edges":
        h = edge_hashes()
    else:
        h = np.zeros(0, np.uint32)
    _, j_rank, j_rounds = mj.build_join_tables(h)
    _, rank, rounds = mt.build_join_tables(h, device="cpu")
    assert rounds == j_rounds
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))
    if case == "crowded_bucket":
        assert rounds == 9


def codes_of(seqs):
    L = max(max(len(s) for s in seqs), 32)
    codes = np.full((len(seqs), L), 4, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_2bit(s)
        lens[i] = len(s)
    return codes, lens


def both_v1(store, reads, join, log2_bits=28, **caps):
    """``map_reads_device`` of both packages on the same codes and index:
    ``join`` is "plain" (no bitmap), "bitmap" or "rank" (bitmap and the
    rank-bounded search).  Returns (JAX dict, port dict) as numpy."""
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(store, cfg)
    codes, lens = codes_of([s for _, s in reads.items()])
    arrays = (index.hashes, index.offsets.astype(np.int32), index.entry_unitig,
              index.entry_pos, index.entry_strand)
    kw = dict(k=cfg.k, w=cfg.w, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
              min_chain_score=cfg.min_chain_score, log2_bits=log2_bits, **caps)
    j_bitmap = j_rank = t_bitmap = t_rank = None
    rounds = 0
    if join != "plain":
        j_bitmap = minimizer_jax.build_hash_bitmap(index.hashes, log2_bits)
        t_bitmap = minimizer_torch.build_hash_bitmap(index.hashes, log2_bits, device="cpu")
    if join == "rank":
        _, j_rank, rounds = mj.build_join_tables(index.hashes)
        _, t_rank, t_rounds = mt.build_join_tables(index.hashes, device="cpu")
        assert t_rounds == rounds
    want = mj.map_reads_device(jnp.asarray(codes), jnp.asarray(lens),
                               *map(jnp.asarray, arrays), j_bitmap, j_rank,
                               join_rounds=rounds, **kw)
    got = mt.map_reads_device(torch.from_numpy(codes), torch.from_numpy(lens),
                              mt.u32_tensor(arrays[0], "cpu"),
                              *(torch.from_numpy(a) for a in arrays[1:]), t_bitmap, t_rank,
                              join_rounds=rounds, **kw)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_fields_equal(want, got):
    assert set(got) == set(want) == {*mt.HIT_FIELDS, "n_hits", "overflow"}
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key].astype(got[key].dtype), err_msg=key)


@pytest.mark.parametrize("join", ("plain", "bitmap", "rank"))
def test_map_reads_device_matches_jax_on_simulated_reads(sim_data, join):
    want, got = both_v1(*sim_data, join, max_pos=2048, max_per_hit=2)
    assert_fields_equal(want, got)
    assert not got["overflow"].any() and got["n_hits"].sum() > len(got["n_hits"])


@pytest.mark.parametrize("join", ("plain", "bitmap", "rank"))
def test_map_reads_device_matches_jax_with_trim(sim_data_b, join):
    """The mapper's budgets: max_per_hit 4 and the anchor trim."""
    want, got = both_v1(*sim_data_b, join, max_pos=1024, max_per_hit=4, trim=1024)
    assert_fields_equal(want, got)


@pytest.mark.parametrize("mph", (4, 8))
@pytest.mark.parametrize("join", ("plain", "rank"))
def test_map_reads_device_overflow_flag_matches_jax(mph, join):
    want, got = both_v1(*six_copies(), join, max_per_hit=mph)
    assert_fields_equal(want, got)
    assert bool(got["overflow"][0]) == (mph == 4)
    if mph == 8:
        assert got["n_hits"][0] == 6


@pytest.mark.parametrize("join", ("plain", "rank"))
def test_map_reads_device_no_hits_and_empty_reads_match_jax(join):
    want, got = both_v1(*no_hits(), join)
    assert_fields_equal(want, got)
    assert got["n_hits"].tolist() == [0, 0, 0] and not got["overflow"].any()


@pytest.mark.parametrize("join", ("plain", "bitmap", "rank"))
def test_map_reads_device_random_adversarial_matches_jax(join):
    store, reads = adversarial_stores()
    want, got = both_v1(store, reads, join, max_pos=512, max_per_hit=4)
    assert_fields_equal(want, got)
    assert got["overflow"][-1] and (~got["overflow"]).sum() >= 15


def test_bitmap_false_positives_take_slots_as_in_jax(sim_data):
    """With a 10-bit bitmap most probes are false positives: they count in
    n_cand and take compaction slots, so reads overflow that the exact
    prefilter keeps; the port flags the same reads as the JAX package."""
    caps = dict(max_pos=1024, max_per_hit=2)
    want, got = both_v1(*sim_data, "rank", log2_bits=10, **caps)
    assert_fields_equal(want, got)
    _, exact = both_v1(*sim_data, "plain", **caps)
    assert not exact["overflow"].any() and got["overflow"].sum() > len(got["overflow"]) // 2


# ---------------------------------------------------------------------------
# map_all_with_device on the v1 path


def port_store(store):
    out = PortStore()
    for rid, seq in store.items():
        out.add(store.registry.name(rid), seq)
    return out


def port_side(unitigs, reads):
    cfg = PortMapperConfig()
    return port_mapper.MinimizerIndex.build(port_store(unitigs), cfg), port_store(reads), cfg


def values(per_read):
    return [(rid, [dataclasses.astuple(m) for m in maps]) for rid, maps in per_read]


def counters():
    return {k: mapper_torch.DEVICE_MAP_STATS[k] for k in mapper_torch._COUNT_KEYS}


@pytest.fixture
def no_v2_tables(monkeypatch):
    """Both mappers refuse the v2 tables, as for an index past their
    packing bounds."""
    monkeypatch.setattr(mj, "build_device_tables", lambda *a, **k: None)
    monkeypatch.setattr(mapper_torch, "build_device_tables", lambda *a, **k: None)


def repeat_reads(seed=54, copies=6, rep_len=300):
    """Unitigs sharing one repeat, reads of the bare repeat, unique reads."""
    rng = np.random.default_rng(seed)
    rep = random_genome(rng, rep_len)
    store = SequenceStore()
    for i in range(copies):
        g = random_genome(rng, 1200)
        store.add(f"u{i}", g[:200] + rep + g[200:])
    reads = SequenceStore()
    for i in range(4):
        reads.add(f"rep{i}", add_noise(rng, rep, 0.02))
    for i in range(copies):
        reads.add(f"uniq{i}", store.sequence(i)[600:1400])
    reads.add("tiny", b"ACGTAC")
    return store, reads


@pytest.mark.parametrize("case", ("sim", "repeats"))
def test_map_all_with_device_v1_at_cap_31_matches_jax(case):
    """max_per_hit 31 is past the v2 count saturation: both mappers run
    the v1 join without any patch."""
    unitigs, reads = sim_stores(45, 25_000, 5.0, 4_000) if case == "sim" else repeat_reads()
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    want = jax_mapper.map_all_with_device(index, reads, cfg, max_per_hit=31)
    want_stats = {k: jax_mapper.DEVICE_MAP_STATS[k] for k in mapper_torch._COUNT_KEYS}
    assert jax_mapper.DEVICE_MAP_STATS["v2"] is False
    got = mapper_torch.map_all_with_device(*port_side(unitigs, reads), max_per_hit=31,
                                           device="cpu")
    assert mapper_torch.DEVICE_MAP_STATS["v2"] is False
    assert values(got) == values(want)
    assert counters() == want_stats
    assert sum(len(maps) for _, maps in got) > len(got) // 2


@pytest.mark.parametrize("mph", (2, 4))
def test_map_all_with_device_v1_overflow_matches_jax(no_v2_tables, mph):
    """With the v2 tables refused, reads over a repeat in six unitigs break
    the cap and go to the host mapper, counted as the JAX package counts
    them; there is no tier 2 and no dense pull."""
    unitigs, reads = repeat_reads()
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    kw = dict(max_pos=512, max_per_hit=mph)
    want = jax_mapper.map_all_with_device(index, reads, cfg, **kw)
    want_stats = {k: jax_mapper.DEVICE_MAP_STATS[k] for k in mapper_torch._COUNT_KEYS}
    got = mapper_torch.map_all_with_device(*port_side(unitigs, reads), device="cpu", **kw)
    stats = dict(mapper_torch.DEVICE_MAP_STATS)
    assert values(got) == values(want)
    assert counters() == want_stats
    assert stats["v2"] is False and stats["tier2_reads"] == stats["dense_repulls"] == 0
    assert 4 <= stats["overflow_reads"] < stats["total_reads"]
    # the index's size and the walls of the join's set-up and of the host
    # mapper's call on the flagged reads
    assert stats["index_entries"] == int(index.offsets[-1]) > 0
    assert stats["v1_setup_s"] >= 0 and stats["host_map_s"] > 0
    assert values(got) == [(rid, [dataclasses.astuple(m) for m in jax_mapper.map_read(
        index, seq, cfg)]) for rid, seq in reads.items()]


def test_map_all_v1_paf_matches_jax(no_v2_tables):
    """map_all(device=True) of both packages on the v1 path: the same PAF
    lines, which equal host mapping's, over several length buckets and
    more than one batch."""
    unitigs, reads = sim_stores(50, 15_000, 6.0, 2_000, noise=0.05)
    reads.add("long", add_noise(np.random.default_rng(2), b"".join(
        unitigs.sequence(i) for i in unitigs.ids()[:6]), 0.03))
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    names = dict(unitig_names=lambda u: unitigs.registry.name(u),
                 read_names=lambda r: reads.registry.name(r))
    want = jax_mapper.map_all(index, reads, cfg, device=True, **names)
    want_stats = {k: jax_mapper.DEVICE_MAP_STATS[k] for k in mapper_torch._COUNT_KEYS}
    p_index, p_reads, p_cfg = port_side(unitigs, reads)
    got = mapper_torch.map_all(p_index, p_reads, p_cfg, device=True, torch_device="cpu",
                               **names)
    assert got == want and len(got) > 50
    assert counters() == want_stats
    assert got == mapper_torch.map_all(p_index, p_reads, p_cfg, device=False, **names)
    batched = mapper_torch.map_all_with_device(p_index, p_reads, p_cfg, batch_reads=8,
                                               device="cpu")
    assert values(batched) == values((rid, jax_mapper.map_read(index, seq, cfg))
                                     for rid, seq in reads.items())


def test_v1_refuses_offsets_past_int32(no_v2_tables):
    unitigs, reads = repeat_reads()
    index, p_reads, cfg = port_side(unitigs, reads)
    index = dataclasses.replace(index, offsets=index.offsets.astype(np.int64) + 2**31)
    with pytest.raises(ValueError, match="int32"):
        mapper_torch.map_all_with_device(index, p_reads, cfg, device="cpu")


def test_v1_on_an_empty_index_maps_to_nothing():
    """An index of no hash (every unitig shorter than k) is refused by the
    v2 tables; the v1 join maps every read to nothing, as ``map_read``
    does.  (The JAX ``map_reads_device`` cannot gather from an empty
    index and raises.)"""
    unitigs = SequenceStore()
    unitigs.add("u0", b"ACGTACGT")
    reads = SequenceStore()
    reads.add("r0", random_genome(np.random.default_rng(5), 800))
    reads.add("r1", b"ACG")
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    assert len(index.hashes) == 0
    got = mapper_torch.map_all_with_device(*port_side(unitigs, reads), device="cpu")
    assert values(got) == [(rid, jax_mapper.map_read(index, seq, cfg))
                           for rid, seq in reads.items()] == [(0, []), (1, [])]
    assert mapper_torch.DEVICE_MAP_STATS["v2"] is False
    assert counters() == {"total_reads": 2, "overflow_reads": 0, "tier2_reads": 0,
                          "dense_repulls": 0}
