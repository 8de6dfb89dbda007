"""The port's v2 device mapper, stage by stage, against the JAX package's.

Simulated genomes and adversarial repeat sets (numpy, from seeds) are
indexed by the host ``MinimizerIndex``; the same packed reads go through
each JAX jit (CPU) and its torch twin (CPU tensors), each stage fed the
same inputs.  Tolerance: exact equality.  The JAX sort is unstable, so
payloads of padding slots (key I32_MAX) are compared on valid slots only;
every output a caller reads is compared in full.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.ops import mapping_jax as mj
from muchsalsa_tpu.pipeline.mapper import (
    MinimizerIndex, device_bucket_budgets, device_bucket_len, map_read)
from muchsalsa_tpu.testing.simulate import add_noise, random_genome, simulate
from muchsalsa_tpu.utils.seq import encode_2bit
from muchsalsa_tpu_torch.ops import mapping_torch as mt
from muchsalsa_tpu_torch.ops.minimizer_torch import minimizer_sketch

I32_MAX = 2**31 - 1


def codes_of(seqs, L):
    codes = np.full((len(seqs), L), 4, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_2bit(s)
        lens[i] = len(s)
    return codes, lens


def tables_of(index, device="cpu"):
    args = (index.hashes, index.offsets, index.entry_unitig, index.entry_pos,
            index.entry_strand)
    return mj.build_device_tables(*args), mt.build_device_tables(*args, device=device)


def np64(x):
    return np.asarray(x).astype(np.int64)


def t64(x):
    return torch.from_numpy(np64(x))


def sim_case(seed=42, genome_length=30_000, coverage=6.0, read_length=5_000, noise=0.05):
    rng = np.random.default_rng(seed)
    sim = simulate(rng, genome_length=genome_length, coverage=coverage, read_length=read_length)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = SequenceStore()
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, noise))
    return unitigs, reads


def adversarial_case():
    """tests/test_mapping_jax.py::test_device_mapper_v2_random_adversarial."""
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


@pytest.fixture(scope="module")
def sim_data():
    unitigs, reads = sim_case()
    cfg = MapperConfig()
    return unitigs, reads, cfg, MinimizerIndex.build(unitigs, cfg)


@pytest.fixture(scope="module")
def adv_data():
    store, reads = adversarial_case()
    cfg = MapperConfig()
    return store, reads, cfg, MinimizerIndex.build(store, cfg)


def test_pack_codes_matches_jax_and_round_trips():
    rng = np.random.default_rng(48)
    R, L = 7, 1024
    codes = np.full((R, L), 4, dtype=np.uint8)
    for i in range(R):
        n = int(rng.integers(1, L))
        codes[i, :n] = rng.integers(0, 5, n)  # includes in-read N (=4)
    want = mj.pack_codes(codes)
    got = mt.pack_codes(codes, device="cpu")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np64(a))
    np.testing.assert_array_equal(mt.unpack_codes(*got).numpy(), codes)
    np.testing.assert_array_equal(
        mt.unpack_codes(*got).numpy(), np.asarray(mj.unpack_codes(*map(jnp.asarray, want))))
    with pytest.raises(ValueError):
        mt.pack_codes(codes[:, : L - 8], device="cpu")
    with pytest.raises(ValueError):
        mt.unpack_codes(got[0], got[1][:, :-1])


@pytest.mark.parametrize("case", ("sim", "adversarial", "repeat6"))
def test_build_device_tables_matches_jax(case, sim_data, adv_data):
    if case == "sim":
        index = sim_data[3]
    elif case == "adversarial":
        index = adv_data[3]
    else:
        store = SequenceStore()
        unit = random_genome(np.random.default_rng(10), 400)
        for i in range(6):
            store.add(f"u{i}", unit)
        index = MinimizerIndex.build(store, MapperConfig())
    (want, want_takes), (got, got_takes) = tables_of(index)
    assert got_takes == want_takes
    for name in ("rp", "jrows", "erows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np64(getattr(want, name)),
                                      err_msg=name)
    assert got.rp.dtype == got.jrows.dtype == torch.int64
    if case == "adversarial":
        # single-entry blocks (any offset) beside 8-aligned multi-entry ones
        ecnt = np.diff(index.offsets)
        assert (ecnt == 1).any() and (ecnt > 1).any()


def test_build_device_tables_none_cases():
    # a probe bucket holding 32 distinct hashes (> 31)
    h = (np.uint32(77) << np.uint32(32 - mt.RANK2_LOG2)) | np.arange(32, dtype=np.uint32)
    off = np.arange(33, dtype=np.int64)
    ent = (np.zeros(32, np.int32), np.arange(32, dtype=np.int32), np.zeros(32, bool))
    assert mj.build_device_tables(h, off, *ent) is None
    assert mt.build_device_tables(h, off, *ent, device="cpu") is None
    assert mt.build_device_tables(h[:31], off[:32], *(e[:31] for e in ent),
                                  device="cpu") is not None
    # entry offsets beyond 27 bits (refused before the entries are read)
    big = (np.array([5], np.uint32), np.array([0, 1 << 27], np.int64),
           np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, bool))
    assert mj.build_device_tables(*big) is None
    assert mt.build_device_tables(*big, device="cpu") is None
    # the empty index
    empty = (np.zeros(0, np.uint32), np.zeros(1, np.int64), np.zeros(0, np.int32),
             np.zeros(0, np.int32), np.zeros(0, bool))
    assert mt.build_device_tables(*empty, device="cpu") is None


def run_stages(index, reads, cfg, max_pos_cap=2048, mph=4, hit_budget=None):
    """Every stage of both packages on one batch; each torch stage gets the
    JAX stage's inputs.  Returns {stage: (jax outputs, torch outputs)}."""
    seqs = [s for _, s in reads.items()]
    L = device_bucket_len(max(len(s) for s in seqs))
    sel_L, pos_L, trim_L = device_bucket_budgets(L, cfg.k, max_pos_cap, mph)
    codes, lens = codes_of(seqs, L)
    (jt, takes), (tt, _) = tables_of(index)
    packed, nmask = mj.pack_codes(codes)
    out = {}

    j = mj.sketch_device_packed(jnp.asarray(packed), jnp.asarray(nmask), jnp.asarray(lens),
                                k=cfg.k, w=cfg.w)
    t = minimizer_sketch(mt.unpack_codes(t64(packed), t64(nmask)), torch.from_numpy(lens), cfg.k,
                         cfg.w)
    out["sketch"] = (j, t)

    jsel = mj.select_compact_device_v2(*j, max_sel=sel_L)
    tsel = mt.select_compact_device_v2(*(torch.from_numpy(np.array(a)).to(b.dtype)
                                         for a, b in zip(j, t)), max_sel=sel_L)
    out["select"] = (jsel, tsel)
    skey, h_s, n_sel = (t64(a) for a in jsel)

    jp = mj.probe_candidates_device_v2(*jsel[:2], jt.rp)
    tp = mt.probe_candidates_device_v2(skey, h_s, tt.rp)
    out["probe"] = (jp, tp)

    jc = mj.compact_candidates_device_v2(*jsel[:2], *jp, jsel[2], max_pos=pos_L)
    tc = mt.compact_candidates_device_v2(skey, h_s, t64(jp[0]), torch.from_numpy(np.array(jp[1])),
                                         n_sel, max_pos=pos_L)
    out["compact"] = (jc, tc)

    ja = mj.expand_anchors_device_v2(*jc, jt.jrows, jt.erows, max_per_hit=mph,
                                     hash_takes=takes)
    ckey, h_c, rpv_c = (t64(a) for a in jc[:3])
    ta = mt.expand_anchors_device_v2(ckey, h_c, rpv_c, torch.from_numpy(np.array(jc[3])),
                                     tt.jrows, tt.erows, max_per_hit=mph, hash_takes=takes)
    out["expand"] = (ja, ta)

    anchors_t = tuple(t64(a) if i not in (4,) else torch.from_numpy(np.array(a))
                      for i, a in enumerate(ja))
    tail_kw = dict(k=cfg.k, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
                   min_chain_score=cfg.min_chain_score, max_hits=64, trim=trim_L)
    out["dense"] = (mj.anchors_to_hits_device_dense(*ja, budget=hit_budget, **tail_kw),
                    mt.anchors_to_hits_device_dense(*anchors_t, budget=hit_budget, **tail_kw))
    out["packed"] = (mj.anchors_to_hits_device_packed(*ja, per_hit_cap=mph, **tail_kw),
                     mt.anchors_to_hits_device_packed(*anchors_t, per_hit_cap=mph, **tail_kw))
    return out


def assert_stages_equal(out):
    (j, t) = out["sketch"]
    for name, a, b in zip(("selected", "h", "strand"), j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype), name)

    (j, t) = out["select"]
    valid = np.asarray(j[0]) < I32_MAX
    np.testing.assert_array_equal(t[0].numpy(), np64(j[0]))
    np.testing.assert_array_equal(t[1].numpy()[valid], np64(j[1])[valid])
    np.testing.assert_array_equal(t[2].numpy(), np64(j[2]))

    for name in ("probe", "expand"):
        (j, t) = out[name]
        for i, (a, b) in enumerate(zip(j, t)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype),
                                          f"{name}[{i}]")

    (j, t) = out["compact"]
    valid = np.asarray(j[0]) < I32_MAX
    np.testing.assert_array_equal(t[0].numpy(), np64(j[0]))
    for i in (1, 2):
        np.testing.assert_array_equal(t[i].numpy()[valid], np64(j[i])[valid], f"compact[{i}]")
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))

    for name in ("dense", "packed"):
        (j, t) = out[name]
        np.testing.assert_array_equal(t.numpy(), np64(j), name)
    want = mj.unpack_hits(out["packed"][0], 64)
    got = mt.unpack_hits(out["packed"][1], 64)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]).astype(got[key].dtype), key)


@pytest.mark.parametrize("mph", (2, 4, 16))
def test_stages_match_jax_on_simulated_reads(sim_data, mph):
    _, reads, cfg, index = sim_data
    out = run_stages(index, reads, cfg, mph=mph)
    assert_stages_equal(out)
    assert int((out["compact"][1][0] < I32_MAX).sum()) > 1000  # real candidates


def test_stages_match_jax_on_adversarial_reads(adv_data):
    _, reads, cfg, index = adv_data
    out = run_stages(index, reads, cfg, max_pos_cap=512)
    assert_stages_equal(out)
    assert out["expand"][1][5].max() > 4  # the repeat's entries exceed the cap


def test_dense_tail_small_budget_matches_jax(sim_data):
    """A budget below the batch's hit count truncates the dense rows the
    same way (the mapper then re-pulls through the padded tail)."""
    _, reads, cfg, index = sim_data
    out = run_stages(index, reads, cfg, hit_budget=5)
    assert_stages_equal(out)
    R = len(reads)
    assert out["dense"][1].shape == (3 * R + 9 * 5,)
    assert int(out["dense"][1][:R].clamp(max=64).sum()) > 5


def composed(index, reads, cfg, max_pos_cap=2048, mph=4, L=None):
    """The six port stages composed, as map_all_with_device runs them."""
    seqs = [s for _, s in reads.items()]
    L = L or device_bucket_len(max(len(s) for s in seqs))
    sel_L, pos_L, trim_L = device_bucket_budgets(L, cfg.k, max_pos_cap, mph)
    codes, lens = codes_of(seqs, L)
    tables, takes = mt.build_device_tables(
        index.hashes, index.offsets, index.entry_unitig, index.entry_pos, index.entry_strand,
        device="cpu")
    anchors = mt.anchors_device_v2(
        mt.unpack_codes(*mt.pack_codes(codes, device="cpu")), torch.from_numpy(lens), *tables,
        k=cfg.k, w=cfg.w, max_sel=sel_L, max_pos=pos_L, max_per_hit=mph, hash_takes=takes)
    packed = mt.anchors_to_hits_device_packed(
        *anchors, k=cfg.k, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
        min_chain_score=cfg.min_chain_score, max_hits=64, trim=trim_L, per_hit_cap=mph)
    return [rid for rid, _ in reads.items()], mt.unpack_hits(packed, 64)


def test_anchors_device_v2_frees_the_codes_after_the_sketch(sim_data, monkeypatch):
    """Stages 2-5 run without the caller's temporary (R, L) codes, as when
    stage 1 was a call of its own: a batch's codes are not held through the
    later stages, which set the card's peak."""
    _, reads, cfg, index = sim_data
    seqs = [s for _, s in reads.items()]
    L = device_bucket_len(max(len(s) for s in seqs))
    sel_L, pos_L, _trim = device_bucket_budgets(L, cfg.k, 2048, 4)
    codes, lens = codes_of(seqs, L)
    tables, takes = mt.build_device_tables(
        index.hashes, index.offsets, index.entry_unitig, index.entry_pos, index.entry_strand,
        device="cpu")
    refs, alive = [], []

    def fresh_codes():
        t = mt.unpack_codes(*mt.pack_codes(codes, device="cpu"))
        refs.append(weakref.ref(t))
        return t

    select = mt.select_compact_device_v2

    def select_noting(*args, **kw):
        alive.append(refs[0]() is not None)
        return select(*args, **kw)

    monkeypatch.setattr(mt, "select_compact_device_v2", select_noting)
    got = mt.anchors_device_v2(fresh_codes(), torch.from_numpy(lens), *tables, k=cfg.k, w=cfg.w,
                               max_sel=sel_L, max_pos=pos_L, max_per_hit=4, hash_takes=takes)
    assert alive == [False] and int((got[0] < I32_MAX).sum()) > 0


def assert_matches_host(index, reads, cfg, rids, dev):
    for i, rid in enumerate(rids):
        if dev["overflow"][i]:
            continue
        host = map_read(index, reads.sequence(rid), cfg, use_native=False)
        assert int(dev["n_hits"][i]) == len(host), rid
        for j, m in enumerate(host):
            got = tuple(int(dev[f][i, j]) for f in mt.HIT_FIELDS)
            assert got == (m.unitig, int(m.strand), m.q_start, m.q_end, m.t_start, m.t_end,
                           m.matches, m.n_anchors), (rid, j)


def test_composed_v2_matches_host_on_simulated_reads(sim_data):
    _, reads, cfg, index = sim_data
    rids, dev = composed(index, reads, cfg, mph=2)
    assert not dev["overflow"].any(), "test data exceeded anchor budget"
    assert_matches_host(index, reads, cfg, rids, dev)
    assert dev["n_hits"].sum() > len(rids)


def test_composed_v2_matches_host_on_adversarial_reads(adv_data):
    _, reads, cfg, index = adv_data
    rids, dev = composed(index, reads, cfg, max_pos_cap=512)
    assert dev["overflow"][rids.index(reads.registry["rep_read"])]
    assert (~dev["overflow"]).sum() >= 15
    assert_matches_host(index, reads, cfg, rids, dev)


def test_overflow_flag_on_a_six_times_repeated_unitig():
    unit = random_genome(np.random.default_rng(10), 400)
    store = SequenceStore()
    for i in range(6):  # same sequence 6x -> every minimizer has 6 entries
        store.add(f"u{i}", unit)
    cfg = MapperConfig()
    index = MinimizerIndex.build(store, cfg)
    reads = SequenceStore()
    reads.add("r0", unit)
    _, dev = composed(index, reads, cfg, mph=4)
    assert dev["overflow"][0]
    _, dev = composed(index, reads, cfg, mph=8)
    assert not dev["overflow"][0]
    assert dev["n_hits"][0] == 6


def test_expand_refuses_max_per_hit_31(sim_data):
    _, reads, cfg, index = sim_data
    tables, takes = mt.build_device_tables(
        index.hashes, index.offsets, index.entry_unitig, index.entry_pos, index.entry_strand,
        device="cpu")
    z = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="31"):
        mt.expand_anchors_device_v2(z, z, z, torch.zeros(1, dtype=torch.bool), tables.jrows,
                                    tables.erows, max_per_hit=31, hash_takes=takes)
