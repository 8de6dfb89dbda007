"""The port's mesh and sharded steps (``muchsalsa_tpu_torch/parallel/``)
against the JAX package's ``shard_map`` steps.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh lists ``torch.device("cpu")`` as often as the JAX mesh has
devices, and where a caller builds its own mesh (the mapper, the core's
driver) ``parallel.mesh.visible_devices`` is replaced by that list.  Inputs
are made with numpy from seeds and go through both packages.  Tolerance:
every score, backpointer, distance, hit field, count and output byte exact;
the float64 score sum of ``sharded_chain_dp``'s stats to a relative 1e-12
(the port sums its shards in another order than XLA's ``psum``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.assemble.driver import assemble as jax_assemble
from muchsalsa_tpu.assemble.driver import build_graph, chaining_phase
from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.matching.edges import build_edges
from muchsalsa_tpu.matching.edges_jax import build_edges_device as jax_build_edges_device
from muchsalsa_tpu.ops import mapping_jax as mj
from muchsalsa_tpu.ops import minimizer_jax
from muchsalsa_tpu.ops.align import pack_problems as jax_pack_problems
from muchsalsa_tpu.ops.chaining_jax import chaining_phase_device as jax_chaining_phase_device
from muchsalsa_tpu.parallel import sharded as jax_sharded
from muchsalsa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from muchsalsa_tpu.pipeline import mapper as jax_mapper
from muchsalsa_tpu.testing.simulate import add_noise, simulate
from muchsalsa_tpu.utils.seq import encode_2bit
from muchsalsa_tpu_torch.assemble import host as port_host
from muchsalsa_tpu_torch.assemble.driver import assemble
from muchsalsa_tpu_torch.config import MapperConfig as PortMapperConfig
from muchsalsa_tpu_torch.matching.edges import build_edges as port_build_edges
from muchsalsa_tpu_torch.matching.edges_torch import build_edges_device
from muchsalsa_tpu_torch.ops import mapping_torch as mt
from muchsalsa_tpu_torch.ops import minimizer_torch
from muchsalsa_tpu_torch.ops.align_torch import pack_problems
from muchsalsa_tpu_torch.ops.chaining_torch import chaining_phase_device
from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
from muchsalsa_tpu_torch.parallel import sharded
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch
from muchsalsa_tpu_torch.state import pack_batch
from muchsalsa_tpu_torch.testing.chains import WIGGLE_ROOM, chain_batch
from muchsalsa_tpu_torch.testing.pairs import random_pairs
from tests.test_distributed_core import OUT_FILES, _simulated_inputs
from tests.test_torch_chaining import _stores as chaining_stores
from tests.test_torch_chaining import snapshot
from tests.test_torch_edges import _stores as edge_stores
from tests.test_torch_map_device import port_store, repeat_stores, sim_stores, values

CPU = torch.device("cpu")
SIZES = (2, 4, 8)
MAP_STATS = ("n_devices", "meshed", "batch_reads", "v2", "total_reads", "overflow_reads",
             "dense_repulls", "tier2_reads")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: its shards are
    small, and an op's thread pool slows it many times over when test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(n: int) -> mesh_mod.Mesh:
    return mesh_mod.make_mesh(devices=[CPU] * n)


@pytest.fixture
def cpu_devices(monkeypatch):
    """``visible_devices`` listing the CPU n times: the mapper and the
    core's driver then build a mesh of n shards."""
    def use(n):
        monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [CPU] * n)
    return use


def test_mesh_repeats_devices_and_rejects_none():
    mesh = mesh_mod.make_mesh(3, devices=[CPU] * 5)
    assert mesh.size == 3 and mesh.devices == (CPU,) * 3 and mesh.axis == "reads"
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()
    assert mesh_mod.local_mesh(CPU) is None  # no visible CPU devices


def test_process_group_absent_is_one_process():
    mesh_mod.init_distributed()  # no coordinator: a no-op
    assert (mesh_mod.process_count(), mesh_mod.process_index()) == (1, 0)
    with pytest.raises(ValueError):
        mesh_mod.init_distributed("localhost:1", 2)


def test_replicas_are_one_per_distinct_device():
    t = torch.arange(4)
    reps = sharded.replicate((t,), cpu_mesh(4))
    assert list(reps) == [CPU] and reps[CPU][0] is t


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ("random", "inverted"))
def test_sharded_chain_dp_matches_jax(n, kind):
    assert len(jax.devices()) == 8
    B, K = 32, 16
    batch = chain_batch(B, K, kind, seed=100 * n + len(kind))
    want_s, want_b, want_st = jax_sharded.sharded_chain_dp(
        {k: jnp.asarray(v) for k, v in batch.items()}, WIGGLE_ROOM, jax_make_mesh(n))
    s, b, st = sharded.sharded_chain_dp(*pack_batch(batch), K, WIGGLE_ROOM, cpu_mesh(n))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(b.numpy(), np.asarray(want_b))
    want_st = np.asarray(want_st)
    assert st.dtype == torch.float64 and float(st[0]) == want_st[0] > 0
    np.testing.assert_allclose(float(st[1]), want_st[1], rtol=1e-12)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_myers_matches_jax(n):
    pairs = random_pairs(np.random.default_rng(n), 16, 120)
    want_d, want_total = jax_sharded.sharded_myers(*jax_pack_problems(pairs), jax_make_mesh(n))
    d, total = sharded.sharded_myers(*pack_problems(pairs), cpu_mesh(n))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    assert float(total) == float(want_total) == float(d.sum())


def mapping_data(n_reads=16):
    """The JAX package's and the port's index of one simulated unitig set,
    the reads' (R, L) codes and lengths, and the mapping caps of
    tests/test_parallel.py."""
    rng = np.random.default_rng(77)
    sim = simulate(rng, genome_length=16_000, coverage=4.0, read_length=3_000)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    p_index = port_mapper.MinimizerIndex.build(port_store(unitigs), PortMapperConfig())
    seqs = [add_noise(rng, seq, 0.04) for _, seq in sim.read_records()][:n_reads]
    L = 1024 * -(-max(len(s) for s in seqs) // 1024)
    codes = np.full((len(seqs), L), 4, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_2bit(s)
        lens[i] = len(s)
    caps = dict(k=cfg.k, w=cfg.w, bandwidth=cfg.bandwidth,
                min_anchor_count=cfg.min_anchor_count,
                min_chain_score=cfg.min_chain_score, max_pos=1024, max_per_hit=2)
    return index, p_index, codes, lens, caps


def assert_hits_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_anchor_counts_matches_jax(n):
    index, p_index, codes, lens, caps = mapping_data()
    want, want_st = jax_sharded.sharded_anchor_counts(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(index.hashes), jax_make_mesh(n))
    got, st = sharded.sharded_anchor_counts(
        torch.from_numpy(codes), torch.from_numpy(lens), mt.u32_tensor(p_index.hashes, CPU),
        cpu_mesh(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    assert int(got.sum()) > 0


def test_anchor_counts_match_jax():
    index, p_index, codes, lens, _ = mapping_data()
    jc, jl, tc, tl = jnp.asarray(codes), jnp.asarray(lens), torch.from_numpy(codes), \
        torch.from_numpy(lens)
    exact = minimizer_torch.anchor_counts(tc, tl, mt.u32_tensor(p_index.hashes, CPU))
    np.testing.assert_array_equal(
        exact.numpy(), np.asarray(minimizer_jax.anchor_counts(jc, jl, jnp.asarray(index.hashes))))
    for log2_bits in (28, 12):
        bitmap = minimizer_torch.build_hash_bitmap(p_index.hashes, log2_bits, device=CPU)
        got = minimizer_torch.anchor_counts_bitmap(tc, tl, bitmap, log2_bits=log2_bits)
        want = minimizer_jax.anchor_counts_bitmap(
            jc, jl, minimizer_jax.build_hash_bitmap(index.hashes, log2_bits), log2_bits=log2_bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got >= exact).all()
    empty = torch.zeros(0, dtype=torch.int64)
    assert not minimizer_torch.anchor_counts(tc, tl, empty).any()


@pytest.mark.parametrize("n", SIZES)
def test_sharded_map_reads_v1_matches_jax(n):
    index, p_index, codes, lens, caps = mapping_data()
    bitmap, rank, rounds = mj.build_join_tables(index.hashes)
    jax_idx = (jnp.asarray(index.hashes), jnp.asarray(index.offsets.astype(np.int32)),
               jnp.asarray(index.entry_unitig), jnp.asarray(index.entry_pos),
               jnp.asarray(index.entry_strand), bitmap, rank)
    want, want_st = jax_sharded.sharded_map_reads(
        jnp.asarray(codes), jnp.asarray(lens), jax_idx, jax_make_mesh(n), join_rounds=rounds,
        **caps)
    p_bitmap, p_rank, p_rounds = mt.build_join_tables(p_index.hashes, device=CPU)
    port_idx = (mt.u32_tensor(p_index.hashes, CPU),
                torch.from_numpy(p_index.offsets.astype(np.int32)),
                torch.from_numpy(p_index.entry_unitig), torch.from_numpy(p_index.entry_pos),
                torch.from_numpy(p_index.entry_strand), p_bitmap, p_rank)
    got, st = sharded.sharded_map_reads(torch.from_numpy(codes), torch.from_numpy(lens),
                                        port_idx, cpu_mesh(n), join_rounds=p_rounds, **caps)
    assert_hits_equal(got, want)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    assert float(st[1]) > 0


def v2_inputs():
    index, p_index, codes, lens, caps = mapping_data()
    tables, takes = mj.build_device_tables(index.hashes, index.offsets, index.entry_unitig,
                                           index.entry_pos, index.entry_strand)
    p_tables, p_takes = mt.build_device_tables(
        p_index.hashes, p_index.offsets, p_index.entry_unitig, p_index.entry_pos,
        p_index.entry_strand, device=CPU)
    assert takes == p_takes
    caps = dict(caps, hash_takes=takes, max_sel=2048, trim=512)
    return codes, lens, tables, p_tables, caps


@pytest.mark.parametrize("packed", (False, True))
def test_map_reads_device_v2_matches_jax(packed):
    codes, lens, tables, p_tables, caps = v2_inputs()
    if packed:
        want = mj.map_reads_device_v2_packed(*map(jnp.asarray, mj.pack_codes(codes)),
                                             jnp.asarray(lens), *tables, **caps)
        got = mt.map_reads_device_v2_packed(*mt.pack_codes(codes, device=CPU),
                                            torch.from_numpy(lens), *p_tables, **caps)
    else:
        want = mj.map_reads_device_v2(jnp.asarray(codes), jnp.asarray(lens), *tables, **caps)
        got = mt.map_reads_device_v2(torch.from_numpy(codes), torch.from_numpy(lens),
                                     *p_tables, **caps)
    assert_hits_equal(got, want)
    assert int(got["n_hits"].sum()) > 0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("packed", (False, True))
def test_sharded_map_reads_v2_matches_jax(n, packed):
    codes, lens, tables, p_tables, caps = v2_inputs()
    if packed:
        want, want_st = jax_sharded.sharded_map_reads_v2_packed(
            *map(jnp.asarray, mj.pack_codes(codes)), jnp.asarray(lens), tables,
            jax_make_mesh(n), **caps)
        got, st = sharded.sharded_map_reads_v2_packed(
            *mt.pack_codes(codes, device=CPU), torch.from_numpy(lens), p_tables, cpu_mesh(n),
            **caps)
    else:
        want, want_st = jax_sharded.sharded_map_reads_v2(
            jnp.asarray(codes), jnp.asarray(lens), tables, jax_make_mesh(n), **caps)
        got, st = sharded.sharded_map_reads_v2(
            torch.from_numpy(codes), torch.from_numpy(lens), p_tables, cpu_mesh(n), **caps)
    assert_hits_equal(got, want)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))


def test_a_leading_axis_that_does_not_divide_raises():
    batch = chain_batch(12, 8, "random", seed=1)
    with pytest.raises(ValueError, match="does not divide"):
        sharded.sharded_chain_dp(*pack_batch(batch), 8, WIGGLE_ROOM, cpu_mesh(8))
    pairs = random_pairs(np.random.default_rng(0), 6, 40)
    with pytest.raises(ValueError, match="does not divide"):
        sharded.sharded_myers(*pack_problems(pairs), cpu_mesh(4))


@pytest.mark.parametrize("n", (3, 8))
def test_meshed_edges_match_jax(tmp_path, n):
    store, p_store = edge_stores(tmp_path)
    want = jax_build_edges_device(store, mesh=jax_make_mesh(n))
    got = build_edges_device(p_store, device="cpu", mesh=cpu_mesh(n))
    assert got.n_edges > 0
    for field in ("edge_v", "edge_w", "em_edge", "em_illu", "em_ov_start", "em_ov_end",
                  "em_direction", "em_score", "em_primary", "em_line"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


@pytest.mark.parametrize("n", (3, 8))
def test_meshed_chaining_matches_jax(tmp_path, monkeypatch, n):
    """Identical chains, and each bucket's B the JAX package's: the power of
    two rounded up to a multiple of the mesh size."""
    store, p_store = chaining_stores("simulated", 99, tmp_path)
    jax_batches = {}
    jax_step = jax_sharded.sharded_chain_dp

    def recording(batch, wiggle_room, mesh, **kw):
        B, K = batch["valid"].shape
        jax_batches[K] = B
        return jax_step(batch, wiggle_room, mesh, **kw)

    monkeypatch.setattr(jax_sharded, "sharded_chain_dp", recording)
    em = build_edges(store)
    g_jax = build_graph(store, em)
    jax_chaining_phase_device(g_jax, store, em, 300, min_device_batch=1, mesh=jax_make_mesh(n))
    g_host = build_graph(store, em)
    chaining_phase(g_host, store, em, 300)

    p_em = port_build_edges(p_store)
    g_port = port_host.build_graph(p_store, p_em)
    placed = chaining_phase_device(g_port, p_store, p_em, 300, min_device_batch=1,
                                   device="cpu", mesh=cpu_mesh(n))
    assert snapshot(g_port) == snapshot(g_jax) == snapshot(g_host)
    assert placed["batches"] == jax_batches
    assert all(B % n == 0 for B in placed["batches"].values())
    if n == 3:
        assert any(B & (B - 1) for B in placed["batches"].values())  # not a power of two


@pytest.mark.parametrize("data", ("sim", "repeat"))
def test_meshed_device_mapping_matches_jax(cpu_devices, data):
    """``map_all_with_device`` over a mesh of 8 against the JAX package's,
    which is meshed over the 8 virtual devices: identical mappings and
    counters (the repeat set sends reads past a budget to the host)."""
    unitigs, reads = sim_stores(50, 15_000, 4.0, 2_000) if data == "sim" else repeat_stores()
    cfg = MapperConfig()
    index = jax_mapper.MinimizerIndex.build(unitigs, cfg)
    want = jax_mapper.map_all_with_device(index, reads, cfg)
    want_stats = {k: jax_mapper.DEVICE_MAP_STATS[k] for k in MAP_STATS}
    cpu_devices(8)
    p_cfg = PortMapperConfig()
    p_index = port_mapper.MinimizerIndex.build(port_store(unitigs), p_cfg)
    got = mapper_torch.map_all_with_device(p_index, port_store(reads), p_cfg, device="cpu")
    assert values(got) == values(want)
    assert {k: mapper_torch.DEVICE_MAP_STATS[k] for k in MAP_STATS} == want_stats
    assert want_stats["meshed"] and want_stats["n_devices"] == 8
    assert want_stats["tier2_reads"] == 0
    assert (want_stats["overflow_reads"] > 0) == (data == "repeat")


def test_meshed_and_distributed_core_match_jax(tmp_path, cpu_devices):
    """The port's core with a mesh of 8 against the JAX package's (meshed
    over its 8 devices), and through the distributed branch with one
    process and an identity allgather: the same three files, the mesh
    counted."""
    paf, unitigs_fa, reads_fa = _simulated_inputs(tmp_path)
    jax_assemble(paf, unitigs_fa, reads_fa, tmp_path / "jax", workers=1)
    seq = assemble(paf, unitigs_fa, reads_fa, tmp_path / "seq", workers=1, device="cpu")
    dist = assemble(paf, unitigs_fa, reads_fa, tmp_path / "dist", process_index=0,
                    process_count=1, allgather=lambda x: x, device="cpu")
    cpu_devices(8)
    meshed = assemble(paf, unitigs_fa, reads_fa, tmp_path / "meshed", workers=1, device="cpu")
    for name in OUT_FILES:
        want = (tmp_path / "jax" / name).read_bytes()
        for run in ("seq", "dist", "meshed"):
            assert (tmp_path / run / name).read_bytes() == want, (run, name)
    counters = meshed["timer"].counters
    assert seq["timer"].counters["mesh_devices"] == 0 and counters["mesh_devices"] == 8
    assert dist["paths"] == seq["paths"] >= 2
    batches = {k: v for k, v in counters.items() if k.startswith("chain_batch_k")}
    assert batches and batches == {k: v for k, v in seq["timer"].counters.items()
                                   if k.startswith("chain_batch_k")}
