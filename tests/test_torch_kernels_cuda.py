"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  This
module imports no JAX, so on a machine with a card and no JAX it runs as
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.
Tolerance: exact equality (bit-equal float64 scores, equal int32
backpointers and distances, and identical output bytes).
"""

import dataclasses
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from muchsalsa_tpu_torch.ops.align_torch import (
    banded_edit_distance, banded_edit_distance_reference, gather_problems,
    gather_problems_reference, pack_problems)
from muchsalsa_tpu_torch.ops.chain_scan import (
    NEG, chain_dp, chain_dp_reference, chain_scan, chain_scan_reference)
from muchsalsa_tpu_torch.ops.myers_torch import (
    myers_banded, myers_banded_reference, myers_edit_distance, myers_edit_distance_reference)
from muchsalsa_tpu_torch.state import pack_batch
from muchsalsa_tpu_torch.testing.chains import KINDS as CHAIN_KINDS
from muchsalsa_tpu_torch.testing.chains import WIGGLE_ROOM, chain_batch, inverted_pair_batch
from muchsalsa_tpu_torch.testing.pairs import (
    GATHER_CASES, band_edge_pairs, gather_case, gather_inputs, gather_scale_inputs, random_pairs,
    scramble_past_lengths, sliced_pairs)

pytestmark = pytest.mark.cuda

BUCKETS = (8, 16, 32, 64, 128)
KINDS = ("random", "all_true", "all_false")


def scan_inputs(B, K, kind, seed):
    """numpy inputs of the chain scan: asymmetric random compat, all-true
    compat with equal (tying) scores, or all-false compat; initial scores
    with -1e30 holes."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        compat = rng.integers(0, 2, (B, K, K), dtype=np.uint8)
        init = rng.integers(400, 1500, (B, K)).astype(np.float64)
    elif kind == "all_true":
        compat = np.ones((B, K, K), dtype=np.uint8)
        init = np.zeros((B, K), dtype=np.float64)
    elif kind == "all_false":
        compat = np.zeros((B, K, K), dtype=np.uint8)
        init = rng.integers(400, 1500, (B, K)).astype(np.float64)
    else:
        raise ValueError(kind)
    init[rng.random((B, K)) < 0.1] = NEG
    return compat, init


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,K", [(B, K) for K in BUCKETS for B in (1, 33, 4096)] + [(65536, 32)])
def test_chain_scan_kernel_matches_reference(cuda, B, K, kind):
    compat, init = scan_inputs(B, K, kind, seed=B + K)
    c = torch.from_numpy(compat).to(cuda)
    i = torch.from_numpy(init).to(cuda)
    before = chain_scan.launches
    s, b = chain_scan(c, i)
    torch.cuda.synchronize()
    assert chain_scan.launches == before + 1
    s_ref, b_ref = chain_scan_reference(c, i)
    assert torch.equal(s, s_ref)
    assert torch.equal(b, b_ref)


def test_chain_scan_kernel_rejects_mixed_devices(cuda):
    compat, init = scan_inputs(4, 8, "random", seed=0)
    with pytest.raises(ValueError):
        chain_scan(torch.from_numpy(compat).to(cuda), torch.from_numpy(init))


@pytest.mark.parametrize("kind", CHAIN_KINDS)
@pytest.mark.parametrize("B,K", [(B, K) for K in BUCKETS for B in (1, 33, 4096)] + [(65536, 32)])
def test_chain_dp_kernel_matches_reference(cuda, B, K, kind):
    packed = [x.to(cuda) for x in pack_batch(chain_batch(B, K, kind, seed=B + K))]
    before = chain_dp.launches
    s, b = chain_dp(*packed, K, WIGGLE_ROOM)
    torch.cuda.synchronize()
    assert chain_dp.launches == before + 1
    s_ref, b_ref = chain_dp_reference(*packed, K, WIGGLE_ROOM)
    assert torch.equal(s, s_ref)
    assert torch.equal(b, b_ref)


def test_chain_dp_kernel_tests_pairs_in_the_oracle_order(cuda):
    """The two anchors whose pair order decides the chain: the kernel, like
    its plain version and the JAX package's chain_dp_batch, chains neither."""
    packed = [x.to(cuda) for x in pack_batch(inverted_pair_batch())]
    s, b = chain_dp(*packed, 8, WIGGLE_ROOM)
    assert s[0, :2].tolist() == [500.0, 700.0] and b[0].tolist() == [-1] * 8
    s_ref, b_ref = chain_dp_reference(*packed, 8, WIGGLE_ROOM)
    assert torch.equal(s, s_ref) and torch.equal(b, b_ref)


def test_chain_dp_kernel_rejects_bad_inputs(cuda):
    fields, flags, offsets = pack_batch(chain_batch(4, 8, "random", seed=0))
    f, g, o = fields.to(cuda), flags.to(cuda), offsets.to(cuda)
    with pytest.raises(ValueError):
        chain_dp(f, flags, o, 8, WIGGLE_ROOM)
    with pytest.raises(TypeError):
        chain_dp(f.float(), g, o, 8, WIGGLE_ROOM)
    with pytest.raises(ValueError):
        chain_dp(f[:, :4].contiguous(), g, o, 8, WIGGLE_ROOM)
    with pytest.raises(ValueError):
        chain_dp(f, g, o, 129, WIGGLE_ROOM)


def test_port_edges_on_card_match_host(cuda, tmp_path):
    from muchsalsa_tpu_torch.io.paf import read_paf
    from muchsalsa_tpu_torch.matching.edges import build_edges
    from muchsalsa_tpu_torch.matching.edges_torch import build_edges_device
    from muchsalsa_tpu_torch.matching.store import MatchStore
    from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation

    sim = simulate(np.random.default_rng(3), genome_length=40_000, coverage=9.0,
                   both_strands=True)
    store = MatchStore.from_paf(read_paf(write_simulation(sim, tmp_path)["paf"]))
    got, ref = build_edges_device(store, device=cuda), build_edges(store)
    assert got.n_edges > 0
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(
            getattr(got, field.name), getattr(ref, field.name), err_msg=field.name)


def golden_inputs(tmp_path):
    """The golden dataset's three inputs and its sha256 values."""
    from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation

    # by path: another installed package named ``tests`` may shadow this
    # directory, which has no __init__.py
    spec = importlib.util.spec_from_file_location(
        "test_golden", Path(__file__).with_name("test_golden.py"))
    test_golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(test_golden)
    sim = simulate(np.random.default_rng(20260817), genome_length=60_000,
                   unitig_length=1_100, unitig_gap=300, read_length=6_000,
                   coverage=9.0, both_strands=True)
    paths = write_simulation(sim, tmp_path / "data")
    return (paths["paf"], paths["unitigs"], paths["reads"]), test_golden.GOLDEN


def device_config(**fields):
    from muchsalsa_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, device=dataclasses.replace(cfg.device, **fields))


def output_bytes(out):
    return {n: (out / n).read_bytes() for n in ("temp_1.target.fa", "temp_1.query.fa",
                                                "temp_1.align.paf")}


def test_port_golden_on_card(cuda, tmp_path):
    from muchsalsa_tpu_torch.assemble.driver import assemble

    inputs, GOLDEN = golden_inputs(tmp_path)
    # gates 0: the golden size is below the card's crossovers
    cfg = device_config(min_device_batch=1, edges_device_min_rows=0, chain_device_min_problems=0)
    before = chain_dp.launches
    assemble(*inputs, tmp_path / "out", cfg, device=cuda)
    assert chain_dp.launches > before
    got = {n: hashlib.sha256((tmp_path / "out" / n).read_bytes()).hexdigest() for n in GOLDEN}
    assert got == GOLDEN


def test_port_gates_on_card(cuda, tmp_path):
    """Both sides of each gate on the golden input at the default config:
    closed, no ``chain_dp`` launch; at 0, launched; the outputs the same."""
    from muchsalsa_tpu_torch.assemble.driver import _on_device, assemble

    inputs, GOLDEN = golden_inputs(tmp_path)
    outs, placed = {}, {}
    for name, thr in (("closed", 10**9), ("open", 0), ("default", None)):
        gates = {} if thr is None else dict(edges_device_min_rows=thr,
                                            chain_device_min_problems=thr)
        cfg = device_config(**gates)
        before = chain_dp.launches
        r = assemble(*inputs, tmp_path / name, cfg, device=cuda)
        c = r["timer"].counters
        placed[name] = (c["edges_on_device"], c["chaining_on_device"],
                        chain_dp.launches - before)
        outs[name] = output_bytes(tmp_path / name)
        if thr is None:
            expect = (_on_device(cfg, c["match_rows"], cfg.device.edges_device_min_rows, cuda),
                      _on_device(cfg, 2 * c["graph_size"],
                                 cfg.device.chain_device_min_problems, cuda))
            assert placed[name][:2] == tuple(map(int, expect))
    assert placed["closed"] == (0, 0, 0)
    assert placed["open"][:2] == (1, 1) and placed["open"][2] > 0
    assert outs["closed"] == outs["open"] == outs["default"]
    got = {n: hashlib.sha256(outs["open"][n]).hexdigest() for n in GOLDEN}
    assert got == GOLDEN


def test_port_profile_on_card_traces_chain_dp(cuda, tmp_path, monkeypatch):
    """``MS_TPU_PROFILE`` on the card: a Chrome trace of the chaining stage
    that holds the ``chain_dp`` kernel; the outputs unchanged."""
    import json

    from muchsalsa_tpu_torch.assemble.driver import assemble

    inputs, GOLDEN = golden_inputs(tmp_path)
    cfg = device_config(min_device_batch=1, edges_device_min_rows=0, chain_device_min_problems=0)
    assemble(*inputs, tmp_path / "plain", cfg, device=cuda)
    monkeypatch.setenv("MS_TPU_PROFILE", str(tmp_path / "trace"))
    assemble(*inputs, tmp_path / "traced", cfg, device=cuda)
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("chain_dp" in k for k in kernels), sorted(set(kernels))[:20]
    assert output_bytes(tmp_path / "traced") == output_bytes(tmp_path / "plain")


ALIGN_SHAPES = [(P, M) for M in (31, 32, 33, 1000) for P in (1, 33, 512)] + [(33, 1100)]
# the exact kernel: empty queries, segments of 1 to 32 lanes (M <= 1000), 2
# and 4 words per lane (1100, 4096), and the device-memory class (9000)
MYERS_FULL_SHAPES = ([(P, M) for M in (0, 1, 31, 33, 200, 1000, 4096) for P in (1, 33, 512)]
                     + [(33, 1100), (1, 9000), (33, 9000)])


def align_inputs(P, M, seed, device):
    """A packed batch of random pairs (mutated at 0-30 % with Ns, empty
    queries, unrelated lengths) on ``device``."""
    return tuple(x.to(device) for x in pack_problems(random_pairs(np.random.default_rng(seed), P, M)))


def check_kernel(kernel, reference, args, **kw):
    before = kernel.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, reference(*args, **kw))


@pytest.mark.parametrize("P,M", MYERS_FULL_SHAPES)
def test_myers_full_kernel_matches_reference(cuda, P, M):
    check_kernel(myers_edit_distance, myers_edit_distance_reference,
                 align_inputs(P, M, P + M, cuda))


def test_myers_full_kernel_max_n(cuda):
    args = align_inputs(64, 100, 5, cuda)
    for max_n in (0, 17, 64, 1000):
        check_kernel(myers_edit_distance, myers_edit_distance_reference, args, max_n=max_n)


@pytest.mark.parametrize("window_words", (2, 4, 8))
@pytest.mark.parametrize("P,M", ALIGN_SHAPES)
def test_myers_banded_kernel_matches_reference(cuda, P, M, window_words):
    check_kernel(myers_banded, myers_banded_reference, align_inputs(P, M, P + M + 1, cuda),
                 window_words=window_words)


@pytest.mark.parametrize("window_words", range(1, 9))
def test_myers_banded_kernel_every_window(cuda, window_words):
    """Each instantiation of the banded kernel against the plain version,
    on pairs long enough for the window to advance."""
    check_kernel(myers_banded, myers_banded_reference, align_inputs(200, 400, window_words, cuda),
                 window_words=window_words)


def test_myers_banded_kernel_rejects_bad_inputs(cuda):
    q, ql, t, tl = align_inputs(8, 40, 0, cuda)
    with pytest.raises(ValueError):
        myers_banded(q, ql.cpu(), t, tl)
    with pytest.raises(TypeError):
        myers_banded(q.long(), ql, t, tl)
    with pytest.raises(ValueError):
        myers_banded(q, ql, t[:4], tl)
    with pytest.raises(ValueError):
        myers_banded(q, ql, t, tl, window_words=0)


@pytest.mark.parametrize("band", (128, 256))
@pytest.mark.parametrize("P,M", ALIGN_SHAPES)
def test_wavefront_kernel_matches_reference(cuda, P, M, band):
    check_kernel(banded_edit_distance, banded_edit_distance_reference,
                 align_inputs(P, M, P + M + 2, cuda), band=band)


def wavefront_edge_inputs(P, M, band, seed, device):
    """``band_edge_pairs`` on ``device``, every target's bytes past its
    length set to codes 0-3, which the kernel may read and must not let
    reach the result."""
    rng = np.random.default_rng(seed)
    q, ql, t, tl = pack_problems(band_edge_pairs(rng, P, M, band))
    t = torch.from_numpy(scramble_past_lengths(rng, t.numpy(), tl.numpy()))
    return tuple(x.to(device) for x in (q, ql, t, tl))


@pytest.mark.parametrize("band", (32, 64, 256, 512))
@pytest.mark.parametrize("P,M", [(7, 60), (33, 300), (517, 1000)])
def test_wavefront_kernel_edges(cuda, P, M, band):
    """Every band class's edges, P not a multiple of the block's warps,
    garbage past each target's length, with and without max_m < M."""
    args = wavefront_edge_inputs(P, M, band, P + M + band, cuda)
    for max_m in (None, M // 2):
        check_kernel(banded_edit_distance, banded_edit_distance_reference, args, band=band,
                     max_m=max_m)


@pytest.mark.parametrize("band", (32, 256, 512))
def test_wavefront_kernel_long_queries(cuda, band):
    """M = 4096: a problem sweeps up to 64 of the kernel's staged chunks of
    rows."""
    check_kernel(banded_edit_distance, banded_edit_distance_reference,
                 wavefront_edge_inputs(33, 4096, band, band, cuda), band=band)


def test_align_kernels_reject_unsupported_shapes(cuda):
    args = align_inputs(8, 40, 0, cuda)
    with pytest.raises(ValueError):
        banded_edit_distance(*args, band=100)
    with pytest.raises(ValueError):
        myers_banded(*args, window_words=9)
    with pytest.raises(ValueError):
        myers_edit_distance(args[0], args[1].cpu(), args[2], args[3])


def check_gather(device, args, M, N):
    """The gather kernel on ``device`` against its plain version there, one
    launch counted where there are problems."""
    on_card = args.to(device)
    P = on_card.q_len.numel()
    before = gather_problems.launches
    got = gather_problems(*on_card, M, N)
    torch.cuda.synchronize()
    assert gather_problems.launches == before + (P > 0)
    want = gather_problems_reference(*on_card, M, N)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_kernel_matches_reference(cuda, case):
    queries, targets, problems = gather_case(case, GATHER_CASES.index(case))
    args, M, N = gather_inputs(queries, targets, problems)
    got = check_gather(cuda, args, M, N)
    for a, b in zip(got, pack_problems(sliced_pairs(queries, targets, problems))):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("max_len", (1, 7, 16, 17, 40, 1000))
def test_gather_kernel_every_row_alignment(cuda, max_len):
    """Widths below, at and past one 16-byte store, rows starting at every
    alignment."""
    queries, targets, problems = gather_case("lower_case", max_len, max_len=max_len, P=257)
    check_gather(cuda, *gather_inputs(queries, targets, problems))


def test_gather_kernel_at_a_refined_map_stage(cuda):
    """~57,000 problems of 0.5-10 kb into 232 MB of reads: a synthetic
    batch the size of a refined E. coli map stage's."""
    check_gather(cuda, *gather_scale_inputs(20_261_018))


def test_gather_kernel_rejects_bad_inputs(cuda):
    args, M, N = gather_inputs(*gather_case("minus_strand", 3))
    on_card = args.to(cuda)
    with pytest.raises(ValueError):
        gather_problems(*on_card, M - 1, N)
    with pytest.raises(ValueError):
        gather_problems(*on_card._replace(q_blob=on_card.q_blob.cpu()), M, N)
    with pytest.raises(TypeError):
        gather_problems(*on_card._replace(t_minus=on_card.t_minus.to(torch.uint8)), M, N)


def test_port_refinement_on_card_matches_cpu(cuda):
    from muchsalsa_tpu_torch.config import MapperConfig
    from muchsalsa_tpu_torch.pipeline.mapper_torch import MinimizerIndex, SequenceStore, map_all
    from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate

    sim = simulate(np.random.default_rng(41), genome_length=30_000, coverage=8.0,
                   read_length=5_000)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, 0.08))
    cfg = dataclasses.replace(MapperConfig(), refine=True)
    index = MinimizerIndex.build(unitigs, cfg)
    before = myers_edit_distance.launches, gather_problems.launches
    stats = {}
    on_card = map_all(index, reads, cfg, unitigs=unitigs, device=False, torch_device=cuda,
                      stats=stats)
    assert (myers_edit_distance.launches, gather_problems.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert stats["card_packed"] == stats["problems"] > 0
    assert on_card == map_all(index, reads, cfg, unitigs=unitigs, device=False,
                              torch_device="cpu")


def test_port_device_mapping_on_card_matches_cpu(cuda):
    """The six mapping stages on CUDA tensors give the CPU tensors' result,
    with and without refinement, and on a repeat set that takes tier 2."""
    from muchsalsa_tpu_torch.config import MapperConfig
    from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
    from muchsalsa_tpu_torch.pipeline.mapper_torch import SequenceStore
    from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome, simulate

    sim = simulate(np.random.default_rng(42), genome_length=60_000, coverage=8.0,
                   read_length=9_000)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, 0.08))
    rep = random_genome(rng, 300)
    for i in range(8):
        unitigs.add(f"rep_u{i}", random_genome(rng, 400) + rep + random_genome(rng, 400))
        reads.add(f"rep_r{i}", add_noise(rng, rep, 0.03))
    for refine in (False, True):
        cfg = dataclasses.replace(MapperConfig(), refine=refine)
        index = mt.MinimizerIndex.build(unitigs, cfg)
        on_card = mt.map_all(index, reads, cfg, unitigs=unitigs, device=True, torch_device=cuda)
        stats = dict(mt.DEVICE_MAP_STATS)
        assert stats["v2"] and stats["device"].startswith("cuda")
        on_cpu = mt.map_all(index, reads, cfg, unitigs=unitigs, device=True, torch_device="cpu")
        assert on_card == on_cpu
        assert {k: mt.DEVICE_MAP_STATS[k] for k in mt._COUNT_KEYS} == {
            k: stats[k] for k in mt._COUNT_KEYS}
        # the card launches a batch shape's first batch op by op and replays
        # a graph for the rest; the CPU launches every batch op by op
        assert mt.DEVICE_MAP_STATS["graph_batches"] == 0
        assert stats["eager_batches"] + stats["graph_batches"] == (
            mt.DEVICE_MAP_STATS["eager_batches"]) > 0
        assert on_card == mt.map_all(index, reads, cfg, unitigs=unitigs, device=False,
                                     torch_device=cuda)
    assert stats["tier2_reads"] > 0


def v1_inputs(device):
    """A simulated index and a batch of noisy reads, as the v1 join's
    arguments on ``device``: (codes, lens, index arrays, bitmap, rank,
    rounds)."""
    from muchsalsa_tpu_torch.config import MapperConfig
    from muchsalsa_tpu_torch.ops import mapping_torch as mpt
    from muchsalsa_tpu_torch.pipeline.mapper_torch import MinimizerIndex, SequenceStore
    from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate
    from muchsalsa_tpu_torch.utils.seq import encode_2bit

    sim = simulate(np.random.default_rng(44), genome_length=60_000, coverage=6.0,
                   read_length=9_000)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    rng = np.random.default_rng(3)
    seqs = [add_noise(rng, seq, 0.08) for _name, seq in sim.read_records()][:64]
    index = MinimizerIndex.build(unitigs, MapperConfig())
    codes = np.full((len(seqs), 10_240), 4, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_2bit(s)
        lens[i] = len(s)
    arrays = (mpt.u32_tensor(index.hashes, device),
              torch.from_numpy(index.offsets.astype(np.int32)).to(device),
              *(torch.from_numpy(a).to(device)
                for a in (index.entry_unitig, index.entry_pos, index.entry_strand)))
    return (torch.from_numpy(codes).to(device), torch.from_numpy(lens).to(device), arrays,
            *mpt.build_join_tables(index.hashes, device=device))


@pytest.mark.parametrize("mph", (2, 4))
def test_port_v1_join_on_card_matches_cpu(cuda, mph):
    """The v1 join on CUDA tensors gives the CPU tensors' fields."""
    from muchsalsa_tpu_torch.ops import mapping_torch as mpt

    on_card, on_cpu = (mpt.map_reads_device(codes, lens, *arrays, bitmap, rank, max_pos=2048,
                                            max_per_hit=mph, trim=2048, join_rounds=rounds)
                       for codes, lens, arrays, bitmap, rank, rounds
                       in (v1_inputs(cuda), v1_inputs(torch.device("cpu"))))
    assert set(on_card) == set(on_cpu)
    for key, want in on_cpu.items():
        assert torch.equal(on_card[key].cpu(), want), key
    assert int(on_cpu["n_hits"].sum()) > 64


def test_port_v1_mapping_on_card_matches_host(cuda, monkeypatch):
    """map_all on the card with the v2 tables refused: the v1 join maps the
    reads, identical to host mapping with refinement off and on."""
    from muchsalsa_tpu_torch.config import MapperConfig
    from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
    from muchsalsa_tpu_torch.pipeline.mapper_torch import SequenceStore
    from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate

    monkeypatch.setattr(mt, "build_device_tables", lambda *a, **k: None)
    sim = simulate(np.random.default_rng(45), genome_length=60_000, coverage=8.0,
                   read_length=9_000)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, 0.08))
    for refine in (False, True):
        cfg = dataclasses.replace(MapperConfig(), refine=refine)
        index = mt.MinimizerIndex.build(unitigs, cfg)
        before = myers_edit_distance.launches
        on_card = mt.map_all(index, reads, cfg, unitigs=unitigs, device=True, torch_device=cuda)
        stats = dict(mt.DEVICE_MAP_STATS)
        assert stats["v2"] is False and stats["device"].startswith(cuda.type)
        assert stats["overflow_reads"] < stats["total_reads"] == len(reads)
        assert on_card == mt.map_all(index, reads, cfg, unitigs=unitigs, device=False,
                                     torch_device=cuda)
        assert (myers_edit_distance.launches > before) == refine


def two_shards_on(cuda):
    from muchsalsa_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[cuda, cuda])


@pytest.mark.parametrize("kind", ("random", "inverted"))
def test_sharded_chain_dp_on_card_matches_kernel(cuda, kind):
    """Two shards on one card: bit-equal to one chain_dp launch over the
    whole batch, one launch a shard, the stats a host sum."""
    from muchsalsa_tpu_torch.parallel.sharded import sharded_chain_dp

    B, K = 4096, 16
    packed = pack_batch(chain_batch(B, K, kind, seed=7))
    before = chain_dp.launches
    s, b, stats = sharded_chain_dp(*packed, K, WIGGLE_ROOM, two_shards_on(cuda))
    torch.cuda.synchronize()
    assert chain_dp.launches == before + 2
    s_ref, b_ref = chain_dp(*(x.to(cuda) for x in packed), K, WIGGLE_ROOM)
    assert torch.equal(s, s_ref) and torch.equal(b, b_ref)
    sizes = (packed[2][1:] - packed[2][:-1]).to(cuda)
    best = torch.where(torch.arange(K, device=cuda) < sizes[:, None], s_ref, 0.0).amax(1)
    assert float(stats[0]) == float((sizes > 0).sum())
    assert float(stats[1]) == pytest.approx(float(best.sum()), rel=1e-12)


def test_sharded_myers_on_card_matches_kernel(cuda):
    from muchsalsa_tpu_torch.parallel.sharded import sharded_myers

    args = [x.to(cuda) for x in pack_problems(random_pairs(np.random.default_rng(5), 4096, 200))]
    before = myers_edit_distance.launches
    d, total = sharded_myers(*args, two_shards_on(cuda))
    torch.cuda.synchronize()
    assert myers_edit_distance.launches == before + 2
    d_ref = myers_edit_distance(*args)
    assert torch.equal(d, d_ref) and float(total) == float(d_ref.sum())
