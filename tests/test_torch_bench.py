"""The port's kernel benchmark (``muchsalsa_tpu_torch/bench.py``) against the
JAX package's ``bench.py``, and the bounds of ``utils/roofline.py``.

The bench's inputs are compared byte for byte with those of ``bench.py`` and
``__graft_entry__.py`` (loaded by path).  Each figure runs on the CPU at a
tiny size (P 4, L 200; B 8, K 16; R 4, L 1,024; E 2^12) through the port's
plain versions, and its checksum (the sum of its outputs) is held against
the JAX function's on the same numpy inputs: exact Myers, banded Myers
(the Pallas kernel in interpret mode), the wavefront (its XLA twin), the
chaining DP (x64), seeding, and ``bench.py``'s six mapping stages.
Tolerance: exact equality; every output is an integer or an exact float64
DP of integer-valued scores.
"""

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops import mapping_jax as mj
from muchsalsa_tpu.ops.align import banded_edit_distance as jax_wavefront
from muchsalsa_tpu.ops.chaining_jax import chain_dp_batch
from muchsalsa_tpu.ops.minimizer_jax import anchor_counts_bitmap, build_hash_bitmap
from muchsalsa_tpu.ops.myers_jax import myers_edit_distance
from muchsalsa_tpu.ops.myers_pallas import myers_banded_pallas
from muchsalsa_tpu.pipeline.mapper import device_bucket_budgets
from muchsalsa_tpu_torch import bench
from muchsalsa_tpu_torch.ops.align_torch import pack_problems
from muchsalsa_tpu_torch.testing.chains import example_batch
from muchsalsa_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parents[1]
TINY = bench.TINY
FIGURES = ("Myers exact DP on cpu", "banded Myers (cpu) on cpu", "chain DP on cpu",
           "mapping seed+join on cpu", "FULL device mapping on cpu (production 6-stage split)",
           "device parity (mapping + f64 chaining vs host oracle)", "banded wavefront (cpu)")
KERNEL_LINES = ("myers_full timing", "myers_banded timing", "chain_dp timing",
                "banded_wavefront timing")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: its tensors are
    small, and an op's thread pool slows it many times over when test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load_by_path(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """``bench.py`` as a module, its ``main`` not run; its ``setdefault`` of
    the JAX cache variables finds them set and leaves the environment as it
    was."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "5")
    return load_by_path(REPO / "bench.py", "_jax_bench")


def run_main(argv):
    """``bench.main(argv)``: (exit code, standard output, standard error)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def tiny_run():
    return run_main(["--device", "cpu", "--tiny"])


def jnp_args(args):
    return tuple(jnp.asarray(x.numpy()) for x in args)


# --- inputs


@pytest.mark.parametrize("n", (1, 3))
def test_align_problems_are_bench_py_s(jax_bench, n):
    ours = bench._align_problems(n)
    theirs = jax_bench._align_problems(n)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


@pytest.mark.parametrize("B, K", ((8, 16), (3, 64)))
def test_example_batch_is_graft_entry_s(B, K):
    graft = load_by_path(REPO / "__graft_entry__.py", "_graft_entry")
    theirs = graft._example_batch(B, K, np.float64)
    ours = example_batch(B, K, np.float64)
    assert sorted(ours) == sorted(theirs)
    for name, arr in ours.items():
        want = np.asarray(theirs[name])
        assert arr.dtype == want.dtype, name
        np.testing.assert_array_equal(arr, want, err_msg=name)


def test_seeding_and_mapping_inputs_are_bench_py_s_draws():
    """``bench.py``'s own draws (:193-196 and :218-232), written out."""
    R, L, E = 4, 1024, 1 << 12
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    hashes = rng.integers(0, 1 << 32, E, dtype=np.uint32)
    got = bench._seeding_inputs(R, L, E)
    np.testing.assert_array_equal(got[0], codes)
    np.testing.assert_array_equal(got[1], np.full(R, L, dtype=np.int32))
    np.testing.assert_array_equal(got[2], hashes)
    assert got[2].dtype == np.uint32

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    hashes = np.unique(np.sort(rng.integers(0, 1 << 32, E, dtype=np.uint32)))
    H = len(hashes)
    index = (hashes, np.arange(H + 1, dtype=np.int64), rng.integers(0, 5000, H).astype(np.int32),
             rng.integers(0, 1000, H).astype(np.int32), rng.random(H) < 0.5)
    got_codes, got_lens, got_index = bench._mapping_inputs(R, L, E)
    np.testing.assert_array_equal(got_codes, codes)
    np.testing.assert_array_equal(got_lens, np.full(R, L, dtype=np.int32))
    for a, b in zip(got_index, index):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- figures against the JAX functions


def test_myers_figure_matches_jax():
    rate, checksum = bench._bench_myers("cpu", TINY.align_p, TINY.align_l)
    want = myers_edit_distance(*jnp_args(bench._align_problems(TINY.align_p, TINY.align_l)))
    assert rate > 0
    assert checksum == int(np.asarray(want).astype(np.int64).sum())


def test_banded_myers_figure_matches_pallas_interpret():
    rate, checksum = bench._bench_myers_banded("cpu", TINY.align_p, TINY.align_l)
    args = jnp_args(bench._align_problems(TINY.align_p, TINY.align_l))
    want = myers_banded_pallas(*args, window_words=bench.ALIGN_BAND // 32, interpret=True)
    assert rate > 0
    assert checksum == int(np.asarray(want).astype(np.int64).sum())


def test_wavefront_figure_matches_xla():
    rate, checksum = bench._bench_align("cpu", TINY.align_p, TINY.align_l)
    args = jnp_args(bench._align_problems(TINY.align_p, TINY.align_l))
    want = jax_wavefront(*args, band=bench.ALIGN_BAND)
    assert rate > 0
    assert checksum == int(np.asarray(want).astype(np.int64).sum())


def test_chain_dp_figure_matches_jax_x64():
    rate, checksum = bench._bench_chain_dp("cpu", TINY.chain_b, TINY.chain_k)
    batch = {k: jnp.asarray(v) for k, v in example_batch(TINY.chain_b, TINY.chain_k,
                                                          np.float64).items()}
    scores, bps = chain_dp_batch(batch, bench.WIGGLE)
    assert np.asarray(scores).dtype == np.float64
    assert rate > 0
    assert checksum == float(np.asarray(scores).sum()) + float(np.asarray(bps).sum())


@pytest.mark.parametrize("R, L, E", ((TINY.seed_r, TINY.seed_l, TINY.index_e),
                                     (TINY.seed_r, bench.SEED_L, bench.INDEX_E)))
def test_seeding_figure_matches_jax(R, L, E):
    """At the tiny size no minimizer of a random read is in the index; at
    bench.py's read length and index size a few dozen are."""
    rate, checksum = bench._bench_seeding("cpu", R, L, E)
    codes, lens, hashes = bench._seeding_inputs(R, L, E)
    want = anchor_counts_bitmap(jnp.asarray(codes), jnp.asarray(lens), build_hash_bitmap(hashes))
    assert rate > 0
    assert checksum == int(np.asarray(want).astype(np.int64).sum())
    assert checksum > 0 or E < bench.INDEX_E


def test_full_mapping_figure_matches_bench_py_s_six_stages():
    """bench.py's random reads chain against no random unitig, so the hit
    table is its padding and flags; the parity check holds mapping itself
    against the host mapper."""
    R, L, E = TINY.map_r, TINY.map_l, TINY.index_e
    rate, checksum = bench._bench_full_mapping("cpu", R, L, E)
    codes, lens, index = bench._mapping_inputs(R, L, E)
    tables, hash_takes = mj.build_device_tables(*index)
    packed, nmask = mj.pack_codes(codes)
    max_sel, max_pos, trim = device_bucket_budgets(L, 15, 2048, 4)
    # bench.py's `chain` (:237-252)
    selected, h, strand = mj.sketch_device_packed(jnp.asarray(packed), jnp.asarray(nmask),
                                                  jnp.asarray(lens))
    skey, h_s, n_sel = mj.select_compact_device_v2(selected, h, strand, max_sel=max_sel)
    rpv, cand = mj.probe_candidates_device_v2(skey, h_s, tables.rp)
    sel = mj.compact_candidates_device_v2(skey, h_s, rpv, cand, n_sel, max_pos=max_pos)
    anchors = mj.expand_anchors_device_v2(*sel, tables.jrows, tables.erows, max_per_hit=4,
                                          hash_takes=hash_takes)
    want = mj.anchors_to_hits_device_packed(*anchors, trim=trim, per_hit_cap=4)
    assert rate > 0
    assert checksum == int(np.asarray(want).astype(np.int64).sum())


# --- the parity check and the exit codes


def test_parity_check_is_ok_at_bench_py_s_size():
    assert bench._device_parity_check("cpu") == "ok"


def test_a_mapping_divergence_fails_the_run_and_names_the_read(monkeypatch):
    monkeypatch.setattr(bench, "map_read", lambda *args, **kwargs: ["not a mapping"])
    rc, out, err = run_main(["--device", "cpu", "--tiny"])
    assert rc == 1
    assert re.search(r"mapping device/host diverged on read \d+ \(\S+\)", err), err[-2000:]
    assert out == ""


def test_a_failed_cpu_baseline_fails_the_run(monkeypatch):
    def fail(tiny):
        raise RuntimeError("exit 1: no baseline")

    monkeypatch.setattr(bench, "_cpu_baseline", fail)
    rc, out, err = run_main(["--device", "cpu", "--tiny"])
    assert rc != 0
    assert "[bench] cpu baseline failed: exit 1: no baseline" in err
    assert out == ""


def test_no_card_and_no_device_flag_exits_before_any_figure(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run_main([])
    assert rc != 0
    assert "no CUDA device" in err
    assert out == "" and "[bench]" not in err


def test_output_has_bench_py_s_json_and_lines_gen_bench_table_reads(tiny_run):
    rc, out, err = tiny_run
    assert rc == 0, err[-3000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert sorted(last) == ["metric", "unit", "value", "vs_baseline"]
    assert last["metric"] == "myers_edit_distance_gcups" and last["unit"] == "cells/s"
    assert last["value"] > 0 and last["vs_baseline"] > 0
    table = load_by_path(REPO / "scripts" / "gen_bench_table.py", "_gen_bench_table")
    vals = table.parse_lines(err)
    assert vals["device"] == "cpu (the kernels' plain versions), count 0"
    for name in FIGURES + KERNEL_LINES:
        assert name in vals, name
    assert vals["device parity (mapping + f64 chaining vs host oracle)"] == "ok"
    # the headline and then the baseline, both on the CPU here
    assert len(re.findall(r"^\[bench\] Myers exact DP on cpu: ", err, re.M)) == 2


# --- bounds


def test_scan_bound_at_the_core_s_batch():
    ms, by = roofline.scan_bound(131072, 8)
    assert by == "bytes"
    assert round(ms, 5) == 0.00876


def test_dp_bound_by_hand():
    offsets = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    ms, by = roofline.dp_bound(offsets, 8)
    nbytes = 8 * 105 + 4 * 4 + 3 * 8 * 12
    ops = (3 + 10) * (roofline.DP_PAIR_OPS + 2)
    assert roofline.dp_bytes(8, 3, 8) == nbytes
    assert (ms, by) == roofline.bound(nbytes, ops, roofline.FP64_FLOPS)


def hand_batch():
    rng = np.random.default_rng(3)
    lens = [(0, 5), (1, 7), (32, 40), (33, 33), (100, 90), (64, 400)]
    seq = lambda n: bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n))
    return pack_problems([(seq(m), seq(n)) for m, n in lens]), lens


@pytest.mark.parametrize("name, kw", (("myers_full", {}), ("myers_banded", {"window_words": 8}),
                                      ("banded_wavefront", {"band": 256})))
def test_align_work_counts_by_hand(name, kw):
    args, lens = hand_batch()
    nbytes, ops = roofline.align_work(name, args, kw)
    assert nbytes == 6 * 100 + 6 * 400 + 12 * 6
    if name == "myers_full":
        want = 15 * sum(-(-m // 32) * n for m, n in lens)
    elif name == "myers_banded":
        # band diagonals [klo, khi] = [-126, 129]; a problem is inside where n - m
        # lies 32 or more rows from both ends, with m, n > 0
        want = 15 * 8 * sum(n for m, n in lens if m and n and -94 <= n - m <= 97)
    else:
        want = 3 * 256 * sum(m for m, n in lens if m and n and abs(n - m) < 256)
    assert ops == want
    rate = 1e13
    assert roofline.align_bound(name, args, kw, rate) == roofline.bound(nbytes, ops, rate)
