"""The port's problem packing and banded wavefront (plain version) against
the JAX package, and the gather of packed problems from coordinates against
the packing of the same pairs sliced in Python.

Inputs are random pairs made with numpy from a seed (mutated at 0-30 % with
``N``s, empty queries and targets, unrelated lengths), and for the gather
random sequences and ranges (``testing/pairs.py::gather_case``).
Tolerance: exact equality of the packed arrays and of the int32 distances,
-1s included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops.align import banded_edit_distance as jax_banded_edit_distance
from muchsalsa_tpu.ops.align import edit_distance_np
from muchsalsa_tpu.ops.align import pack_problems as jax_pack_problems
from muchsalsa_tpu.ops.align_pallas import banded_edit_distance_pallas
from muchsalsa_tpu_torch.ops.align_torch import (
    INF, banded_edit_distance, banded_edit_distance_reference, gather_problems,
    gather_problems_reference, pack_problems, slice_bounds)
from muchsalsa_tpu_torch.testing.pairs import (
    GATHER_CASES, gather_case, gather_inputs, random_pairs, random_seq, sliced_pairs)


def packed(pairs):
    ours = pack_problems(pairs)
    return ours, tuple(jnp.asarray(x.numpy()) for x in ours)


def wavefront_batch(seed, P, M, band):
    """Random pairs, an empty target, N against N (a match for the
    wavefront), and length differences at and around the band."""
    rng = np.random.default_rng(seed)
    pairs = random_pairs(rng, P, M) + [(random_seq(rng, 30), b""), (b"NNN", b"NNAN")]
    for d in (band - 1, band, -(band - 1), -band):
        m = int(rng.integers(5, 60))
        pairs.append((random_seq(rng, m), random_seq(rng, m + d) if m + d >= 0 else b""))
    return pairs


def test_inf_matches_jax():
    from muchsalsa_tpu.ops.align import INF as JAX_INF

    assert INF == int(JAX_INF)


@pytest.mark.parametrize("seed,P,M", [(0, 0, 1), (1, 1, 1), (2, 7, 33), (3, 40, 300)])
def test_pack_problems_matches_jax(seed, P, M):
    pairs = random_pairs(np.random.default_rng(seed), P, M)
    ours = pack_problems(pairs)
    theirs = jax_pack_problems(pairs)
    for a, b in zip(ours, theirs):
        assert a.device.type == "cpu"
        assert a.dtype == {np.dtype(np.uint8): torch.uint8,
                           np.dtype(np.int32): torch.int32}[np.asarray(b).dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("band", (128, 256))
@pytest.mark.parametrize("seed,M", [(10, 60), (11, 200), (12, 420)])
def test_wavefront_reference_matches_xla(band, seed, M):
    ours, theirs = packed(wavefront_batch(seed, 30, M, band))
    got = banded_edit_distance(*ours, band=band)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_banded_edit_distance(*theirs, band=band)))


@pytest.mark.parametrize("band", (128, 256))
def test_wavefront_reference_matches_pallas_interpret(band):
    ours, theirs = packed(wavefront_batch(20 + band, 24, 120, band))
    np.testing.assert_array_equal(
        banded_edit_distance_reference(*ours, band=band).numpy(),
        np.asarray(banded_edit_distance_pallas(*theirs, band=band, interpret=True)))


@pytest.mark.parametrize("max_m", (0, 25, 90, 500))
def test_wavefront_reference_max_m(max_m):
    ours, theirs = packed(wavefront_batch(30, 16, 90, 128))
    np.testing.assert_array_equal(
        banded_edit_distance(*ours, band=128, max_m=max_m).numpy(),
        np.asarray(jax_banded_edit_distance(*theirs, band=128, max_m=max_m)))


def test_wavefront_band_guard_and_oracle():
    rng = np.random.default_rng(5)
    q = random_seq(rng, 200, n_rate=0.0)
    near = q[:50] + q[53:] + b"ACGT"
    pairs = [(q, near), (q, q + random_seq(rng, 128)), (q, q[:72]), (b"", q), (q, b"")]
    got = banded_edit_distance(*pack_problems(pairs), band=128).tolist()
    assert got == [edit_distance_np(q, near), -1, -1, -1, -1]
    assert banded_edit_distance(*pack_problems(pairs[1:3]), band=129).tolist() == [128, 128]


def test_wrapper_rejects_bad_inputs_and_launches_nothing_on_cpu():
    (q, ql, t, tl), _ = packed(random_pairs(np.random.default_rng(3), 4, 20))
    before = banded_edit_distance.launches
    banded_edit_distance(q, ql, t, tl, band=96)
    assert banded_edit_distance.launches == before
    with pytest.raises(TypeError):
        banded_edit_distance(q, ql, t.int(), tl)
    with pytest.raises(ValueError):
        banded_edit_distance(q, ql, t, tl + t.shape[1])
    with pytest.raises(ValueError):
        banded_edit_distance(q.to("meta"), ql.to("meta"), t.to("meta"), tl.to("meta"))


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_reference_matches_pack_problems(case):
    queries, targets, problems = gather_case(case, GATHER_CASES.index(case))
    args, M, N = gather_inputs(queries, targets, problems)
    got = gather_problems_reference(*args.to("cpu"), M, N)
    want = pack_problems(sliced_pairs(queries, targets, problems))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_slice_bounds_is_python_slicing():
    seq = bytes(range(10))
    cuts = [(a, b) for a in range(-13, 14) for b in range(-13, 14)]
    start, length = slice_bounds([a for a, _ in cuts], [b for _, b in cuts], [len(seq)] * len(cuts))
    assert length.dtype == np.int32
    for (a, b), s, n in zip(cuts, start.tolist(), length.tolist()):
        assert seq[s : s + n] == seq[a:b]


def test_gather_wrapper_on_cpu_is_the_reference_and_checks_its_inputs():
    queries, targets, problems = gather_case("minus_strand", 5)
    args, M, N = gather_inputs(queries, targets, problems)
    args = args.to("cpu")
    before = gather_problems.launches
    for a, b in zip(gather_problems(*args, M, N), gather_problems_reference(*args, M, N)):
        assert torch.equal(a, b)
    assert gather_problems.launches == before
    with pytest.raises(ValueError, match="lengths"):
        gather_problems(*args, M - 1, N)
    last = int(torch.where(args.q_len > 0, args.q_off + args.q_start + args.q_len, 0).max())
    with pytest.raises(ValueError, match="outside its blob"):
        gather_problems(*args._replace(q_blob=args.q_blob[: last - 1]), M, N)
    with pytest.raises(ValueError, match="outside its blob"):
        gather_problems(*args._replace(q_off=args.q_off - 1 - args.q_off.max()), M, N)
    with pytest.raises(TypeError):
        gather_problems(*args._replace(q_len=args.q_len.long()), M, N)
    with pytest.raises(ValueError):
        gather_problems(*args._replace(q_len=args.q_len[1:]), M, N)
    with pytest.raises(ValueError):
        gather_problems(*(x.to("meta") for x in args), M, N)
