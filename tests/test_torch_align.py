"""The port's problem packing and banded wavefront (plain version) against
the JAX package.

Inputs are random pairs made with numpy from a seed (mutated at 0-30 % with
``N``s, empty queries and targets, unrelated lengths).  Tolerance: exact
equality of the packed arrays and of the int32 distances, -1s included.
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
    INF, banded_edit_distance, banded_edit_distance_reference, pack_problems)
from muchsalsa_tpu_torch.testing.pairs import random_pairs, random_seq


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
