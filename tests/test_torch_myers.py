"""The port's Myers edit distances (plain versions) against the JAX package.

Inputs are random pairs made with numpy from a seed (mutated at 0-30 % with
``N``s, empty queries, unrelated lengths), packed once and fed to both
packages.  Tolerance: exact equality of the int32 distances, -1s and
out-of-band values included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops.myers_full_pallas import myers_edit_distance_pallas
from muchsalsa_tpu.ops.myers_jax import _pack_peq as jax_pack_peq
from muchsalsa_tpu.ops.myers_jax import myers_edit_distance as jax_myers_edit_distance
from muchsalsa_tpu.ops.myers_pallas import _geometry, myers_banded_pallas
from muchsalsa_tpu_torch.ops.align_torch import pack_problems
from muchsalsa_tpu_torch.ops.myers_torch import (
    CLASS_WORDS_PER_LANE, STATE_CLASS, STEP_SLOTS, WORD_SLOTS, geometry, myers_banded,
    myers_banded_reference, myers_edit_distance, myers_edit_distance_reference, pack_peq,
    schedule_problems)
from muchsalsa_tpu_torch.testing.pairs import random_pairs, random_seq

WORD_EDGES = (31, 32, 33, 63, 64, 65, 96, 97)


def packed(pairs):
    """The same batch for both packages: (torch CPU tensors, jnp arrays)."""
    ours = pack_problems(pairs)
    return ours, tuple(jnp.asarray(x.numpy()) for x in ours)


def edge_pairs(seed):
    """Hand-picked cases: empty query, empty target, both empty, N against
    N (no match in PEq), and lengths far apart."""
    rng = np.random.default_rng(seed)
    q = random_seq(rng, 40)
    return [
        (b"", random_seq(rng, 17)),
        (q, b""),
        (b"", b""),
        (b"N", b"N"),
        (b"NNNN", b"NNNN"),
        (q, q),
        (random_seq(rng, 5), random_seq(rng, 90)),
        (random_seq(rng, 90), random_seq(rng, 3)),
    ]


@pytest.mark.parametrize("M", (1, 31, 32, 33, 65, 100))
def test_pack_peq_matches_jax(M):
    (q, _, _, _), (jq, _, _, _) = packed(random_pairs(np.random.default_rng(M), 9, M))
    n_words = -(-M // 32) + 3  # padded words past the query as well
    np.testing.assert_array_equal(
        pack_peq(q, n_words).numpy(), np.asarray(jax_pack_peq(jq, n_words)).astype(np.int64))


@pytest.mark.parametrize("M", WORD_EDGES)
def test_myers_reference_matches_jax_at_word_edges(M):
    pairs = random_pairs(np.random.default_rng(100 + M), 24, M) + edge_pairs(M)
    ours, theirs = packed(pairs)
    got = myers_edit_distance(*ours)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_myers_edit_distance(*theirs)))


@pytest.mark.parametrize("M", WORD_EDGES)
def test_myers_reference_matches_pallas_interpret(M):
    pairs = random_pairs(np.random.default_rng(200 + M), 20, M) + edge_pairs(M)
    ours, theirs = packed(pairs)
    np.testing.assert_array_equal(
        myers_edit_distance_reference(*ours).numpy(),
        np.asarray(myers_edit_distance_pallas(*theirs, interpret=True)))


@pytest.mark.parametrize("max_n", (0, 17, 32, 45, 500))
def test_myers_reference_max_n_truncates_columns(max_n):
    pairs = random_pairs(np.random.default_rng(7), 16, 70) + edge_pairs(7)
    ours, theirs = packed(pairs)
    np.testing.assert_array_equal(
        myers_edit_distance(*ours, max_n=max_n).numpy(),
        np.asarray(jax_myers_edit_distance(*theirs, max_n=max_n)))


def test_myers_reference_edge_values():
    ours, _ = packed([(b"", b"ACG"), (b"ACGT", b""), (b"N", b"N"), (b"ACGT", b"ACGT"),
                      (b"ACGT", b"AGGT")])
    assert myers_edit_distance(*ours).tolist() == [3, 4, 1, 0, 1]


@pytest.mark.parametrize("window_words", (1, 3, 5, 8))
def test_geometry_matches_pallas(window_words):
    assert geometry(window_words) == _geometry(window_words)


def banded_batch(seed, P, M):
    """Random pairs at a low rate (mostly in the band), the edge cases,
    pairs whose length difference sits at and just past the band's edges,
    and one pair of equal lengths whose optimal path makes an 80-diagonal
    excursion (an 80-base insertion, then the last 80 bases missing)."""
    rng = np.random.default_rng(seed)
    pairs = random_pairs(rng, P, M, max_rate=0.1) + edge_pairs(seed)
    for d in (-130, -100, -66, -64, -63, -33, -32, -31, 31, 32, 33, 63, 64, 97, 98, 140):
        m = int(rng.integers(max(1, -d + 1), M + 1)) if -d < M else M
        q = random_seq(rng, m)
        pairs.append((q, random_seq(rng, max(m + d, 0)) if rng.random() < 0.5
                      else (q + random_seq(rng, d) if d > 0 else q[:max(m + d, 0)])))
    a, b = random_seq(rng, 20), random_seq(rng, 300)
    pairs.append((a + b, a + random_seq(rng, 80) + b[:-80]))
    return pairs


@pytest.mark.parametrize("window_words", (2, 4, 8))
@pytest.mark.parametrize("M", (40, 150))
def test_myers_banded_reference_matches_pallas_interpret(window_words, M):
    pairs = banded_batch(300 + M + window_words, 24, M)
    ours, theirs = packed(pairs)
    got = myers_banded(*ours, window_words=window_words)
    want = np.asarray(myers_banded_pallas(*theirs, window_words=window_words, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.asarray(jax_myers_edit_distance(*theirs))
    if window_words == 2:
        # the static band of 2 words leaves no length difference that passes
        # the in-band test (klo = -30, khi = 33), so every problem is refused
        assert (want == -1).all()
        return
    # refusals, exact in-band values, and (window of 4 words, band reaching
    # diagonal 65) an in-band value that is only an upper bound
    assert (want == -1).any()
    assert ((want >= 0) & (want == exact)).any()
    if window_words == 4:
        assert ((want >= 0) & (want > exact)).any()


def test_myers_banded_reference_max_n_rounds_to_blocks():
    pairs = banded_batch(5, 12, 90)
    ours, theirs = packed(pairs)
    for max_n in (1, 40, 64):
        np.testing.assert_array_equal(
            myers_banded(*ours, window_words=4, max_n=max_n).numpy(),
            np.asarray(myers_banded_pallas(*theirs, window_words=4, max_n=max_n,
                                           interpret=True)))


def test_wrappers_reject_bad_inputs():
    (q, ql, t, tl), _ = packed(random_pairs(np.random.default_rng(3), 4, 20))
    for fn in (myers_edit_distance, myers_banded):
        with pytest.raises(TypeError):
            fn(q.long(), ql, t, tl)
        with pytest.raises(TypeError):
            fn(q, ql.long(), t, tl)
        with pytest.raises(ValueError):
            fn(q, ql, t[:2], tl)
        with pytest.raises(ValueError):
            fn(q, ql + q.shape[1], t, tl)  # a length past the padded width
        with pytest.raises(ValueError):
            fn(q.t().contiguous().t(), ql, t, tl)  # not contiguous
        # neither cpu nor cuda: no silent fallback to the plain version
        with pytest.raises(ValueError):
            fn(q.to("meta"), ql.to("meta"), t.to("meta"), tl.to("meta"))
    with pytest.raises(ValueError):
        myers_banded_reference(q, ql, t, tl, window_words=0)


def test_cpu_tensors_launch_nothing():
    (q, ql, t, tl), _ = packed(random_pairs(np.random.default_rng(4), 4, 20))
    before = (myers_edit_distance.launches, myers_banded.launches)
    myers_edit_distance(q, ql, t, tl)
    myers_banded(q, ql, t, tl, window_words=2)
    assert (myers_edit_distance.launches, myers_banded.launches) == before


# the exact kernel's schedule: every register class and segment lengths of
# 1 to 32 lanes (M <= 4096), and the device-memory class past 8,192 rows
# (M = 9000)
SCHEDULE_M = (0, 1, 31, 33, 200, 1000, 4096)
SCHEDULE_COLS = 150


def schedule_pairs(M):
    """40 random pairs with longest query M and the edge cases; for M = 0,
    empty queries against the targets of pairs of up to 50 bases."""
    if M == 0:
        return [(b"", t) for _, t in random_pairs(np.random.default_rng(900), 40, 50)]
    return random_pairs(np.random.default_rng(900 + M), 40, M) + edge_pairs(M)


def expected_class_and_segment(m):
    """The cheapest (class, lanes) by the schedule's cost model, in ints."""
    words = max(-(-m // 32), 1)
    plans = [(-(-words // k) * (STEP_SLOTS + k * WORD_SLOTS), cls, -(-words // k))
             for cls, k in enumerate(CLASS_WORDS_PER_LANE) if -(-words // k) <= 32]
    if not plans:
        return STATE_CLASS, 32
    _cost, cls, lanes = min(plans)
    return cls, lanes


@pytest.mark.parametrize("M", SCHEDULE_M + (9000,))
def test_schedule_orders_problems_by_class_segment_and_work(M):
    (q, ql, t, tl), _ = packed(schedule_pairs(M))
    order, groups, k_state = schedule_problems(ql, tl, SCHEDULE_COLS)
    P = q.shape[0]
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(P))
    assert [g[2] for g in groups] == list(np.cumsum([0] + [g[3] for g in groups])[:-1])
    assert sum(g[3] for g in groups) == P
    assert [(c, s) for c, s, _, _ in groups] == sorted({(c, s) for c, s, _, _ in groups},
                                                         reverse=True)
    m, n = ql.tolist(), tl.tolist()
    for cls, seg, start, count in groups:
        slots = order[start:start + count].tolist()
        assert {expected_class_and_segment(m[p]) for p in slots} == {(cls, seg)}
        work = [min(n[p], SCHEDULE_COLS) if m[p] > 0 else 0 for p in slots]
        assert work == sorted(work, reverse=True)
    words = max(-(-max(m) // 32), 1)
    assert k_state == (-(-words // 32) if words > 32 * CLASS_WORDS_PER_LANE[-1] else 0)
    assert (k_state > 0) == (M == 9000)


@pytest.mark.parametrize("M", SCHEDULE_M)
def test_schedule_round_trip_matches_jax(M):
    """The problems in the kernel's order through the plain version, each
    result scattered back to its problem's slot, give the JAX distances."""
    ours, theirs = packed(schedule_pairs(M))
    q, ql, t, tl = ours
    order, _, _ = schedule_problems(ql, tl, SCHEDULE_COLS)
    idx = order.long()
    permuted = myers_edit_distance_reference(q[idx], ql[idx], t[idx], tl[idx],
                                             max_n=SCHEDULE_COLS)
    got = torch.empty_like(permuted)
    got[idx] = permuted
    want = np.asarray(jax_myers_edit_distance(*theirs, max_n=SCHEDULE_COLS))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(myers_edit_distance(*ours, max_n=SCHEDULE_COLS).numpy(), want)
