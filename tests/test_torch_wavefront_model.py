"""A torch model of the banded wavefront kernel's arithmetic, held to the
plain version and to the JAX package on the CPU.

``csrc/banded_wavefront.cu`` runs only on the card.  ``kernel_model`` below
repeats what it computes, in the order it computes it: the band in shifted
coordinates ``S[x] = R[x] - x`` with no range test, no ``j == 0`` case and
no clamp inside a row; C = band / 32 cells a lane, the in-lane prefix min,
the shuffle scan of the 32 lane totals (a lane below the shuffle distance
keeps its own total) and the exclusive prefix; every target byte read with
no test, from a copy that holds a stand-in code outside the problem's row
(the kernel stages code 4 there; the model tries another code too); one
clamp on the answer cell.  It also counts the interior rows, whose window
lies inside the row.  It is held bit-equal to
``banded_edit_distance_reference`` and to the JAX package's
``ops/align.py::banded_edit_distance`` on seeded batches (tolerance: exact
equality of the int32 distances, -1s included), with garbage codes past
every target's length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muchsalsa_tpu.ops.align import banded_edit_distance as jax_banded_edit_distance
from muchsalsa_tpu_torch.ops.align_torch import (
    INF, T_PAD, banded_edit_distance_reference, pack_problems)
from muchsalsa_tpu_torch.testing.pairs import band_edge_pairs, random_seq, scramble_past_lengths

INT_MAX = 2**31 - 1
LANES = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: its tensors are
    small, and an op's thread pool slows it many times over when test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def kernel_model(q, ql, t, tl, band, max_m=None, edge_code=T_PAD):
    """The kernel's result on CPU tensors, and the number of interior rows
    it swept; ``edge_code`` is what a row reads outside [0, N)."""
    P, M = q.shape
    N = t.shape[1]
    B, C = band, band // LANES
    rows = max_m if max_m is not None else M
    m, n = ql.int(), tl.int()
    diff = n - m
    adiff = diff.abs()
    ok = (adiff < B) & (m > 0) & (n > 0) & (m <= rows)
    klo = torch.minimum(diff, torch.zeros_like(diff)) - torch.div(
        B - 1 - adiff, 2, rounding_mode="floor")
    x = torch.arange(B, dtype=torch.int32)
    k = klo[:, None] + x
    S = torch.where((k >= 0) & (k <= n[:, None]), k, INF).int() - x
    above_band = torch.full((P, 1), INF - B, dtype=torch.int32)
    # rows 1..e1 start left of column 0, rows e1+1..e2 read inside [0, N)
    e1 = torch.minimum(m, -klo)
    e2 = torch.maximum(e1, torch.minimum(m, N - klo - B + 1))
    interior = 0
    for i in range(1, int(torch.where(ok, m, 0).max()) + 1 if P else 1):
        live = ok & (i <= m)
        edge = (i <= e1) | (i > e2)
        off = i - 1 + klo[:, None] + x
        inside = (off >= 0) & (off < N)
        # an interior row's window lies in the row
        assert bool(inside[live & ~edge].all())
        interior += int((live & ~edge).sum())
        tc = torch.where(inside, t.gather(1, off.clamp(0, N - 1).long()), edge_code)
        cost = (tc != q[:, i - 1, None]).int()
        cand = torch.minimum(S + cost, torch.cat([S[:, 1:], above_band], 1) + 2)
        v = cand.view(P, LANES, C).cummin(2).values
        tot = v[:, :, -1]
        for d in (1, 2, 4, 8, 16):
            tot = torch.minimum(tot, torch.cat([tot[:, :d], tot[:, :-d]], 1))
        before = torch.cat([torch.full((P, 1), INT_MAX, dtype=torch.int32), tot[:, :-1]], 1)
        S = torch.where(live[:, None], torch.minimum(v, before[:, :, None]).view(P, B), S)
    idx = (diff - klo).clamp(0, B - 1)
    val = (S.gather(1, idx[:, None].long())[:, 0] + idx).clamp(max=INF)
    return torch.where(ok, val, -1).int(), interior


def edge_batch(seed: int, P: int, M: int, band: int):
    """``band_edge_pairs`` packed, and the target codes with every byte past
    a target's length set to codes 0-3 in place of the padding."""
    rng = np.random.default_rng(seed)
    q, ql, t, tl = pack_problems(band_edge_pairs(rng, P, M, band))
    return q, ql, torch.from_numpy(scramble_past_lengths(rng, t.numpy(), tl.numpy())), tl, t


@pytest.mark.parametrize("band,M,short", [
    (band, M, short) for band, M in ((32, 70), (64, 90), (256, 60), (512, 40))
    for short in (False, True)])
def test_kernel_model_matches_reference_and_jax(band, M, short):
    q, ql, t, tl, clean = edge_batch(band + M + short, 35, M, band)
    # max_m below M leaves the longest queries at -1; otherwise m == rows for the first
    max_m = M // 2 if short else None
    want = banded_edit_distance_reference(q, ql, t, tl, band, max_m)
    assert torch.equal(want, banded_edit_distance_reference(q, ql, clean, tl, band, max_m))
    assert bool((want >= 0).any()) and bool((want < 0).any())
    theirs = np.asarray(jax_banded_edit_distance(
        *(jnp.asarray(x.numpy()) for x in (q, ql, t, tl)), band=band, max_m=max_m))
    np.testing.assert_array_equal(want.numpy(), theirs)
    for edge_code in (T_PAD, band % 4):
        assert torch.equal(kernel_model(q, ql, t, tl, band, max_m, edge_code)[0], want)


def test_kernel_model_interior_rows_on_long_problems():
    """Problems much longer than the band: all but the first -klo rows of
    each are interior, the share the refinement batch sees."""
    rng = np.random.default_rng(9)
    pairs = [(random_seq(rng, 400), random_seq(rng, 400 + d)) for d in (-20, -3, 0, 5, 31)]
    q, ql, t, tl = pack_problems(pairs)
    got, interior = kernel_model(q, ql, t, tl, 64)
    assert torch.equal(got, banded_edit_distance_reference(q, ql, t, tl, 64))
    assert interior / int(ql.sum()) > 0.8
