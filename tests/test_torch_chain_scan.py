"""The port's chain scan and batched compat against the JAX package.

Inputs are made from numpy seeds and fed to both packages.  Tolerance:
exact equality of float64 scores and int32 backpointers — both sides do the
same IEEE operations one at a time, and max/argmin do not reassociate.
The chain DP tests each pair (anchor k, anchor l) in that order, as the JAX
package's ``chain_dp_batch`` and the host oracle's ``check_compatibility``
do; the ``inverted`` kind and ``inverted_pair_batch`` make the order matter.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from muchsalsa_tpu.ops.chaining_jax import chain_dp_batch as jax_chain_dp_batch
from muchsalsa_tpu.ops.chaining_jax import compat_init_batch as jax_compat_init_batch
from muchsalsa_tpu.ops.chaining_pallas import chain_scan_pallas
from muchsalsa_tpu_torch.ops.chain_scan import (
    NEG, chain_dp, chain_dp_reference, chain_scan, chain_scan_reference)
from muchsalsa_tpu_torch.ops.chaining_torch import (
    _FIELD_MAP, bucket_batch, chain_dp_batch_kernel, compat_init_batch)
from muchsalsa_tpu_torch.state import batch_to_torch, pack_batch, unpack_batch
from muchsalsa_tpu_torch.ops.chaining import check_compatibility
from muchsalsa_tpu_torch.testing.chains import (
    KINDS, WIGGLE_ROOM, chain_batch, inverted_pair_batch)

BUCKETS = (8, 16, 32, 64, 128)


def random_scan_inputs(B, K, seed):
    """Asymmetric random compat (a transposed read fails) and initial
    scores with -1e30 holes."""
    rng = np.random.default_rng(seed)
    compat = rng.integers(0, 2, (B, K, K), dtype=np.uint8)
    init = rng.integers(400, 1500, (B, K)).astype(np.float64)
    init[rng.random((B, K)) < 0.15] = NEG
    return compat, init


# one case per K: interpret-mode Pallas is slow on the CPU
@pytest.mark.parametrize("B,K", [(5, 8), (130, 16), (64, 64), (33, 128)])
def test_chain_scan_matches_pallas_interpret(B, K):
    compat, init = random_scan_inputs(B, K, seed=B * 1000 + K)
    assert not np.array_equal(compat, compat.transpose(0, 2, 1))
    s_ref, b_ref = chain_scan_pallas(jnp.asarray(compat), jnp.asarray(init), interpret=True)
    s, b = chain_scan(torch.from_numpy(compat), torch.from_numpy(init))
    assert s.dtype == torch.float64 and b.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))


def test_chain_scan_ties_take_smallest_index():
    """All-true compat with equal (zero) initial scores: every candidate
    ties, so each backpointer is the smallest index, 0."""
    B, K = 3, 8
    compat = np.ones((B, K, K), dtype=bool)
    init = np.zeros((B, K), dtype=np.float64)
    s, b = chain_scan(torch.from_numpy(compat), torch.from_numpy(init))
    expect_bp = np.array([-1] + [0] * (K - 1), dtype=np.int32)
    np.testing.assert_array_equal(b.numpy(), np.tile(expect_bp, (B, 1)))
    np.testing.assert_array_equal(s.numpy(), init)
    s_ref, b_ref = chain_scan_pallas(jnp.asarray(compat), jnp.asarray(init), interpret=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))


def test_chain_scan_rejects_bad_inputs():
    compat, init = random_scan_inputs(4, 8, seed=1)
    c, i = torch.from_numpy(compat), torch.from_numpy(init)
    with pytest.raises(TypeError):
        chain_scan(c, i.float())
    with pytest.raises(TypeError):
        chain_scan(c.to(torch.int32), i)
    with pytest.raises(ValueError):
        chain_scan(c[:, :4], i)
    with pytest.raises(ValueError):
        chain_scan(c.transpose(1, 2), i)  # not contiguous
    with pytest.raises(ValueError):
        chain_scan(torch.zeros((1, 129, 129), dtype=torch.uint8),
                   torch.zeros((1, 129), dtype=torch.float64))
    # neither cpu nor cuda: no silent fallback to the plain version
    with pytest.raises(ValueError):
        chain_scan(c.to("meta"), i.to("meta"))


def _holed_example_batch(B, K):
    batch = {k: np.asarray(v) for k, v in _example_batch(B, K, np.float64, seed=B + K).items()}
    batch["valid"] = batch["valid"].copy()
    batch["valid"][::3, -2:] = False
    return batch


@pytest.mark.parametrize("B,K", [(5, 8), (130, 16), (64, 64)])
def test_compat_and_dp_match_jax(B, K):
    batch = _holed_example_batch(B, K)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = batch_to_torch(batch, "cpu")

    c_ref, i_ref = jax_compat_init_batch(jbatch, 300)
    c, i = compat_init_batch(tbatch, 300)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))

    s_ref, b_ref = jax_chain_dp_batch(jbatch, 300)
    s, b = chain_dp_batch_kernel(tbatch, 300)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))


def test_batch_to_torch_checks_dtypes():
    batch = _holed_example_batch(4, 8)
    out = batch_to_torch(batch, "cpu")
    assert out["score"].dtype == torch.float64 and out["valid"].dtype == torch.bool
    bad = dict(batch, score=batch["score"].astype(np.float32))
    with pytest.raises(TypeError):
        batch_to_torch(bad, "cpu")
    with pytest.raises(KeyError):
        batch_to_torch({k: v for k, v in batch.items() if k != "cls_dir"}, "cpu")


def test_reference_is_the_wrapper_on_cpu():
    compat, init = random_scan_inputs(7, 16, seed=3)
    before = chain_scan.launches
    s0, b0 = chain_scan_reference(torch.from_numpy(compat), torch.from_numpy(init))
    s1, b1 = chain_scan(torch.from_numpy(compat), torch.from_numpy(init))
    assert torch.equal(s0, s1) and torch.equal(b0, b1)
    assert chain_scan.launches == before  # the plain version is no launch


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", BUCKETS)
def test_chain_dp_matches_jax(K, kind):
    """The packed batch through chain_dp on CPU tensors (its plain version)
    equals the JAX package's chain_dp_batch on the same numpy batch."""
    arrs = chain_batch(9, K, kind, seed=K)
    s_ref, b_ref = jax_chain_dp_batch({k: jnp.asarray(v) for k, v in arrs.items()}, WIGGLE_ROOM)
    s, b = chain_dp(*pack_batch(arrs), K, WIGGLE_ROOM)
    assert s.dtype == torch.float64 and b.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))


def test_boundary_batch_hits_the_edges():
    """Consecutive anchors of the boundary kind meet diff == wiggle_room,
    rel == 15.0 exactly and mx == 0, each compatible or not as the rules say,
    and the shared score makes ties that go to the smallest index."""
    arrs = chain_batch(64, 8, "boundary", seed=1)
    d1 = arrs["v_ns"][:, 1:] - arrs["v_ne"][:, :-1] + 1.0
    d2 = arrs["w_ns"][:, 1:] - arrs["w_ne"][:, :-1] + 1.0
    mx, diff = np.maximum(d1, d2), np.abs(d1 - d2)
    both = arrs["valid"][:, 1:] & arrs["valid"][:, :-1] & arrs["cls_dir"][:, None]
    compat, _ = compat_init_batch(batch_to_torch(arrs, "cpu"), WIGGLE_ROOM)
    step = compat.numpy()[:, np.arange(1, 8), np.arange(7)]  # [b, l, l - 1]
    at_wiggle = both & (d1 > 0) & (diff == WIGGLE_ROOM)
    at_rel = both & (d1 > 0) & (diff > WIGGLE_ROOM) & (diff * 100.0 / mx == 15.0)
    past = both & (d1 > 0) & ((diff == WIGGLE_ROOM + 1) | (diff == 601))
    assert at_wiggle.any() and at_rel.any() and past.any()
    assert step[at_wiggle].all() and step[at_rel].all() and not step[past].any()
    assert (both & (arrs["v_ns"][:, 1:] == arrs["v_ns"][:, :-1])).any()  # mx == 0
    scores, bps = (x.numpy() for x in chain_dp(*pack_batch(arrs), 8, WIGGLE_ROOM))
    c = compat.numpy() & (np.arange(8)[None, None, :] < np.arange(8)[None, :, None])
    cand = np.where(c, scores[:, None, :], -np.inf)  # [b, l, k], k < l
    best = cand.max(axis=2)
    tied = (cand == best[..., None]) & c
    ties = tied.sum(axis=2) > 1
    assert ties.any()
    np.testing.assert_array_equal(bps[ties], np.argmax(tied, axis=2)[ties])


@pytest.mark.parametrize("kind", KINDS)
def test_packed_batch_matches_per_field(kind):
    """One packed batch gives the per-field dict's results, holds only the
    valid anchors, and unpacks to the same fields at every valid anchor."""
    arrs = chain_batch(33, 16, kind, seed=5)
    fields, flags, offsets = pack_batch(arrs)
    valid = arrs["valid"]
    N = int(valid.sum())
    assert fields.is_contiguous() and fields.shape == (13, N)
    assert flags.dtype == torch.uint8 and flags.shape == (N,)
    assert offsets.dtype == torch.int32 and offsets.tolist() == [0, *np.cumsum(valid.sum(1))]
    got = unpack_batch(fields, flags, offsets, 16)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for name in ("v_ns", "v_ne", "v_is", "v_ie", "v_rr", "w_ns", "w_ne", "w_is", "w_ie",
                 "w_rr", "ov_s", "ov_e", "score", "v_dir", "w_dir"):
        np.testing.assert_array_equal(got[name].numpy()[valid], arrs[name][valid], err_msg=name)
    rows = valid.any(axis=1)
    np.testing.assert_array_equal(got["cls_dir"].numpy()[rows], arrs["cls_dir"][rows])
    s, b = chain_dp(fields, flags, offsets, 16, WIGGLE_ROOM)
    s1, b1 = chain_dp_batch_kernel(batch_to_torch(arrs, "cpu"), WIGGLE_ROOM)
    compat, init = compat_init_batch(batch_to_torch(arrs, "cpu"), WIGGLE_ROOM)
    s2, b2 = chain_scan_reference(compat.transpose(1, 2), init)
    assert torch.equal(s, s1) and torch.equal(b, b1)
    assert torch.equal(s, s2) and torch.equal(b, b2)


def test_pack_batch_needs_valid_anchors_first():
    arrs = chain_batch(4, 8, "random", seed=4)
    arrs["valid"] = arrs["valid"].copy()
    arrs["valid"][0] = [False, True] + [False] * 6
    with pytest.raises(ValueError):
        pack_batch(arrs)


@pytest.mark.parametrize("K", (8, 32))
def test_bucket_batch_is_the_packed_per_field_batch(K):
    """The chaining phase's packed bucket equals the per-field batch that
    phase built before (zeroed numpy tables, rRatio 1.0 in padding, anchors
    scattered to their slots) packed by pack_batch."""
    rng = np.random.default_rng(K)
    nb, n_rows = 21, 1000
    B = 32
    sizes = rng.integers(1, K + 1, nb)
    total = int(sizes.sum())
    prob_of_row = np.repeat(np.arange(nb), sizes)
    row_pos = np.arange(total) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    src = rng.permutation(n_rows)[:total]
    dest = prob_of_row * K + row_pos
    f = {g: rng.integers(0, 5000, n_rows).astype(np.float64) for g in _FIELD_MAP.values()}
    f.update(v_dir=rng.random(n_rows) < 0.5, w_dir=rng.random(n_rows) < 0.5)
    cls_dir = rng.random(nb) < 0.5

    arrs = {}
    for bf, gf in _FIELD_MAP.items():
        a = np.zeros(B * K, dtype=np.float64)
        if bf in ("v_rr", "w_rr"):
            a[:] = 1.0
        a[dest] = f[gf][src]
        arrs[bf] = a.reshape(B, K)
    for bf in ("v_dir", "w_dir"):
        a = np.zeros(B * K, dtype=bool)
        a[dest] = f[bf][src]
        arrs[bf] = a.reshape(B, K)
    valid = np.zeros(B * K, dtype=bool)
    valid[dest] = True
    arrs["valid"] = valid.reshape(B, K)
    arrs["cls_dir"] = np.zeros(B, dtype=bool)
    arrs["cls_dir"][:nb] = cls_dir

    packed = bucket_batch(f, src, sizes, cls_dir, B, pin=False)
    for got, want in zip(packed, pack_batch(arrs)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    s, b = chain_dp(*packed, K, WIGGLE_ROOM)
    s1, b1 = chain_dp_batch_kernel(batch_to_torch(arrs, "cpu"), WIGGLE_ROOM)
    assert torch.equal(s, s1) and torch.equal(b, b1)


def test_chain_dp_rejects_bad_inputs():
    fields, flags, offsets = pack_batch(chain_batch(4, 8, "random", seed=2))
    with pytest.raises(TypeError):
        chain_dp(fields.float(), flags, offsets, 8, WIGGLE_ROOM)
    with pytest.raises(TypeError):
        chain_dp(fields, flags.bool(), offsets, 8, WIGGLE_ROOM)
    with pytest.raises(TypeError):
        chain_dp(fields, flags, offsets.long(), 8, WIGGLE_ROOM)
    with pytest.raises(ValueError):
        chain_dp(fields[:12], flags, offsets, 8, WIGGLE_ROOM)
    with pytest.raises(ValueError):
        chain_dp(fields, flags[:-1], offsets, 8, WIGGLE_ROOM)
    with pytest.raises(ValueError):
        chain_dp(fields.t().contiguous().t(), flags, offsets, 8, WIGGLE_ROOM)
    with pytest.raises(ValueError):
        chain_dp(fields, flags, offsets, 129, WIGGLE_ROOM)
    with pytest.raises(ValueError):  # a problem of more than K anchors
        chain_dp(fields, flags, offsets, 2, WIGGLE_ROOM)
    # neither cpu nor cuda: no silent fallback to the plain version
    with pytest.raises(ValueError):
        chain_dp(fields.to("meta"), flags.to("meta"), offsets.to("meta"), 8, WIGGLE_ROOM)


def test_chain_dp_reference_is_the_wrapper_on_cpu():
    fields, flags, offsets = pack_batch(chain_batch(7, 32, "random", seed=3))
    before = chain_dp.launches
    s0, b0 = chain_dp_reference(fields, flags, offsets, 32, WIGGLE_ROOM)
    s1, b1 = chain_dp(fields, flags, offsets, 32, WIGGLE_ROOM)
    assert torch.equal(s0, s1) and torch.equal(b0, b1)
    assert chain_dp.launches == before  # the plain version is no launch


def oracle_context(arrs, b):
    """Problem ``b`` of a per-field batch as the host oracle's edge context."""
    f = {name: arrs[name][b] for name in arrs if name not in ("cls_dir", "valid")}
    return SimpleNamespace(**f, ov_start=f["ov_s"], ov_end=f["ov_e"],
                           em_dir=np.full(len(f["score"]), bool(arrs["cls_dir"][b])))


def test_inverted_pair_matches_jax_and_oracle():
    """Two anchors whose pair order decides the chain: the oracle admits
    (1, 0) but not (0, 1), and chain_dp, like the JAX package's
    chain_dp_batch, keeps both anchors unchained."""
    arrs = inverted_pair_batch()
    ctx = oracle_context(arrs, 0)
    assert not check_compatibility(ctx, 0, 1, WIGGLE_ROOM)
    assert check_compatibility(ctx, 1, 0, WIGGLE_ROOM)
    s_ref, b_ref = jax_chain_dp_batch({k: jnp.asarray(v) for k, v in arrs.items()}, WIGGLE_ROOM)
    s, b = chain_dp(*pack_batch(arrs), 8, WIGGLE_ROOM)
    assert s[0, :2].tolist() == [500.0, 700.0] and b[0].tolist() == [-1] * 8
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))


@pytest.mark.parametrize("K", (8, 32))
def test_inverted_batch_follows_the_oracle_pair_order(K):
    """The inverted kind makes compat_init_batch asymmetric; its [b, k, l]
    is the oracle's check_compatibility(k, l) at every valid pair, and
    chain_dp differs from a scan that reads the pairs the other way."""
    arrs = chain_batch(16, K, "inverted", seed=K + 7)
    compat, init = compat_init_batch(batch_to_torch(arrs, "cpu"), WIGGLE_ROOM)
    c = compat.numpy()
    below = np.tri(K, k=-1, dtype=bool)
    assert (c != c.transpose(0, 2, 1))[:, below].any()
    for b in range(16):
        n = int(arrs["valid"][b].sum())
        ctx = oracle_context(arrs, b)
        for k in range(n):
            for l in range(k + 1, n):
                assert c[b, k, l] == check_compatibility(ctx, k, l, WIGGLE_ROOM), (b, k, l)
    s, bp = chain_dp(*pack_batch(arrs), K, WIGGLE_ROOM)
    s_other, bp_other = chain_scan_reference(compat, init)
    assert not (torch.equal(s, s_other) and torch.equal(bp, bp_other))
