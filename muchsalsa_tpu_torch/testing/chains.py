"""Chaining batches for the chaining kernels' checks.

Host numpy only, from a seed: per-field batches in the layout of
``state.py`` (13 float64 (B, K) fields, (B, K) bool ``v_dir``/``w_dir``/
``valid`` and the (B,) bool ``cls_dir``), of three kinds:

- ``random``: anchors of 400-1,200 bases with random overlap trimming,
  rRatios, directions and strand classes, some padding anchors at the
  rows' ends and some all-padding rows, integer scores (ties happen);
- ``boundary``: anchors whose consecutive gaps differ by exactly the
  wiggle room (``diff == wiggle_room``) and by one more, whose relative gap
  difference is exactly 15 % (``rel == 15.0``) and just above, duplicated
  anchors (``mx == 0``), all with one score (every chain ties);
- ``padding``: rows of padding anchors only;
- ``inverted``: anchors of 100 bases on a 100-base grid, about half of
  them with an empty overlap and an illumina range 50 bases longer than
  the nanopore range, so that their corrected range inverts (hi < lo) and
  many share a corrected start: the compatibility of (k, l) then differs
  from that of (l, k).

``example_batch`` is the port's copy of ``__graft_entry__.py::_example_batch``,
the batch of the JAX package's chaining benchmark, as numpy arrays.
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.state import BOOL_FIELDS, FLOAT_FIELDS

KINDS = ("random", "boundary", "padding", "inverted")
WIGGLE_ROOM = 300

# (v step, w step) between consecutive anchors of 100 bases on both
# vertices: gaps d1 = v step - 99 and d2 = w step - 99
_BOUNDARY_STEPS = (
    (1000, 1000 + WIGGLE_ROOM),      # |d1 - d2| == wiggle room: compatible
    (1000, 1001 + WIGGLE_ROOM),      # one more: not (rel 25 %)
    (4099, 3499),                    # 600 * 100 / 4000 == 15.0: compatible
    (4099, 3498),                    # 601: rel 15.025 %, not
    (0, 0),                          # the same anchor again: ori 0, mx == 0
)


def _empty(B: int, K: int) -> dict[str, np.ndarray]:
    out = {name: np.zeros((B, K), dtype=np.float64) for name in FLOAT_FIELDS}
    out["v_rr"][:] = 1.0
    out["w_rr"][:] = 1.0
    for name in BOOL_FIELDS[:-1]:
        out[name] = np.zeros((B, K), dtype=bool)
    out["cls_dir"] = np.zeros(B, dtype=bool)
    return out


def chain_batch(B: int, K: int, kind: str, seed: int) -> dict[str, np.ndarray]:
    """A (B, K) chaining batch of ``kind`` (see the module doc)."""
    rng = np.random.default_rng(seed)
    out = _empty(B, K)
    if kind == "padding":
        return out
    if kind == "random":
        ns = np.sort(rng.integers(0, 20 * K * 100, (B, K)), axis=1).astype(np.float64)
        span = rng.integers(400, 1200, (B, K)).astype(np.float64)
        is_ = rng.integers(0, 200, (B, K)).astype(np.float64)
        w_ns = ns + rng.integers(-300, 300, (B, K))
        trim = rng.integers(0, 60, (B, K)).astype(np.float64)
        rr = rng.choice(np.array([1.0, 0.5, 1.25, 2.0, 0.8]), (B, K))
        out.update(v_ns=ns, v_ne=ns + span, w_ns=w_ns, w_ne=w_ns + span, v_is=is_,
                   v_ie=is_ + span, w_is=is_, w_ie=is_ + span, ov_s=is_ + trim,
                   ov_e=is_ + span - trim[:, ::-1], v_rr=rr, w_rr=rr[:, ::-1].copy(),
                   score=rng.integers(400, 1500, (B, K)).astype(np.float64))
        out["v_dir"] = rng.random((B, K)) < 0.5
        out["w_dir"] = rng.random((B, K)) < 0.5
        sizes = rng.integers(1, K + 1, B)
        sizes[rng.random(B) < 0.1] = 0
    elif kind == "boundary":
        steps = np.array(_BOUNDARY_STEPS, dtype=np.float64)
        pick = (rng.integers(0, len(steps), (B, 1)) + np.arange(K)) % len(steps)
        pos = np.cumsum(steps[pick], axis=1)
        out.update(v_ns=pos[..., 0], v_ne=pos[..., 0] + 100, w_ns=pos[..., 1],
                   w_ne=pos[..., 1] + 100, v_ie=np.full((B, K), 100.0),
                   w_ie=np.full((B, K), 100.0), ov_e=np.full((B, K), 100.0),
                   score=np.full((B, K), 500.0))
        out["v_dir"] = rng.random((B, K)) < 0.5
        out["w_dir"] = rng.random((B, K)) < 0.5
        sizes = np.where(rng.random(B) < 0.8, K, rng.integers(0, K + 1, B))
    elif kind == "inverted":
        # a proper anchor: illumina range (0, 100), overlap (0, 100), so its
        # corrected range is (ns, ne); an inverted one: illumina range (ns,
        # ns + 150), overlap empty at (0, 0), so that it corrects to (0, -50)
        # forward and (2 ns + 150, 2 ns + 100) reversed
        v_ns = 100.0 * np.sort(rng.integers(0, 2 * K, (B, K)), axis=1)
        w_ns = 100.0 * np.sort(rng.integers(0, 2 * K, (B, K)), axis=1)
        v_inv = rng.random((B, K)) < 0.5
        w_inv = rng.random((B, K)) < 0.5
        out.update(v_ns=v_ns, v_ne=v_ns + 100, w_ns=w_ns, w_ne=w_ns + 100,
                   v_is=np.where(v_inv, v_ns, 0.0), v_ie=np.where(v_inv, v_ns + 150, 100.0),
                   w_is=np.where(w_inv, w_ns, 0.0), w_ie=np.where(w_inv, w_ns + 150, 100.0),
                   ov_s=np.zeros((B, K)), ov_e=np.where(v_inv | w_inv, 0.0, 100.0),
                   score=rng.integers(400, 1500, (B, K)).astype(np.float64))
        out["v_dir"] = rng.random((B, K)) < 0.8
        out["w_dir"] = rng.random((B, K)) < 0.8
        sizes = np.where(rng.random(B) < 0.8, K, rng.integers(0, K + 1, B))
    else:
        raise ValueError(f"unknown chain batch kind {kind!r}")
    out["valid"] = np.arange(K)[None, :] < sizes[:, None]
    out["cls_dir"] = rng.random(B) < 0.7
    return out


def inverted_pair_batch(K: int = 8) -> dict[str, np.ndarray]:
    """One problem of two anchors whose pair order decides the result.

    Anchor 0 is proper: v and w (0, 100), illumina (0, 100), overlap
    (0, 100), score 500.  Anchor 1 has an empty overlap at (0, 0) and an
    illumina range on v of (200, 350), longer than its nanopore range (200,
    300), so its corrected v range inverts to (0, -50); w (200, 300),
    illumina (0, 0); score 700.  Both directions and the strand class are
    forward.  The pair (anchor 0, anchor 1) is incompatible and (1, 0)
    compatible, so a chain DP that tests (k, l), as the JAX package's
    ``chain_dp_batch`` and the host oracle do, gives scores [500, 700] and
    backpointers [-1, -1].
    """
    out = _empty(1, K)
    out.update(v_ns=np.array([[0.0, 200.0] + [0.0] * (K - 2)]),
               v_ne=np.array([[100.0, 300.0] + [0.0] * (K - 2)]),
               v_is=np.array([[0.0, 200.0] + [0.0] * (K - 2)]),
               v_ie=np.array([[100.0, 350.0] + [0.0] * (K - 2)]),
               w_ns=np.array([[0.0, 200.0] + [0.0] * (K - 2)]),
               w_ne=np.array([[100.0, 300.0] + [0.0] * (K - 2)]),
               w_ie=np.array([[100.0, 0.0] + [0.0] * (K - 2)]),
               ov_e=np.array([[100.0, 0.0] + [0.0] * (K - 2)]),
               score=np.array([[500.0, 700.0] + [0.0] * (K - 2)]))
    out["v_dir"] = np.arange(K)[None, :] < 2
    out["w_dir"] = out["v_dir"].copy()
    out["valid"] = out["v_dir"].copy()
    out["cls_dir"] = np.ones(1, dtype=bool)
    return out


def example_batch(B: int, K: int, dtype, seed: int = 0) -> dict[str, np.ndarray]:
    """The (B, K) chaining batch of ``__graft_entry__.py::_example_batch``:
    the same draws of ``default_rng(seed)`` in the same order, every anchor
    valid, every strand class forward; numpy arrays of ``dtype`` (bool
    masks)."""
    rng = np.random.default_rng(seed)
    ns = rng.integers(0, 5000, (B, K)).astype(dtype)
    span = rng.integers(400, 1200, (B, K)).astype(dtype)
    is_ = rng.integers(0, 200, (B, K)).astype(dtype)
    return {
        "v_ns": ns, "v_ne": ns + span,
        "w_ns": ns, "w_ne": ns + span,
        "v_is": is_, "v_ie": is_ + span,
        "w_is": is_, "w_ie": is_ + span,
        "ov_s": is_ + 10, "ov_e": is_ + span - 10,
        "v_rr": np.ones((B, K), dtype=dtype),
        "w_rr": np.ones((B, K), dtype=dtype),
        "score": rng.integers(400, 1500, (B, K)).astype(dtype),
        "v_dir": rng.integers(0, 2, (B, K)).astype(bool),
        "w_dir": rng.integers(0, 2, (B, K)).astype(bool),
        "valid": np.ones((B, K), dtype=bool),
        "cls_dir": np.ones(B, dtype=bool),
    }
