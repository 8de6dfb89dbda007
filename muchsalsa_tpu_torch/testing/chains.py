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
- ``padding``: rows of padding anchors only.
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.state import BOOL_FIELDS, FLOAT_FIELDS

KINDS = ("random", "boundary", "padding")
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
    else:
        raise ValueError(f"unknown chain batch kind {kind!r}")
    out["valid"] = np.arange(K)[None, :] < sizes[:, None]
    out["cls_dir"] = rng.random(B) < 0.7
    return out
