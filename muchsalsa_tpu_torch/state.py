"""The chaining batch tables, as per-field tensors and as one packed batch.

The host builds one padded table per bucket (``ops/chaining_torch.py``, as
``muchsalsa_tpu/ops/chaining_jax.py`` does): (B, K) float64 anchor fields,
(B, K) bool ``v_dir``/``w_dir``/``valid`` and the (B,) bool ``cls_dir``.
Both packages take the same numpy tables, so they compute on identical
inputs.  A problem's valid anchors come first in its row.

The fused chaining kernel (``ops/chain_scan.py::chain_dp``) reads the same
batch packed without its padding, so that it crosses to the card in one
copy of each of three tensors and the kernel reads only anchors: ``fields``
(13, N) float64, the ``FLOAT_FIELDS`` of the N valid anchors, problem by
problem in row order; ``flags`` (N,) uint8 holding each anchor's ``v_dir``
and ``w_dir`` bits and its problem's ``cls_dir`` bit; ``offsets`` (B + 1,)
int32, problem b's anchors being ``offsets[b]`` to ``offsets[b + 1]``.
"""

from __future__ import annotations

import numpy as np
import torch

from muchsalsa_tpu_torch.device import resolve_device

FLOAT_FIELDS = (
    "v_ns", "v_ne", "v_is", "v_ie", "v_rr",
    "w_ns", "w_ne", "w_is", "w_ie", "w_rr",
    "ov_s", "ov_e", "score",
)
BOOL_FIELDS = ("v_dir", "w_dir", "valid", "cls_dir")
# bits of the packed ``flags`` (csrc/chain_scan.cu reads the same bits)
V_DIR, W_DIR, CLS_DIR = 1, 2, 4


def batch_to_torch(
    arrs: dict[str, np.ndarray], device: str | torch.device
) -> dict[str, torch.Tensor]:
    """Copy a chaining batch onto ``device``, checking each field's dtype
    (float64 anchor fields, bool masks) so that no precision is lost."""
    dev = resolve_device(device)
    missing = set(FLOAT_FIELDS + BOOL_FIELDS) - set(arrs)
    if missing:
        raise KeyError(f"chaining batch lacks fields {sorted(missing)}")
    out = {}
    for name in FLOAT_FIELDS + BOOL_FIELDS:
        a = np.asarray(arrs[name])
        want = np.float64 if name in FLOAT_FIELDS else np.bool_
        if a.dtype != want:
            raise TypeError(f"batch field {name!r} is {a.dtype}, expected {np.dtype(want)}")
        out[name] = torch.tensor(a, device=dev)  # a copy, never a view
    return out


def pack_flags(v_dir, w_dir, cls_dir):
    """The ``flags`` byte of anchors from their direction masks and their
    problems' strand classes, all of one shape (numpy uint8 arrays or
    tensors alike)."""
    return (v_dir * V_DIR) | (w_dir * W_DIR) | (cls_dir * CLS_DIR)


def pack_batch(arrs: dict, *, pin: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A per-field batch (numpy arrays, or tensors on one device) packed:
    (fields, flags, offsets) on its device, in pinned host memory when
    ``pin``.  Raises unless each row's valid anchors come first."""
    t = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
         for k, v in arrs.items()}
    valid = t["valid"]
    B, K = valid.shape
    sizes = valid.sum(dim=1)
    if not torch.equal(valid, torch.arange(K, device=valid.device) < sizes[:, None]):
        raise ValueError("a problem's valid anchors must come first in its row")
    N = int(sizes.sum())
    fields = torch.empty((len(FLOAT_FIELDS), N), dtype=torch.float64, device=valid.device,
                         pin_memory=pin)
    for i, name in enumerate(FLOAT_FIELDS):
        fields[i] = t[name][valid]
    flags = torch.empty((N,), dtype=torch.uint8, device=valid.device, pin_memory=pin)
    flags[:] = pack_flags(*(m.to(torch.uint8) for m in (
        t["v_dir"][valid], t["w_dir"][valid], t["cls_dir"][:, None].expand(B, K)[valid])))
    offsets = torch.zeros((B + 1,), dtype=torch.int32, device=valid.device, pin_memory=pin)
    offsets[1:] = torch.cumsum(sizes, 0)
    return fields, flags, offsets


def unpack_batch(fields: torch.Tensor, flags: torch.Tensor, offsets: torch.Tensor,
                 K: int) -> dict[str, torch.Tensor]:
    """The per-field (B, K) batch of a packed one, on its device: padding
    anchors hold 0 (``v_rr`` and ``w_rr`` 1.0), and a problem without
    anchors has ``cls_dir`` False.  Raises unless each problem has 0 to K
    anchors and the offsets cover the N anchors."""
    dev = fields.device
    B = offsets.shape[0] - 1
    sizes = (offsets[1:] - offsets[:-1]).long()
    if B < 0 or int(offsets[0]) != 0 or int(offsets[-1]) != fields.shape[1] or (
            B and not bool(((sizes >= 0) & (sizes <= K)).all())):
        raise ValueError(f"offsets do not cut {fields.shape[1]} anchors into problems of "
                         f"0 to {K}")
    valid = torch.arange(K, device=dev) < sizes[:, None]
    out = {}
    for i, name in enumerate(FLOAT_FIELDS):
        out[name] = torch.full((B, K), 1.0 if name in ("v_rr", "w_rr") else 0.0,
                               dtype=torch.float64, device=dev)
        out[name][valid] = fields[i]
    for name, bit in (("v_dir", V_DIR), ("w_dir", W_DIR)):
        out[name] = torch.zeros((B, K), dtype=torch.bool, device=dev)
        out[name][valid] = (flags & bit) != 0
    out["valid"] = valid
    first = offsets[:-1].long().clamp(max=max(fields.shape[1] - 1, 0))
    out["cls_dir"] = (sizes > 0) & ((flags[first] & CLS_DIR) != 0) if fields.shape[1] else (
        torch.zeros((B,), dtype=torch.bool, device=dev))
    return out
