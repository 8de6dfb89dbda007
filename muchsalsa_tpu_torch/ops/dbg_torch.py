"""De Bruijn extension tables on a torch device.

Port of ``muchsalsa_tpu/ops/dbg_jax.py``, the device leg of the DBG unitig
walk (``pipeline/dbg.py::UnitigBuilder``, the native replacement for the
reference's external ``abyss-pe``, pipeline/pipeline.sh:153-159): for every
canonical k-mer of the sorted set, its 8 possible extensions (4 forward
bases, 4 backward bases) are canonicalised and looked up in the set, all at
once.  The serial stitch stays on the host (``pipeline/dbg.py``), driven by
this table with one lookup a step.

A value is one int64 of 2k bits (k <= 31; the JAX package splits it across
two uint32 lanes).  Every operand is masked to 2k bits before a shift, so no
right shift drags in the sign.  Membership is ``torch.searchsorted`` over
the sorted set and an equality check: the same index as the JAX package's
fixed-round binary search and its rank table, which spared the TPU's
compiler an unrolled search.
"""

from __future__ import annotations

import numpy as np
import torch

from muchsalsa_tpu_torch.device import resolve_device

# the last ext_indices_device call: device, rows (k-mers), chunks
DBG_DEVICE_STATS: dict = {}

Tensor = torch.Tensor

# 2-bit field swaps of a 64-bit word; each mask's top bits are 0, so the
# arithmetic right shift's sign bits are cleared
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def _revcomp(x: Tensor, k: int) -> Tensor:
    """Reverse complement of 2k-bit int64 values (``pipeline.dbg._revcomp_val``)."""
    mask = (1 << (2 * k)) - 1
    y = (~x) & mask
    y = ((y & _M2) << 2) | ((y >> 2) & _M2)
    y = ((y & _M4) << 4) | ((y >> 4) & _M4)
    y = ((y & _M8) << 8) | ((y >> 8) & _M8)
    y = ((y & _M16) << 16) | ((y >> 16) & _M16)
    y = ((y & _M32) << 32) | ((y >> 32) & _M32)
    # the fields now fill the word from the top: move them down
    return (y >> (64 - 2 * k)) & mask


def _canon(x: Tensor, k: int) -> Tensor:
    return torch.minimum(x, _revcomp(x, k))


def _search(q: Tensor, sorted_vals: Tensor) -> Tensor:
    """Index of each of ``q`` in the sorted unique ``sorted_vals``, -1 where
    absent."""
    idx = torch.searchsorted(sorted_vals, q).clamp_(max=sorted_vals.numel() - 1)
    return torch.where(sorted_vals[idx] == q, idx, -1)


def ext_indices_chunk(v: Tensor, sorted_vals: Tensor, k: int) -> Tensor:
    """(C, 8) int32: for each k-mer of ``v``, the set index of the canonical
    form of extension j (j = base forward, 4 + base backward), or -1.
    Matches ``pipeline.dbg.UnitigBuilder._extensions`` on the canonical
    orientation."""
    mask = (1 << (2 * k)) - 1
    outs = []
    for b in range(4):
        # forward: ((v << 2) | b) & mask_2k
        outs.append(_search(_canon(((v << 2) | b) & mask, k), sorted_vals))
    for b in range(4):
        # backward: (v >> 2) | (b << (2k - 2))
        outs.append(_search(_canon((v >> 2) | (b << (2 * k - 2)), k), sorted_vals))
    return torch.stack(outs, dim=1).to(torch.int32)


def ext_indices_device(vals: np.ndarray, k: int, chunk: int = 1 << 20,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """(N, 8) int32 extension-index table of the sorted uint64 canonical
    k-mers ``vals`` on ``device``: the set crosses once, the table is built
    ``chunk`` k-mers at a time on the device and comes back by one copy."""
    if not 1 <= k <= 31:
        raise ValueError(f"k = {k}: the int64 packing holds k <= 31")
    dev = resolve_device(device)
    N = len(vals)
    DBG_DEVICE_STATS.clear()
    DBG_DEVICE_STATS.update(device=str(dev), rows=N, chunks=0)
    if N == 0:
        return np.zeros((0, 8), dtype=np.int32)
    pin = dev.type == "cuda"
    host = torch.empty(N, dtype=torch.int64, pin_memory=pin)
    # below 2**62: the uint64 bits are the int64 value
    host.numpy()[:] = np.asarray(vals, dtype=np.uint64).view(np.int64)
    sorted_vals = host.to(dev, non_blocking=True)
    table = torch.empty((N, 8), dtype=torch.int32, device=dev)
    for s in range(0, N, chunk):
        table[s : s + chunk] = ext_indices_chunk(sorted_vals[s : s + chunk], sorted_vals, k)
        DBG_DEVICE_STATS["chunks"] += 1
    out = torch.empty((N, 8), dtype=torch.int32, pin_memory=pin)
    out.copy_(table)
    return out.numpy()
