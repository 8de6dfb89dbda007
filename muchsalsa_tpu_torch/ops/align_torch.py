"""Banded edit distance (the Levenshtein wavefront) and problem packing.

Port of ``muchsalsa_tpu/ops/align.py`` (``pack_problems``,
``banded_edit_distance``) and of the TPU kernel
``muchsalsa_tpu/ops/align_pallas.py::banded_edit_distance_pallas``.  The
CUDA kernel is ``csrc/banded_wavefront.cu``;
``banded_edit_distance_reference`` is the plain PyTorch version of the same
function.  ``banded_edit_distance`` takes the plain version only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises.

``gather_problems`` builds the same packed batch as ``pack_problems`` from
coordinates into two blobs of raw bytes instead of sliced pairs: on CUDA
tensors with the kernel ``csrc/refine_gather.cu`` (which replaces no TPU
kernel: the JAX package packs on the host), on CPU tensors with
``gather_problems_reference``.

Contract (the XLA function's, align.py:55-116): with D the (m+1, n+1)
Levenshtein matrix, rows i = 1..rows (``rows = max_m or M``) sweep a band of
``band`` diagonals k = j - i in [klo, klo + band), klo = min(0, n - m) -
(band - 1 - |n - m|) // 2, cells outside 0 <= j <= n at ``INF``.  Each row
is ``cand = min(R[k] + cost, R[k+1] + 1)`` (``i`` at j = 0) followed by the
in-row chain as an inclusive prefix-min of ``cand - k``.  The result is the
band cell of j = n, or -1 when |n - m| >= band, m = 0, n = 0 or m > rows.
Codes compare as bytes, so an ``N`` (code 4) in the query matches an ``N``
in the target here, unlike in Myers' PEq.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from muchsalsa_tpu_torch.utils.seq import encode_2bit, reverse_complement

INF = 1 << 20
Q_PAD = 5   # query padding code: matches nothing
T_PAD = 4   # target padding code

# the gather's two code tables, a byte's code and, for a minus-strand
# target, the code of its complement: reverse_complement swaps upper-case
# ACGT alone, so a lower-case base keeps its own code there
_BYTES = np.arange(256, dtype=np.uint8)
FORWARD_CODES = encode_2bit(_BYTES)
MINUS_CODES = encode_2bit(np.frombuffer(reverse_complement(_BYTES.tobytes())[::-1], np.uint8))
_GATHER_TABLES: dict[torch.device, torch.Tensor] = {}


def pack_problems(pairs: list[tuple[bytes, bytes]]):
    """(query, target) byte pairs -> (q_codes (P, M) uint8 padded with 5,
    q_lens (P,) int32, t_codes (P, N) uint8 padded with 4, t_lens (P,)
    int32) as CPU tensors; M and N are the longest query and target (1 when
    there are none), as ``muchsalsa_tpu/ops/align.py::pack_problems``."""
    P = len(pairs)
    q_lens = np.fromiter((len(q) for q, _ in pairs), dtype=np.int32, count=P)
    t_lens = np.fromiter((len(t) for _, t in pairs), dtype=np.int32, count=P)
    M = int(q_lens.max()) if P else 1
    N = int(t_lens.max()) if P else 1

    def pad(seqs, lens, width, fill):
        out = np.full((P, width), fill, dtype=np.uint8)
        total = int(lens.sum())
        if total:
            codes = encode_2bit(b"".join(seqs))
            rows = np.repeat(np.arange(P), lens)
            starts = np.cumsum(lens) - lens
            cols = np.arange(total) - np.repeat(starts, lens)
            out[rows, cols] = codes
        return torch.from_numpy(out)

    return (
        pad([q for q, _ in pairs], q_lens, M, Q_PAD),
        torch.from_numpy(q_lens),
        pad([t for _, t in pairs], t_lens, N, T_PAD),
        torch.from_numpy(t_lens),
    )


class GatherArgs(NamedTuple):
    """``gather_problems``' inputs but its widths, as numpy arrays or
    tensors: two blobs of raw bytes (uint8), and for each problem where its
    sequence begins in its blob (``*_off``, int64), its range's start
    (``*_start``, int64) and length (``*_len``, int32), and whether the
    target is read on the minus strand (``t_minus``, bool)."""

    q_blob: object
    q_off: object
    q_start: object
    q_len: object
    t_blob: object
    t_off: object
    t_start: object
    t_len: object
    t_minus: object

    def to(self, device) -> "GatherArgs":
        """Every field as a tensor on ``device``."""
        return GatherArgs(*(torch.as_tensor(x).to(device) for x in self))


def slice_bounds(start: np.ndarray, end: np.ndarray, length: np.ndarray):
    """(start, length) of ``seq[start:end]`` for sequences of ``length``
    bytes, as Python slicing gives them: negative indices count from the
    end, both are clamped into [0, length], and the length is never below
    0.  int64 arrays in, int64 and int32 out."""
    start, end, length = (np.asarray(x, dtype=np.int64) for x in (start, end, length))

    def clamp(i):
        return np.where(i < 0, np.maximum(i + length, 0), np.minimum(i, length))

    lo, hi = clamp(start), clamp(end)
    return lo, np.maximum(hi - lo, 0).astype(np.int32)


def _check_gather(q_blob, q_off, q_start, q_len, t_blob, t_off, t_start, t_len, t_minus,
                  M: int, N: int) -> int:
    """Validate ``gather_problems``' inputs; returns P.  Every range must lie
    inside its blob and every length inside its width."""
    coords = (q_off, q_start, q_len, t_off, t_start, t_len, t_minus)
    if q_blob.dim() != 1 or t_blob.dim() != 1 or any(x.dim() != 1 for x in coords):
        raise ValueError("blobs and coordinates must be 1-D")
    P = q_len.shape[0]
    if any(x.shape[0] != P for x in coords):
        raise ValueError(f"coordinates of unequal lengths: {[tuple(x.shape) for x in coords]}")
    want = {"q_blob": (q_blob, torch.uint8), "t_blob": (t_blob, torch.uint8),
            "q_off": (q_off, torch.int64), "q_start": (q_start, torch.int64),
            "t_off": (t_off, torch.int64), "t_start": (t_start, torch.int64),
            "q_len": (q_len, torch.int32), "t_len": (t_len, torch.int32),
            "t_minus": (t_minus, torch.bool)}
    for name, (x, dtype) in want.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devs = {x.device for x, _ in want.values()}
    if len(devs) != 1:
        raise ValueError(f"inputs on more than one device: {sorted(map(str, devs))}")
    if M < 0 or N < 0:
        raise ValueError(f"widths must be >= 0, got M={M}, N={N}")
    if P:
        ends = []
        for blob, off, start, lens in ((q_blob, q_off, q_start, q_len),
                                       (t_blob, t_off, t_start, t_len)):
            first = off + start
            used = lens > 0
            ends += [torch.where(used, first, 0).min(), torch.where(used, first + lens, 0).max(),
                     lens.min().long(), lens.max().long()]
        q_lo, q_hi, ql_lo, ql_hi, t_lo, t_hi, tl_lo, tl_hi = torch.stack(ends).tolist()
        if not (0 <= ql_lo and ql_hi <= M and 0 <= tl_lo and tl_hi <= N):
            raise ValueError(f"lengths must lie in [0, M={M}] and [0, N={N}]")
        if not (0 <= q_lo and q_hi <= q_blob.numel() and 0 <= t_lo and t_hi <= t_blob.numel()):
            raise ValueError("a problem's range runs outside its blob")
    return P


def _gather_side(blob, off, start, lens, minus, width: int, pad: int) -> torch.Tensor:
    """One side of ``gather_problems_reference``, in chunks of rows that
    keep its index arrays near 2**24 elements."""
    dev = blob.device
    P = lens.shape[0]
    out = torch.full((P, width), pad, dtype=torch.uint8, device=dev)
    fwd = torch.from_numpy(FORWARD_CODES).to(dev)
    rc = torch.from_numpy(MINUS_CODES).to(dev)
    cols = torch.arange(width, dtype=torch.int64, device=dev)
    step = max(1, (1 << 24) // max(width, 1))
    for s in range(0, P, step):
        n = lens[s : s + step].long()[:, None]
        rev = minus[s : s + step, None].expand(-1, width)
        inside = cols < n
        pos = torch.where(rev, n - 1 - cols, cols)
        idx = (off[s : s + step] + start[s : s + step])[:, None] + pos
        raw = blob[idx[inside]].long()
        out[s : s + step][inside] = torch.where(rev[inside], rc[raw], fwd[raw])
    return out


def gather_problems_reference(q_blob, q_off, q_start, q_len, t_blob, t_off, t_start, t_len,
                              t_minus, M: int, N: int):
    """Plain PyTorch ``gather_problems``: an index array a side, codes
    looked up through the same two tables as the kernel."""
    _check_gather(q_blob, q_off, q_start, q_len, t_blob, t_off, t_start, t_len, t_minus, M, N)
    no_minus = torch.zeros_like(t_minus)
    return (_gather_side(q_blob, q_off, q_start, q_len, no_minus, M, Q_PAD), q_len,
            _gather_side(t_blob, t_off, t_start, t_len, t_minus, N, T_PAD), t_len)


def gather_problems(q_blob, q_off, q_start, q_len, t_blob, t_off, t_start, t_len, t_minus,
                    M: int, N: int):
    """The packed batch of P problems from coordinates into two blobs of raw
    bytes: ``(q_codes (P, M) uint8 padded with Q_PAD, q_len, t_codes (P, N)
    uint8 padded with T_PAD, t_len)``, what ``pack_problems`` gives for the
    pairs ``(q_blob[q_off + q_start :][: q_len], t)`` with ``t`` the bytes
    ``t_blob[t_off + t_start :][: t_len]``, reverse-complemented where
    ``t_minus``.

    The arguments are the fields of ``GatherArgs``, in its order (call
    ``gather_problems(*args, M, N)``), every range inside its blob, every
    length inside its width.  On CUDA tensors this launches
    ``csrc/refine_gather.cu`` on the current stream and counts the launch
    in ``gather_problems.launches``; on CPU tensors it runs
    ``gather_problems_reference``.
    """
    args = (q_blob, q_off, q_start, q_len, t_blob, t_off, t_start, t_len, t_minus)
    if device_type(q_blob, "gather_problems") == "cpu":
        return gather_problems_reference(*args, M, N)
    P = _check_gather(*args, M, N)
    dev = q_blob.device
    q_codes = torch.empty((P, M), dtype=torch.uint8, device=dev)
    t_codes = torch.empty((P, N), dtype=torch.uint8, device=dev)
    if P == 0:
        return q_codes, q_len, t_codes, t_len
    if dev not in _GATHER_TABLES:
        _GATHER_TABLES[dev] = torch.from_numpy(
            np.concatenate([FORWARD_CODES, MINUS_CODES])).to(dev)

    from muchsalsa_tpu_torch import kernels

    lib = kernels.load()
    ptrs = [ctypes.c_void_p(x.data_ptr())
            for x in (*args, _GATHER_TABLES[dev], q_codes, t_codes)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ms_refine_gather(*ptrs, P, M, N, ctypes.c_void_p(stream))
    kernels.check(lib, code, f"refine_gather launch (P={P}, M={M}, N={N})")
    gather_problems.launches += 1
    return q_codes, q_len, t_codes, t_len


gather_problems.launches = 0


def check_problems(q_codes, q_lens, t_codes, t_lens) -> tuple[int, int, int]:
    """Validate a packed batch; returns (P, M, N).  Lengths must lie within
    the padded widths: the kernels read no further than a problem's own
    length."""
    if q_codes.dim() != 2 or t_codes.dim() != 2:
        raise ValueError(
            f"codes must be (P, M) and (P, N), got {tuple(q_codes.shape)} "
            f"and {tuple(t_codes.shape)}")
    P, M = q_codes.shape
    N = t_codes.shape[1]
    if t_codes.shape[0] != P or tuple(q_lens.shape) != (P,) or tuple(t_lens.shape) != (P,):
        raise ValueError(
            f"inconsistent batch: q_codes {tuple(q_codes.shape)}, t_codes "
            f"{tuple(t_codes.shape)}, q_lens {tuple(q_lens.shape)}, t_lens "
            f"{tuple(t_lens.shape)}")
    if q_codes.dtype != torch.uint8 or t_codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {q_codes.dtype} and {t_codes.dtype}")
    if q_lens.dtype != torch.int32 or t_lens.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {q_lens.dtype} and {t_lens.dtype}")
    devs = {x.device for x in (q_codes, q_lens, t_codes, t_lens)}
    if len(devs) != 1:
        raise ValueError(f"inputs on more than one device: {sorted(map(str, devs))}")
    if not all(x.is_contiguous() for x in (q_codes, q_lens, t_codes, t_lens)):
        raise ValueError("inputs must be contiguous")
    if P:
        q_lo, q_hi, t_lo, t_hi = torch.stack(
            [q_lens.min(), q_lens.max(), t_lens.min(), t_lens.max()]).tolist()
        if not (0 <= q_lo and q_hi <= M and 0 <= t_lo and t_hi <= N):
            raise ValueError(f"lengths must lie in [0, M={M}] and [0, N={N}]")
    return P, M, N


def device_type(x: torch.Tensor, name: str) -> str:
    """``"cpu"`` or ``"cuda"``; any other device raises (no fallback)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    return x.device.type


def _band_geometry(m, n, band):
    diff = n - m
    slack = torch.div(band - 1 - diff.abs(), 2, rounding_mode="floor")
    klo = torch.minimum(torch.zeros_like(diff), diff) - slack
    return diff, klo


def banded_edit_distance_reference(
    q_codes: torch.Tensor, q_lens: torch.Tensor, t_codes: torch.Tensor,
    t_lens: torch.Tensor, band: int = 128, max_m: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch wavefront: a loop over rows, each a batch of (P, band)
    ops and ``cummin`` for the in-row chain.  Returns (P,) int32."""
    P, M, N = check_problems(q_codes, q_lens, t_codes, t_lens)
    B = band
    rows = max_m if max_m is not None else M
    dev = q_codes.device
    m = q_lens.long()
    n = t_lens.long()
    diff, klo = _band_geometry(m, n, B)

    t_pad = torch.cat([
        torch.full((P, B), T_PAD, dtype=torch.uint8, device=dev),
        t_codes,
        torch.full((P, B + rows), T_PAD, dtype=torch.uint8, device=dev),
    ], dim=1)
    L = t_pad.shape[1]
    karange = torch.arange(B, dtype=torch.int64, device=dev)
    k = klo[:, None] + karange                                 # (P, B)
    nn = n[:, None]
    R = torch.where((k >= 0) & (k <= nn), k, INF)
    inf_col = torch.full((P, 1), INF, dtype=torch.int64, device=dev)
    for i in range(1, rows + 1):
        j = i + k
        inside = (j >= 0) & (j <= nn)
        qc = q_codes[:, i - 1] if i <= M else torch.full((P,), Q_PAD, dtype=torch.uint8, device=dev)
        # lax.dynamic_slice clamps its start into [0, L - B]
        start = (i - 1 + klo + B).clamp(0, L - B)
        twin = torch.gather(t_pad, 1, start[:, None] + karange)
        cost = (twin != qc[:, None]).long()
        cand = torch.minimum(R + cost, torch.cat([R[:, 1:], inf_col], dim=1) + 1)
        cand = torch.where(j == 0, i, cand)
        cand = torch.where(inside, cand, INF)
        x = torch.cummin(cand - karange, dim=1).values
        Rn = torch.where(inside, torch.clamp(x + karange, max=INF), INF)
        R = torch.where((i <= m)[:, None], Rn, R)
    out = R.gather(1, (diff - klo).clamp(0, B - 1)[:, None])[:, 0]
    ok = (diff.abs() < B) & (m > 0) & (n > 0) & (m <= rows)
    return torch.where(ok, out, -1).to(torch.int32)


def banded_edit_distance(
    q_codes: torch.Tensor, q_lens: torch.Tensor, t_codes: torch.Tensor,
    t_lens: torch.Tensor, band: int = 128, max_m: int | None = None,
) -> torch.Tensor:
    """Batched banded Levenshtein distance (see module doc); (P,) int32.

    On CUDA tensors this launches ``csrc/banded_wavefront.cu`` on the current
    stream (``band`` a multiple of 32 in [32, 512]) and counts the launch in
    ``banded_edit_distance.launches``; on CPU tensors it runs
    ``banded_edit_distance_reference``.
    """
    if device_type(q_codes, "banded_edit_distance") == "cpu":
        return banded_edit_distance_reference(q_codes, q_lens, t_codes, t_lens, band, max_m)
    P, M, N = check_problems(q_codes, q_lens, t_codes, t_lens)
    if band % 32 or not 32 <= band <= 512:
        raise ValueError(f"the CUDA wavefront takes a band that is a multiple of 32 "
                         f"in [32, 512], got {band}")
    rows = max_m if max_m is not None else M
    out = torch.empty((P,), dtype=torch.int32, device=q_codes.device)
    if P == 0:
        return out

    from muchsalsa_tpu_torch import kernels

    lib = kernels.load()
    with torch.cuda.device(q_codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ms_banded_wavefront(
            ctypes.c_void_p(q_codes.data_ptr()), ctypes.c_void_p(q_lens.data_ptr()),
            ctypes.c_void_p(t_codes.data_ptr()), ctypes.c_void_p(t_lens.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), P, M, N, band, rows,
            ctypes.c_void_p(stream))
    kernels.check(lib, code, f"banded_wavefront launch (P={P}, M={M}, N={N}, band={band})")
    banded_edit_distance.launches += 1
    return out


banded_edit_distance.launches = 0
