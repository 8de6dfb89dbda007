"""The chaining DP on the card: the CUDA kernels' wrappers and their plain versions.

Port of ``muchsalsa_tpu/ops/chaining_pallas.py::chain_scan_pallas`` and of
the compatibility build before it (``chaining_jax.py::compat_init_batch``).
Both kernels are in ``csrc/chain_scan.cu``:

- ``chain_scan(compat, init)`` runs the scan over a precomputed
  compatibility matrix (the Pallas kernel's own contract, below); its plain
  version is ``chain_scan_reference``;
- ``chain_dp(fields, flags, offsets, K, wiggle_room)`` takes the packed
  anchor batch (``state.py``: the valid anchors only, cut into problems by
  ``offsets``), builds each problem's compatibility in registers and runs
  the same scan, so the (B, K, K) matrix never reaches device memory; it
  returns the (B, K) scores and backpointers of the padded batch, padding
  anchors at ``NEG`` and -1.  Its plain version is ``chain_dp_reference``,
  ``compat_init_batch`` followed by ``chain_scan_reference`` on the
  unpacked batch's transposed matrix: step l admits k where
  ``compat_init_batch`` gives ``[b, k, l]``, the pair (anchor k, anchor l)
  that the JAX package's ``chain_dp_batch`` (``compat[:, l]``) and the host
  oracle's ``check_compatibility(k, l)`` test.  The matrix is not symmetric
  where a corrected range inverts.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.

Contract (the Pallas kernel's): ``compat`` (B, K, K) bool/uint8 where
``[b, l, k]`` says anchor k may precede anchor l (the matrix need not be
symmetric); ``init`` (B, K) float64 with padding rows at ``NEG``.  For each
l in order, ``score[l] = init[l] + max(score[k])`` over k < l with
``compat[b, l, k]``, unchanged when no such k has a score above ``NEG``; the
backpointer is the smallest such k attaining the max, else -1.  Results are
bit-equal between the versions: the compatibility is the same float64
expressions in the same order (the kernels build with ``--fmad=false``), and
the scan is one float64 addition per step, the rest comparisons.
"""

from __future__ import annotations

import ctypes

import torch

from muchsalsa_tpu_torch.state import FLOAT_FIELDS, unpack_batch

NEG = -1e30
MAX_K = 128

Tensor = torch.Tensor


def _corrected(ns, ne, is_, ie, rr, vdir, ov_s, ov_e):
    """(B, K) anchor ranges corrected by rRatio-projected overlap trimming."""
    ncl = (ov_s - is_) / rr
    ncr = (ie - ov_e) / rr
    lo = ns + torch.where(vdir, ncl, ncr)
    hi = ne - torch.where(vdir, ncr, ncl)
    return lo, hi


def _pair_orientation(lo: Tensor, hi: Tensor) -> tuple[Tensor, Tensor]:
    """All-pairs orientation codes in {-2,-1,0,1,2} and gap diffs, (B, K, K)
    with [b, k, l] describing anchors (k, l) — mpp.cpp:67-91."""
    a_lo, a_hi = lo[:, :, None], hi[:, :, None]
    b_lo, b_hi = lo[:, None, :], hi[:, None, :]
    intersect = (a_lo <= b_hi) & (b_lo <= a_hi)

    fwd = (a_lo < b_lo) & (a_hi < b_hi)
    bwd = (a_lo > b_lo) & (a_hi > b_hi)
    ori_int = torch.where(bwd, -2, torch.where(fwd, 2, 0))
    diff_int = torch.where(
        bwd, b_hi - a_lo + 1.0, torch.where(fwd, a_hi - b_lo + 1.0, 0.0))

    lt = a_lo < b_lo
    ori_dis = torch.where(lt, 1, -1)
    diff_dis = torch.where(lt, b_lo - a_hi + 1.0, a_lo - b_hi + 1.0)

    ori = torch.where(intersect, ori_int, ori_dis)
    diff = torch.where(intersect, diff_int, diff_dis)
    return ori, diff


def _vertex_abort(ns: Tensor, ne: Tensor, ori: Tensor) -> Tensor:
    """Abort where corrected and uncorrected orientations disagree in sign
    over intersecting uncorrected ranges (mpp.cpp:93-109)."""
    a_s, a_e = ns[:, :, None], ne[:, :, None]
    b_s, b_e = ns[:, None, :], ne[:, None, :]
    intersect = (a_s <= b_e) & (b_s <= a_e)
    fwd = (a_s < b_s) & (a_e < b_e)
    bwd = (a_s > b_s) & (a_e > b_e)
    uco = torch.where(bwd, -2, torch.where(fwd, 2, 0))
    return intersect & (((ori < 0) & (uco >= 0)) | ((ori > 0) & (uco <= 0)))


def compat_init_batch(b: dict[str, Tensor], wiggle_room: int) -> tuple[Tensor, Tensor]:
    """(B, K, K) bool compatibility + (B, K) float64 initial scores
    (mpp.cpp:38-142), the JAX package's per-problem ``_single_compat`` with
    the vmap written out as the leading B axis."""
    wiggle_room = float(wiggle_room)
    v_lo, v_hi = _corrected(
        b["v_ns"], b["v_ne"], b["v_is"], b["v_ie"], b["v_rr"], b["v_dir"],
        b["ov_s"], b["ov_e"],
    )
    w_lo, w_hi = _corrected(
        b["w_ns"], b["w_ne"], b["w_is"], b["w_ie"], b["w_rr"], b["w_dir"],
        b["ov_s"], b["ov_e"],
    )

    o1, d1 = _pair_orientation(v_lo, v_hi)
    o2, d2 = _pair_orientation(w_lo, w_hi)

    abort = _vertex_abort(b["v_ns"], b["v_ne"], o1) | _vertex_abort(
        b["w_ns"], b["w_ne"], o2
    )

    o2 = torch.where(b["cls_dir"][:, None, None], o2, -o2)

    same_nz = (o1 == o2) & (o1 != 0)
    mx = torch.maximum(d1, d2)
    diff = mx - torch.minimum(d1, d2)
    # mx == 0 divides by zero; the where masks it exactly as the JAX code does
    rel = torch.where(mx != 0, diff * 100.0 / mx, float("inf"))
    rule1 = same_nz & ((diff <= wiggle_room) | (rel <= 15.0))
    rule2 = (
        ~same_nz
        & (((o1 < 0) & (o2 < 0)) | ((o1 > 0) & (o2 > 0)))
        & (d1 + d2 <= wiggle_room)
    )

    valid = b["valid"]
    valid_pair = valid[:, :, None] & valid[:, None, :]
    compat = ~abort & (rule1 | rule2) & valid_pair
    init = torch.where(valid, b["score"], NEG)
    return compat, init


def _check(compat: torch.Tensor, init: torch.Tensor) -> None:
    if init.dim() != 2:
        raise ValueError(f"init must be (B, K), got shape {tuple(init.shape)}")
    B, K = init.shape
    if tuple(compat.shape) != (B, K, K):
        raise ValueError(
            f"compat must be (B, K, K) = {(B, K, K)}, got {tuple(compat.shape)}")
    if K > MAX_K:
        raise ValueError(f"K = {K} exceeds the kernel's maximum of {MAX_K}")
    if init.dtype != torch.float64:
        raise TypeError(f"init must be float64, got {init.dtype}")
    if compat.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"compat must be bool or uint8, got {compat.dtype}")
    if compat.device != init.device:
        raise ValueError(f"compat on {compat.device} but init on {init.device}")
    if not (compat.is_contiguous() and init.is_contiguous()):
        raise ValueError("compat and init must be contiguous")


def chain_scan_reference(
    compat: torch.Tensor, init: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch scan: a loop over l, each step a masked max over all
    B problems at once.  Returns (scores (B, K) float64, bps (B, K) int32)."""
    B, K = init.shape
    dev = init.device
    mask = compat != 0
    scores = init.clone()
    bps = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    idx = torch.arange(K, device=dev)
    neg = torch.tensor(NEG, dtype=init.dtype, device=dev)
    for l in range(K):
        cand = torch.where(mask[:, l, :] & (idx < l), scores, neg)
        best = cand.max(dim=1).values
        # smallest index among the maxima (jnp.argmax's first-occurrence rule)
        bp = torch.where(cand == best[:, None], idx, K).min(dim=1).values
        ok = best > NEG
        scores[:, l] = torch.where(ok, init[:, l] + best, scores[:, l])
        bps[:, l] = torch.where(ok, bp, -1).to(torch.int32)
    return scores, bps


def chain_scan(
    compat: torch.Tensor, init: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward chaining DP over precomputed compatibility (see module doc).

    On CUDA tensors this launches ``csrc/chain_scan.cu`` on the current
    stream and counts the launch in ``chain_scan.launches``; on CPU tensors
    it runs ``chain_scan_reference``.  Any other input raises.
    """
    _check(compat, init)
    if init.device.type == "cpu":
        return chain_scan_reference(compat, init)
    if init.device.type != "cuda":
        raise ValueError(f"chain_scan runs on cuda or cpu tensors, not {init.device}")

    from muchsalsa_tpu_torch import kernels

    B, K = init.shape
    scores = torch.empty_like(init)
    bps = torch.empty((B, K), dtype=torch.int32, device=init.device)
    if B == 0 or K == 0:
        return scores, bps
    lib = kernels.load()
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ms_chain_scan(
            ctypes.c_void_p(compat.data_ptr()), ctypes.c_void_p(init.data_ptr()),
            ctypes.c_void_p(scores.data_ptr()), ctypes.c_void_p(bps.data_ptr()),
            B, K, ctypes.c_void_p(stream))
    kernels.check(lib, code, f"chain_scan launch (B={B}, K={K})")
    chain_scan.launches += 1
    return scores, bps


chain_scan.launches = 0


def _check_packed(fields: Tensor, flags: Tensor, offsets: Tensor, K: int) -> None:
    if fields.dim() != 2 or fields.shape[0] != len(FLOAT_FIELDS):
        raise ValueError(f"fields must be ({len(FLOAT_FIELDS)}, N), got {tuple(fields.shape)}")
    if tuple(flags.shape) != (fields.shape[1],):
        raise ValueError(f"flags must be (N,) = ({fields.shape[1]},), got {tuple(flags.shape)}")
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"offsets must be (B + 1,), got {tuple(offsets.shape)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K = {K} is outside the kernel's 1 to {MAX_K}")
    if fields.dtype != torch.float64:
        raise TypeError(f"fields must be float64, got {fields.dtype}")
    if flags.dtype != torch.uint8:
        raise TypeError(f"flags must be uint8, got {flags.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be int32, got {offsets.dtype}")
    if not fields.device == flags.device == offsets.device:
        raise ValueError(f"fields on {fields.device}, flags on {flags.device}, "
                         f"offsets on {offsets.device}")
    if not (fields.is_contiguous() and flags.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("fields, flags and offsets must be contiguous")


def chain_dp_reference(
    fields: Tensor, flags: Tensor, offsets: Tensor, K: int, wiggle_room: int
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch chaining DP of a packed batch: ``compat_init_batch``
    on the unpacked (B, K) batch, then ``chain_scan_reference`` over its
    transpose, so that step l admits k where the pair (anchor k, anchor l)
    is compatible.  Returns (scores (B, K) float64, bps (B, K) int32)."""
    compat, init = compat_init_batch(unpack_batch(fields, flags, offsets, K), wiggle_room)
    return chain_scan_reference(compat.transpose(1, 2), init)


def chain_dp(
    fields: Tensor, flags: Tensor, offsets: Tensor, K: int, wiggle_room: int
) -> tuple[Tensor, Tensor]:
    """Chaining DP of a packed batch (``state.py``) of B problems of at most
    K anchors: each problem's compatibility and its forward scan, (scores
    (B, K) float64, bps (B, K) int32), padding anchors at ``NEG`` and -1.

    On CUDA tensors this launches the fused kernel of ``csrc/chain_scan.cu``
    on the current stream and counts the launch in ``chain_dp.launches``
    (the kernel reads ``offsets`` as given: each problem's count is clamped
    to 0..K and no anchor past N is read); on CPU tensors it runs
    ``chain_dp_reference``.  Any other input raises.
    """
    _check_packed(fields, flags, offsets, K)
    if fields.device.type == "cpu":
        return chain_dp_reference(fields, flags, offsets, K, wiggle_room)
    if fields.device.type != "cuda":
        raise ValueError(f"chain_dp runs on cuda or cpu tensors, not {fields.device}")

    from muchsalsa_tpu_torch import kernels

    B, N = offsets.shape[0] - 1, fields.shape[1]
    scores = torch.empty((B, K), dtype=torch.float64, device=fields.device)
    bps = torch.empty((B, K), dtype=torch.int32, device=fields.device)
    if B == 0:
        return scores, bps
    lib = kernels.load()
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ms_chain_dp(
            ctypes.c_void_p(fields.data_ptr()), ctypes.c_void_p(flags.data_ptr()),
            ctypes.c_void_p(offsets.data_ptr()), ctypes.c_void_p(scores.data_ptr()),
            ctypes.c_void_p(bps.data_ptr()), B, K, N, ctypes.c_double(float(wiggle_room)),
            ctypes.c_void_p(stream))
    kernels.check(lib, code, f"chain_dp launch (B={B}, K={K}, N={N})")
    chain_dp.launches += 1
    return scores, bps


chain_dp.launches = 0
