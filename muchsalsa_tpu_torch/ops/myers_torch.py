"""Myers' bit-parallel edit distance: exact and banded, kernels and plain versions.

Port of ``muchsalsa_tpu/ops/myers_jax.py`` and of the TPU kernels
``muchsalsa_tpu/ops/myers_full_pallas.py::myers_edit_distance_pallas``
(exact, unbanded) and ``muchsalsa_tpu/ops/myers_pallas.py::myers_banded_pallas``
(banded, static geometry).  The CUDA kernels are ``csrc/myers_full.cu`` and
``csrc/myers_banded.cu``; ``myers_edit_distance_reference`` and
``myers_banded_reference`` are the plain PyTorch versions of the same
functions.  The wrappers take the plain version only for tensors on the CPU;
for a CUDA tensor they launch the kernel or raise.

Inputs are a packed batch (``ops.align_torch.pack_problems``): query codes
(P, M) uint8 padded with 5, target codes (P, N) uint8 padded with 4, int32
lengths.  PEq has rows for the codes 0-3 only, so an ``N`` (code 4) matches
nothing, not even an ``N``.

The 32-bit bit-vectors are carried as int64 masked to 32 bits in the plain
versions (PyTorch's CPU uint32 has no shifts or comparisons): every sum and
left shift is masked with ``FULL`` where uint32 arithmetic would wrap.
"""

from __future__ import annotations

import ctypes

import torch

from muchsalsa_tpu_torch.ops.align_torch import Q_PAD, check_problems, device_type

W_BITS = 32
FULL = 0xFFFFFFFF
TOP = 0x80000000


def pack_peq(q_codes: torch.Tensor, n_words: int) -> torch.Tensor:
    """(P, M) codes -> PEq (P, 4, n_words) int64 holding 32-bit masks: bit
    ``i % 32`` of word ``i // 32`` of row c is set where query position i
    holds code c (myers_jax.py:39)."""
    P, M = q_codes.shape
    qp = torch.full((P, n_words * W_BITS), Q_PAD, dtype=torch.uint8, device=q_codes.device)
    qp[:, :M] = q_codes
    qp = qp.view(P, n_words, W_BITS)
    weights = torch.ones(W_BITS, dtype=torch.int64, device=q_codes.device) << torch.arange(
        W_BITS, device=q_codes.device)
    return torch.stack([((qp == c).long() * weights).sum(dim=2) for c in range(4)], dim=1)


def _select_eq(peq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """PEq words of text code ``c`` (P,); zero for codes >= 4.  peq is
    (P, 4, W), the result (P, W)."""
    idx = c.long().clamp(max=3)[:, None, None].expand(-1, 1, peq.shape[2])
    return torch.where((c < 4)[:, None], peq.gather(1, idx)[:, 0], 0)


def _half_step(eq, vp, vn):
    """Myers' block core for a fixed Eq: (xv, ph, mh) before the shift."""
    xv = eq | vn
    xh = ((((eq & vp) + vp) & FULL) ^ vp) | eq
    ph = vn | (~(xh | vp) & FULL)
    mh = vp & xh
    return xv, ph, mh


def _hout(ph, mh):
    return torch.where((ph & TOP) != 0, 1, torch.where((mh & TOP) != 0, -1, 0))


def _column(eq, vp, vn):
    """One text column over all words (P, W): returns the updated
    (vp, vn) and the pre-shift (ph, mh) of each word.

    A word's horizontal output depends on its input only through the
    ``Eq | (hin < 0)`` bit, so both cases are evaluated and the carry chain
    across words is resolved by an inclusive scan over the per-word maps
    (out if hin < 0, out if hin >= 0), composed left to right; word 0 gets
    hin = +1."""
    P, W = eq.shape
    a = _half_step(eq, vp, vn)
    b = _half_step(eq | 1, vp, vn)
    f_neg, f_nn = _hout(b[1], b[2]), _hout(a[1], a[2])
    s = 1
    while s < W:
        e_neg, e_nn = f_neg[:, :-s], f_nn[:, :-s]        # the earlier words
        g_neg, g_nn = f_neg[:, s:], f_nn[:, s:]          # applied after them
        f_neg = torch.cat([f_neg[:, :s], torch.where(e_neg < 0, g_neg, g_nn)], dim=1)
        f_nn = torch.cat([f_nn[:, :s], torch.where(e_nn < 0, g_neg, g_nn)], dim=1)
        s *= 2
    hin = torch.cat([torch.ones((P, 1), dtype=f_nn.dtype, device=eq.device), f_nn[:, :-1]], dim=1)
    neg = hin < 0
    xv, ph, mh = (torch.where(neg, y, x) for x, y in zip(a, b))
    ph_s = ((ph << 1) & FULL) | (hin > 0).long()
    mh_s = ((mh << 1) & FULL) | neg.long()
    vp_n = mh_s | (~(xv | ph_s) & FULL)
    vn_n = ph_s & xv
    return vp_n, vn_n, ph, mh


def myers_edit_distance_reference(
    q_codes: torch.Tensor, q_lens: torch.Tensor, t_codes: torch.Tensor,
    t_lens: torch.Tensor, max_n: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch exact Myers (myers_jax.py:65-167): a loop over the text
    columns, each a batch of (P, n_words) ops.  Returns (P,) int32; an empty
    query gives n, and only the first ``max_n`` columns are read."""
    P, M, N = check_problems(q_codes, q_lens, t_codes, t_lens)
    cols = max_n if max_n is not None else N
    n_words = max(-(-M // W_BITS), 1)
    dev = q_codes.device
    peq = pack_peq(q_codes, n_words)
    m = q_lens.long()
    n = t_lens.long()
    last_word = (m - 1).clamp(min=0) // W_BITS
    last_bit = (m - 1).clamp(min=0) % W_BITS

    vp = torch.full((P, n_words), FULL, dtype=torch.int64, device=dev)
    vn = torch.zeros((P, n_words), dtype=torch.int64, device=dev)
    score = m.clone()
    for j in range(min(cols, N)):
        eq = _select_eq(peq, t_codes[:, j])
        vp_n, vn_n, ph, mh = _column(eq, vp, vn)
        up = (ph.gather(1, last_word[:, None])[:, 0] >> last_bit) & 1
        dn = (mh.gather(1, last_word[:, None])[:, 0] >> last_bit) & 1
        active = (j < n) & (m > 0)
        vp = torch.where(active[:, None], vp_n, vp)
        vn = torch.where(active[:, None], vn_n, vn)
        score = torch.where(active, score + up - dn, score)
    return torch.where(m > 0, score, n).to(torch.int32)


def _launch_args(*tensors):
    return [ctypes.c_void_p(x.data_ptr()) for x in tensors]


# The exact kernel's classes: words per lane held in registers (K), and the
# device-memory class past 32 lanes of 8 words.  A lane's step costs about
# STEP_SLOTS issue slots outside its words (shuffle, text, branch) and
# WORD_SLOTS per word (PEq selection and the word step), so a problem of W
# words over L = ceil(W / K) lanes costs L * (STEP_SLOTS + K * WORD_SLOTS)
# per column; the schedule takes the cheapest K.
CLASS_WORDS_PER_LANE = (1, 2, 4, 8)
STATE_CLASS = len(CLASS_WORDS_PER_LANE)
STEP_SLOTS = 22
WORD_SLOTS = 15
_LANES = 32
_STATE_PLANES = 6        # VP, VN and the four PEq planes of the device-memory class


def lane_plan(words: int) -> tuple[int, int]:
    """(class, lanes per problem) of a problem of ``words`` >= 1 pattern
    words: the register class of least cost, or ``STATE_CLASS`` on 32 lanes
    past 256 words."""
    best = None
    for cls, k in enumerate(CLASS_WORDS_PER_LANE):
        lanes = -(-words // k)
        cost = lanes * (STEP_SLOTS + k * WORD_SLOTS)
        if lanes <= _LANES and (best is None or cost < best[0]):
            best = (cost, cls, lanes)
    return (best[1], best[2]) if best else (STATE_CLASS, _LANES)


_REGISTER_WORDS = _LANES * CLASS_WORDS_PER_LANE[-1]
# lane_plan of 0..257 words (0 as 1; 257 stands for every longer pattern)
_PLAN = torch.tensor([lane_plan(max(w, 1)) for w in range(_REGISTER_WORDS + 2)])
_plan_on: dict[str, torch.Tensor] = {}


def schedule_problems(
    q_lens: torch.Tensor, t_lens: torch.Tensor, cols: int,
) -> tuple[torch.Tensor, list[tuple[int, int, int, int]], int]:
    """The exact kernel's launch plan: ``(order, groups, k_state)``.

    Each problem gets a class and a segment length (``lane_plan``, looked
    up in a table of its word count).
    ``order`` (P,) int32 lists the problems by descending class (the
    longest steps first), descending lanes and descending columns of work
    ``min(n, cols)`` (0 for an empty query), so a warp's problems end
    together and the longest warps start first; ``groups`` holds one
    ``(class, lanes, first slot, count)`` row per non-empty group, in that
    order; ``k_state`` is the device-memory class's largest words per lane
    (0 when no problem has that class).  Each problem's result goes to its
    own slot, so ``order`` needs no inverse."""
    m = q_lens.long()
    words = ((m + W_BITS - 1) // W_BITS).clamp(min=1)
    plan = _plan_on.get(str(m.device))
    if plan is None:
        plan = _plan_on[str(m.device)] = _PLAN.to(m.device)
    cls, lanes = plan[words.clamp(max=_REGISTER_WORDS + 1)].unbind(1)
    work = torch.where(m > 0, t_lens.long().clamp(max=cols), 0)
    group = (STATE_CLASS - cls) * _LANES + _LANES - lanes
    order = torch.argsort((group << 32) | (0x7FFFFFFF - work), stable=True).to(torch.int32)
    counts = torch.bincount(group, minlength=(STATE_CLASS + 1) * _LANES).tolist()
    groups, start = [], 0
    for g, count in enumerate(counts):
        if count:
            groups.append((STATE_CLASS - g // _LANES, _LANES - g % _LANES, start, count))
            start += count
    k_state = 0
    if groups and groups[0][0] == STATE_CLASS:
        k_state = -(-int(words.max()) // _LANES)
    return order, groups, k_state


def myers_edit_distance(
    q_codes: torch.Tensor, q_lens: torch.Tensor, t_codes: torch.Tensor,
    t_lens: torch.Tensor, max_n: int | None = None,
) -> torch.Tensor:
    """Batched exact (unbanded) edit distance; (P,) int32.

    On CUDA tensors this launches ``csrc/myers_full.cu`` on the current
    stream with ``schedule_problems``' plan and counts the call in
    ``myers_edit_distance.launches``; on CPU tensors it runs
    ``myers_edit_distance_reference``.
    """
    if device_type(q_codes, "myers_edit_distance") == "cpu":
        return myers_edit_distance_reference(q_codes, q_lens, t_codes, t_lens, max_n)
    P, M, N = check_problems(q_codes, q_lens, t_codes, t_lens)
    cols = max(min(max_n if max_n is not None else N, N), 0)
    dev = q_codes.device
    out = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return out
    order, groups, k_state = schedule_problems(q_lens, t_lens, cols)
    n_state = sum(count for cls, _seg, _start, count in groups if cls == STATE_CLASS)
    state = torch.empty((_STATE_PLANES * k_state * n_state * W_BITS,), dtype=torch.int32,
                        device=dev)
    table = (ctypes.c_int * (4 * len(groups)))(*(v for row in groups for v in row))

    from muchsalsa_tpu_torch import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ms_myers_full(
            *_launch_args(q_codes, q_lens, t_codes, t_lens, order, out, state),
            table, len(groups), P, M, N, cols, k_state, ctypes.c_void_p(stream))
    kernels.check(lib, code, f"myers_full launch (P={P}, M={M}, N={N})")
    myers_edit_distance.launches += 1
    return out


myers_edit_distance.launches = 0


def geometry(window_words: int) -> tuple[int, int, int]:
    """Static band geometry (myers_pallas.py:51): (klo, khi, h) with
    khi = 1 (mod 32), so the window advances one word exactly at 32-column
    block boundaries; the window of block b starts at word
    ``clip(b - h, 0, max_wb)``."""
    band_rows = window_words * W_BITS
    khi = W_BITS * (window_words // 2) + 1
    klo = khi - band_rows + 1
    h = (khi - 1) // W_BITS
    return klo, khi, h


def banded_words(M: int, window_words: int) -> int:
    """PEq words of the banded kernel's padded query.  It depends on the
    batch's padded M, and with it the window's last position max_wb =
    banded_words - window_words (myers_pallas.py:167)."""
    return max(-(-M // W_BITS), window_words) + window_words + 2


def _banded_epilogue(score, vp, vn, m, n, in_band, khi, max_wb, window_words):
    """Closed-form window-advance bookkeeping (+32 per advanced word) and
    the walk from the window's bottom row up to row m - 1
    (myers_pallas.py:246-263).  vp, vn: (P, WB) final windows."""
    WB = window_words
    wb_p = (torch.clamp(n - khi, min=0) // W_BITS).clamp(0, max_wb)
    score = score + wb_p * W_BITS
    lane = torch.arange(W_BITS, device=vp.device)
    w_local = torch.arange(WB, device=vp.device)[None, :, None]
    rows = (wb_p[:, None, None] + w_local) * W_BITS + lane
    in_range = rows > (m[:, None, None] - 1)
    vp_bits = ((vp[:, :, None] >> lane) & 1) != 0
    vn_bits = ((vn[:, :, None] >> lane) & 1) != 0
    adj = (in_range & vn_bits).sum(dim=(1, 2)) - (in_range & vp_bits).sum(dim=(1, 2))
    score = score + adj
    bottom_row = (wb_p + WB) * W_BITS - 1
    ok = in_band & (bottom_row >= m - 1) & (m - 1 >= wb_p * W_BITS - 1)
    return torch.where(ok, score, -1).to(torch.int32)


def myers_banded_reference(
    q_codes: torch.Tensor, q_lens: torch.Tensor, t_codes: torch.Tensor,
    t_lens: torch.Tensor, window_words: int = 8, max_n: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch banded Myers with the Pallas kernel's static geometry
    (myers_pallas.py:144-264): a loop over 32-column blocks and their
    columns, each a batch of (P, window_words) ops.  Returns (P,) int32,
    -1 where the problem's length difference leaves the band.  Exact when
    the optimal path stays in the band, an upper bound otherwise."""
    P, M, N = check_problems(q_codes, q_lens, t_codes, t_lens)
    if window_words < 1:
        raise ValueError(f"window_words must be >= 1, got {window_words}")
    WB = window_words
    cols = max_n if max_n is not None else N
    n_blocks = max(-(-cols // W_BITS), 1)
    klo, khi, h = geometry(WB)
    n_words = banded_words(M, WB)
    max_wb = n_words - WB
    m = q_lens.long()
    n = t_lens.long()
    diff = n - m
    in_band = (diff - klo >= W_BITS) & (khi - diff >= W_BITS) & (m > 0) & (n > 0)
    dev = q_codes.device
    peq = pack_peq(q_codes, n_words)
    n_eff = torch.where(in_band, n, 0)

    vp = torch.full((P, WB), FULL, dtype=torch.int64, device=dev)
    vn = torch.zeros((P, WB), dtype=torch.int64, device=dev)
    score = torch.full((P,), WB * W_BITS, dtype=torch.int64, device=dev)
    # columns past N change nothing: every active problem has n <= N
    for j in range(1, min(n_blocks * W_BITS, N) + 1):
        if (j - 1) % W_BITS == 0:
            b = (j - 1) // W_BITS
            if h < b <= h + max_wb:
                # window advance: words move up one slot, a fresh word
                # enters at the bottom; a finished problem keeps its window
                act = (j <= n_eff)[:, None]
                vp = torch.where(act, torch.cat([vp[:, 1:], torch.full_like(vp[:, :1], FULL)], 1), vp)
                vn = torch.where(act, torch.cat([vn[:, 1:], torch.zeros_like(vn[:, :1])], 1), vn)
            wb = min(max(b - h, 0), max_wb)
            peq_w = peq[:, :, wb:wb + WB]
        vp_n, vn_n, ph, mh = _column(_select_eq(peq_w, t_codes[:, j - 1]), vp, vn)
        active = j <= n_eff
        vp = torch.where(active[:, None], vp_n, vp)
        vn = torch.where(active[:, None], vn_n, vn)
        score = torch.where(active, score + _hout(ph[:, -1], mh[:, -1]), score)
    return _banded_epilogue(score, vp, vn, m, n, in_band, khi, max_wb, WB)


def myers_banded(
    q_codes: torch.Tensor, q_lens: torch.Tensor, t_codes: torch.Tensor,
    t_lens: torch.Tensor, window_words: int = 8, max_n: int | None = None,
) -> torch.Tensor:
    """Banded Myers with the static ``window_words * 32``-diagonal band;
    (P,) int32, -1 outside the band.

    On CUDA tensors this launches ``csrc/myers_banded.cu`` on the current
    stream (``window_words`` in 1..8; the launch first orders the problems
    on the card by their blocks of work, so that a warp's problems end
    together, with out-of-band ones last) and counts the launch in
    ``myers_banded.launches``; on CPU tensors it runs
    ``myers_banded_reference``.
    """
    if device_type(q_codes, "myers_banded") == "cpu":
        return myers_banded_reference(q_codes, q_lens, t_codes, t_lens, window_words, max_n)
    P, M, N = check_problems(q_codes, q_lens, t_codes, t_lens)
    if not 1 <= window_words <= 8:
        raise ValueError(f"the CUDA banded Myers takes window_words in 1..8, got {window_words}")
    WB = window_words
    cols = max_n if max_n is not None else N
    n_blocks = max(-(-cols // W_BITS), 1)
    klo, khi, h = geometry(WB)
    n_words = banded_words(M, WB)
    dev = q_codes.device
    out = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return out
    # the problems' order and its 1024 bucket counters, written by the launch
    scratch = torch.empty((P + 1024,), dtype=torch.int32, device=dev)

    from muchsalsa_tpu_torch import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ms_myers_banded(
            *_launch_args(q_codes, q_lens, t_codes, t_lens, scratch, out),
            P, M, N, n_words, WB, n_blocks, klo, khi, h, ctypes.c_void_p(stream))
    kernels.check(lib, code, f"myers_banded launch (P={P}, M={M}, N={N}, WB={WB})")
    myers_banded.launches += 1
    return out


myers_banded.launches = 0
