"""extd2 forward sweep + traceback: CUDA kernels and their plain versions.

Counterpart of pansvr_tpu/ops/extd2_pallas.py. Two entry points:

  extd2_fwd(q, ql, t, tl, params, W)            -> Extd2Out
  extd2_traceback(dmat, ql, tl, i0, j0, params, W, n_diag_pad, Tmax)
                                                 -> (ops, i_fin, j_fin)

A CUDA tensor launches the hand-written kernel (csrc/extd2_fwd.cu,
csrc/extd2_tb.cu, built at first use) on the tensors' own device (each
launch runs under a device guard) or raises; a CPU tensor takes the
plain PyTorch version, which loops over the anti-diagonals on (B, W)
tensors and is the specification of the kernels (the on-card oracle in
chip_smoke.py). There is no fallback from one to the other.

Layouts (problems on axis 0, unlike the Pallas (G, ..., 128) lanes):
  dmat (B, n_diag_pad, W) uint8: direction byte of window row k at
       diagonal r (state in bits 0-2, continuation flags in bits 3-6);
  ops  (B, n_diag_pad) int8 in walk order (descending diagonal), 3 = no
       op at that diagonal; decode with ops_to_cigar_skip.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..index.device import device_guard
from .extd2 import (
    NEG_INF,
    Extd2Params,
    check_window,
    leading_gap_delta,
    plan,
    state_fits_int8,
    window_origin,
)

# kernel launches since the last reset (a wrapper counts where it launches),
# in all and by DP shape and problem count: {(kernel, Tmax, W, B): n}
LAUNCHES = {"extd2_fwd": 0, "extd2_tb": 0}
LAUNCHES_BY_SHAPE: dict = {}
# launches of the front's entry points (ops/front_cuda.py), counted,
# recorded and replayed like K1's and K2's: {entry point: n}
FRONT_LAUNCHES: dict = {}
# while a dict (keep_samples): the wrapper arguments of the last launch at
# each (kernel, Tmax, W, B), for timing a pass's kernels alone afterwards
SAMPLES: dict | None = None
# while a list (record_launches): launches are recorded here instead of
# counted (a CUDA graph's capture, which count_launches counts at every
# replay)
RECORD: list | None = None

_I32 = torch.int32
_I32MAX = 0x7FFFFFFF
MAX_W = 256     # widest window the forward kernel takes (8 row slots a lane)
# traceback kernel constants (csrc/extd2_tb.cu): diagonals per staged
# chunk (one per lane of the problem's warp), problems (warps) per block,
# and the shared memory a block may use on the H100
TB_D = 32
TB_WARPS = 4
MAX_SMEM_BLOCK = 232448


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()
    FRONT_LAUNCHES.clear()


@contextlib.contextmanager
def keep_samples():
    """Within the block, keep the arguments of each shape's last launch
    in the dict it yields."""
    global SAMPLES
    SAMPLES = {}
    try:
        yield SAMPLES
    finally:
        SAMPLES = None


@contextlib.contextmanager
def record_launches():
    """Within the block, launches are not counted but appended to the
    list it yields as (kernel, Tmax, W, B, args)."""
    global RECORD
    prev, RECORD = RECORD, []
    try:
        yield RECORD
    finally:
        RECORD = prev


def count_launches(record) -> None:
    """Count the launches of a record_launches list (a graph replay
    running them again); their arguments are the captured tensors, which
    hold the latest replay's data."""
    for launch in record:
        _count(*launch)


def _count(kernel: str, Tmax: int, W: int, B: int, args: tuple) -> None:
    if RECORD is not None:
        # the arguments only while samples are kept: they hold a graph's
        # intermediate tensors, which its memory pool could reuse
        RECORD.append((kernel, Tmax, W, B,
                       args if SAMPLES is not None else None))
        return
    if kernel not in LAUNCHES:
        FRONT_LAUNCHES[kernel] = FRONT_LAUNCHES.get(kernel, 0) + 1
        return
    LAUNCHES[kernel] += 1
    key = (kernel, Tmax, W, B)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    if SAMPLES is not None and args is not None:
        SAMPLES[key] = args


class Extd2Out(NamedTuple):
    score: torch.Tensor      # (B,) int32, NEG_INF when the end is not reached
    mqe: torch.Tensor
    mqe_t: torch.Tensor
    mte: torch.Tensor
    mte_q: torch.Tensor
    max: torch.Tensor
    max_q: torch.Tensor
    max_t: torch.Tensor
    zdropped: torch.Tensor   # (B,) bool
    dmat: torch.Tensor       # (B, n_diag_pad, W) uint8


def _ceil16(n: int) -> int:
    return (n + 15) // 16 * 16


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _extract(arr, pos, o_r, W):
    """arr[b, pos[b] - o_r] floored at NEG_INF; NEG_INF off-window (the
    Pallas masked-max row extract)."""
    k = pos - o_r
    inwin = (k >= 0) & (k < W)
    v = arr.gather(1, k.clamp(0, W - 1).long()[:, None])[:, 0]
    return torch.where(inwin, v.clamp(min=NEG_INF), NEG_INF).to(_I32)


def extd2_fwd_plain(q, ql, t, tl, params: Extd2Params, W: int) -> Extd2Out:
    """Anti-diagonal loop over (B, W) window tensors; the exact semantics
    of the Pallas forward kernel (int32 state)."""
    return extd2_fwd_plain_cells(q, ql, t, tl, params, W)[0]


def extd2_fwd_plain_cells(q, ql, t, tl, params: Extd2Params, W: int):
    """extd2_fwd_plain, plus the (B,) int64 count of band cells each
    problem's sweep computed (the 16-padded band over the diagonals it
    reached): the work the kernel's bound is counted from."""
    B, Qmax = q.shape
    Tmax = t.shape[1]
    dev = q.device
    t_pad, n_diag_pad, q_padl, q_ext = plan(Qmax, Tmax, W)
    pn = params.normalized()
    gq, ge, gq2, ge2 = pn.q, pn.e, pn.q2, pn.e2
    neg1, neg2 = -gq - ge, -gq2 - ge2
    ql = ql.to(_I32)
    tl = tl.to(_I32)

    def c(val):
        return torch.tensor(val, dtype=_I32, device=dev)

    def full(val, w=W):
        return torch.full((B, w), val, dtype=_I32, device=dev)

    q_full = torch.zeros((B, q_ext), dtype=_I32, device=dev)
    q_full[:, q_padl:q_padl + Qmax] = q.to(_I32).flip(1)
    t_full = torch.zeros((B, t_pad), dtype=_I32, device=dev)
    t_full[:, :Tmax] = t.to(_I32)
    tlen_pad16 = (tl + 15) // 16 * 16
    kidx = torch.arange(W, dtype=_I32, device=dev)[None, :]

    u, v, x, y = full(neg1), full(neg1), full(neg1), full(neg1)
    x2, y2, s, H = full(neg2), full(neg2), full(0), full(NEG_INF)
    col = lambda val: torch.full((B,), val, dtype=_I32, device=dev)
    last_st, last_en = col(-1), col(-1)
    ez_max, ez_max_q, ez_max_t = col(0), col(-1), col(-1)
    mqe, mqe_t, mte, mte_q = col(NEG_INF), col(-1), col(NEG_INF), col(-1)
    score, zdropped = col(NEG_INF), col(0)
    dmat = torch.zeros((B, n_diag_pad, W), dtype=torch.uint8, device=dev)
    cells = torch.zeros(B, dtype=torch.int64, device=dev)

    n_act = int((ql + tl).max().item()) - 1 if B else 0
    n_act = min(max(_ceil16(n_act), 16), n_diag_pad)
    fills = (neg1, neg1, neg1, neg1, neg2, neg2, 0, NEG_INF)
    o_prev = -1
    for r in range(n_act):
        o_r = window_origin(r, params.w, t_pad, W)
        if o_r != o_prev:
            u, v, x, y, x2, y2, s, H = (
                torch.cat([a[:, 16:], full(f, 16)], dim=1)
                for a, f in zip((u, v, x, y, x2, y2, s, H), fills))
        o_prev = o_r
        idx = kidx + o_r

        st0 = torch.clamp(r - ql + 1, min=max(0, (r - params.w + 1) >> 1))
        en0 = torch.clamp(tl - 1, max=min(r, (r + params.w) >> 1))
        in_range = r < ql + tl - 1
        band_dead = st0 > en0
        live = in_range & (zdropped == 0)
        active = live & ~band_dead
        new_zdrop_from_band = live & band_dead
        st = st0 // 16 * 16
        en = torch.minimum((en0 + 16) // 16 * 16 - 1, tlen_pad16 - 1)
        real = (idx >= st0[:, None]) & (idx <= en0[:, None])
        band = (idx >= st[:, None]) & (idx <= en[:, None])
        act = active[:, None]

        qstart = min(max(q_padl + Qmax - 1 - r + o_r, 0), q_ext - W)
        qwin = q_full[:, qstart:qstart + W]
        twin = t_full[:, o_r:o_r + W]
        s_new = torch.where(real & act, torch.where(
            qwin == twin, c(params.match), c(params.mismatch)), s)

        topm = ((en >= r) & active)[:, None] & (idx == r)
        ub = leading_gap_delta(r, params)
        u_arr = torch.where(topm, c(ub), u)
        y_arr = torch.where(topm, c(neg1), y)
        y2_arr = torch.where(topm, c(neg2), y2)

        stale_ok = (st - 1 >= last_st) & (st - 1 <= last_en)
        pos = st - 1
        x1 = torch.where((st > 0) & stale_ok, _extract(x, pos, o_r, W),
                         c(neg1))
        x21 = torch.where((st > 0) & stale_ok, _extract(x2, pos, o_r, W),
                          c(neg2))
        v1 = torch.where(st > 0, torch.where(
            stale_ok, _extract(v, pos, o_r, W), c(neg1)), c(ub))

        at_st = idx == st[:, None]
        x_sh = torch.where(at_st, x1[:, None], torch.roll(x, 1, 1))
        v_sh = torch.where(at_st, v1[:, None], torch.roll(v, 1, 1))
        x2_sh = torch.where(at_st, x21[:, None], torch.roll(x2, 1, 1))

        a = x_sh + v_sh
        b = y_arr + u_arr
        a2 = x2_sh + v_sh
        b2 = y2_arr + u_arr
        z = s_new
        d = torch.zeros_like(z)
        for code, cand in ((1, a), (2, b), (3, a2), (4, b2)):
            d = torch.where(cand > z, c(code), d)
            z = torch.maximum(z, cand)
        z = z.clamp(max=params.match)
        u_new = z - v_sh
        v_new = z - u_arr
        a = a - (z - gq)
        b = b - (z - gq)
        a2 = a2 - (z - gq2)
        b2 = b2 - (z - gq2)
        x_new = a.clamp(min=0) - gq - ge
        y_new = b.clamp(min=0) - gq - ge
        x2_new = a2.clamp(min=0) - gq2 - ge2
        y2_new = b2.clamp(min=0) - gq2 - ge2
        d = d | (a > 0).to(_I32) * 0x08 | (b > 0).to(_I32) * 0x10 \
            | (a2 > 0).to(_I32) * 0x20 | (b2 > 0).to(_I32) * 0x40

        wmask = band & act
        u = torch.where(wmask, u_new, u_arr)
        v = torch.where(wmask, v_new, v)
        x = torch.where(wmask, x_new, x)
        y = torch.where(wmask, y_new, y_arr)
        x2 = torch.where(wmask, x2_new, x2)
        y2 = torch.where(wmask, y2_new, y2_arr)
        s = s_new

        # H: the band end uses the OLD H[en0 - 1]; mid cells their own
        H_prev_en0m1 = _extract(H, en0 - 1, o_r, W)
        H_prev_en0 = _extract(H, en0, o_r, W)
        u_new_w = torch.where(band, u_new, c(NEG_INF))
        v_new_w = torch.where(band, v_new, c(NEG_INF))
        H_en0 = torch.where(en0 > 0,
                            H_prev_en0m1 + _extract(u_new_w, en0, o_r, W),
                            H_prev_en0 + _extract(v_new_w, en0, o_r, W))
        at_en0 = act & (idx == en0[:, None])
        if r == 0:
            H_r0 = _extract(v_new_w, torch.zeros_like(en0), o_r, W) - (gq + ge)
            H = torch.where(at_en0, H_r0[:, None], H)
        else:
            H_mid = torch.where(real & (idx < en0[:, None]) & act,
                                H + v_new, H)
            H = torch.where(at_en0, H_en0[:, None], H_mid)

        # diagonal max; H[en0] seeds, then the first strictly greater
        Hmask = torch.where(real, H, c(NEG_INF))
        seg_max = Hmask.max(dim=1).values
        first_t = torch.where(Hmask == seg_max[:, None], idx,
                              c(_I32MAX)).min(dim=1).values
        H_new_en0 = _extract(H, en0, o_r, W)
        max_t = torch.where(H_new_en0 == seg_max, en0, first_t)
        max_H = seg_max

        mte_hit = active & (en0 == tl - 1) & (H_new_en0 > mte)
        mte = torch.where(mte_hit, H_new_en0, mte)
        mte_q = torch.where(mte_hit, r - en, mte_q)
        H_new_st0 = _extract(H, st0, o_r, W)
        mqe_hit = active & (r - st0 == ql - 1) & (H_new_st0 > mqe)
        mqe = torch.where(mqe_hit, H_new_st0, mqe)
        mqe_t = torch.where(mqe_hit, st0, mqe_t)

        better = max_H > ez_max
        l_ = ((max_t - ez_max_t) - ((r - max_t) - ez_max_q)).abs()
        drop_check = active & ~better & (max_t >= ez_max_t) \
            & (r - max_t >= ez_max_q)
        dropped_now = drop_check & (params.zdrop >= 0) \
            & (ez_max - max_H > params.zdrop + l_ * ge2)
        upd = active & better
        ez_max = torch.where(upd, max_H, ez_max)
        ez_max_t = torch.where(upd, max_t, ez_max_t)
        ez_max_q = torch.where(upd, r - max_t, ez_max_q)
        zdropped = torch.where(dropped_now | new_zdrop_from_band, c(1),
                               zdropped)
        score_hit = active & ~dropped_now & (r == ql + tl - 2) \
            & (en0 == tl - 1)
        score = torch.where(score_hit, _extract(H, tl - 1, o_r, W), score)

        dmat[:, r, :] = torch.where(wmask, d, c(0)).to(torch.uint8)
        cells += wmask.sum(1)
        last_st = torch.where(active, st, last_st)
        last_en = torch.where(active, en, last_en)

    return Extd2Out(score, mqe, mqe_t, mte, mte_q, ez_max, ez_max_q,
                    ez_max_t, zdropped > 0, dmat), cells


def extd2_traceback_plain(dmat, ql, tl, i0, j0, params: Extd2Params, W: int,
                          n_diag_pad: int, Tmax: int):
    """Per-diagonal backward walk over (B,) tensors; the exact semantics
    of the Pallas traceback kernel."""
    B = dmat.shape[0]
    dev = dmat.device
    t_pad = max(_ceil16(Tmax), W)
    ql = ql.to(_I32)
    tl = tl.to(_I32)
    tlen_pad16 = (tl + 15) // 16 * 16
    i = i0.to(_I32).clone()
    j = j0.to(_I32).clone()
    state = torch.zeros(B, dtype=_I32, device=dev)
    alive = (i >= 0) & (j >= 0)
    ops_mem = torch.full((B, n_diag_pad), 3, dtype=torch.int8, device=dev)
    rows = torch.arange(B, device=dev)
    zero, three = (torch.tensor(v, dtype=_I32, device=dev) for v in (0, 3))
    n_act = int((i + j).max().item()) + 1 if B else 0
    n_act = min(max(_ceil16(n_act), 16), n_diag_pad)
    for r in range(n_act - 1, -1, -1):
        o_r = window_origin(r, params.w, t_pad, W)
        st0 = torch.clamp(r - ql + 1, min=max(0, (r - params.w + 1) >> 1))
        en0 = torch.clamp(tl - 1, max=min(r, (r + params.w) >> 1))
        st = st0 // 16 * 16
        en = torch.minimum((en0 + 16) // 16 * 16 - 1, tlen_pad16 - 1)
        here = alive & (i + j == r)
        k = i - o_r
        inwin = (k >= 0) & (k < W)
        dm = torch.where(
            inwin, dmat[rows, r, k.clamp(0, W - 1).long()].to(_I32), zero)
        force = torch.where(i < st, 2, torch.where(i > en, 1, -1)).to(_I32)
        tmp = torch.where(force < 0, dm, zero)
        st1 = torch.where(state == 0, tmp & 7, state)
        cont = torch.bitwise_right_shift(tmp, st1 + 2) & 1
        st2 = torch.where((state != 0) & (cont == 0), zero, st1)
        st3 = torch.where(st2 == 0, tmp & 7, st2)
        st4 = torch.where(force >= 0, force, st3)
        op = torch.where(st4 == 0, 0, torch.where(
            (st4 == 1) | (st4 == 3), 2, 1)).to(_I32)
        i_n = torch.where(op != 1, i - 1, i)
        j_n = torch.where(op != 2, j - 1, j)
        ops_mem[:, r] = torch.where(here, op, three).to(torch.int8)
        alive = torch.where(here, (i_n >= 0) & (j_n >= 0), alive)
        i = torch.where(here, i_n, i)
        j = torch.where(here, j_n, j)
        state = torch.where(here, st4, state)
    return ops_mem.flip(1), i, j


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(*ts) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else is refused."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: "
                     f"{sorted({str(t.device) for t in ts})}")


def _stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def packed_state(params: Extd2Params, W: int) -> bool:
    """Whether the forward kernel runs packed 16-bit state: the profile
    is int8-bounded (as the JAX package's state8) and the window is whole
    64-row register pairs; else its int32 instance."""
    return state_fits_int8(params) and W % 64 == 0


def _fwd_args(q, ql, t, tl, params: Extd2Params, W: int):
    """Checks, output allocation and the C argument list of one forward
    launch on CUDA tensors: (lib, args, out, dmat, the converted inputs
    the argument list points into)."""
    from .._build import load_kernels

    if W % 32 or not 32 <= W <= MAX_W:
        raise ValueError(f"CUDA extd2_fwd needs W % 32 == 0, 32 <= W <= "
                         f"{MAX_W} (got {W})")
    B, Qmax = q.shape
    Tmax = t.shape[1]
    if t.shape[0] != B or ql.shape != (B,) or tl.shape != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)}, t {tuple(t.shape)}, "
                         f"ql {tuple(ql.shape)}, tl {tuple(tl.shape)}")
    lib = load_kernels()
    t_pad, n_diag_pad, _, _ = plan(Qmax, Tmax, W)
    dev = q.device
    qc = q.to(torch.uint8).contiguous()
    tc = t.to(torch.uint8).contiguous()
    qlc = ql.to(_I32).contiguous()
    tlc = tl.to(_I32).contiguous()
    out = torch.empty((9, B), dtype=_I32, device=dev)
    # the kernel writes every byte (zeros past each problem's sweep)
    dmat = torch.empty((B, n_diag_pad, W), dtype=torch.uint8, device=dev)
    pn = params.normalized()
    state16 = int(packed_state(params, W))
    keep = (qc, tc, qlc, tlc)      # alive as long as the argument list
    args = (qc.data_ptr(), qlc.data_ptr(), tc.data_ptr(), tlc.data_ptr(),
            out.data_ptr(), dmat.data_ptr(), B, Qmax, Tmax, W, t_pad,
            n_diag_pad, params.match, params.mismatch, pn.q, pn.e, pn.q2,
            pn.e2, params.w, params.zdrop, params.long_thres,
            params.long_diff, state16, _stream_ptr(dev))
    return lib, args, out, dmat, keep


def extd2_fwd(q, ql, t, tl, params: Extd2Params = Extd2Params(),
              W: int = 256) -> Extd2Out:
    """q (B, Qmax) / t (B, Tmax) codes 0..3 (any int dtype), ql/tl (B,)
    lengths (>= 1). W: window width, a multiple of 16 covering the band."""
    check_window(params, t.shape[1], W)
    if not _on_cuda(q, ql, t, tl):
        return extd2_fwd_plain(q, ql, t, tl, params, W)
    out, dmat = fwd_launch(q, ql, t, tl, params, W)
    return Extd2Out(out[0], out[1], out[2], out[3], out[4], out[5], out[6],
                    out[7], out[8] > 0, dmat)


def fwd_launch(q, ql, t, tl, params: Extd2Params, W: int):
    """One counted launch of the forward kernel on CUDA tensors (the
    window checked by the caller): (out (9, B) int32 rows score, mqe,
    mqe_t, mte, mte_q, max, max_q, max_t, zdropped, dmat). With q and t
    uint8 and ql, tl int32, all contiguous, it dispatches no ATen op but
    the outputs' allocation."""
    from .._build import check

    lib, args, out, dmat, _ = _fwd_args(q, ql, t, tl, params, W)
    with device_guard(q.device):
        check(lib, lib.pansvr_extd2_fwd(*args), "extd2_fwd launch")
    _count("extd2_fwd", t.shape[1], W, q.shape[0], (q, ql, t, tl, params, W))
    return out, dmat


def fwd_raw_launcher(q, ql, t, tl, params: Extd2Params, W: int):
    """A function that launches the forward kernel alone on CUDA tensors
    (inputs converted and outputs allocated once, here), for timing the
    kernel without its wrapper. Its launches are not counted."""
    from .._build import check

    check_window(params, t.shape[1], W)
    lib, args, _, _, keep = _fwd_args(q, ql, t, tl, params, W)

    def launch(_keep=keep):
        with device_guard(q.device):
            check(lib, lib.pansvr_extd2_fwd(*args), "extd2_fwd launch")
    return launch


def tb_plan(W: int) -> tuple[int, int, int]:
    """(TB_D, warps per block, dynamic shared-memory bytes a block) of a
    traceback launch at window W, as pansvr_extd2_tb computes them: two
    buffers per warp of TB_D + 2 rows (a step reads two rows ahead) of
    W + 48 bytes (the window, its slide by 16 and the forced cells around
    it). Each row of a chunk's TB_D x W bytes of dmat arrives in 16-byte
    cp.async pieces, so W (and TB_D * W) must be a multiple of 16."""
    smem = TB_WARPS * 2 * (TB_D + 2) * (W + 48)
    if W % 16 or smem > MAX_SMEM_BLOCK:
        raise ValueError(f"traceback plan W={W}: {smem} bytes of shared "
                         "memory a block")
    return TB_D, TB_WARPS, smem


def _tb_args(dmat, ql, tl, i0, j0, params: Extd2Params, W: int,
             n_diag_pad: int, Tmax: int):
    """Checks, output allocation and the C argument list of one traceback
    launch on CUDA tensors: (lib, args, ops, fin, the converted inputs the
    argument list points into)."""
    from .._build import load_kernels

    if dmat.dtype != torch.uint8:
        raise TypeError(f"dmat must be uint8, got {dmat.dtype}")
    B = dmat.shape[0]
    if any(a.shape != (B,) for a in (ql, tl, i0, j0)):
        raise ValueError("ql, tl, i0, j0 must be (B,) for dmat of B problems")
    tb_plan(W)
    lib = load_kernels()
    dev = dmat.device
    t_pad = max(_ceil16(Tmax), W)
    keep = [dmat.contiguous()] + [a.to(_I32).contiguous()
                                  for a in (ql, tl, i0, j0)]
    if keep[0].data_ptr() % 16:
        raise ValueError("dmat must start 16-byte aligned (the kernel "
                         "stages it with 16-byte cp.async)")
    ops = torch.empty((B, n_diag_pad), dtype=torch.int8, device=dev)
    fin = torch.empty((2, B), dtype=_I32, device=dev)
    args = (*(a.data_ptr() for a in keep), ops.data_ptr(), fin.data_ptr(),
            B, W, n_diag_pad, t_pad, params.w, _stream_ptr(dev))
    return lib, args, ops, fin, keep


def extd2_traceback(dmat, ql, tl, i0, j0, params: Extd2Params, W: int,
                    n_diag_pad: int, Tmax: int):
    """Walk the direction bytes back from (i0, j0) (target, query; -1 =
    no walk). Returns ops (B, n_diag_pad) int8 in walk order and the
    final (i, j). As for extd2_fwd, W covers the band and tl <= Tmax."""
    check_window(params, Tmax, W)
    if dmat.shape[1:] != (n_diag_pad, W):
        raise ValueError(f"dmat shape {tuple(dmat.shape)} != (B, {n_diag_pad}, {W})")
    if not _on_cuda(dmat, ql, tl, i0, j0):
        return extd2_traceback_plain(dmat, ql, tl, i0, j0, params, W,
                                     n_diag_pad, Tmax)
    ops, fin = tb_launch(dmat, ql, tl, i0, j0, params, W, n_diag_pad, Tmax)
    return ops, fin[0], fin[1]


def tb_launch(dmat, ql, tl, i0, j0, params: Extd2Params, W: int,
              n_diag_pad: int, Tmax: int):
    """One counted launch of the traceback kernel on CUDA tensors (the
    window checked by the caller): (ops, fin (2, B) int32 final i, j).
    With int32 contiguous inputs it dispatches no ATen op but the
    outputs' allocation."""
    from .._build import check

    lib, args, ops, fin, _ = _tb_args(dmat, ql, tl, i0, j0, params, W,
                                      n_diag_pad, Tmax)
    with device_guard(dmat.device):
        check(lib, lib.pansvr_extd2_tb(*args), "extd2_traceback launch")
    _count("extd2_tb", Tmax, W, dmat.shape[0],
           (dmat, ql, tl, i0, j0, params, W, n_diag_pad, Tmax))
    return ops, fin


def tb_raw_launcher(dmat, ql, tl, i0, j0, params: Extd2Params, W: int,
                    n_diag_pad: int, Tmax: int):
    """The traceback kernel alone, as fwd_raw_launcher; not counted."""
    from .._build import check

    lib, args, _, _, keep = _tb_args(dmat, ql, tl, i0, j0, params, W,
                                     n_diag_pad, Tmax)

    def launch(_keep=keep):
        with device_guard(dmat.device):
            check(lib, lib.pansvr_extd2_tb(*args), "extd2_traceback launch")
    return launch
