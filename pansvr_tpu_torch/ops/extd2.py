"""JAX-free basics of the extd2 banded dual-affine DP: scoring parameters,
the shared-window size plan, and the traceback op decoder.

Same definitions as pansvr_tpu.ops.extd2_jax (Extd2Params, NEG_INF) and
pansvr_tpu.ops.extd2_pallas (_plan, state_fits_int8, ops_to_cigar_skip),
so a DP request planned here lays out its direction bytes exactly like
the Pallas kernel does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NEG_INF = -0x40000000
DCHUNK = 16        # diagonal padding quantum of the direction matrix


class Extd2Params(NamedTuple):
    match: int = 2
    mismatch: int = -12
    q: int = 16
    e: int = 1
    q2: int = 32
    e2: int = 0
    w: int = 200
    zdrop: int = 400

    def normalized(self) -> "Extd2Params":
        if self.q2 + self.e2 < self.q + self.e:
            return self._replace(q=self.q2, e=self.e2, q2=self.q, e2=self.e)
        return self

    @property
    def long_thres(self) -> int:
        p = self.normalized()
        lt = (p.q2 - p.q) // (p.e - p.e2) - 1 if p.e != p.e2 else 0
        if p.q2 + p.e2 + lt * p.e2 > p.q + p.e + lt * p.e:
            lt += 1
        return lt

    @property
    def long_diff(self) -> int:
        p = self.normalized()
        return self.long_thres * (p.e - p.e2) - (p.q2 - p.q) - p.e2


def leading_gap_delta(r: int, p: Extd2Params) -> int:
    """u/v boundary value at diagonal r (the H(0-row) leading-gap cost
    schedule of the reference kernel)."""
    pn = p.normalized()
    if r == 0:
        return -pn.q - pn.e
    if r < p.long_thres:
        return -pn.e
    if r == p.long_thres:
        return p.long_diff
    return -pn.e2


def plan(Qmax: int, Tmax: int, W: int):
    """(t_pad, n_diag_pad, q_padl, q_ext) of a (Qmax, Tmax, W) size class:
    the padded target width the global window slides over, and the
    diagonal count padded to DCHUNK."""
    t_pad = max(((Tmax + 15) // 16) * 16, W)
    n_diag = Qmax + Tmax - 1
    n_diag_pad = ((n_diag + DCHUNK - 1) // DCHUNK) * DCHUNK
    q_padl = t_pad + 64
    q_ext = q_padl + Qmax + W
    return t_pad, n_diag_pad, q_padl, q_ext


def window_origin(r: int, w: int, t_pad: int, W: int) -> int:
    """o_r: target coordinate of window row 0 at diagonal r. Python's >>
    and // floor, as the Pallas kernel's int32 ops do for negative
    operands."""
    o_form = ((r - w + 1) >> 1) // 16 * 16 - 16
    return min(max(o_form, 0), t_pad - W)


def check_window(params: Extd2Params, Tmax: int, W: int) -> None:
    """W must be a multiple of 16 that covers every band at every
    diagonal: W >= w + 48, or W spans the whole padded target."""
    t_pad = plan(1, Tmax, W)[0]
    if W % 16 or not (W >= params.w + 48 or W >= t_pad):
        raise ValueError(
            f"window W={W} does not cover band w={params.w} at Tmax={Tmax}")


def state_fits_int8(params: Extd2Params) -> bool:
    """Whether the difference-recurrence state is int8-bounded for this
    scoring profile (u/v/x/y/x2/y2 and their intermediates)."""
    pn = params.normalized()
    return (pn.match - pn.mismatch + pn.q + pn.e + pn.q2 + pn.e2) <= 120


def reference(q: np.ndarray, t: np.ndarray, params: Extd2Params):
    """Scalar NumPy oracle of the kernels (ops/ksw2_ref.py extd2,
    bit-exact with the reference SSE kernel): an Ez with score, max,
    zdropped and the CIGAR."""
    from . import ksw2_ref

    return ksw2_ref.extd2(q, t, match=params.match, mismatch=params.mismatch,
                          q=params.q, e=params.e, q2=params.q2, e2=params.e2,
                          w=params.w, zdrop=params.zdrop)


def ops_to_cigar_skip(ops_row: np.ndarray, i_fin: int, j_fin: int) -> list:
    """Backward op codes (0=M 1=I 2=D, 3 = no op at that diagonal) ->
    forward run-length CIGAR with the ksw_backtrack leading-gap tail."""
    codes = np.asarray(ops_row)
    codes = codes[codes != 3]
    out: list[tuple[str, int]] = []
    if len(codes):
        starts = np.flatnonzero(np.diff(codes, prepend=-1))
        runs = np.diff(np.append(starts, len(codes)))
        out = [("MID"[int(c)], int(n)) for c, n in zip(codes[starts], runs)]
    if i_fin >= 0:
        if out and out[-1][0] == "D":
            out[-1] = ("D", out[-1][1] + i_fin + 1)
        else:
            out.append(("D", int(i_fin) + 1))
    if j_fin >= 0:
        if out and out[-1][0] == "I":
            out[-1] = ("I", out[-1][1] + j_fin + 1)
        else:
            out.append(("I", int(j_fin) + 1))
    return out[::-1]
