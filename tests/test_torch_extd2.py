"""Port extd2 (plain PyTorch versions of the CUDA kernels) vs the JAX
Pallas kernels in interpret mode: every output field, the direction
bytes, the traceback ops and the CIGAR, bit-exact. The CUDA kernels are
compared with these plain versions on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from pansvr_tpu.ops import ksw2_ref
from pansvr_tpu.ops.extd2_jax import Extd2Params as JaxParams
from pansvr_tpu.ops.extd2_pallas import (
    BLK,
    extd2_batch_pallas,
    traceback_batch_pallas,
)
from pansvr_tpu_torch.ops import extd2_cuda as ec
from pansvr_tpu_torch.ops.extd2 import Extd2Params, ops_to_cigar_skip, plan

ALN = Extd2Params()
SV = Extd2Params(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1, w=132,
                 zdrop=132)


def _pad(pairs, Q, T):
    B = ((len(pairs) + BLK - 1) // BLK) * BLK
    qc = np.zeros((B, Q), np.int32)
    tc = np.zeros((B, T), np.int32)
    ql = np.ones(B, np.int32)
    tl = np.ones(B, np.int32)
    for i, (q, t) in enumerate(pairs):
        qc[i, : len(q)] = q
        tc[i, : len(t)] = t
        ql[i], tl[i] = len(q), len(t)
    return qc, ql, tc, tl


def _mutate(rng, t, n_sub, n_gap, gmax):
    q = list(t)
    for _ in range(n_sub):
        i = int(rng.integers(0, len(q)))
        q[i] = (q[i] + int(rng.integers(1, 4))) % 4
    for _ in range(n_gap):
        g = int(rng.integers(-gmax, gmax + 1))
        i = int(rng.integers(1, max(2, len(q) - abs(g) - 1)))
        if g > 0:
            q[i:i] = [int(rng.integers(0, 4)) for _ in range(g)]
        elif g < 0:
            del q[i : i - g]
    return q


def _mixed(rng):
    pairs = []
    s = rng.integers(0, 4, 120).astype(np.uint8)
    pairs.append((s, s.copy()))
    t = rng.integers(0, 4, 150).astype(np.uint8)
    q = t.copy()
    q[[10, 50, 90]] = (q[[10, 50, 90]] + 1) % 4
    pairs.append((q, t))
    t = rng.integers(0, 4, 180).astype(np.uint8)
    pairs.append((np.concatenate([t[:60], t[100:]]), t))
    t2 = rng.integers(0, 4, 120).astype(np.uint8)
    ins = rng.integers(0, 4, 25).astype(np.uint8)
    pairs.append((np.concatenate([t2[:40], ins, t2[40:]]), t2))
    pairs.append((rng.integers(0, 4, 100).astype(np.uint8),
                  rng.integers(0, 4, 150).astype(np.uint8)))
    pairs.append((np.array([1], np.uint8), np.array([1, 2, 3], np.uint8)))
    pairs.append((rng.integers(0, 4, 10).astype(np.uint8),
                  rng.integers(0, 4, 180).astype(np.uint8)))
    pairs.append((rng.integers(0, 4, 155).astype(np.uint8),
                  rng.integers(0, 4, 12).astype(np.uint8)))
    return pairs, (176, 256, 256)


def _fuzz(rng):
    pairs = []
    for _ in range(24):
        t = rng.integers(0, 4, int(rng.integers(20, 150))).astype(np.uint8)
        q = _mutate(rng, t, int(rng.integers(0, 6)), int(rng.integers(0, 3)),
                    20)
        if q:
            pairs.append((np.array(q, np.uint8), t))
    return pairs, (176, 256, 256)


def _long(rng):
    pairs = []
    for _ in range(8):
        t = rng.integers(0, 4, int(rng.integers(500, 900))).astype(np.uint8)
        q = _mutate(rng, t, int(rng.integers(0, 10)), int(rng.integers(0, 3)),
                    40)
        pairs.append((np.array(q, np.uint8), t))
    return pairs, (960, 912, 192)


def _class(rng, Q, T, W, gmax):
    pairs = []
    for _ in range(24):
        n = int(rng.integers(4, T))
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = _mutate(rng, t[: min(n, Q)], int(rng.integers(0, 4)),
                    int(rng.integers(0, 2)), gmax)[:Q]
        if len(q) < 2:
            q = [0, 1]
        pairs.append((np.array(q, np.uint8), t))
    return pairs, (Q, T, W)


CASES = {
    "mixed": _mixed,
    "fuzz": _fuzz,
    "long_window": _long,
    "class96x128": lambda rng: _class(rng, 96, 128, 128, 15),
    "class48x64": lambda rng: _class(rng, 48, 64, 64, 8),
}
# the long-target case needs w + 48 <= W: the SV profile only
PARAMS = [(c, p) for c in CASES for p in ("aln", "sv")
          if not (c == "long_window" and p == "aln")]


def _endpoints(score_fields, ql, tl):
    zd, mq, mt = score_fields
    i0 = np.where(~zd, tl - 1, np.where(mt >= 0, mt, -1)).astype(np.int32)
    j0 = np.where(~zd, ql - 1, np.where(mq >= 0, mq, -1)).astype(np.int32)
    return i0, j0


@pytest.mark.parametrize("case,prof", PARAMS)
def test_plain_matches_pallas(case, prof):
    params = ALN if prof == "aln" else SV
    seed = 100 + list(CASES).index(case)
    pairs, (Q, T, W) = CASES[case](np.random.default_rng(seed))
    qc, ql, tc, tl = _pad(pairs, Q, T)
    jp = JaxParams(*params)
    res = extd2_batch_pallas(qc, ql, tc, tl, params=jp, W=W, interpret=True,
                             state8=False)
    got = ec.extd2_fwd(torch.from_numpy(qc), torch.from_numpy(ql),
                       torch.from_numpy(tc), torch.from_numpy(tl), params, W)
    for f in ("score", "mqe", "mqe_t", "mte", "mte_q", "max", "max_q",
              "max_t", "zdropped"):
        assert np.array_equal(np.asarray(getattr(res, f)),
                              getattr(got, f).numpy()), f"{case} field {f}"

    _, n_diag_pad, _, _ = plan(Q, T, W)
    B = len(ql)
    # Pallas (G, r, k, lane) -> (b, r, k); each 128-lane block sweeps only
    # to its own longest problem, rows past that are never written
    jd = np.asarray(res.dmat).transpose(0, 3, 1, 2).reshape(B, n_diag_pad, W)
    pd = got.dmat.numpy()
    for g in range(B // BLK):
        sl = slice(g * BLK, (g + 1) * BLK)
        n_act = min(max((int((ql[sl] + tl[sl]).max()) - 1 + 15) // 16 * 16,
                        16), n_diag_pad)
        assert np.array_equal(jd[sl, :n_act], pd[sl, :n_act]), \
            f"{case} dmat block {g}"
        assert not pd[sl, n_act:].any()

    i0, j0 = _endpoints((np.asarray(res.zdropped), np.asarray(res.max_q),
                         np.asarray(res.max_t)), ql, tl)
    jops, ji, jj = traceback_batch_pallas(
        res.dmat, ql, tl, i0, j0, params=jp, W=W, n_diag_pad=n_diag_pad,
        Tmax=T, interpret=True)
    ops, i_f, j_f = ec.extd2_traceback(
        got.dmat, torch.from_numpy(ql), torch.from_numpy(tl),
        torch.from_numpy(i0), torch.from_numpy(j0), params, W, n_diag_pad, T)
    assert np.array_equal(np.asarray(jops), ops.numpy()), f"{case} ops"
    assert np.array_equal(np.asarray(ji), i_f.numpy())
    assert np.array_equal(np.asarray(jj), j_f.numpy())

    for b, (q, t) in enumerate(pairs):
        ref = ksw2_ref.extd2(q, t, match=params.match,
                             mismatch=params.mismatch, q=params.q, e=params.e,
                             q2=params.q2, e2=params.e2, w=params.w,
                             zdrop=params.zdrop)
        assert int(got.max[b]) == ref.max and \
            bool(got.zdropped[b]) == ref.zdropped, f"{case} case {b}"
        if not ref.zdropped:
            assert int(got.score[b]) == ref.score, f"{case} case {b} score"
        cig = ops_to_cigar_skip(ops[b].numpy(), int(i_f[b]), int(j_f[b])) \
            if i0[b] >= 0 and j0[b] >= 0 else []
        assert cig == ref.cigar, f"{case} case {b} cigar"


def test_wrapper_refuses_bad_window():
    q = torch.zeros((1, 8), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ec.extd2_fwd(q, one, q, one, ALN, W=40)


@pytest.mark.parametrize("W", range(32, ec.MAX_W + 1, 32))
def test_traceback_plan_fits_every_forward_window(W):
    """The traceback kernel's launch plan at every window the forward
    kernel takes: whole 16-byte cp.async pieces, and two chunk buffers a
    warp within a block's 227 KB of shared memory."""
    D, warps, smem = ec.tb_plan(W)
    assert (D * W) % 16 == 0
    assert smem == warps * 2 * (D + 2) * (W + 48) <= 227 * 1024
    with pytest.raises(ValueError):
        ec.tb_plan(W + 8)   # not whole 16-byte pieces


def test_traceback_refuses_bad_window():
    """As the forward wrapper: a window that does not cover the band is
    refused (the kernel folds the band into the window's bytes)."""
    one = torch.ones(1, dtype=torch.int32)
    _, n_diag_pad, _, _ = plan(8, 400, 64)
    dmat = torch.zeros((1, n_diag_pad, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not cover"):
        ec.extd2_traceback(dmat, one, one, one, one, ALN, 64, n_diag_pad, 400)


def test_plain_path_counts_no_launch():
    ec.reset_launches()
    q = torch.randint(0, 4, (4, 20), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(0))
    ln = torch.full((4,), 20, dtype=torch.int32)
    r = ec.extd2_fwd(q, ln, q, ln, ALN, W=64)
    assert (r.score == 40).all()
    assert ec.LAUNCHES == {"extd2_fwd": 0, "extd2_tb": 0}


@pytest.mark.parametrize("params", [ALN, ALN._replace(zdrop=-1), SV],
                         ids=["aln", "aln_no_zdrop", "sv"])
def test_plain_cells_count_the_swept_band(params):
    """extd2_fwd_plain_cells: the same result as extd2_fwd_plain, plus per
    problem the 16-padded band cells of every diagonal its sweep reached
    (the first band death, z-drop or its last diagonal ends it)."""
    rng = np.random.default_rng(5)
    pairs, (Q, T, W) = _mixed(rng)
    qc, ql, tc, tl = (torch.from_numpy(a) for a in _pad(pairs, Q, T))
    out, cells = ec.extd2_fwd_plain_cells(qc, ql, tc, tl, params, W)
    ref = ec.extd2_fwd_plain(qc, ql, tc, tl, params, W)
    for f in ref._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for b in range(len(ql)):
        qlen, tlen = int(ql[b]), int(tl[b])
        want = 0
        for r in range(qlen + tlen - 1):
            st0 = max(0, r - qlen + 1, (r - params.w + 1) >> 1)
            en0 = min(tlen - 1, r, (r + params.w) >> 1)
            if st0 > en0:
                break
            st = st0 // 16 * 16
            en = min((en0 + 16) // 16 * 16 - 1, (tlen + 15) // 16 * 16 - 1)
            want += en - st + 1
        # a z-drop may end the sweep before the band does
        if bool(out.zdropped[b]):
            assert 0 < int(cells[b]) <= want, b
        else:
            assert int(cells[b]) == want, b
