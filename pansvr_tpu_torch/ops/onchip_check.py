"""On-card kernel parity gate: the extd2 forward and traceback kernels
(ops/extd2_cuda.py: K1 + K2 on a CUDA device, their plain versions on
the CPU) vs the scalar ksw2 oracle (ops/ksw2_ref.py, the port's copy of
the fuzz-verified oracle of src/kswlib/ksw2_extd2_sse.c).

The port's counterpart of pansvr_tpu/ops/onchip_check.py, on a `device`
argument instead of the JAX backend: the CPU tests run it on the plain
versions, chip_smoke.py on the card. It checks the realigner's profile
and the contig (fc_sv) profile at Q=176, T=256, W=256; the contig
profile at that window runs the packed 16-bit instance of K1, a
combination no fc_aln or fc_sv launch takes.
"""

from __future__ import annotations

import numpy as np

from . import ksw2_ref
from .extd2 import Extd2Params, ops_to_cigar_skip, plan

ALN = Extd2Params()
SV = Extd2Params(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1,
                 w=132, zdrop=132)


def _pad_batch(pairs, Q, T):
    B = len(pairs)
    qc = np.zeros((B, Q), np.int32)
    tc = np.zeros((B, T), np.int32)
    ql = np.ones(B, np.int32)
    tl = np.ones(B, np.int32)
    for i, (q, t) in enumerate(pairs):
        qc[i, : len(q)] = q
        tc[i, : len(t)] = t
        ql[i] = len(q)
        tl[i] = len(t)
    return qc, ql, tc, tl


def _fuzz_pairs(rng, n_cases):
    pairs = []
    for _ in range(n_cases):
        n = int(rng.integers(20, 150))
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = list(t)
        for _ in range(int(rng.integers(0, 6))):
            i = int(rng.integers(0, len(q)))
            q[i] = (q[i] + int(rng.integers(1, 4))) % 4
        for _ in range(int(rng.integers(0, 3))):
            g = int(rng.integers(-20, 21))
            i = int(rng.integers(1, max(2, len(q) - abs(g) - 1)))
            if g > 0:
                q[i:i] = [int(rng.integers(0, 4)) for _ in range(g)]
            elif g < 0:
                del q[i : i - g]
        if q:
            pairs.append((np.array(q, np.uint8), t))
    return pairs


def check_extd2(pairs, params, Q=176, T=256, W=256, device="cuda") -> int:
    """Kernel + traceback on `device` vs the oracle; raises AssertionError
    on the first mismatch, returns the number of cases checked."""
    import torch

    from ..index.device import resolve_device
    from .extd2_cuda import extd2_fwd, extd2_traceback

    dev = resolve_device(device)
    qc, ql, tc, tl = (torch.from_numpy(a).to(dev)
                      for a in _pad_batch(pairs, Q, T))
    res = extd2_fwd(qc, ql, tc, tl, params, W)
    n_diag_pad = plan(Q, T, W)[1]

    i0 = np.full(len(pairs), -1, np.int32)
    j0 = np.full(len(pairs), -1, np.int32)
    refs = []
    for i, (q, t) in enumerate(pairs):
        ref = ksw2_ref.extd2(
            q, t, match=params.match, mismatch=params.mismatch,
            q=params.q, e=params.e, q2=params.q2, e2=params.e2,
            w=params.w, zdrop=params.zdrop,
        )
        refs.append(ref)
        if not ref.zdropped:
            i0[i], j0[i] = len(t) - 1, len(q) - 1
        elif ref.max_t >= 0 and ref.max_q >= 0:
            i0[i], j0[i] = ref.max_t, ref.max_q

    ops, i_f, j_f = extd2_traceback(
        res.dmat, ql, tl, torch.from_numpy(i0).to(dev),
        torch.from_numpy(j0).to(dev), params, W, n_diag_pad, T)
    ops, i_f, j_f = (x.cpu().numpy() for x in (ops, i_f, j_f))
    zd, mx, sc, mqe, mq, mt = (x.cpu().numpy() for x in (
        res.zdropped, res.max, res.score, res.mqe, res.max_q, res.max_t))
    for i, ref in enumerate(refs):
        assert bool(zd[i]) == ref.zdropped, f"case {i} zdropped"
        assert int(mx[i]) == ref.max, f"case {i} max"
        if not ref.zdropped:
            assert int(sc[i]) == ref.score, f"case {i} score"
        assert int(mqe[i]) == ref.mqe, f"case {i} mqe"
        assert (int(mq[i]), int(mt[i])) == (ref.max_q, ref.max_t), \
            f"case {i} max endpoint"
        cig = (ops_to_cigar_skip(ops[i], int(i_f[i]), int(j_f[i]))
               if i0[i] >= 0 else [])
        assert cig == ref.cigar, f"case {i} cigar {cig} != {ref.cigar}"
    return len(pairs)


def run_onchip_parity(quick: bool = False, seed: int = 10,
                      device="cuda") -> dict:
    """The whole gate; returns a summary dict for logging (cases checked
    per profile)."""
    rng = np.random.default_rng(seed)
    n_fuzz = 8 if quick else 48
    out = {}
    for name, params in (("aln", ALN),) + ((("sv", SV),) if not quick
                                           else ()):
        pairs = _fuzz_pairs(rng, n_fuzz)
        out[f"extd2_{name}"] = check_extd2(pairs, params, device=device)
    return out
