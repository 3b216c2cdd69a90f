"""The per-batch front, chain, collect and DP glue as hand-written CUDA
kernels (csrc/front.cu): what align/programs.py runs on a card.

  front_program(didx, inputs, shapes) -> programs.front_program's dict
  front(didx, words, lens2, mask2, is_str2, S0, S, M, n_ext, nf_mult,
        comp, L)                       -> (es, stats3, rid, is_str, codes)
  chain(es, is_str, K, pack)           -> chain tensors (sorted seeds,
                                          pre, hits; or the host pack)
  chain_program(es, is_str, rid, active, K, n_pad, NC, NP) -> dict
  dp_program(codes_flat, ref_words, meta, cq, ct, W, size, params,
             tru_len)                  -> {"ops", "packed"}

Each matches, bit for bit, the plain PyTorch program it stands in for:
programs.front_program_plain, programs.front_seeds + unpack_codes
(ops/seeding.py), programs.chain_program_plain (ops/chain.py,
ops/collect.py) and programs.dp_program_plain.
Those stay the CPU's path and the specification. On a card the plain
programs dispatch 45 ATen op kinds that the engine build never
ran, and the first launch of each loads a libtorch CUDA module that
stays in host memory; these wrappers dispatch nothing but torch.empty
for their outputs and scratch, and launch their kernels through ctypes
on the current stream, so a CUDA graph captures them. Each launch of
an entry point counts in extd2_cuda.FRONT_LAUNCHES (by its name, as K1's
and K2's count in LAUNCHES: recorded at a graph's capture, counted at
each replay).

Inputs must be contiguous (the es tensors of a chain: rows of one
stride), as the programs hand them; anything else raises. `lib`: the
kernel library (default: the card's, _build.load_kernels); the CPU tests
pass a host build of csrc/front.cu with CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..index.device import PAD_WORDS, device_guard
from . import extd2_cuda
from .extd2 import Extd2Params, check_window, plan
from .seeding import DeviceSeeds

_I32 = torch.int32
_I16 = torch.int16
_I8 = torch.int8
_U8 = torch.uint8
_BOOL = torch.bool
ES_FIELDS = DeviceSeeds._fields[:-1]     # all but n_dropped
# the widest MEM lane row csrc/front.cu holds (M of the 1600 read class)
MAX_M = 320
MAX_K = 32


def bind(lib) -> None:
    """Argument types of the entry points of csrc/front.cu in `lib`."""
    P = ctypes.c_void_p
    for name in ("pansvr_front", "pansvr_chain", "pansvr_collect",
                 "pansvr_dp_fill", "pansvr_dp_start", "pansvr_dp_pack"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [P, P, P]
    for name in ("pansvr_front_scratch", "pansvr_collect_scratch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [P]


def _lib(lib):
    if lib is not None:
        return lib
    from .._build import load_kernels

    return load_kernels()


def _c(t: torch.Tensor, dtype, name: str) -> torch.Tensor:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor, got "
                         f"{t.dtype} of strides {t.stride()}")
    return t


def _call(lib, fn: str, dev, ptrs, ints) -> None:
    """lib.fn(pointer table, int table, stream) on `dev`; raises on a
    failed launch (a shape the kernels refuse: -1)."""
    p = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    n = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(dev).cuda_stream \
        if dev.type == "cuda" else None
    with device_guard(dev):
        err = getattr(lib, fn)(p, n, stream)
    if err == -1:
        raise ValueError(f"{fn}: shapes {list(ints)} refused")
    if err:
        from .._build import check

        check(lib, err, f"{fn} launch")
    extd2_cuda._count(fn, 0, 0, 0, None)


def front_program(didx, inputs: dict, shapes: dict, lib=None) -> dict:
    """programs.front_program on a card: front(), then chain_program()
    at the speculative width K, as the same dict ("chain/<name>",
    "codes", "es/<field>", "is_str", and "rid", "active" when not
    None)."""
    g = shapes.__getitem__
    es, stats3, rid, is_str_c, codes = front(
        didx, inputs["words"], inputs["lens2"], inputs["mask2"],
        inputs["is_str2"], g("S0"), g("S"), g("M"), g("n_ext"),
        g("nf_mult"), g("comp"), g("L"), lib=lib)
    is_str = inputs["is_str2"] if rid is None else is_str_c
    active = inputs["act_pad"] if g("NC") else None
    chain = chain_program(es, is_str, rid, active, g("K"), g("n_pad"),
                          g("NC"), g("NP"), lib=lib)
    out = {"chain/stats3": stats3}
    out.update((f"chain/{k}", v) for k, v in chain.items())
    out["codes"] = codes
    out.update((f"es/{f}", getattr(es, f)) for f in ES_FIELDS)
    out["is_str"] = is_str
    if rid is not None:
        out["rid"] = rid
    if active is not None:
        out["active"] = active
    return out


def front(didx, words, lens2, mask2, is_str2, S0: int, S: int, M: int,
          n_ext: int, nf_mult: int, comp: int, L: int, lib=None):
    """seed_reads_flat (compacted to `comp` rows when > 0) +
    merge_expand_device3 + unpack_codes of one batch's B rows. Returns
    (es: DeviceSeeds of the chain rows, n_dropped None; stats3 (3, B)
    int32 [overflow, dropped, seed count]; rid (comp,) int32 or None;
    is_str of the chain rows (comp,) bool or None; codes (B * L,)
    uint8), as programs.front_seeds and unpack_codes give them."""
    lib = _lib(lib)
    dev = words.device
    B, Wr = words.shape
    if M > MAX_M or not 0 <= comp:
        raise ValueError(f"front: M={M} (at most {MAX_M}), comp={comp}")
    ins = (_c(words, _I32, "words"), _c(lens2, _I32, "lens2"),
           _c(mask2, _BOOL, "mask2"), _c(is_str2, _BOOL, "is_str2"),
           didx.ent_key, didx.ent_run, didx.ent_pack, didx.uni_words_pad,
           didx.uni_posp, didx.uni_pos)
    ints = [B, Wr, S0, M, S, n_ext, nf_mult * B, comp, didx.n_kmer,
            didx.uni_words_pad.shape[0], didx.n_uni, didx.uni_pos.shape[0],
            didx.search_k, didx.first_level_bases, L, PAD_WORDS]
    Bc = comp or B

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    es = [empty((Bc, S), _I32) for _ in range(6)] + [empty((Bc, S), _BOOL)]
    stats3 = empty((3, B), _I32)
    rid = empty((comp,), _I32) if comp else None
    is_str = empty((comp,), _BOOL) if comp else None
    codes = empty((B * L,), _U8)
    scratch = empty((int(lib.pansvr_front_scratch(
        (ctypes.c_int * len(ints))(*ints))),), _I32)
    _call(lib, "pansvr_front", dev,
          (*ins, *es, stats3, rid, is_str, codes, scratch), ints)
    return (DeviceSeeds(*es, n_dropped=None), stats3, rid, is_str, codes)


def chain(es, is_str, K: int, pack: bool, lib=None) -> dict:
    """chain_batch + chain_extract_batch at width K over the first K
    columns of the (R, S) es tensors. Returns {"rb", "re", "fb", "fe",
    "pre"} (R, K) int32 in sorted order and "hits" (3, R, 6) int32
    (hit_idx, hit_score, hit_final); with `pack`, programs.chain_pack's
    tensors as well (p32, p16, p8, hits8, hscore)."""
    lib = _lib(lib)
    cols = [getattr(es, f) for f in ES_FIELDS]
    R, S = cols[0].shape
    dev = cols[0].device
    if not 1 <= K <= min(S, MAX_K):
        raise ValueError(f"chain: K={K} for {S} seed columns")
    for f, t in zip(ES_FIELDS, cols):
        if t.shape != (R, S) or t.stride() != (S, 1) \
                or t.dtype != (_BOOL if f == "valid" else _I32):
            raise ValueError(f"chain: es.{f} {tuple(t.shape)} {t.dtype} "
                             f"strides {t.stride()}")
    _c(is_str, _BOOL, "is_str")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {k: empty((R, K), _I32) for k in ("rb", "re", "fb", "fe", "pre")}
    out["hits"] = empty((3, R, 6), _I32)
    packed = ()
    if pack:
        packed = (empty((R, K), _I32), empty((3, R, K), _I16),
                  empty((R, K), _I8), empty((2, R, 6), _I8),
                  empty((R, 6), _I16))
        out.update(zip(("p32", "p16", "p8", "hits8", "hscore"), packed))
    _call(lib, "pansvr_chain", dev,
          (*cols, is_str, out["rb"], out["re"], out["fb"], out["fe"],
           out["pre"], out["hits"], *packed), [R, S, K, int(pack)])
    return out


def collect(ch: dict, active, rid, n_pad: int, NC: int, NP: int,
            lib=None) -> dict:
    """select_and_paths over chain()'s tensors: {"over", "scal",
    "chain_meta", "path_a", "path_b", "path_dfe"} as programs.
    chain_program returns them with the device collect."""
    lib = _lib(lib)
    R, K = ch["rb"].shape
    dev = ch["rb"].device
    if active.shape != (n_pad,) or (rid is None and R != 2 * n_pad):
        raise ValueError(f"collect: {R} chain rows, n_pad {n_pad}, "
                         f"active {tuple(active.shape)}")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    ints = [R, K, n_pad, NC, NP]
    out = dict(over=empty((n_pad,), _I32), scal=empty((4,), _I32),
               chain_meta=empty((NC, 3), _I32), path_a=empty((NP,), _I32),
               path_b=empty((NP,), _I32), path_dfe=empty((NP,), _I16))
    scratch = empty((int(lib.pansvr_collect_scratch(
        (ctypes.c_int * len(ints))(*ints))),), _I32)
    _call(lib, "pansvr_collect", dev,
          (ch["rb"], ch["re"], ch["fb"], ch["fe"], ch["pre"], ch["hits"],
           _c(active, _BOOL, "active"),
           None if rid is None else _c(rid, _I32, "rid"),
           out["chain_meta"], out["path_a"], out["path_b"], out["path_dfe"],
           out["scal"], out["over"], scratch), ints)
    return out


def chain_program(es, is_str, rid, active, K: int, n_pad: int, NC: int,
                  NP: int, lib=None) -> dict:
    """programs.chain_program: the chain at width K, then the device
    collect (NC > 0) or the host collect's pack ("rid" added when
    compacted)."""
    ch = chain(es, is_str, K, pack=not NC, lib=lib)
    if NC:
        return collect(ch, active, rid, n_pad, NC, NP, lib=lib)
    out = {k: ch[k] for k in ("p32", "p16", "p8", "hits8", "hscore")}
    if rid is not None:
        out["rid"] = rid
    return out


def dp_program(codes_flat, ref_words, meta, cq: int, ct: int, W: int,
               size: int, params: Extd2Params, tru_len: int,
               lib=None) -> dict:
    """programs.dp_program on a card: the fill kernel, K1, the walk's
    start, K2 and the packing, with no ATen op between them. `meta`
    (5, size) int32 with unit column stride (a column slice of the
    batch's metadata is taken in place)."""
    lib = _lib(lib)
    dev = codes_flat.device
    if meta.shape != (5, size) or meta.dtype != _I32 or meta.stride(1) != 1:
        raise ValueError(f"DP metadata {tuple(meta.shape)} {meta.dtype} "
                         f"strides {meta.stride()} != (5, {size}) int32")
    check_window(params, ct, W)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    qc, tc = empty((size, cq), _U8), empty((size, ct), _U8)
    ql, tl = empty((size,), _I32), empty((size,), _I32)
    _call(lib, "pansvr_dp_fill", dev,
          (_c(codes_flat, _U8, "codes"), _c(ref_words, _I32, "ref_words"),
           meta, qc, tc, ql, tl),
          [size, cq, ct, codes_flat.shape[0], ref_words.shape[0], tru_len,
           meta.stride(0)])
    out9, dmat = extd2_cuda.fwd_launch(qc, ql, tc, tl, params, W)
    i0, j0 = empty((size,), _I32), empty((size,), _I32)
    _call(lib, "pansvr_dp_start", dev, (out9, ql, tl, i0, j0), [size])
    _, n_diag_pad, _, _ = plan(cq, ct, W)
    ops, fin = extd2_cuda.tb_launch(dmat, ql, tl, i0, j0, params, W,
                                    n_diag_pad, ct)
    packed = empty((8, size), _I32)
    _call(lib, "pansvr_dp_pack", dev, (out9, fin, packed), [size])
    return {"ops": ops, "packed": packed}
