"""The port's device collect (ops/collect.py select_and_paths) vs the JAX
one on the same chain tensors: uncompacted rows, a compacted front's rid
row map, and lane budgets small enough that reads spill them (`over`
and the unclipped demand totals)."""

import numpy as np
import pytest
import torch

from pansvr_tpu.align.engine import _pack_mask_host
from pansvr_tpu.align.host_align import OriResult
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.ops import collect as jc
from pansvr_tpu.utils.simulate import DictGenome, make_dataset
from pansvr_tpu_torch.align.engine import AlignEngine
from pansvr_tpu_torch.ops import collect as tc
from pansvr_tpu_torch.ops.chain import chain_batch, chain_extract_batch


@pytest.fixture(scope="module")
def engine():
    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome), device="cpu")
    seqs = [s for r in ds.reads[:100] for s in (r.seq1, r.seq2)]
    return eng, seqs


def _chains(engine, comp):
    """Chain tensors (numpy) of one prepared batch through the port's
    front (compacted to `comp` rows when comp > 0) and chain."""
    eng, seqs = engine
    prep = eng._prep_batch(seqs, [OriResult(unmapped=True)] * len(seqs))
    L, S0 = prep["L"], prep["S0"]
    es, _, rid = eng._front(
        *(torch.from_numpy(prep[k]) for k in ("words", "lens2", "mask2")),
        S0=S0, S=32, M=32, n_ext=9, nf_mult=10, comp=comp)
    is_str = torch.from_numpy(prep["is_str2"])
    if rid is not None:
        B2 = len(prep["lens2"])
        is_str = is_str[rid.long().clamp(0, B2 - 1)] & (rid < B2)
    K = 32
    cr = chain_batch(es.read_begin[:, :K], es.read_end[:, :K],
                     es.ref_begin[:, :K], es.ref_end[:, :K], es.cov[:, :K],
                     es.seed_id[:, :K], es.valid[:, :K], is_str)
    hits = chain_extract_batch(cr.dist, cr.pre, cr.valid)
    arrs = [a.numpy() for a in (cr.read_begin, cr.read_end, cr.ref_begin,
                                cr.ref_end, cr.pre, *hits)]
    return arrs, prep["act_pad"], None if rid is None else rid.numpy(), \
        prep["n_pad"]


@pytest.mark.parametrize("comp,budget", [(0, None), (256, None),
                                         (256, (16, 24))],
                         ids=["rows", "rid", "rid_tiny"])
def test_select_and_paths_matches_jax(engine, comp, budget):
    arrs, act_pad, rid, n_pad = _chains(engine, comp)
    NC, NP = budget or (n_pad, 2 * n_pad)
    j = jc.select_and_paths(*arrs, _pack_mask_host(act_pad[None, :]).ravel(),
                            rid, n_pad=n_pad, NC=NC, NP=NP)
    t = tc.select_and_paths(*(torch.from_numpy(a) for a in arrs),
                            torch.from_numpy(act_pad),
                            None if rid is None else torch.from_numpy(rid),
                            n_pad=n_pad, NC=NC, NP=NP)
    for f in jc.CollectOut._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f
    n_used, n_total = t.n_chains.tolist()
    assert n_used > 0 and t.n_nodes[0] > 0
    if budget:
        # demand spills the lanes: reads flagged, true totals reported
        assert t.over.any() and (n_total > NC or t.n_nodes[1] > NP)
    else:
        assert not t.over.any() and n_used == n_total
    if rid is not None:
        assert (rid >= 2 * n_pad).any()    # empty compacted slots
