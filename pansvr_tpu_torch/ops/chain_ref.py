"""Host (scalar) reference of seed chaining + chain extraction.

Literal behavioral port of Graph_handler::process /
dynamic_programming_path (src/cpp_lib/graph.cpp:53-150) and the
realigner's sort_output chain extraction (read_realignment.cpp:213-293).
Oracle for ops/chain.py (device) and used directly by the host aligner.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_REF_DIS, MAX_REF_DIS_STR = 50, 400
MAX_READ_DIS, MAX_READ_DIS_STR = 50, 400
MAX_SEARCH_STEP, MAX_SEARCH_STEP_STR = 40, 80
MAX_ABS_GAP, MAX_ABS_GAP_STR = 50, 20


@dataclass
class ChainGraph:
    """Sorted seed arrays + DP results (the Graph_handler state)."""
    read_begin: np.ndarray
    read_end: np.ndarray
    ref_begin: np.ndarray
    ref_end: np.ndarray
    cov: np.ndarray
    seed_id: np.ndarray
    dist: np.ndarray
    pre: np.ndarray
    already_used: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.already_used is None:
            self.already_used = np.zeros(len(self.dist), dtype=bool)

    @property
    def n(self):
        return len(self.dist)


def chain_seeds(seeds, is_str: bool) -> ChainGraph:
    """seeds: iterable with .read_begin/.read_end/.ref_begin/.ref_end/
    .cov/.seed_id (e.g. index.query.RefSeed)."""
    arr = sorted(seeds, key=lambda s: (s.ref_end, s.ref_begin))
    n = len(arr)
    rb = np.array([s.read_begin for s in arr], dtype=np.int64)
    re_ = np.array([s.read_end for s in arr], dtype=np.int64)
    fb = np.array([s.ref_begin for s in arr], dtype=np.int64)
    fe = np.array([s.ref_end for s in arr], dtype=np.int64)
    cv = np.array([s.cov for s in arr], dtype=np.int64)
    sid = np.array([s.seed_id for s in arr], dtype=np.int64)

    dist = cv.astype(np.float64).copy()
    pre = np.full(n, -1, dtype=np.int64)

    max_ref = MAX_REF_DIS_STR if is_str else MAX_REF_DIS
    max_read = MAX_READ_DIS_STR if is_str else MAX_READ_DIS
    max_step = MAX_SEARCH_STEP_STR if is_str else MAX_SEARCH_STEP
    max_gap = MAX_ABS_GAP_STR if is_str else MAX_ABS_GAP
    search_step = min(n, max_step)

    edges: list[list[tuple[int, int, int]]] = [[] for _ in range(n)]
    for i in range(n - 1):
        for j in range(i + 1, min(n, i + search_step)):
            if sid[j] == sid[i]:
                continue
            if fe[j] == fe[i]:
                continue
            dis_ref = int(fb[j] - fe[i])
            if dis_ref > max_ref:
                break
            dis_read = int(rb[j] - re_[i])
            if dis_read > max_read:
                continue
            gap = abs(dis_read - dis_ref)
            if gap > max_gap:
                continue
            penalty = 0 if gap == 0 else (gap >> 3) + 3
            if dis_read == dis_ref:
                weight = int(cv[j]) - max(1 - dis_read, 0)
            elif dis_read > 0 and dis_ref > 0:
                weight = int(cv[j])
            elif -5 <= dis_read <= 0 and dis_ref >= -5:
                weight = int(cv[j]) + min(dis_read, dis_ref)
            else:
                continue
            edges[j].append((i, weight, penalty))

    any_edge = any(edges)
    if any_edge:
        for j in range(n):
            if not edges[j]:
                continue
            current = 0.0
            pre_node = -1
            for i, w, p in edges[j]:
                temp = dist[i] + w - p
                if current <= temp:
                    current = temp
                    pre_node = i
            dist[j] = current
            pre[j] = pre_node

    return ChainGraph(rb, re_, fb, fe, cv, sid, dist, pre)


@dataclass
class ChainHit:
    """One extracted chain (pre-sort_output result fields)."""
    max_index: int       # sorted position of the chain tail
    chain_score: float
    first_node: int      # sorted position of the chain head
    read_begin: int
    ref_begin: int       # packed-reference coordinate of head seed


def extract_chain(g: ChainGraph, rng=None) -> ChainHit | None:
    """sort_output (read_realignment.cpp:213-293) minus the chr-id
    conversion: pick max-dist unused node (random tie-break among equal
    tops), walk predecessors marking used, apply the STR region
    suppression, retry if >= half the nodes were already used."""
    if g.n == 0:
        return None
    while True:
        max_index = -1
        max_dist = 0.0
        ties: list[int] = [max_index]
        for i in range(g.n - 1, -1, -1):
            if g.already_used[i]:
                continue
            d = g.dist[i]
            if max_dist < d:
                max_dist = d
                max_index = i
                ties = [i]
            elif max_dist == d:
                ties.append(i)
        if max_index == -1:
            return None
        if len(ties) > 1:
            if rng is not None:
                max_index = ties[int(rng.integers(len(ties)))]
            # deterministic default: keep the last-found (smallest index)?
            # reference picks rand() % size among ties; callers that need
            # parity pass an rng seeded to reproduce distributions.

        used = 0
        not_used = 0
        node = max_index
        first = node
        while True:
            if g.already_used[node]:
                used += 1
            else:
                not_used += 1
            g.already_used[node] = True
            nxt = g.pre[node]
            if nxt == -1:
                break
            node = nxt
        final = node

        # STR/VNTR suppression (read_realignment.cpp:271-275)
        if max_index - final > ((not_used + used + 5) << 1):
            g.already_used[final:max_index] = True

        if used >= not_used:
            continue  # re-entrant retry (read_realignment.cpp:277-278)

        return ChainHit(
            max_index=max_index,
            chain_score=g.dist[max_index],
            first_node=final,
            read_begin=int(g.read_begin[final]),
            ref_begin=int(g.ref_begin[final]),
        )


def chain_nodes(g: ChainGraph, max_index: int) -> list[int]:
    """Chain node list from tail to head (the get_ksw_score walk order)."""
    out = [max_index]
    while g.pre[out[-1]] != -1:
        out.append(int(g.pre[out[-1]]))
    return out
