"""HSP chaining (reference chain.c).

Reduces a segment table to the best strictly-ordered chain under the
blastz chain penalty model: connecting segment j -> i costs
diagDiff * diagPen + numSubs * antiPen, where overlap (negative
numSubs) is instead credited at scale * sub[A][A] per base
(reference chain_connect_penalty, lastz.c:3687).

The reference accelerates best-predecessor queries with a k-d tree
(chain.c:647,920); the same structure is implemented in
native/chain_kd.cpp and used whenever the native library is available,
with a vectorized numpy DP (O(n^2)) as the no-compiler fallback.  Both
paths produce identical results, including tie-breaking (equal-scoring
predecessors resolve to the smallest index in pos1-sorted order).
"""

from __future__ import annotations

import numpy as np

CHAIN_SCALE = 100
BEST_POSSIBLE = 0x7FFFFFFF


def reduce_to_chain(anchors, diag_pen: int, anti_pen: int, scoring) -> int:
    """Keep only the best chain; returns the chain score (descaled)."""
    segs = anchors.segments
    n = len(segs)
    if n == 0:
        return 0

    # reference sorts with qSegmentsByPos1 before the DP
    segs.sort(key=lambda s: (s.pos1, s.length, s.pos2, s.seg_id, s.score))

    pos1 = np.array([s.pos1 for s in segs], dtype=np.int64)
    pos2 = np.array([s.pos2 for s in segs], dtype=np.int64)
    length = np.array([s.length for s in segs], dtype=np.int64)
    score = np.array([s.score for s in segs], dtype=np.float64)

    x_end = pos1 + length - 1
    y_end = pos2 + length - 1
    diag = pos1 - pos2
    sub_aa = int(scoring.sub[ord("A"), ord("A")])

    chain_score = np.zeros(n, dtype=np.float64)
    back = np.full(n, -1, dtype=np.int64)

    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        lib.chain_reduce(
            n,
            pos1.ctypes.data_as(p_i64), pos2.ctypes.data_as(p_i64),
            length.ctypes.data_as(p_i64), score.ctypes.data_as(p_f64),
            float(CHAIN_SCALE), float(diag_pen), float(anti_pen),
            float(CHAIN_SCALE * sub_aa), float(BEST_POSSIBLE),
            chain_score.ctypes.data_as(p_f64), back.ctypes.data_as(p_i64))
        return _finish_chain(anchors, segs, chain_score, back)

    for i in range(n):
        pred = (pos1 < pos1[i]) & (pos2 < pos2[i])
        pred[i:] = False
        idx = np.nonzero(pred)[0]
        contrib = 0.0
        best_j = -1
        if len(idx):
            diag_diff = diag[i] - diag[idx]
            num_subs = np.where(
                diag_diff >= 0,
                pos2[i] - y_end[idx] - 1,
                pos1[i] - x_end[idx] - 1)
            penalty = np.abs(diag_diff).astype(np.float64) * diag_pen
            pos_subs = num_subs >= 0
            penalty += np.where(
                pos_subs,
                num_subs * float(anti_pen),
                (-num_subs) * float(CHAIN_SCALE * sub_aa))
            penalty = np.minimum(penalty, BEST_POSSIBLE)
            cand = chain_score[idx] - penalty
            k = int(np.argmax(cand))
            if cand[k] > contrib:
                contrib = float(cand[k])
                best_j = int(idx[k])
        chain_score[i] = score[i] * CHAIN_SCALE + contrib
        back[i] = best_j

    return _finish_chain(anchors, segs, chain_score, back)


def _finish_chain(anchors, segs, chain_score, back):
    n = len(segs)
    best = 0.0
    best_end = -1
    for i in range(n):
        if chain_score[i] > best:
            best = chain_score[i]
            best_end = i

    keep = np.zeros(n, dtype=bool)
    i = best_end
    while i != -1:
        keep[i] = True
        i = int(back[i])
    anchors.segments = [s for k, s in zip(keep, segs) if k]
    anchors.coverage = sum(s.length for s in anchors.segments)

    best = best / CHAIN_SCALE + 0.5
    return min(int(best), BEST_POSSIBLE)
