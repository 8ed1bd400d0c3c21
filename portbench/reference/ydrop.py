"""Gapped extension in plain NumPy: a one-sided y-drop, score only.

From a cell where an alignment has reached in the H state, `extend`
explores the affine-gap dynamic programme over the sequences a and b
that follow it (the caller hands them over oriented: reversed for an
extension to the left), a row of `a` at a time, and returns the best score it reaches and that cell (rows
and columns consumed). A gap of k columns costs open + k * extend. A
cell whose score falls more than `y_drop` below the best so far is
dead; the extension ends when a row has no live cell, at the ends of
the sequences, or once the best reaches `stop_at`.
"""

from __future__ import annotations

import numpy as np

NEG = np.int64(-(1 << 60))


def extend(a, b, sub, gap_open, gap_extend, y_drop, stop_at=None,
           max_rows=None):
    na, nb = len(a), len(b)
    oe = gap_open + gap_extend
    e = gap_extend
    best, bi, bj = 0, 0, 0
    # row 0: the start and a horizontal gap from it
    k = min(nb, max((y_drop - oe) // e + 1, 0)) if y_drop >= oe else 0
    lo = 0
    H = np.concatenate(([0], -oe - e * np.arange(k)))
    F = np.full(len(H), NEG)
    rows = na if max_rows is None else min(na, max_rows)
    for i in range(1, rows + 1):
        hi = lo + len(H)  # columns [lo, hi) of the previous row
        ai = a[i - 1]
        # diagonal: column j from column j - 1 of the previous row
        c_hi = min(hi + 1, nb + 1)
        cols = np.arange(lo, c_hi)
        D = np.full(len(cols), NEG)
        src = cols - 1 - lo
        okd = (src >= 0) & (src < len(H))
        D[okd] = H[src[okd]] + sub[ai, b[cols[okd] - 1]]
        # vertical: column j of the previous row
        Fn = np.full(len(cols), NEG)
        Fn[:hi - lo] = np.maximum(F - e, H - oe)
        Hp = np.maximum(D, Fn)
        # horizontal: best of Hp[k] - oe - e * (j - k - 1) over k < j
        ramp = Hp + e * np.arange(len(cols))
        pre = np.maximum.accumulate(ramp)
        E = np.full(len(cols), NEG)
        E[1:] = pre[:-1] - oe + e - e * np.arange(1, len(cols))
        Hn = np.maximum(Hp, E)
        # a horizontal gap past the previous row's band
        if c_hi <= nb and pre[-1] > NEG // 2:
            L = len(cols)
            first = pre[-1] - oe - e * (L - 1)
            more = min(nb + 1 - c_hi, max((first - (best - y_drop)) // e + 1,
                                          0))
            if more > 0:
                Hn = np.concatenate((Hn, first - e * np.arange(more)))
                Fn = np.concatenate((Fn, np.full(more, NEG)))
        m = int(Hn.max())
        if m > best:
            best = m
            bi, bj = i, lo + int(Hn.argmax())
        floor = best - y_drop
        Hn = np.where(Hn < floor, NEG, Hn)
        Fn = np.where(Fn < floor, NEG, Fn)
        alive = np.nonzero((Hn > NEG) | (Fn > NEG))[0]
        if not len(alive) or (stop_at is not None and best >= stop_at):
            break
        lo2, hi2 = int(alive[0]), int(alive[-1]) + 1
        H, F = Hn[lo2:hi2], Fn[lo2:hi2]
        lo = lo + lo2
    return best, bi, bj
