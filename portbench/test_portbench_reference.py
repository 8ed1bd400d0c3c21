"""The reference's parts against plain loops written from LASTZ's
definitions."""

import numpy as np
import pytest
import torch

from portbench.reference import lav
from portbench.reference.check import (output_threshold, repeated, rescore,
                                       wellformed)
from portbench.reference.scoring import Scores
from portbench.reference.seeds import (TargetIndex, padded, seed_hits,
                                       xdrop_scan)
from portbench.reference.ydrop import extend

HOXD55 = np.array([[91, -90, -25, -100], [-90, 100, -100, -25],
                   [-25, -100, 100, -90], [-100, -25, -90, 91]])
SC = Scores(HOXD55, 400, 30)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def gotoh_best(a, b, sub, o, e):
    """The best score of any alignment of a prefix of a with a prefix of
    b, by the full affine-gap table."""
    neg = -10**15
    H = np.full((len(a) + 1, len(b) + 1), neg)
    E = H.copy()
    F = H.copy()
    H[0, 0] = 0
    for i in range(len(a) + 1):
        for j in range(len(b) + 1):
            if i == j == 0:
                continue
            if j:
                E[i, j] = max(E[i, j - 1] - e, H[i, j - 1] - o - e)
            if i:
                F[i, j] = max(F[i - 1, j] - e, H[i - 1, j] - o - e)
            d = H[i - 1, j - 1] + sub[a[i - 1], b[j - 1]] if i and j else neg
            H[i, j] = max(d, E[i, j], F[i, j])
    return H.max()


@pytest.mark.parametrize("seed", range(40))
def test_ydrop_without_drop_is_gotoh(seed):
    rng = np.random.default_rng(seed)
    a = ACGT[rng.integers(0, 4, rng.integers(5, 40))]
    b = a.copy()
    m = rng.random(len(b)) < 0.2
    b[m] = ACGT[rng.integers(0, 4, m.sum())]
    k = rng.integers(0, len(b))
    b = np.concatenate([b[:k], ACGT[rng.integers(0, 4, 3)], b[k + 2:]])
    assert extend(a, b, SC.gapped, 400, 30, 10**9)[0] == gotoh_best(
        a, b, SC.gapped, 400, 30)


def test_ydrop_stops():
    rng = np.random.default_rng(1)
    a = ACGT[rng.integers(0, 4, 3000)]
    b = np.concatenate([a[:100], ACGT[rng.integers(0, 4, 2900)]])
    best, i, j = extend(a, b, SC.gapped, 400, 30, 3400)
    # the copied 100 bases and whatever the random tail adds by chance
    assert best >= SC.gapped[a[:100], a[:100]].sum()
    assert 100 <= i < 130 and 100 <= j < 130
    assert best == extend(a[:i], b[:j], SC.gapped, 400, 30, 10**9)[0]


def test_xdrop_scan_plain_loop():
    rng = np.random.default_rng(2)
    s1 = ACGT[rng.integers(0, 4, 5000)]
    s2 = s1.copy()
    m = rng.random(5000) < 0.25
    s2[m] = ACGT[rng.integers(0, 4, m.sum())]
    i0 = rng.integers(100, 4900, 50)
    limit = rng.integers(0, 100, 50)
    got = [g.numpy() for g in xdrop_scan(
        padded(s1), padded(s2), torch.from_numpy(SC.masked.reshape(-1)),
        torch.from_numpy(i0), torch.from_numpy(i0), 1,
        torch.from_numpy(limit), 910)]
    for h in range(50):
        c = m_ = 0
        best, kb, consumed = 0, -1, limit[h]
        for k in range(limit[h]):
            c += SC.masked[s1[i0[h] + k], s2[i0[h] + k]]
            m_ = max(m_, c)
            if c < max(m_, 0) - 910:
                consumed = k
                break
            if c > best:
                best, kb = c, k
        assert (got[0][h], got[1][h], got[2][h]) == (consumed, best, kb)


def test_seed_hits_brute_force():
    rng = np.random.default_rng(3)
    pattern = "1110100110010101111"
    t = ACGT[rng.integers(0, 4, 3000)]
    t[rng.random(3000) < 0.02] += 32  # a few lowercase bases
    q = t[500:1500].copy()
    flip = rng.random(len(q)) < 0.05
    q[flip] = ACGT[(np.searchsorted(ACGT, q[flip] & ~np.uint8(32)) ^ 2)]
    cares = [i for i, c in enumerate(pattern) if c == "1"]
    L = len(pattern)

    def ok(s, e):
        return all(s[k] in b"ACGT" for k in range(e - L, e))

    want = set()
    for te in range(L, len(t) + 1):
        if not ok(t, te):
            continue
        for qe in range(L, len(q) + 1):
            if not ok(q, qe):
                continue
            d = [(t[te - L + c], q[qe - L + c]) for c in cares
                 if t[te - L + c] != q[qe - L + c]]
            if not d or (len(d) == 1 and {d[0][0], d[0][1]} in
                         ({65, 71}, {67, 84})):
                want.add((te, qe))
    got = set(zip(*(h.tolist() for h in
                    seed_hits(TargetIndex(t, pattern), q, True))))
    assert got == want


def test_lav_round_trip_and_rescore():
    rng = np.random.default_rng(4)
    t = ACGT[rng.integers(0, 4, 400)]
    q = np.concatenate([t[10:110], t[115:200]])
    # blocks: t 11..110 ~ q 1..100, then t 116..200 ~ q 101..185
    al = {"score": 0, "begin": (11, 1), "end": (200, 185),
          "blocks": [(11, 1, 110, 100, 100), (116, 101, 200, 185, 100)]}
    al["score"] = (SC.gapped[t[10:110], t[10:110]].sum()
                   + SC.gapped[t[115:200], t[115:200]].sum() - (400 + 5 * 30))
    st = [{"rc": 0, "t_len": 400, "q_len": len(q), "aligns": [al]}]
    back = lav.parse(lav.write(st))
    got = back[0]["aligns"][0]
    assert wellformed(got, 400, len(q))
    assert rescore(got, t, q, SC) == (al["score"], [100, 100])
    with pytest.raises(lav.LavError):
        lav.parse("a {\n  s 1\n}\n")


def _al(*blocks):
    return {"blocks": [(b1, b2, e1, e2, 100) for b1, b2, e1, e2 in blocks]}


@pytest.mark.parametrize("aligns, want", [
    ([], 0),
    ([_al((1, 1, 50, 50))], 0),
    # the same alignment twice
    ([_al((1, 1, 50, 50), (60, 55, 90, 85))] * 2, 1),
    # another diagonal, or the same diagonal apart: no shared cell
    ([_al((1, 1, 50, 50)), _al((1, 2, 50, 51))], 0),
    ([_al((1, 1, 50, 50)), _al((51, 51, 80, 80))], 0),
    # one cell in common, at the first's end
    ([_al((1, 1, 50, 50)), _al((50, 50, 80, 80))], 1),
    # a later block of the second inside the first's block
    ([_al((1, 1, 100, 100)), _al((1, 20, 10, 29), (40, 40, 45, 45))], 1),
    # three alignments over one stretch: two repeat the first
    ([_al((1, 1, 100, 100)), _al((10, 10, 20, 20)), _al((30, 30, 40, 40))],
     2),
])
def test_repeated_counts_alignments_that_share_a_cell(aligns, want):
    assert repeated(aligns) == want


def test_output_threshold_is_l_or_the_lower_h():
    assert output_threshold({"gapped_threshold": 6000}) == 6000
    assert output_threshold({"gapped_threshold": 6000,
                             "inner_threshold": 2000}) == 2000
    assert output_threshold({"gapped_threshold": 4500,
                             "inner_threshold": None}) == 4500
