"""The LAV judge: the comparison that decides `correct` for every
configuration that names no `check` (see reference/anyornone.py for
one that does).

It reads what the window produced (each query's LAV text and the
anchors its seed stage handed to gapped extension) and judges it
against this package's own recomputation from the generated sequences
and the configuration. Each number has a limit of its own (the cell's
file under portbench/cells/); a run is correct when none is over.

- `lav_unreadable` (count, every query): LAV that does not parse, or
  an alignment whose blocks are out of the sequences, out of order or
  not gap-free.
- `rescore_wrong` (count, every query): alignments whose printed score
  or an l-line's identity differs from the blocks rescored from the
  sequences under the configuration's matrix and gap costs.
- `below_threshold` (count, every query): alignments that score below
  the output threshold, L, or H where the configuration interpolates
  with it (H is then the lower): a gapped stage that dropped its filter.
- `duplicates` (count, every query): alignments of a strand that pass
  through a cell (a pair of aligned positions) of another alignment of
  that strand, identical copies among them: an alignment written twice.
- `ends_extendable` (%, sampled queries): alignments that a y-drop
  extension from either end, stopped short of the strand's other
  alignments, carries to a higher score: the gapped stage stopped short.
- `anchors_missing` (%, sampled queries): the reference's HSPs with no
  anchor of the program on the same diagonal overlapping them.
- `anchors_unfounded` (%, sampled queries): the program's anchors with
  no reference HSP on the same diagonal overlapping them.
- `hsps_unaligned` (%, sampled queries): the reference's HSPs that no
  alignment passes near and whose two-sided y-drop extension scores at
  least L: an alignment that should be in the output and is not.
"""

from __future__ import annotations

import time

import numpy as np

from . import lav as lavmod
from .seeds import TargetIndex, hsps, padded
from .ydrop import extend

COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in (b"AT", b"TA", b"CG", b"GC"):
    COMPLEMENT[_a] = _b
    COMPLEMENT[_a + 32] = _b + 32

# an HSP within this many diagonals of an alignment's block, over the
# same query bases, counts as aligned
NEAR_DIAGONALS = 100

NUMBERS = ("lav_unreadable", "rescore_wrong", "below_threshold",
           "duplicates", "ends_extendable",
           "anchors_missing", "anchors_unfounded", "hsps_unaligned")


def revcomp(seq):
    return COMPLEMENT[seq[::-1]]


def block_arrays(align):
    return np.array(align["blocks"], dtype=np.int64).reshape(-1, 5)


def wellformed(align, t_len, q_len) -> bool:
    b = block_arrays(align)
    if (b[:, 0] < 1).any() or (b[:, 1] < 1).any() or (b[:, 2] > t_len).any() \
            or (b[:, 3] > q_len).any():
        return False
    if ((b[:, 2] - b[:, 0]) != (b[:, 3] - b[:, 1])).any() \
            or (b[:, 2] < b[:, 0]).any():
        return False
    if len(b) > 1 and ((b[1:, 0] <= b[:-1, 2]).any()
                       or (b[1:, 1] <= b[:-1, 3]).any()):
        return False
    return (tuple(b[0, :2]) == tuple(align["begin"])
            and tuple(b[-1, 2:4]) == tuple(align["end"]))


def rescore(align, t, q, scores):
    """(score, per-block identity) of an alignment from its blocks."""
    b = block_arrays(align)
    total = 0
    pct = []
    for b1, b2, e1, e2, _ in b:
        x, y = t[b1 - 1:e1], q[b2 - 1:e2]
        total += int(scores.gapped[x, y].sum())
        run = e1 - b1 + 1
        m = int(np.count_nonzero((x | 32) == (y | 32)))
        pct.append((200 * m + run) // (2 * run))
    if len(b) > 1:
        g1 = b[1:, 0] - b[:-1, 2] - 1
        g2 = b[1:, 1] - b[:-1, 3] - 1
        total -= int(scores.gap(g1).sum() + scores.gap(g2).sum())
    return total, pct


def output_threshold(cfg) -> int:
    """The least score an output alignment may have: L, or H where the
    configuration interpolates with it."""
    inner = cfg.get("inner_threshold")
    thr = cfg["gapped_threshold"]
    return min(thr, inner) if inner is not None else thr


def repeated(aligns) -> int:
    """The alignments of one strand that share a cell with an alignment
    before them in diagonal order: a block on the same diagonal as
    another alignment's block, over overlapping positions."""
    rows = [(b1 - b2, b2, e2, k) for k, al in enumerate(aligns)
            for b1, b2, e1, e2, _ in al["blocks"]]
    if len(rows) < 2:
        return 0
    a = np.array(rows, dtype=np.int64)
    a = a[np.lexsort((a[:, 1], a[:, 0]))]
    marked = set()
    diag = reach = owner = None
    for d, q0, q1, k in a.tolist():
        if d != diag:
            diag, reach, owner = d, q1, k
            continue
        if q0 <= reach and k != owner:
            marked.add(k)
        if q1 > reach:
            reach, owner = q1, k
    return len(marked)


def end_gain(align, others, t, q, scores, y_drop) -> bool:
    """Whether a y-drop extension past either end gains, within the room
    up to the strand's nearest other alignment on each sequence."""
    (b1, b2), (e1, e2) = align["begin"], align["end"]
    t_hi, q_hi = len(t), len(q)
    t_lo = q_lo = 0
    for o in others:
        (ob1, ob2), (oe1, oe2) = o["begin"], o["end"]
        if ob1 > e1:
            t_hi = min(t_hi, ob1 - 1)
        if ob2 > e2:
            q_hi = min(q_hi, ob2 - 1)
        if oe1 < b1:
            t_lo = max(t_lo, oe1)
        if oe2 < b2:
            q_lo = max(q_lo, oe2)
    o, e = scores.gap_open, scores.gap_extend
    fwd = extend(t[e1:t_hi], q[e2:q_hi], scores.gapped, o, e, y_drop,
                 stop_at=1)[0]
    if fwd > 0:
        return True
    back = extend(t[t_lo:b1 - 1][::-1], q[q_lo:b2 - 1][::-1], scores.gapped,
                  o, e, y_drop, stop_at=1)[0]
    return back > 0


def overlaps(a, b):
    """For each row of a, whether b has a row on the same diagonal whose
    query interval overlaps it (rows: t start, q start, length, ...)."""
    out = np.zeros(len(a), dtype=bool)
    if not len(a) or not len(b):
        return out
    bd = b[:, 0] - b[:, 1]
    order = np.argsort(bd, kind="stable")
    bd, bs = bd[order], b[order]
    ad = a[:, 0] - a[:, 1]
    lo = np.searchsorted(bd, ad, "left")
    hi = np.searchsorted(bd, ad, "right")
    for i in np.nonzero(hi > lo)[0]:
        c = bs[lo[i]:hi[i]]
        out[i] = bool(((c[:, 1] < a[i, 1] + a[i, 2])
                       & (a[i, 1] < c[:, 1] + c[:, 2])).any())
    return out


def near_alignment(h, blocks) -> bool:
    """Whether some block lies within NEAR_DIAGONALS of the HSP's
    diagonal over an overlapping stretch of the query."""
    if not len(blocks):
        return False
    d = (blocks[:, 0] - blocks[:, 1]) - (h[0] - h[1])
    q0, q1 = h[1] + 1, h[1] + h[2]
    return bool(((np.abs(d) <= NEAR_DIAGONALS) & (blocks[:, 1] <= q1)
                 & (q0 <= blocks[:, 3])).any())


def unaligned(h, t, q, scores, y_drop, l_thresh) -> bool:
    """Whether a two-sided y-drop extension from the HSP's middle
    reaches the gapped threshold L."""
    o, e = scores.gap_open, scores.gap_extend
    i, j = int(h[0] + h[2] // 2), int(h[1] + h[2] // 2)
    fwd = extend(t[i:], q[j:], scores.gapped, o, e, y_drop,
                 stop_at=l_thresh)[0]
    if fwd >= l_thresh:
        return True
    back = extend(t[:i][::-1], q[:j][::-1], scores.gapped, o, e, y_drop,
                  stop_at=l_thresh - fwd)[0]
    return fwd + back >= l_thresh


def pick_sample(queries, n, rng):
    """The longest query and n - 1 others drawn from the run's seed."""
    if not queries:
        return []
    longest = max(range(len(queries)), key=lambda i: len(queries[i]["seq"]))
    rest = [i for i in range(len(queries)) if i != longest]
    take = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + sorted(rest[k] for k in take)


def judge(queries, target, cfg, scores, sample_n, rng, device="cpu"):
    """The numbers of one run. `queries`: what the window completed,
    each with its forward bases `seq`, its LAV text `text` and its
    anchors by strand `anchors` ({0: array, 1: array}, rows of target
    start, query start, length, score)."""
    t0 = time.monotonic()
    bad_lav = 0
    wrong = 0
    low = 0
    dup = 0
    thr = output_threshold(cfg)
    n_aligns = 0
    parsed = []
    for qr in queries:
        try:
            strands = lavmod.parse(qr["text"])
        except (lavmod.LavError, ValueError, IndexError):
            bad_lav += 1
            parsed.append(None)
            continue
        seqs = {0: qr["seq"], 1: None}
        ok = True
        for st in strands:
            if st["rc"]:
                if seqs[1] is None:
                    seqs[1] = revcomp(qr["seq"])
            q = seqs[st["rc"]]
            for al in st["aligns"]:
                n_aligns += 1
                if not wellformed(al, len(target), len(q)):
                    ok = False
                    continue
                s, pct = rescore(al, target, q, scores)
                if s != al["score"] or pct != [b[4] for b in al["blocks"]]:
                    wrong += 1
                if al["score"] < thr:
                    low += 1
        if not ok:
            bad_lav += 1
        parsed.append(strands if ok else None)
        if ok:
            dup += sum(repeated([al for st in strands if st["rc"] == rc
                                 for al in st["aligns"]]) for rc in (0, 1))

    index = TargetIndex(target, cfg["seed_pattern"], device)
    t_pad = padded(target, device)
    ext = [0, 0]
    miss = [0, 0]
    unf = [0, 0]
    una = [0, 0]
    for i in pick_sample(queries, sample_n, rng):
        qr = queries[i]
        strands = parsed[i] or []
        for rc in (0, 1):
            q = qr["seq"] if rc == 0 else revcomp(qr["seq"])
            aligns = [al for st in strands if st["rc"] == rc
                      for al in st["aligns"]]
            for k, al in enumerate(aligns):
                ext[1] += 1
                if end_gain(al, aligns[:k] + aligns[k + 1:], target, q,
                            scores, cfg["y_drop"]):
                    ext[0] += 1
            ref = hsps(index, target, q, scores.masked, cfg["transitions"],
                       cfg["x_drop"], cfg["hsp_threshold"],
                       cfg.get("entropy", True), t_pad=t_pad)
            got = np.asarray(qr["anchors"].get(rc, np.zeros((0, 4))),
                             dtype=np.int64).reshape(-1, 4)
            miss[0] += int((~overlaps(ref, got)).sum())
            miss[1] += len(ref)
            unf[0] += int((~overlaps(got, ref)).sum())
            unf[1] += len(got)
            blocks = (np.concatenate([block_arrays(al) for al in aligns])
                      if aligns else np.zeros((0, 5), np.int64))
            for h in ref:
                una[1] += 1
                if not near_alignment(h, blocks) and unaligned(
                        h, target, q, scores, cfg["y_drop"],
                        cfg["gapped_threshold"]):
                    una[0] += 1

    def share(p):
        return 100.0 * p[0] / p[1] if p[1] else 0.0

    numbers = {
        "lav_unreadable": bad_lav,
        "rescore_wrong": wrong,
        "below_threshold": low,
        "duplicates": dup,
        "ends_extendable": share(ext),
        "anchors_missing": share(miss),
        "anchors_unfounded": share(unf),
        "hsps_unaligned": share(una),
    }
    facts = {"alignments": n_aligns, "sampled_alignments": ext[1],
             "reference_hsps": miss[1], "program_anchors": unf[1],
             "check_s": time.monotonic() - t0}
    return numbers, facts
