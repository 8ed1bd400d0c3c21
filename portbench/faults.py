"""The control and the planted faults the check has to fail, keyed by
the judge that has to fail them (`FAULTS[check][name]`).

Each rewrites what a window produced as a broken program would have
produced it. For the LAV judge (reference/check.py), a query's LAV text
and the anchors its seed stage handed on:

- `control_int16`: the gapped stage computed in int16, the step below
  the int32 scores the configuration states, as GPU aligners that pack
  16-bit cells do. A saturating int16 score stops growing at 32,767,
  so the extension ends at the first cell of its path that reaches it,
  and 32,767 is printed. The reference's own rescoring of the path,
  put in the program's place, gives that cell.
- `control_plus_strand`: the search of one strand, where the
  configuration states both (LASTZ's default): the minus strand's
  anchors and alignments are left out. It halves the work, the step a
  cell without gapped alignments would tempt.
- `unchanged`: the gapped stage returns its state unchanged: every
  anchor is written as a gap-free alignment of its HSP.
- `half_dropped`: half of the batch left out: every other alignment of
  a strand, and every other anchor.
- `altered`: one answer altered where it is produced: the first
  alignment of each query scores one more, and every other anchor is
  moved one diagonal over.
- `duplicated`: an alignment written twice: each strand's first
  alignment is printed again after it.
- `unfiltered`: the gapped stage's output filter dropped: each strand
  with an anchor also prints a gap-free extension below the output
  threshold: the best-scoring start, of at most 19 bases (under 1,900
  with both matrices' top score of 100, below every threshold here),
  of an anchor that no alignment covers (of its first anchor where
  all are covered).

For the any-or-none SAM judge (reference/anyornone.py), a read's SAM
lines:

- `control_plus_strand`: the search of one strand, where the
  configuration states both: every reverse-strand line (flag 16) left
  out.
- `half_dropped`: half of the batch left out: the lines of every other
  answered read.
- `altered`: an answer altered where it is produced: each line's
  position moved one base on.
- `duplicated`: each alignment line written twice.
- `unfiltered`: the filters dropped: each line's alignment cut to a
  gap-free piece of its first PIECE aligned bases, under every
  coverage filter of 20% or more and every gapped threshold above
  PIECE times the top score (19 with `--match=1,<n>`).
"""

from __future__ import annotations

import re

import numpy as np

from .reference import lav as lavmod
from .reference.check import overlaps, revcomp

INT16_MAX = 32767


def _strands(rec):
    return lavmod.parse(rec.text)


def _truncate(al, t, q, scores):
    """The alignment as an int16 gapped stage ends it."""
    run = 0
    blocks = []
    prev = None
    for b1, b2, e1, e2, pct in al["blocks"]:
        if prev is not None:
            g1, g2 = b1 - prev[0] - 1, b2 - prev[1] - 1
            run -= int(scores.gap(g1) + scores.gap(g2))
        sc = scores.gapped[t[b1 - 1:e1], q[b2 - 1:e2]]
        c = run + np.cumsum(sc)
        hit = np.nonzero(c >= INT16_MAX)[0]
        if len(hit):
            k = int(hit[0])
            x, y = t[b1 - 1:b1 + k], q[b2 - 1:b2 + k]
            m = int(np.count_nonzero((x | 32) == (y | 32)))
            blocks.append((b1, b2, b1 + k, b2 + k,
                           (200 * m + k + 1) // (2 * (k + 1))))
            return {"score": INT16_MAX, "begin": al["begin"],
                    "end": (b1 + k, b2 + k), "blocks": blocks}
        run = int(c[-1]) if len(c) else run
        blocks.append((b1, b2, e1, e2, pct))
        prev = (e1, e2)
    return al


def control_int16(records, target, scores):
    for rec in records:
        strands = _strands(rec)
        for st in strands:
            q = rec.seq if st["rc"] == 0 else revcomp(rec.seq)
            st["aligns"] = [_truncate(al, target, q, scores)
                            for al in st["aligns"]]
        rec.text = lavmod.write(strands)


def control_plus_strand(records, target, scores):
    for rec in records:
        strands = [st for st in _strands(rec) if st["rc"] == 0]
        rec.text = lavmod.write(strands)
        rec.anchors = {rc: a for rc, a in rec.anchors.items() if rc == 0}


def unchanged(records, target, scores):
    for rec in records:
        strands = []
        for rc, a in sorted(rec.anchors.items()):
            q = rec.seq if rc == 0 else revcomp(rec.seq)
            aligns = []
            for p1, p2, n, s in a:
                x, y = target[p1:p1 + n], q[p2:p2 + n]
                m = int(np.count_nonzero((x | 32) == (y | 32)))
                aligns.append({"score": int(s), "begin": (p1 + 1, p2 + 1),
                               "end": (p1 + n, p2 + n),
                               "blocks": [(p1 + 1, p2 + 1, p1 + n, p2 + n,
                                           (200 * m + n) // (2 * n))]})
            strands.append({"rc": rc, "t_len": len(target), "q_len": len(q),
                            "aligns": aligns})
        rec.text = lavmod.write(strands)


def half_dropped(records, target, scores):
    for rec in records:
        strands = _strands(rec)
        for st in strands:
            st["aligns"] = st["aligns"][::2]
        rec.text = lavmod.write(strands)
        rec.anchors = {rc: a[::2] for rc, a in rec.anchors.items()}


def altered(records, target, scores):
    for rec in records:
        strands = _strands(rec)
        for st in strands:
            if st["aligns"]:
                st["aligns"][0]["score"] += 1
                break
        rec.text = lavmod.write(strands)
        moved = {}
        for rc, a in rec.anchors.items():
            a = a.copy()
            a[1::2, 0] += 1
            moved[rc] = a
        rec.anchors = moved


def duplicated(records, target, scores):
    for rec in records:
        strands = _strands(rec)
        for st in strands:
            if st["aligns"]:
                st["aligns"].insert(1, dict(st["aligns"][0]))
        rec.text = lavmod.write(strands)


PIECE = 19


def _piece(p1, p2, n, t, q, scores):
    """The gap-free alignment of an anchor's best-scoring start of at
    most PIECE bases, scored as the reference scores it."""
    x, y = t[p1:p1 + n], q[p2:p2 + n]
    c = np.cumsum(scores.gapped[x, y])
    k = int(np.argmax(c[:PIECE])) + 1
    m = int(np.count_nonzero((x[:k] | 32) == (y[:k] | 32)))
    return {"score": int(c[k - 1]), "begin": (p1 + 1, p2 + 1),
            "end": (p1 + k, p2 + k),
            "blocks": [(p1 + 1, p2 + 1, p1 + k, p2 + k,
                        (200 * m + k) // (2 * k))]}


def unfiltered(records, target, scores):
    for rec in records:
        strands = {st["rc"]: st for st in _strands(rec)}
        for rc, a in sorted(rec.anchors.items()):
            if not len(a):
                continue
            q = rec.seq if rc == 0 else revcomp(rec.seq)
            st = strands.setdefault(rc, {"rc": rc, "t_len": len(target),
                                         "q_len": len(q), "aligns": []})
            blocks = [b for al in st["aligns"] for b in al["blocks"]]
            # blocks as rows of target start, query start, length
            rows = np.array([(b1 - 1, b2 - 1, e1 - b1 + 1)
                             for b1, b2, e1, e2, _ in blocks],
                            dtype=np.int64).reshape(-1, 3)
            free = np.nonzero(~overlaps(np.asarray(a, np.int64), rows))[0]
            p1, p2, n, _ = (int(v) for v in a[free[0] if len(free) else 0])
            st["aligns"].append(_piece(p1, p2, n, target, q, scores))
        rec.text = lavmod.write([strands[rc] for rc in sorted(strands)])


def _sam_lines(records, edit):
    """Each record's SAM text with `edit(fields)` applied to every
    alignment line; it returns the lines to write in its place."""
    for rec in records:
        out = []
        for line in rec.text.splitlines(keepends=True):
            if not line.strip() or line.startswith("@"):
                out.append(line)
                continue
            out += ["\t".join(f) + "\n"
                    for f in edit(line.rstrip("\n").split("\t"))]
        rec.text = "".join(out)


def sam_control_plus_strand(records, target, scores):
    _sam_lines(records, lambda f: [] if int(f[1]) & 16 else [f])


def sam_half_dropped(records, target, scores):
    answered = [r for r in records
                if any(ln and not ln.startswith("@")
                       for ln in r.text.splitlines())]
    _sam_lines(answered[::2], lambda f: [])


def sam_altered(records, target, scores):
    def edit(f):
        f[3] = str(int(f[3]) + 1)
        return [f]
    _sam_lines(records, edit)


def sam_duplicated(records, target, scores):
    _sam_lines(records, lambda f: [f, list(f)])


def sam_unfiltered(records, target, scores):
    def edit(f):
        ops = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDS])", f[5])]
        lead = ops[0][0] if ops[0][1] == "S" else 0
        first = next(n for n, op in ops if op == "M")
        k = min(PIECE, first)
        rest = len(f[9]) - lead - k
        f[5] = (f"{lead}S" if lead else "") + f"{k}M" + (
            f"{rest}S" if rest else "")
        return [f]
    _sam_lines(records, edit)


FAULTS = {
    "check": {"control_int16": control_int16,
              "control_plus_strand": control_plus_strand,
              "unchanged": unchanged, "half_dropped": half_dropped,
              "altered": altered, "duplicated": duplicated,
              "unfiltered": unfiltered},
    "anyornone": {"control_plus_strand": sam_control_plus_strand,
                  "half_dropped": sam_half_dropped, "altered": sam_altered,
                  "duplicated": sam_duplicated,
                  "unfiltered": sam_unfiltered},
}
