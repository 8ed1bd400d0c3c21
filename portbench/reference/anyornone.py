"""The judge of any-or-none short-read mapping (SAM output).

LASTZ's Any-or-None recipe (`--anyornone --step=<s> --seed=match<k>
--notransition --exact=<n> --noytrim`, with `--filter=identity:<p>`
and `--filter=coverage:<p>`, and `--format=softsam`) reports, for each
read, the first alignment it meets that passes the filters, and nothing
for a read that has none. So any qualifying alignment answers a read,
and the judge never asks for a particular one. It reads each record's
SAM text and recomputes from the generated sequences and the
configuration's `reference` group (`seed_pattern`, `step`,
`transitions`, `exact`, `gap_open`, `gap_extend`, `y_drop`,
`gapped_threshold`, `min_identity`, `min_coverage`):

- `sam_unreadable` (count, every read): alignment lines that do not
  parse; whose CIGAR's M, I and S lengths do not sum to the read's
  length; whose aligned block lies outside the target; whose SEQ is
  neither the read nor, under flag 16, its reverse complement; or
  that name another read.
- `multiple` (count, every read): reads with more than one alignment
  line.
- `below_filter` (count, every read): readable lines whose alignment,
  rescored from the sequences, scores below the gapped threshold, or
  has an identity below `min_identity` or a coverage below
  `min_coverage`, as LASTZ's filters define them: identity, the
  matched share of the substitution columns whose two bases are both
  A, C, G or T; coverage, the aligned span of the shorter sequence
  over its length.
- `missed` (%, sampled reads): sampled reads with no alignment line for
  which this reference finds a qualifying alignment on either strand.
  Its search: contiguous seed words of uppercase bases, the target's at
  its step lattice (word ends at multiples of `step`), each hit
  extended over exactly matching bases (either case) to an HSP of at
  least `exact` bases, a two-sided untrimmed y-drop from the HSP's
  peak, then the filters.

The y-drop here prunes a cell against the best score of the rows
before and of its own row once the row is done (LASTZ prunes against
the best so far within the row too); untrimmed, an extension that
reaches the end of the read, or of the target, alive ends there, at the
best such cell, as `--noytrim` does. Any indel at either end of the
alignment is lopped off.
"""

from __future__ import annotations

import re
import time

import numpy as np

from ..genome import CODE
from .check import revcomp
from .seeds import words

NUMBERS = ("sam_unreadable", "multiple", "below_filter", "missed")

CIGAR = re.compile(r"(\d+)([MIDS])")
NEG = -(1 << 40)
# LASTZ's anchor: the middle of the HSP's best window of this length
ANCHOR_PEAK_LEN = 31


class StepIndex:
    """The target's seed words whose windows end at a multiple of
    `step`, sorted once."""

    def __init__(self, target: np.ndarray, pattern: str, step: int):
        ends, w = words(target, pattern)
        keep = ends % step == 0
        order = np.argsort(w[keep], kind="stable")
        self.words = w[keep][order]
        self.ends = ends[keep][order]
        self.pattern = pattern


def parse_line(line: str, name: str, read: np.ndarray, t_len: int):
    """(strand, target start, read start, ops) of a SAM alignment line,
    origin 0, the read's start on its strand after the leading soft
    clip, the ops (letter, length) of M, I and D between the clips;
    None where the line is unreadable for the judge."""
    f = line.rstrip("\n").split("\t")
    if len(f) < 11 or f[0] != name:
        return None
    try:
        flag, pos = int(f[1]), int(f[3])
    except ValueError:
        return None
    if flag not in (0, 16) or pos < 1:
        return None
    ops = [(op, int(n)) for n, op in CIGAR.findall(f[5])]
    if "".join(f"{n}{op}" for op, n in ops) != f[5] \
            or any(n <= 0 for _, n in ops):
        return None
    clip = ops.pop(0)[1] if ops and ops[0][0] == "S" else 0
    back = ops.pop()[1] if ops and ops[-1][0] == "S" else 0
    if not ops or ops[0][0] != "M" or ops[-1][0] != "M" \
            or any(op == "S" for op, _ in ops):
        return None
    if clip + sum(n for op, n in ops if op in "MI") + back != len(read):
        return None
    if pos - 1 + sum(n for op, n in ops if op in "MD") > t_len:
        return None
    strand = 1 if flag == 16 else 0
    q = read if strand == 0 else revcomp(read)
    seq = np.frombuffer(f[9].encode("latin-1", "replace"), np.uint8)
    if len(seq) != len(q) or not np.array_equal(q | 32, seq | 32):
        return None
    return strand, pos - 1, clip, ops


def rescore(t, q, t0, q0, ops, scores):
    """(score, identity, query span, target span) of an alignment that
    starts at (t0, q0), origin 0, with ops of M, I and D."""
    i, j = t0, q0
    score = matches = denom = 0
    for op, n in ops:
        if op == "M":
            x, y = t[i:i + n], q[j:j + n]
            score += int(scores.gapped[x, y].sum())
            cx, cy = CODE[x], CODE[y]
            both = (cx < 4) & (cy < 4)
            denom += int(both.sum())
            matches += int((both & (cx == cy)).sum())
            i += n
            j += n
        else:
            score -= scores.gap_open + scores.gap_extend * n
            if op == "I":
                j += n
            else:
                i += n
    return score, (matches / denom if denom else 0.0), j - q0, i - t0


def qualifies(t, q, t0, q0, ops, scores, cfg) -> bool:
    score, ident, q_span, t_span = rescore(t, q, t0, q0, ops, scores)
    cov = (q_span / len(q)) if len(q) <= len(t) else (t_span / len(t))
    return (score >= cfg["gapped_threshold"]
            and ident >= cfg.get("min_identity", 0.0)
            and cov >= cfg.get("min_coverage", 0.0))


def one_sided(a, b, sub, gap_open, gap_extend, y_drop):
    """An untrimmed y-drop extension over a (rows, the target from the
    anchor to its end) and b (columns, the read from the anchor to its
    end) from a cell where the alignment stands before a[0] and b[0].
    Returns (rows, columns, ops from the far end back to the start).

    As LASTZ scans the cells row by row, the end moves to each cell
    that reaches the best score so far, or, alive at the end of the
    read or of the target, the best score so far of such cells; the
    last of these moves is where the extension ends."""
    n = len(b)
    oe, e = gap_open + gap_extend, gap_extend
    cols = np.arange(n + 1)
    H = np.where(cols == 0, 0, -oe - e * (cols - 1)).astype(np.int64)
    H = np.where(H < -y_drop, NEG, H)
    E = np.where(cols == 0, NEG, H)
    F = np.full(n + 1, NEG, np.int64)
    Hs, Es, Fs = [H], [E], [F]
    best = 0
    end = (0, 0)
    edge_score = NEG
    if H[n] > NEG:
        end, edge_score = (0, n), int(H[n])
    rows = min(len(a), n + (n + y_drop) // max(e, 1) + 2)
    for i in range(1, rows + 1):
        D = np.full(n + 1, NEG, np.int64)
        D[1:] = np.where(H[:-1] > NEG, H[:-1] + sub[a[i - 1], b], NEG)
        F = np.maximum(np.where(F > NEG, F - e, NEG),
                       np.where(H > NEG, H - oe, NEG))
        Hp = np.maximum(D, F)
        ramp = np.maximum.accumulate(np.where(Hp > NEG, Hp + e * cols, NEG))
        E = np.full(n + 1, NEG, np.int64)
        E[1:] = np.where(ramp[:-1] > NEG,
                         ramp[:-1] - oe - e * (cols[1:] - 1), NEG)
        H = np.maximum(Hp, E)
        top = int(H.max())
        if top >= best:
            best = top
            end = (i, int(np.nonzero(H == top)[0][-1]))
        floor = best - y_drop
        H = np.where(H < floor, NEG, H)
        E = np.where(H > NEG, E, NEG)
        F = np.where(F < floor, NEG, F)
        Hs.append(H)
        Es.append(E)
        Fs.append(F)
        live = np.nonzero(H > NEG)[0]
        edge = live if i == len(a) else live[live == n]
        if len(edge):
            k = int(edge[len(edge) - 1 - int(np.argmax(H[edge][::-1]))])
            if H[k] >= edge_score:
                edge_score = int(H[k])
                end = (i, k)
        if not len(live):
            break
    i, j = end
    return i, j, trace(Hs, Es, Fs, a, b, sub, gap_extend, i, j)


def trace(Hs, Es, Fs, a, b, sub, e, i, j):
    """The ops of the path to (i, j), from (i, j) back to (0, 0)."""
    ops = []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            h = Hs[i][j]
            if i and j and Hs[i - 1][j - 1] > NEG \
                    and h == Hs[i - 1][j - 1] + sub[a[i - 1], b[j - 1]]:
                ops.append("M")
                i, j = i - 1, j - 1
            elif i and h == Fs[i][j]:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            ops.append("D")
            f = Fs[i][j]
            state = "F" if i > 1 and Fs[i - 1][j] > NEG \
                and f == Fs[i - 1][j] - e else "H"
            i -= 1
        else:
            ops.append("I")
            x = Es[i][j]
            state = "E" if j > 1 and Es[i][j - 1] > NEG \
                and x == Es[i][j - 1] - e else "H"
            j -= 1
    return ops


def runs(letters):
    """Run-length ops of a list of letters."""
    out = []
    for c in letters:
        if out and out[-1][0] == c:
            out[-1][1] += 1
        else:
            out.append([c, 1])
    return [(c, n) for c, n in out]


def gapped(t, q, a1, a2, scores, cfg):
    """The untrimmed two-sided y-drop alignment through the anchor
    (a1, a2): (target start, read start, ops), indels at either end
    lopped off; None where nothing is left."""
    o, e, y = scores.gap_open, scores.gap_extend, cfg["y_drop"]
    li, lj, left = one_sided(t[:a1 + 1][::-1], q[:a2 + 1][::-1],
                             scores.gapped, o, e, y)
    _, _, right = one_sided(t[a1 + 1:], q[a2 + 1:], scores.gapped, o, e, y)
    letters = left + right[::-1]
    t0, q0 = a1 + 1 - li, a2 + 1 - lj
    while letters and letters[0] != "M":
        if letters.pop(0) == "I":
            q0 += 1
        else:
            t0 += 1
    while letters and letters[-1] != "M":
        letters.pop()
    if not letters:
        return None
    return t0, q0, runs(letters)


def hsps(index: StepIndex, t, q, exact: int):
    """The exact-match HSPs of seed hits of the read strand q: (target
    start, read start, length), each once."""
    q_ends, q_words = words(q, index.pattern)
    lo = np.searchsorted(index.words, q_words, "left")
    hi = np.searchsorted(index.words, q_words, "right")
    L = len(index.pattern)
    ct, cq = CODE[t], CODE[q]
    found = set()
    out = []
    for k in np.nonzero(hi > lo)[0]:
        qe = int(q_ends[k])
        for te in index.ends[lo[k]:hi[k]].tolist():
            d = te - qe
            # the read's columns on this diagonal, matched or not
            j0, j1 = max(0, -d), min(len(q), len(t) - d)
            same = (cq[j0:j1] == ct[j0 + d:j1 + d]) & (cq[j0:j1] < 4)
            miss = np.nonzero(~same)[0] + j0
            s = qe - L
            left = int(miss[miss < s].max()) + 1 if (miss < s).any() else j0
            right = int(miss[miss >= qe].min()) if (miss >= qe).any() \
                else j1
            if right - left >= exact and (d, left) not in found:
                found.add((d, left))
                out.append((left + d, left, right - left))
    return out


def answerable(index, t, read, scores, cfg) -> bool:
    """Whether the reference finds a qualifying alignment of the read on
    either strand."""
    for q in (read, revcomp(read)):
        for t0, q0, n in hsps(index, t, q, cfg["exact"]):
            peak = ANCHOR_PEAK_LEN // 2 if n > ANCHOR_PEAK_LEN else n // 2
            got = gapped(t, q, t0 + peak, q0 + peak, scores, cfg)
            if got is not None and qualifies(t, q, *got, scores, cfg):
                return True
    return False


def judge(queries, target, cfg, scores, sample_n, rng, device="cpu"):
    """The numbers of one run. `queries`: what the window completed,
    each with its name `name`, its forward bases `seq` and its SAM text
    `text`. The reference runs on the host; `device` is unused."""
    t0 = time.monotonic()
    bad = multiple = low = lines = 0
    answered = []
    for qr in queries:
        mine = [ln for ln in qr["text"].splitlines()
                if ln and not ln.startswith("@")]
        lines += len(mine)
        answered.append(bool(mine))
        if len(mine) > 1:
            multiple += 1
        for ln in mine:
            got = parse_line(ln, qr["name"], qr["seq"], len(target))
            if got is None:
                bad += 1
                continue
            strand, pos, clip, ops = got
            q = qr["seq"] if strand == 0 else revcomp(qr["seq"])
            if not qualifies(target, q, pos, clip, ops, scores, cfg):
                low += 1
    index = StepIndex(target, cfg["seed_pattern"], cfg.get("step", 1))
    take = rng.permutation(len(queries))[:sample_n]
    missed = found = 0
    for i in sorted(take.tolist()):
        ok = answerable(index, target, queries[i]["seq"], scores, cfg)
        found += ok
        if ok and not answered[i]:
            missed += 1
    numbers = {
        "sam_unreadable": bad,
        "multiple": multiple,
        "below_filter": low,
        "missed": 100.0 * missed / len(take) if len(take) else 0.0,
    }
    facts = {"reads": len(queries), "lines": lines,
             "answered": int(sum(answered)), "sampled": len(take),
             "sampled_answered": int(sum(answered[i] for i in take)),
             "sampled_answerable": found,
             "check_s": time.monotonic() - t0}
    return numbers, facts
