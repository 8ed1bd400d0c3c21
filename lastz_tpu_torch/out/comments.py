"""Per-record comment lines shared by the maf+/axt+ writers
(reference maf.c:170-219, axt.c:140-156, 437-470)."""

from __future__ import annotations

from ..filters.identity import (
    alignment_identity_counts, segment_identity_counts)
from ..filters.coverage import alignment_coverage, segment_coverage


class _Seg:
    __slots__ = ("pos1", "pos2", "length")

    def __init__(self, pos1, pos2, length):
        self.pos1 = pos1
        self.pos2 = pos2
        self.length = length


def _frac(tag, numer, denom) -> str:
    line = f"# {tag}={numer}/{denom}"
    if denom != 0:
        line += f" ({100.0 * numer / denom:.1f}%)"
    return line + "\n"


def cigar_comment(a) -> str:
    """Alignment path as the reference's comment cigar: Nm for
    substitution runs, Nd/Ni for indels, d before i (maf.c:193-219)."""
    out = ["# cigar="]
    ops = a.script.ops
    ix = 0
    while ix < len(ops):
        run = 0
        while ix < len(ops) and ops[ix][0] == "S":
            run += ops[ix][1]
            ix += 1
        if run > 0:
            out.append(f"{run}m")
        d = i = 0
        while ix < len(ops) and ops[ix][0] != "S":
            if ops[ix][0] == "D":
                d += ops[ix][1]
            else:
                i += ops[ix][1]
            ix += 1
        if d > 0:
            out.append(f"{d}d")
        if i > 0:
            out.append(f"{i}i")
    out.append("\n")
    return "".join(out)


def align_comments(seq1, seq2, a, with_continuity: bool,
                   with_cigar: bool) -> str:
    """identity/coverage[/continuity][/cigar] comment lines for a
    gapped alignment (maf.c:170-219 with continuity+cigar; axt.c:143-155
    without)."""
    out = []
    numer, denom = alignment_identity_counts(seq1.v, seq2.v, a)
    out.append(_frac("identity", numer, denom))
    numer, denom = alignment_coverage(seq1, seq2, a)
    out.append(_frac("coverage", numer, denom))
    if with_continuity:
        from ..filters.continuity import alignment_continuity
        numer, denom = alignment_continuity(a)
        out.append(_frac("continuity", numer, denom))
    if with_cigar:
        out.append(cigar_comment(a))
    return "".join(out)


def match_comments(seq1, pos1, seq2, pos2, length,
                   with_cigar: bool = True) -> str:
    """identity/coverage[/cigar] comment lines for an ungapped match
    (maf.c:534-554 with cigar; axt.c:443-460 without)."""
    out = []
    numer, denom = segment_identity_counts(seq1.v, pos1, seq2.v, pos2, length)
    out.append(_frac("identity", numer, denom))
    numer, denom = segment_coverage(seq1, seq2, _Seg(pos1, pos2, length))
    out.append(_frac("coverage", numer, denom))
    if with_cigar:
        out.append(f"# cigar={length}m\n")
    return "".join(out)
