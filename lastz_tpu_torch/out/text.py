"""Human-readable text alignment format (reference text_align.c)."""

from __future__ import annotations

from ..core.encoding import NUC_TO_BITS

ROW_WIDTH = 50
DIGITS = 10

_PUR_PYR = "RYRY"


def text_align(seq1, seq2, a, one_based=True) -> str:
    """reference print_text_align_align: 50-column blocks with a
    match bar (| match, : transition, space other, - gap)."""
    rev1 = bool(seq1.rev_comp_flags & 2)
    rev2 = bool(seq2.rev_comp_flags & 2)
    beg1, beg2 = a.beg1, a.beg2
    height = a.end1 - beg1 + 1
    width = a.end2 - beg2 + 1
    bo = 0 if one_based else -1

    from ..core.scoring import score_str
    out = [f"score:{score_str(a.score)} length:({height} {width})\n"]

    offset1 = offset2 = 0
    seq1_len = len(seq1.v)
    seq2_len = len(seq2.v)
    if seq1.is_partitioned:
        part = seq1.lookup_partition(beg1)
        offset1 = part.sep_before + 1
        seq1_len = part.sep_after - offset1
    if seq2.is_partitioned:
        part = seq2.lookup_partition(beg2)
        offset2 = part.sep_before + 1
        seq2_len = part.sep_after - offset2

    loc1 = (seq1_len + 1 + bo - beg1) if rev1 else (beg1 + bo - offset1)
    loc2 = (seq2_len + 1 + bo - beg2) if rev2 else (beg2 + bo - offset2)

    # build full gapped rows then chunk
    row1 = []
    row2 = []
    i = j = 0
    for op, run in a.script.ops:
        if op == "S":
            row1.append(seq1.v[beg1 - 1 + i : beg1 - 1 + i + run]
                        .tobytes().decode("latin-1"))
            row2.append(seq2.v[beg2 - 1 + j : beg2 - 1 + j + run]
                        .tobytes().decode("latin-1"))
            i += run
            j += run
        elif op == "D":
            row1.append(seq1.v[beg1 - 1 + i : beg1 - 1 + i + run]
                        .tobytes().decode("latin-1"))
            row2.append("-" * run)
            i += run
        else:
            row1.append("-" * run)
            row2.append(seq2.v[beg2 - 1 + j : beg2 - 1 + j + run]
                        .tobytes().decode("latin-1"))
            j += run
    t1 = "".join(row1)
    t2 = "".join(row2)

    for k in range(0, len(t1), ROW_WIDTH):
        c1 = t1[k : k + ROW_WIDTH]
        c2 = t2[k : k + ROW_WIDTH]
        bar = []
        for ch1, ch2 in zip(c1, c2):
            if ch1 == "-" or ch2 == "-":
                bar.append("-")
                continue
            b1 = NUC_TO_BITS[ord(ch1)]
            b2 = NUC_TO_BITS[ord(ch2)]
            if b1 < 0 or b2 < 0:
                bar.append(" ")
            elif b1 == b2:
                bar.append("|")
            elif _PUR_PYR[b1] == _PUR_PYR[b2]:
                bar.append(":")
            else:
                bar.append(" ")
        out.append("\n")
        out.append(f"{loc1:>{DIGITS}} {c1}\n")
        out.append(f"{'':>{DIGITS}} {''.join(bar)}\n")
        out.append(f"{loc2:>{DIGITS}} {c2}\n")
        n1 = sum(1 for ch in c1 if ch != "-")
        n2 = sum(1 for ch in c2 if ch != "-")
        loc1 = loc1 - n1 if rev1 else loc1 + n1
        loc2 = loc2 - n2 if rev2 else loc2 + n2
    out.append("\n")
    return "".join(out)


def text_match(seq1, pos1, seq2, pos2, length, s, one_based=True) -> str:
    """reference print_text_align_match: single full-width block."""
    from ..core.scoring import score_str

    bo = 0 if one_based else -1
    offset1 = offset2 = 0
    start_loc1, start_loc2 = seq1.start_loc, seq2.start_loc
    if seq1.is_partitioned:
        part = seq1.lookup_partition(pos1)
        offset1 = part.sep_before + 1
        start_loc1 = part.start_loc
    if seq2.is_partitioned:
        part = seq2.lookup_partition(pos2)
        offset2 = part.sep_before + 1
        start_loc2 = part.start_loc
    c1 = seq1.v[pos1 : pos1 + length].tobytes().decode("latin-1")
    c2 = seq2.v[pos2 : pos2 + length].tobytes().decode("latin-1")
    bar = []
    for ch1, ch2 in zip(c1, c2):
        b1 = NUC_TO_BITS[ord(ch1)]
        b2 = NUC_TO_BITS[ord(ch2)]
        if b1 < 0 or b2 < 0:
            bar.append(" ")
        elif b1 == b2:
            bar.append("|")
        elif _PUR_PYR[b1] == _PUR_PYR[b2]:
            bar.append(":")
        else:
            bar.append(" ")
    out = [f"score:{score_str(s)} length:{length}\n"]
    out.append(f"{pos1 + bo - offset1 + start_loc1:>{DIGITS}}: {c1}\n")
    out.append(f"{'':>{DIGITS}}  {''.join(bar)}\n")
    out.append(f"{pos2 + bo - offset2 + start_loc2:>{DIGITS}}: {c2}\n")
    out.append("\n")
    return "".join(out)
