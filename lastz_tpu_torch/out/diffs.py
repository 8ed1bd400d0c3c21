"""Alignment differences format (reference align_diffs.c)."""

from __future__ import annotations

from ..core.encoding import NUC_TO_BITS
from .axt import _gapped_texts


def diffs_align(seq1, seq2, a, with_blocks=True, inhibit_n=False) -> str:
    """One line per mismatch run / gap (print_align_diffs_align)."""
    beg1 = a.beg1 - 1
    beg2 = a.beg2 - 1
    end1 = a.end1
    end2 = a.end2
    height = end1 - beg1
    width = end2 - beg2
    v1, v2 = seq1.v, seq2.v

    block1 = block2 = None
    if with_blocks:
        block1, block2 = _gapped_texts(v1, v2, beg1 + 1, beg2 + 1, a.script)

    out = []

    def emit(diff_pos1, text1, diff_pos2, text2, length):
        out.append(_difference_line(
            seq1, seq2, beg1, beg2, diff_pos1, text1, diff_pos2, text2,
            length, block1, block2))

    i = j = 0
    for op, run in a.script.ops:
        if op == "S":
            mm = 0
            for ix in range(run):
                b1 = NUC_TO_BITS[v1[beg1 + i + ix]]
                b2 = NUC_TO_BITS[v2[beg2 + j + ix]]
                if inhibit_n:
                    is_match = b1 < 0 or b2 < 0 or b1 == b2
                else:
                    is_match = b1 == b2
                if not is_match:
                    mm += 1
                elif mm:
                    emit(i + ix - mm,
                         v1[beg1 + i + ix - mm : beg1 + i + ix],
                         j + ix - mm,
                         v2[beg2 + j + ix - mm : beg2 + j + ix], mm)
                    mm = 0
            if mm:
                emit(i + run - mm,
                     v1[beg1 + i + run - mm : beg1 + i + run],
                     j + run - mm,
                     v2[beg2 + j + run - mm : beg2 + j + run], mm)
            i += run
            j += run
        elif op == "D":
            emit(i, v1[beg1 + i : beg1 + i + run], j, None, run)
            i += run
        else:
            emit(i, None, j, v2[beg2 + j : beg2 + j + run], run)
            j += run
    return "".join(out)


def _difference_line(seq1, seq2, beg1, beg2, diff_pos1, text1, diff_pos2,
                     text2, length, block1, block2) -> str:
    name1 = seq1.name_for_output() or "seq1"
    name2 = seq2.name_for_output() or "seq2"
    offset1 = offset2 = 0
    start_loc1, start_loc2 = seq1.start_loc, seq2.start_loc
    seq1_len, seq2_len = len(seq1.v), len(seq2.v)
    seq1_true, seq2_true = seq1.true_len, seq2.true_len
    if seq1.is_partitioned:
        part = seq1.lookup_partition(beg1)
        name1 = part.header
        offset1 = part.sep_before + 1
        start_loc1 = part.start_loc
        seq1_len = part.sep_after - offset1
        seq1_true = part.true_len
    if seq2.is_partitioned:
        part = seq2.lookup_partition(beg2)
        name2 = part.header
        offset2 = part.sep_before + 1
        start_loc2 = part.start_loc
        seq2_len = part.sep_after - offset2
        seq2_true = part.true_len
    if seq1.rev_comp_flags & 2:
        start1 = beg1 + diff_pos1 - offset1 + seq1_true + 2 - (
            start_loc1 + seq1_len)
        strand1 = "-"
    else:
        start1 = beg1 + diff_pos1 - offset1 + start_loc1
        strand1 = "+"
    if seq2.rev_comp_flags & 2:
        start2 = beg2 + diff_pos2 - offset2 + seq2_true + 2 - (
            start_loc2 + seq2_len)
        strand2 = "-"
    else:
        start2 = beg2 + diff_pos2 - offset2 + start_loc2
        strand2 = "+"
    len1 = length if text1 is not None else 0
    len2 = length if text2 is not None else 0
    t1 = (text1.tobytes().decode("latin-1") if text1 is not None
          else "-" * length)
    t2 = (text2.tobytes().decode("latin-1") if text2 is not None
          else "-" * length)
    line = (f"{name1}\t{start1 - 1}\t{start1 - 1 + len1}\t{strand1}"
            f"\t{seq1_true}\t"
            f"{name2}\t{start2 - 1}\t{start2 - 1 + len2}\t{strand2}"
            f"\t{seq2_true}\t{t1}\t{t2}")
    if block1 is not None:
        line += f"\t{block1}\t{block2}"
    return line + "\n"
