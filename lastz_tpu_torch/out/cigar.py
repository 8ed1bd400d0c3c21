"""CIGAR output format (reference cigar.c)."""

from __future__ import annotations

from ..core.encoding import NUC_TO_BITS
from ..core.scoring import score_fmt

RCF_SUFFIX = ["", "~", "~", ""]


def _item(ch: str, run: int, letter_after, with_spaces, hide_singles) -> str:
    if not letter_after and not with_spaces:
        return f"{ch}{run}"
    if not letter_after and with_spaces:
        return f" {ch} {run}"
    if hide_singles and run == 1:
        return ch
    return f"{run}{ch}"


def _mismatchy_run(v1, v2, p1, p2, run, letter_after, with_spaces,
                   hide_singles, lower_case) -> str:
    """Split a substitution run into =/X items
    (reference print_cigar_mismatchy_run)."""
    ch_x = "x" if lower_case else "X"
    out = []
    run_is_mm = False
    run_len = 0
    for ix in range(run):
        b1 = NUC_TO_BITS[v1[p1 + ix]]
        b2 = NUC_TO_BITS[v2[p2 + ix]]
        if b1 == b2 and b1 >= 0:
            if not run_is_mm:
                run_len += 1
                continue
            if run_len > 0:
                out.append(_item(ch_x, run_len, letter_after, with_spaces,
                                 hide_singles))
            run_is_mm = False
            run_len = 1
        else:
            if run_is_mm:
                run_len += 1
                continue
            if run_len > 0:
                out.append(_item("=", run_len, letter_after, with_spaces,
                                 hide_singles))
            run_is_mm = True
            run_len = 1
    if run_len > 0:
        out.append(_item(ch_x if run_is_mm else "=", run_len,
                         letter_after, with_spaces, hide_singles))
    return "".join(out)


def cigarx_text(v1, beg1, v2, beg2, script, letter_after=True,
                with_spaces=True, hide_singles=True, lower_case=False,
                mark_mismatches=True) -> str:
    ch_m = "m" if lower_case else "M"
    ch_d = "d" if lower_case else "D"
    ch_i = "i" if lower_case else "I"
    out = []
    i = j = 0
    for op, run in script.ops:
        if op == "S":
            if mark_mismatches:
                out.append(_mismatchy_run(v1, v2, beg1 + i, beg2 + j, run,
                                          letter_after, with_spaces,
                                          hide_singles, lower_case))
            else:
                out.append(_item(ch_m, run, letter_after, with_spaces,
                                 hide_singles))
            i += run
            j += run
        elif op == "D":
            out.append(_item(ch_d, run, letter_after, with_spaces,
                             hide_singles))
            i += run
        else:
            out.append(_item(ch_i, run, letter_after, with_spaces,
                             hide_singles))
            j += run
    return "".join(out)


def cigar_align(seq1, seq2, a, with_info=True, mark_mismatches=False,
                letter_after=False, with_spaces=True, hide_singles=False,
                lower_case=False) -> str:
    """--format=cigar record (reference print_cigar_align)."""
    beg1 = a.beg1 - 1
    beg2 = a.beg2 - 1
    height = a.end1 - beg1
    width = a.end2 - beg2

    name1 = seq1.name_for_output() or "seq1"
    name2 = seq2.name_for_output() or "seq2"
    suff1 = RCF_SUFFIX[seq1.rev_comp_flags]
    suff2 = RCF_SUFFIX[seq2.rev_comp_flags]
    if seq1.rev_comp_flags & 2:
        start1 = seq1.start_loc + len(seq1.v) - (beg1 + 1)
        end1 = start1 - height
        strand1 = "-"
    else:
        start1 = beg1 - 1 + seq1.start_loc
        end1 = start1 + height
        strand1 = "+"
    if seq2.rev_comp_flags & 2:
        start2 = seq2.start_loc + len(seq2.v) - (beg2 + 1)
        end2 = start2 - width
        strand2 = "-"
    else:
        start2 = beg2 - 1 + seq2.start_loc
        end2 = start2 + width
        strand2 = "+"

    out = []
    if with_info:
        out.append(
            f"cigar: {name2}{suff2} {start2} {end2} {strand2}"
            f" {name1}{suff1} {start1} {end1} {strand1}"
            f" {score_fmt(a.score)}")
    out.append(cigarx_text(seq1.v, beg1, seq2.v, beg2, a.script,
                           letter_after=letter_after, with_spaces=with_spaces,
                           hide_singles=hide_singles, lower_case=lower_case,
                           mark_mismatches=mark_mismatches))
    out.append("\n")
    return "".join(out)
