"""AXT output format (reference axt.c)."""

from __future__ import annotations

import numpy as np

from ..core.scoring import score_fmt


def _matrix_with_extras(scoring, prefix="# ") -> str:
    """Score matrix block with row labels and gap penalties
    (reference print_score_matrix_prefix withExtras)."""
    out = []
    out.append(f"{prefix}gap_open_penalty   = {scoring.gap_open}\n")
    out.append(f"{prefix}gap_extend_penalty = {scoring.gap_extend}\n")
    from ..core.scoring import SCORE_TYPE, score_str
    cols = [c for c in scoring.col_chars if 65 <= c <= 90]
    rows = [r for r in scoring.row_chars if 65 <= r <= 90]
    width = 13 if SCORE_TYPE == "D" else 4
    out.append(prefix + "   " + "".join(f" {chr(c):>{width}}" for c in cols)
               + "\n")
    for r in rows:
        out.append(prefix + " " + f"{chr(r):>2}"
                   + "".join(f" {score_str(scoring.sub[r, c]):>{width}}"
                             for c in cols)
                   + "\n")
    return "".join(out)


def axt_job_header(program_name, args, scoring, hsp_threshold,
                   gapped_threshold, x_drop, y_drop) -> str:
    out = []
    out.append(f"# {program_name} {args}\n")
    out.append("#\n")
    out.append(f"# hsp_threshold      = {hsp_threshold.to_string()}\n")
    out.append(f"# gapped_threshold   = {gapped_threshold.to_string()}\n")
    out.append(f"# x_drop             = {x_drop}\n")
    out.append(f"# y_drop             = {y_drop}\n")
    out.append(_matrix_with_extras(scoring))
    return "".join(out)


def _names_and_coords(seq1, beg1, seq2, beg2):
    """Resolve display names and strand-adjusted start coordinates."""
    if seq1.is_partitioned:
        part = _lookup_partition(seq1, beg1 - 1)
        name1 = part.header
        offset1, start_loc1 = part.sep_before + 1, part.start_loc
        seq1_len = part.sep_after - offset1
        seq1_true = part.true_len
    else:
        name1 = seq1.name_for_output() or "seq1"
        offset1, start_loc1 = 0, seq1.start_loc
        seq1_len, seq1_true = len(seq1.v), seq1.true_len
    if seq2.is_partitioned:
        part = _lookup_partition(seq2, beg2 - 1)
        name2 = part.header
        offset2, start_loc2 = part.sep_before + 1, part.start_loc
        seq2_len = part.sep_after - offset2
        seq2_true = part.true_len
    else:
        name2 = seq2.name_for_output() or "seq2"
        offset2, start_loc2 = 0, seq2.start_loc
        seq2_len, seq2_true = len(seq2.v), seq2.true_len
    return (name1, offset1, start_loc1, seq1_len, seq1_true,
            name2, offset2, start_loc2, seq2_len, seq2_true)


def _lookup_partition(seq, pos):
    for part in seq.partitions:
        if part.sep_before < pos < part.sep_after:
            return part
    # position on a separator: return the nearest following partition
    for part in seq.partitions:
        if pos <= part.sep_after:
            return part
    return seq.partitions[-1]


def _gapped_texts(v1, v2, beg1, beg2, script):
    """Render the two gap-padded sequence lines."""
    t1 = []
    t2 = []
    i = j = 0
    for op, run in script.ops:
        if op == "S":
            t1.append(v1[beg1 - 1 + i : beg1 - 1 + i + run].tobytes())
            t2.append(v2[beg2 - 1 + j : beg2 - 1 + j + run].tobytes())
            i += run
            j += run
        elif op == "I":
            t1.append(b"-" * run)
            t2.append(v2[beg2 - 1 + j : beg2 - 1 + j + run].tobytes())
            j += run
        else:
            t1.append(v1[beg1 - 1 + i : beg1 - 1 + i + run].tobytes())
            t2.append(b"-" * run)
            i += run
    return (b"".join(t1).decode("latin-1"), b"".join(t2).decode("latin-1"))


def axt_align(seq1, seq2, a, number: int, extras_size2=False) -> str:
    beg1, beg2 = a.beg1, a.beg2
    len1 = a.end1 - beg1 + 1
    len2 = a.end2 - beg2 + 1
    (name1, offset1, start_loc1, seq1_len, seq1_true,
     name2, offset2, start_loc2, seq2_len, seq2_true) = _names_and_coords(
        seq1, beg1, seq2, beg2)
    start1 = beg1 - 1 - offset1 + start_loc1
    if seq2.rev_comp_flags & 2:
        start2 = beg2 - 1 - offset2 + seq2_true + 2 - (start_loc2 + seq2_len)
        strand2 = "-"
    else:
        start2 = beg2 - 1 - offset2 + start_loc2
        strand2 = "+"
    head = (f"{number} {name1} {start1} {start1 + len1 - 1}"
            f" {name2} {start2} {start2 + len2 - 1} {strand2}"
            f" {score_fmt(a.score)}")
    if extras_size2:
        head += f" {seq2_len}"
    t1, t2 = _gapped_texts(seq1.v, seq2.v, beg1, beg2, a.script)
    return f"{head}\n{t1}\n{t2}\n\n"


def axt_match(seq1, pos1, seq2, pos2, length, s, number: int,
              extras_size2=False) -> str:
    from ..align.edit_script import EditScript
    from ..align.edit_script import Alignment

    script = EditScript()
    script.add("S", length)
    a = Alignment(beg1=pos1 + 1, beg2=pos2 + 1,
                  end1=pos1 + length, end2=pos2 + length,
                  script=script, score=s)
    return axt_align(seq1, seq2, a, number, extras_size2=extras_size2)
