"""MAF output format (reference maf.c)."""

from __future__ import annotations

from .axt import _names_and_coords, _gapped_texts, _matrix_with_extras

RCF_SUFFIX = ["", "~", "~", ""]


def maf_job_header(program_name, args, scoring, hsp_threshold,
                   gapped_threshold, x_drop, y_drop,
                   with_comments=True) -> str:
    if not with_comments:
        return ""
    out = []
    out.append(f"##maf version=1 scoring={program_name}\n")
    out.append(f"# {program_name} {args}\n")
    out.append("#\n")
    out.append(f"# hsp_threshold      = {hsp_threshold.to_string()}\n")
    if gapped_threshold.t == "S" or hsp_threshold.t == "S":
        out.append(f"# gapped_threshold   = {gapped_threshold.to_string()}\n")
    else:
        out.append("# gapped_threshold   = (derived from hsp_threshold)\n")
    out.append(f"# x_drop             = {x_drop}\n")
    out.append(f"# y_drop             = {y_drop}\n")
    out.append(_matrix_with_extras(scoring))
    return "".join(out)


def _digits(x: int) -> int:
    return len(str(x))


def maf_align(seq1, seq2, a, distinguish_names=False) -> str:
    beg1, beg2 = a.beg1, a.beg2
    (name1, offset1, start_loc1, seq1_len, seq1_true,
     name2, offset2, start_loc2, seq2_len, seq2_true) = _names_and_coords(
        seq1, beg1, seq2, beg2)

    suff1 = RCF_SUFFIX[seq1.rev_comp_flags]
    suff2 = RCF_SUFFIX[seq2.rev_comp_flags]
    pref2 = "~" if (distinguish_names and name1 == name2) else ""

    if seq1.rev_comp_flags & 2:
        start1 = beg1 - 1 - offset1 + seq1_true + 2 - (start_loc1 + seq1_len)
        strand1 = "-"
    else:
        start1 = beg1 - 1 - offset1 + start_loc1
        strand1 = "+"
    if seq2.rev_comp_flags & 2:
        start2 = beg2 - 1 - offset2 + seq2_true + 2 - (start_loc2 + seq2_len)
        strand2 = "-"
    else:
        start2 = beg2 - 1 - offset2 + start_loc2
        strand2 = "+"

    len1 = len(name1) + len(suff1)
    len2 = len(pref2) + len(name2) + len(suff2)
    name_w = max(len1, len2)
    start_w = max(_digits(start1), _digits(start2))
    l1 = a.end1 + 1 - beg1
    l2 = a.end2 + 1 - beg2
    end_w = max(_digits(l1), _digits(l2))
    len_w = max(_digits(seq1_true), _digits(seq2_true))

    t1, t2 = _gapped_texts(seq1.v, seq2.v, beg1, beg2, a.script)

    from ..core.scoring import score_fmt
    out = [f"a score={score_fmt(a.score)}\n"]
    out.append(
        f"s {name1}{suff1}{' ' * (name_w + 1 - len1)}"
        f"{start1 - 1:>{start_w}} {l1:>{end_w}} {strand1}"
        f" {seq1_true:>{len_w}} {t1}\n")
    out.append(
        f"s {pref2}{name2}{suff2}{' ' * (name_w + 1 - len2)}"
        f"{start2 - 1:>{start_w}} {l2:>{end_w}} {strand2}"
        f" {seq2_true:>{len_w}} {t2}\n")
    out.append("\n")
    return "".join(out)


def maf_match(seq1, pos1, seq2, pos2, length, s) -> str:
    from ..align.edit_script import EditScript, Alignment

    script = EditScript()
    script.add("S", length)
    a = Alignment(beg1=pos1 + 1, beg2=pos2 + 1,
                  end1=pos1 + length, end2=pos2 + length,
                  script=script, score=s)
    return maf_align(seq1, seq2, a)
