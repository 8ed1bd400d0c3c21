"""LAV output (blastz-compatible), replicating reference lav.c byte for byte."""

from __future__ import annotations

import numpy as np

from ..core.encoding import NUC_TO_BITS

def _upper(seg: np.ndarray) -> np.ndarray:
    out = seg.copy()
    lower = (out >= ord("a")) & (out <= ord("z"))
    out[lower] -= 32
    return out


RCF_SHORT_SUFFIX = ["", "~", "~-", "-"]
RCF_LONG_SUFFIX = ["", "~", "~ (reverse complement)", " (reverse complement)"]


def format_score_matrix(scoring) -> str:
    """Score matrix block as in the LAV d stanza (reference
    private_print_score_matrix, dna_utilities.c:1996).  Quantum
    alphabets print hex column/row labels; pure-DNA matrices hide the
    row labels (blastz compatibility)."""
    from ..core.scoring import SCORE_TYPE
    width = 13 if SCORE_TYPE == "D" else 4

    def cell(v):
        if SCORE_TYPE == "D":
            return f"{float(v):.6e}"
        return str(int(v))

    def printable(ch):
        return 33 <= ch <= 126  # isprint && !isspace

    if scoring.cols_are_dna:
        cols = [c for c in scoring.col_chars if 65 <= c <= 90]
    else:
        cols = list(scoring.col_chars)
    if scoring.rows_are_dna:
        rows = [r for r in scoring.row_chars if 65 <= r <= 90]
    else:
        rows = list(scoring.row_chars)

    rows_as_hex = any(not printable(r) for r in rows)
    cols_as_hex = any(not printable(c) for c in cols)
    rows_hidden = not rows_as_hex and not cols_as_hex

    def label(ch, as_hex):
        return f"{ch:02X}" if as_hex else chr(ch)

    lines = []
    lead = " " if rows_hidden else ("    " if rows_as_hex else "   ")
    lines.append(lead + "".join(
        f" {label(c, cols_as_hex):>{width}}" for c in cols))
    for r in rows:
        row = "  " if rows_as_hex else " "
        if not rows_hidden:
            row += f"{label(r, rows_as_hex):>2}"
        row += "".join(f" {cell(scoring.sub[r, c]):>{width}}" for c in cols)
        lines.append(row)
    return "\n".join(lines)


def lav_job_header(program_name, name1, name2, args, scoring,
                   hsp_threshold, gapped_threshold, dynamic_masking,
                   with_extras=False, x_drop=0, y_drop=0) -> str:
    out = []
    out.append("#:lav\n")
    out.append("d {\n")
    out.append(f'  "{program_name} {name1} {name2} {args}\n')
    out.append(format_score_matrix(scoring) + "\n")
    from ..core.scoring import score_str
    out.append(
        f"  O = {score_str(scoring.gap_open)},"
        f" E = {score_str(scoring.gap_extend)},"
        f" K = {hsp_threshold.to_string()}, L = {gapped_threshold.to_string()},"
        f" M = {dynamic_masking}"
    )
    if with_extras:
        out.append(f", X = {x_drop}, Y = {y_drop}")
    out.append('"\n}\n')
    return "".join(out)


def lav_job_footer() -> str:
    return "#:eof\n"


def lav_header(seq1, seq2) -> str:
    """Per-strand s/h stanzas (reference print_lav_header)."""
    name1 = seq1.filename or "(no name)"
    name2 = seq2.filename or "(no name)"
    header1 = seq1.header or "(no header)"
    header2 = seq2.header or "(no header)"
    r1, r2 = seq1.rev_comp_flags, seq2.rev_comp_flags
    out = []
    out.append("#:lav\n")
    out.append("s {\n")
    out.append(
        f'  "{name1}{RCF_SHORT_SUFFIX[r1]}" {seq1.start_loc}'
        f" {seq1.start_loc + len(seq1.v) - 1} {1 if r1 & 2 else 0} {seq1.contig}\n"
    )
    out.append(
        f'  "{name2}{RCF_SHORT_SUFFIX[r2]}" {seq2.start_loc}'
        f" {seq2.start_loc + len(seq2.v) - 1} {1 if r2 & 2 else 0} {seq2.contig}\n"
    )
    out.append("}\n")
    out.append("h {\n")
    out.append(f'   "{header1}{RCF_LONG_SUFFIX[r1]}"\n')
    out.append(f'   "{header2}{RCF_LONG_SUFFIX[r2]}"\n')
    out.append("}\n")
    return "".join(out)


def percent_identical(v1: np.ndarray, pos1: int, v2: np.ndarray, pos2: int,
                      length: int) -> int:
    """reference percent_identical (sequences.c:9623): case-insensitive
    ACGT matches / legal pairs, rounded."""
    if length == 0:
        return 0
    b1 = NUC_TO_BITS[v1[pos1 : pos1 + length]]
    b2 = NUC_TO_BITS[v2[pos2 : pos2 + length]]
    ok = (b1 >= 0) & (b2 >= 0)
    denom = int(np.count_nonzero(ok))
    if denom == 0:
        return 0
    matches = int(np.count_nonzero(ok & (b1 == b2)))
    return (200 * matches + denom) // (2 * denom)


def lav_match(v1, pos1, v2, pos2, length, s, score_in_l_line=False) -> str:
    """HSP a-stanza (reference print_lav_match); pos1/pos2 are START
    positions, origin-0.  With score_in_l_line, the l-line carries the
    score rather than percent identity (reference print_lavscore_match,
    lav.c:363)."""
    end1 = pos1 + length
    end2 = pos2 + length
    from ..core.scoring import score_str
    if score_in_l_line:
        tail = score_str(s)
    else:
        tail = percent_identical(v1, pos1, v2, pos2, length)
    return (
        "a {\n"
        f"  s {score_str(s)}\n"
        f"  b {pos1 + 1} {pos2 + 1}\n"
        f"  e {end1} {end2}\n"
        f"  l {pos1 + 1} {pos2 + 1} {end1} {end2} {tail}\n"
        "}\n"
    )


def lav_comment(text: str) -> str:
    """reference vprint_lav_comment: '# ' prefixed comment line."""
    return f"# {text}\n"


def _align_match_percent(run: int, match: int) -> int:
    if run == 0:
        return 0
    return (200 * match + run) // (2 * run)


def lav_align(v1, beg1, end1, v2, beg2, end2, script, s) -> str:
    """Gapped-alignment a-stanza (reference print_lav_align).

    beg/end are origin-0 start, origin-1-inclusive end (i.e. beg is the
    0-based start index, end is the 0-based end index + 1... matching
    the reference call convention beg1-1,end1 from 1-based fields).
    script: EditScript of (op, run) with ops 'S'(sub) 'I' 'D'.
    """
    b1, b2 = beg1 + 1, beg2 + 1  # origin-1 inclusive
    from ..core.scoring import score_str
    out = [
        "a {\n",
        f"  s {score_str(s)}\n",
        f"  b {b1} {b2}\n",
        f"  e {end1} {end2}\n",
    ]
    height = end1 - b1 + 1
    width = end2 - b2 + 1
    i = j = 0
    op_ix = 0
    ops = script.ops
    while i < height or j < width:
        prev_i, prev_j = i, j
        # run of substitutions, counting matches
        run = 0
        match = 0
        while op_ix < len(ops) and ops[op_ix][0] == "S":
            r = ops[op_ix][1]
            seg1 = v1[b1 - 1 + i + run : b1 - 1 + i + run + r]
            seg2 = v2[b2 - 1 + j + run : b2 - 1 + j + run + r]
            # match counts ANY equal characters after case folding
            # (edit_script_run_of_subs_match, edit_script.c); for
            # ASCII letters x|32 == y|32 <=> toupper(x) == toupper(y)
            match += int(np.count_nonzero((seg1 | 32) == (seg2 | 32)))
            run += r
            op_ix += 1
        i += run
        j += run
        out.append(
            f"  l {b1 + prev_i} {b2 + prev_j} {b1 + i - 1} {b2 + j - 1}"
            f" {_align_match_percent(run, match)}\n"
        )
        if i < height or j < width:
            # consume indel
            if op_ix < len(ops):
                op, r = ops[op_ix]
                op_ix += 1
                if op == "I":
                    j += r
                elif op == "D":
                    i += r
            else:
                break
    out.append("}\n")
    return "".join(out)


def lav_x_stanza(num_masked: int) -> str:
    return "x {\n  n " + str(num_masked) + "\n}\n"


def lav_m_stanza(census) -> str:
    out = ["m {\n"]
    n = 0
    if census is not None:
        for b, e in census.masked_intervals():
            out.append(f"  x {b} {e}\n")
            n += 1
    out.append(f"  n {n}\n")
    out.append("}\n")
    return "".join(out)
