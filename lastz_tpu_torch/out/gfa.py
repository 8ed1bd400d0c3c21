"""GFA output format (reference gfa.c) — blastz's tabular ancestor."""

from __future__ import annotations

from .lav import percent_identical, RCF_SHORT_SUFFIX, RCF_LONG_SUFFIX


def gfa_job_header(program_name, name1, name2) -> str:
    return f"d {program_name} {name1 or '(no name)'} {name2 or '(no name)'}\n"


def gfa_generic(text: str) -> str:
    return f"z {text}\n"


def gfa_header(seq1, seq2) -> str:
    name1 = seq1.filename or "(no name)"
    name2 = seq2.filename or "(no name)"
    header1 = seq1.header or "(no header)"
    header2 = seq2.header or "(no header)"
    r1, r2 = seq1.rev_comp_flags, seq2.rev_comp_flags
    return (
        f's "{name1}{RCF_SHORT_SUFFIX[r1]}" {seq1.start_loc}'
        f" {seq1.start_loc + len(seq1.v) - 1} {1 if r1 & 2 else 0} {seq1.contig}"
        f' "{name2}{RCF_SHORT_SUFFIX[r2]}" {seq2.start_loc}'
        f" {seq2.start_loc + len(seq2.v) - 1} {1 if r2 & 2 else 0} {seq2.contig}\n"
        f'h "{header1}{RCF_LONG_SUFFIX[r1]}" "{header2}{RCF_LONG_SUFFIX[r2]}"\n'
    )


def gfa_match(seq1, pos1, seq2, pos2, length, s) -> str:
    pct = percent_identical(seq1.v, pos1, seq2.v, pos2, length)
    diag = pos1 - pos2
    s1 = "-" if seq1.rev_comp_flags & 2 else "+"
    s2 = "-" if seq2.rev_comp_flags & 2 else "+"
    return (f"a {pos1 + 1}{s1}/{pos2 + 1}{s2} {length} {s} {pct}"
            f" ; diag {diag}\n")


def _score_match(scoring, seq1, pos1, seq2, pos2, run) -> int:
    if scoring is None or run == 0:
        return 0
    return int(scoring.sub[seq1.v[pos1 : pos1 + run],
                           seq2.v[pos2 : pos2 + run]].sum())


def gfa_align(seq1, seq2, a, scoring=None) -> str:
    """A-record + per-segment a-records (reference print_gfa_align)."""
    out = []
    beg1, beg2 = a.beg1, a.beg2
    height = a.end1 - beg1 + 1
    width = a.end2 - beg2 + 1
    s1 = "-" if seq1.rev_comp_flags & 2 else "+"
    s2 = "-" if seq2.rev_comp_flags & 2 else "+"
    total = 0
    if scoring is not None:
        i = j = 0
        op_ix = 0
        ops = a.script.ops
        while i < height or j < width:
            run = 0
            prev_i, prev_j = i, j
            while op_ix < len(ops) and ops[op_ix][0] == "S":
                run += ops[op_ix][1]
                op_ix += 1
            i += run
            j += run
            total += _score_match(scoring, seq1, beg1 - 1 + prev_i,
                                  seq2, beg2 - 1 + prev_j, run)
            if i < height or j < width:
                if op_ix >= len(ops):
                    break
                op, r = ops[op_ix]
                op_ix += 1
                if r > 0:
                    total -= scoring.gap_open + r * scoring.gap_extend
                if op == "I":
                    j += r
                else:
                    i += r
    out.append(f"A {beg1}{s1}/{beg2}{s2} {height}/{width} {total}\n")
    i = j = 0
    op_ix = 0
    ops = a.script.ops
    while i < height or j < width:
        prev_i, prev_j = i, j
        run = 0
        while op_ix < len(ops) and ops[op_ix][0] == "S":
            run += ops[op_ix][1]
            op_ix += 1
        i += run
        j += run
        out.append(gfa_match(
            seq1, beg1 - 1 + prev_i, seq2, beg2 - 1 + prev_j, run,
            _score_match(scoring, seq1, beg1 - 1 + prev_i,
                         seq2, beg2 - 1 + prev_j, run)))
        if i < height or j < width:
            if op_ix >= len(ops):
                break
            op, r = ops[op_ix]
            op_ix += 1
            if op == "I":
                j += r
            else:
                i += r
    return "".join(out)
