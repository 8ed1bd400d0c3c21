"""Continuity filter (reference continuity_dist.c): fraction of
alignment columns that are not gaps."""

from __future__ import annotations


def alignment_continuity(a):
    height = a.end1 - a.beg1 + 1
    width = a.end2 - a.beg2 + 1
    run_total = sum(r for op, r in a.script.ops if op == "S")
    if run_total == 0:
        return 0, 0
    gap_columns = (height - run_total) + (width - run_total)
    return run_total, run_total + gap_columns


def filter_aligns_by_continuity(align_list, min_con, max_con):
    out = []
    for a in align_list:
        numer, denom = alignment_continuity(a)
        if denom == 0:
            continue
        con = numer / denom
        if min_con <= con <= max_con:
            out.append(a)
    return out


def _gap_runs_and_columns(a):
    """(number of gap runs, total gap columns); consecutive indel ops
    count as ONE run (reference filter_aligns_by_num_gaps,
    continuity_dist.c:116-118)."""
    runs = 0
    columns = 0
    in_gap = False
    for op, rpt in a.script.ops:
        if op == "S":
            in_gap = False
        else:
            if not in_gap:
                runs += 1
                in_gap = True
            columns += rpt
    return runs, columns


def filter_aligns_by_num_gaps(align_list, max_separate_gaps):
    return [a for a in align_list
            if _gap_runs_and_columns(a)[0] <= max_separate_gaps]


def filter_aligns_by_num_gap_columns(align_list, max_gap_columns):
    return [a for a in align_list
            if _gap_runs_and_columns(a)[1] <= max_gap_columns]
