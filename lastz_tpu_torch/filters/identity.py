"""Identity filters over segments and alignments (reference identity_dist.c)."""

from __future__ import annotations

import numpy as np

from ..core.encoding import NUC_TO_BITS


def _identity_of_segment(v1, pos1, v2, pos2, length):
    b1 = NUC_TO_BITS[v1[pos1 : pos1 + length]]
    b2 = NUC_TO_BITS[v2[pos2 : pos2 + length]]
    ok = (b1 >= 0) & (b2 >= 0)
    denom = int(np.count_nonzero(ok))
    if denom == 0:
        return 0.0, 0
    matches = int(np.count_nonzero(ok & (b1 == b2)))
    return matches / denom, denom


def filter_segments_by_identity(v1, v2, table, min_identity, max_identity):
    kept = []
    for seg in table.segments:
        ident, denom = _identity_of_segment(v1, seg.pos1, v2, seg.pos2, seg.length)
        if min_identity <= ident <= max_identity:
            kept.append(seg)
    table.segments = kept


def segment_identity_counts(v1, pos1, v2, pos2, length):
    """(matches, denom) counts (reference segment_identity,
    identity_dist.c:350)."""
    b1 = NUC_TO_BITS[v1[pos1 : pos1 + length]]
    b2 = NUC_TO_BITS[v2[pos2 : pos2 + length]]
    ok = (b1 >= 0) & (b2 >= 0)
    denom = int(np.count_nonzero(ok))
    matches = int(np.count_nonzero(ok & (b1 == b2)))
    return matches, denom


def alignment_identity_counts(v1, v2, a):
    """(matches, denom) over an alignment's substitution columns
    (reference alignment_identity, identity_dist.c:180)."""
    i = a.beg1 - 1
    j = a.beg2 - 1
    matches = 0
    denom = 0
    for op, run in a.script.ops:
        if op == "S":
            m, d = segment_identity_counts(v1, i, v2, j, run)
            denom += d
            matches += m
            i += run
            j += run
        elif op == "I":
            j += run
        else:
            i += run
    return matches, denom


def alignment_identity(v1, v2, a):
    """match/mismatch ratio over substitution columns of an alignment."""
    matches, denom = alignment_identity_counts(v1, v2, a)
    if denom == 0:
        return 0.0
    return matches / denom


def filter_aligns_by_identity(v1, v2, align_list, min_identity, max_identity):
    return [a for a in align_list
            if min_identity <= alignment_identity(v1, v2, a) <= max_identity]


def filter_aligns_by_match_count(v1, v2, align_list, min_match_count):
    """Drop alignments with fewer matched bases than the minimum
    (reference filter_aligns_by_match_count, identity_dist.c:492)."""
    out = []
    for a in align_list:
        numer, denom = alignment_identity_counts(v1, v2, a)
        if denom == 0 or numer < min_match_count:
            continue
        out.append(a)
    return out


def filter_aligns_by_mismatch_count(v1, v2, align_list, max_mismatch_count):
    """Drop alignments with more mismatched bases than the maximum
    (reference filter_aligns_by_mismatch_count, identity_dist.c:639)."""
    out = []
    for a in align_list:
        numer, denom = alignment_identity_counts(v1, v2, a)
        if denom == 0 or denom - numer > max_mismatch_count:
            continue
        out.append(a)
    return out


def filter_segments_by_match_count(v1, v2, table, min_match_count):
    kept = []
    for seg in table.segments:
        numer, denom = segment_identity_counts(
            v1, seg.pos1, v2, seg.pos2, seg.length)
        if denom == 0 or numer < min_match_count:
            continue
        kept.append(seg)
    table.segments = kept


def filter_segments_by_mismatch_count(v1, v2, table, max_mismatch_count):
    kept = []
    for seg in table.segments:
        numer, denom = segment_identity_counts(
            v1, seg.pos1, v2, seg.pos2, seg.length)
        if denom == 0 or denom - numer > max_mismatch_count:
            continue
        kept.append(seg)
    table.segments = kept
