"""Coverage filters (reference coverage_dist.c): aligned length over
the SHORTER sequence's true length."""

from __future__ import annotations


def alignment_coverage(seq1, seq2, a):
    t_len = (seq1.lookup_partition(a.beg1 - 1).true_len
             if seq1.is_partitioned else seq1.true_len)
    q_len = (seq2.lookup_partition(a.beg2 - 1).true_len
             if seq2.is_partitioned else seq2.true_len)
    if t_len < q_len:
        return a.end1 + 1 - a.beg1, t_len
    return a.end2 + 1 - a.beg2, q_len


def filter_aligns_by_coverage(seq1, seq2, align_list, min_cov, max_cov):
    out = []
    for a in align_list:
        numer, denom = alignment_coverage(seq1, seq2, a)
        if denom == 0:
            continue
        cov = numer / denom
        if min_cov <= cov <= max_cov:
            out.append(a)
    return out


def segment_coverage(seq1, seq2, seg):
    t_len = (seq1.lookup_partition(seg.pos1).true_len
             if seq1.is_partitioned else seq1.true_len)
    q_len = (seq2.lookup_partition(seg.pos2).true_len
             if seq2.is_partitioned else seq2.true_len)
    return seg.length, min(t_len, q_len)


def filter_segments_by_coverage(seq1, seq2, table, min_cov, max_cov):
    kept = []
    for seg in table.segments:
        numer, denom = segment_coverage(seq1, seq2, seg)
        if denom == 0:
            continue
        cov = numer / denom
        if min_cov <= cov <= max_cov:
            kept.append(seg)
    table.segments = kept
