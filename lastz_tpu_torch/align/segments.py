"""Segment (HSP/anchor) tables.

Replicates the behavior of the reference segtable (segment.c:1-500):
a table of (pos1, pos2, length, score, id) with optional score-
coverage limiting implemented as a min-heap — when a coverage budget
('C'/adaptive-K thresholds) is active, the lowest-scoring segments are
evicted once the total covered length exceeds the budget, with ties
kept together (segment.c:5-40).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Segment:
    pos1: int  # start in target (origin-0)
    pos2: int  # start in query (origin-0)
    length: int
    score: int
    seg_id: int = 0  # strand rcf value
    hsp_id: int = 0
    filter: bool = False
    scale: float = 1.0  # used transiently by chaining
    score_cov: int = 0  # coverage of the same-score subheap (heap mode)

    @property
    def diag(self) -> int:
        return self.pos1 - self.pos2


class SegmentTable:
    def __init__(self, coverage_limit: int = 0):
        self.segments: list[Segment] = []
        self.coverage_limit = coverage_limit  # 0 => no limit
        self.coverage = 0  # total length of contained segments
        self.low_score = 0
        self.have_scores = False

    def __len__(self):
        return len(self.segments)

    def __iter__(self):
        return iter(self.segments)

    # -- insertion with coverage limiting ---------------------------------
    #
    # Exact port of the reference's score-bounded min-heap
    # (segment.c:1000-1330).  Below the coverage limit the table is a
    # plain list; upon first reaching the limit it is sorted by
    # increasing score (becoming a valid min-heap) and per-node
    # "scoreCov" (coverage of the same-score subheap rooted there) is
    # maintained through percolations.  Pruning removes the entire
    # root tie-group while doing so keeps coverage at/above the limit.
    # The heap SHAPE is semantically relevant (the prune test uses the
    # root's tie-subheap coverage), hence the faithful port.

    _hsp_id_counter = 0

    def add(self, pos1, pos2, length, score, seg_id=0, hsp_id=0):
        if hsp_id == 0:
            SegmentTable._hsp_id_counter += 1
            hsp_id = SegmentTable._hsp_id_counter
        if (self.coverage_limit != 0
                and self.coverage >= self.coverage_limit
                and len(self.segments) > 0
                and score < self.low_score):
            return
        seg = Segment(pos1, pos2, length, score, seg_id, hsp_id)
        seg.score_cov = length
        self.segments.append(seg)
        self.coverage += length
        if len(self.segments) == 1 or score < self.low_score:
            self.low_score = score
        if score != 0:
            self.have_scores = True

        if self.coverage_limit == 0 or self.coverage < self.coverage_limit:
            return

        segs = self.segments
        if self.coverage - length < self.coverage_limit:
            # first time over the limit: sort into a valid min-heap
            segs.sort(key=lambda g: (g.score, g.length, g.pos2, g.pos1,
                                     g.seg_id))
            for ix in range(len(segs) - 1, -1, -1):
                self._record_tie_score(ix)
        else:
            # percolate the appended segment up the min-heap
            tied = False
            ix = len(segs) - 1
            while ix > 0:
                p_ix = (ix - 1) // 2
                if segs[ix].score >= segs[p_ix].score:
                    tied = segs[ix].score == segs[p_ix].score
                    break
                segs[ix], segs[p_ix] = segs[p_ix], segs[ix]
                self._record_tie_score(ix)
                ix = p_ix
            self._record_tie_score(ix)
            if tied:
                stopped = False
                ix = (ix - 1) // 2
                while ix > 0:
                    if not self._record_tie_score(ix):
                        stopped = True
                        break
                    ix = (ix - 1) // 2
                if not stopped:
                    self._record_tie_score(0)

        # prune
        if self.coverage - segs[0].score_cov < self.coverage_limit:
            return
        while (segs and
               self.coverage - segs[0].score_cov >= self.coverage_limit):
            s = segs[0].score
            while segs and segs[0].score == s:
                self._remove_root()
        if segs:
            self.low_score = segs[0].score

    def _record_tie_score(self, ix) -> bool:
        segs = self.segments
        seg = segs[ix]
        cov = seg.length
        lft = 2 * ix + 1
        if lft < len(segs):
            if segs[lft].score == seg.score:
                cov += segs[lft].score_cov
            rgt = lft + 1
            if rgt < len(segs) and segs[rgt].score == seg.score:
                cov += segs[rgt].score_cov
        if cov != seg.score_cov:
            seg.score_cov = cov
            return True
        return False

    def _remove_root(self):
        segs = self.segments
        self.coverage -= segs[0].length
        if len(segs) <= 1:
            self.segments.clear()
            return
        detached = segs.pop()
        if len(segs) == 1:
            segs[0] = detached
            return
        ix = (len(segs) - 1) // 2
        while ix > 0:
            if not self._record_tie_score(ix):
                break
            ix = (ix - 1) // 2
        ix = 0
        while True:
            child_ix = 2 * ix + 1
            if child_ix >= len(segs):
                break
            rgt_ix = child_ix + 1
            if rgt_ix < len(segs) and segs[rgt_ix].score < segs[child_ix].score:
                child_ix = rgt_ix
            if detached.score <= segs[child_ix].score:
                break
            segs[ix] = segs[child_ix]
            ix = child_ix
        segs[ix] = detached
        while ix > 0:
            self._record_tie_score(ix)
            ix = (ix - 1) // 2
        self._record_tie_score(0)

    # -- bulk ops -----------------------------------------------------------

    def sort_by_pos1(self):
        # reference qSegmentsByPos1 ordering
        self.segments.sort(
            key=lambda s: (s.pos1, s.length, s.pos2, s.seg_id, s.score))

    def sort_by_pos2(self):
        # reference qSegmentsByPos2 ordering
        self.segments.sort(
            key=lambda s: (s.pos2, s.length, s.pos1, s.seg_id, s.score))

    def sort_by_decreasing_score(self):
        self.segments.sort(key=lambda s: (-s.score, s.pos1, s.pos2, s.length))

    def sort_by_diag(self):
        self.segments.sort(key=lambda s: (s.diag, s.pos2))

    def merge_overlapping(self):
        """reference merge_segments (segment.c:1527): sort by diagonal
        then pos2; merge strictly-overlapping same-diagonal segments
        (adjoining segments are NOT merged); merged score is the max."""
        if len(self.segments) < 2:
            return
        segs = sorted(self.segments, key=lambda s: (s.diag, s.pos2))
        merged = []
        cur = Segment(segs[0].pos1, segs[0].pos2, segs[0].length,
                      segs[0].score, segs[0].seg_id, segs[0].hsp_id)
        for seg in segs[1:]:
            if seg.diag == cur.diag and seg.pos2 < cur.pos2 + cur.length:
                new_end = max(cur.pos2 + cur.length, seg.pos2 + seg.length)
                cur.length = new_end - cur.pos2
                cur.score = max(cur.score, seg.score)
            else:
                merged.append(cur)
                cur = Segment(seg.pos1, seg.pos2, seg.length,
                              seg.score, seg.seg_id, seg.hsp_id)
        merged.append(cur)
        self.segments = merged
        self.coverage = sum(s.length for s in merged)

    def score_all(self, v1: np.ndarray, v2: np.ndarray, scoring):
        sub = scoring.sub
        for seg in self.segments:
            seg.score = sub[v1[seg.pos1 : seg.pos1 + seg.length],
                            v2[seg.pos2 : seg.pos2 + seg.length]].sum().item()
        self.have_scores = True


def read_segment_table(path: str, table: SegmentTable, target, query):
    """Read anchors/segments file (reference read_segment_table,
    segment.c:335-383): lines 'tName tStart tEnd qName qStart qEnd
    strand [score]', origin-1 closed; '*' wildcard name; '#' comments.

    Only records matching the current query name/strand are added.
    """
    qname = query.name_for_output()
    tname = target.name_for_output()
    strand = "-" if (query.rev_comp_flags & 2) else "+"
    qlen = len(query.v)
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 7:
                raise ValueError(f"bad segments line: {line}")
            t_name, t_start, t_end, q_name, q_start, q_end, s_strand = parts[:7]
            score = int(parts[7]) if len(parts) > 7 else 0
            if s_strand != strand:
                continue
            if t_name != "*" and t_name != tname:
                continue
            if q_name != "*" and q_name != qname:
                continue
            ts, te = int(t_start), int(t_end)
            qs, qe = int(q_start), int(q_end)
            length = te - ts + 1
            # negative-strand query intervals are counted from the 5'
            # end of the minus strand, which matches our reversed v2
            table.add(ts - 1, qs - 1, length, score,
                      seg_id=query.rev_comp_flags)
    table.have_scores = any(s.score for s in table.segments)
