"""Dynamic masking and census (reference masking.c).

The census counts, per target base, how many alignments (or HSPs in
ungapped mode) covered it.  With --masking=M, bases reaching M are
replaced with 'x' in the target (coupling successive queries) and
their seed words are removed from the position table.

On TPU the census is a scatter-add per query batch followed by a psum
across data-parallel workers; the host mirror here is the exact
engine's version.
"""

from __future__ import annotations

import numpy as np


class Census:
    def __init__(self, length: int, kind: str = "B", mask_thresh: int = 0):
        dtype = {"B": np.uint8, "W": np.uint16, "L": np.uint32}[kind]
        self.count = np.zeros(max(length, 1), dtype=dtype)
        self.kind = kind
        self.mask_thresh = mask_thresh
        self.len = max(length, 1)

    def _bump(self, beg: int, end: int):
        seg = self.count[beg:end]
        maxv = np.iinfo(self.count.dtype).max
        seg[seg < maxv] += 1

    def mask_segments(self, table, fwd: np.ndarray, on_mask=None) -> int:
        count = 0
        for seg in table.segments:
            self._bump(seg.pos1, seg.pos1 + seg.length)
            if self.mask_thresh > 0:
                count += self._mask_interval(
                    fwd, seg.pos1, seg.pos1 + seg.length, on_mask)
        return count

    def mask_aligns(self, align_list, fwd: np.ndarray, on_mask=None) -> int:
        count = 0
        for a in align_list:
            self._bump(a.beg1 - 1, a.end1)
            if self.mask_thresh > 0:
                count += self._mask_interval(fwd, a.beg1 - 1, a.end1, on_mask)
        return count

    def _mask_interval(self, fwd, beg, end, on_mask) -> int:
        """reference mask_interval: runs of threshold-reaching,
        still-uppercase bases are reported then masked with 'x'."""
        masked = 0
        run_beg = -1
        pos = beg
        while pos < end:
            c = int(self.count[pos])
            ch = fwd[pos]
            if (c >= self.mask_thresh and 65 <= ch <= 90):
                if run_beg < 0:
                    run_beg = pos
            elif run_beg >= 0:
                if on_mask is not None:
                    on_mask(run_beg + 1, pos)
                fwd[run_beg:pos] = ord("x")
                masked += pos - run_beg
                run_beg = -1
            pos += 1
        if run_beg >= 0:
            if on_mask is not None:
                on_mask(run_beg + 1, end)
            fwd[run_beg:end] = ord("x")
            masked += end - run_beg
        return masked

    def masked_intervals(self):
        """Yield (beg, end) origin-1 inclusive runs reaching threshold
        (reference report_census_intervals; a zero threshold matches
        every position, i.e. one whole-sequence interval)."""
        run_beg = -1
        for pos in range(self.len):
            if int(self.count[pos]) >= self.mask_thresh:
                if run_beg < 0:
                    run_beg = pos
            elif run_beg >= 0:
                yield (run_beg + 1, pos)
                run_beg = -1
        if run_beg >= 0:
            yield (run_beg + 1, self.len)

    def print_census(self, out, seq=None, delimiter=" "):
        """Print positions whose count meets the threshold (reference
        masking.c:676 print_census).  With a sequence, each line is
        name<d>pos<d>count; partitioned sequences use per-partition
        names and offsets."""
        thresh = self.mask_thresh
        if seq is None:
            for pos in range(self.len):
                c = int(self.count[pos])
                if c >= thresh:
                    out.write(f"{pos + 1}{delimiter}{c}\n")
            return
        if not seq.is_partitioned:
            name = seq.name_for_output() or "seq1"
            for pos in range(self.len):
                c = int(self.count[pos])
                if c >= thresh:
                    out.write(f"{name}{delimiter}{pos + 1}{delimiter}{c}\n")
            return
        parts = list(seq.partitions)
        part_ix = 0
        name = None
        offset = 0
        for pos in range(self.len):
            if part_ix < len(parts) and pos == parts[part_ix].sep_before:
                name = parts[part_ix].header
                offset = parts[part_ix].sep_before + 1
                part_ix += 1
            elif name is not None:
                c = int(self.count[pos])
                if c >= thresh:
                    out.write(
                        f"{name}{delimiter}{pos + 1 - offset}"
                        f"{delimiter}{c}\n")


def remove_interval_seeds(pt, seed, target_v, beg, end):
    """Remove seed words overlapping [beg, end) origin-0 from the
    position table (reference remove_interval_seeds, lastz.c:3770+).

    Must be called BEFORE the characters are masked, so the old word
    values can be recomputed.  Word END positions p with
    p - L < end and p > beg are affected; the reference expands the
    interval by seedLength-1 on each side and rescans.  Returns the
    indices into csr_pos of the entries it cleared (int64).
    """
    from .core.encoding import UPPER_NUC_TO_BITS
    from .index.postable import _window_words

    L = seed.length
    lo = max(0, beg - (L - 1))
    hi = min(len(target_v), end + (L - 1))
    none = np.zeros(0, np.int64)
    if hi - lo < L:
        return none
    codes = UPPER_NUC_TO_BITS[target_v[lo:hi]]
    words, valid = _window_words(codes, L, seed.bits_per_base)
    end_pos = lo + L + np.arange(len(words), dtype=np.int64)
    sel = valid & ((end_pos % pt.step) == 0)
    if not np.any(sel):
        return none
    packed = seed.pack(words[sel])
    stored = ((end_pos[sel] - pt.adj_start) // pt.step).astype(pt.csr_pos.dtype)
    if pt.alive is None:
        pt.alive = np.ones(len(pt.csr_pos), dtype=bool)
    cleared = [none]
    for w, p in zip(packed.tolist(), stored.tolist()):
        loix, hiix = pt.csr_start[w], pt.csr_start[w + 1]
        seg = pt.csr_pos[loix:hiix]
        hits = np.nonzero(seg == p)[0]
        if len(hits):
            pt.alive[loix + hits] = False
            cleared.append(loix + hits.astype(np.int64))
    return np.concatenate(cleared)
