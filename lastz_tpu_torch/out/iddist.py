"""--format=identity: percent-identity distribution
(reference identity_dist.c:768-900, fmtIdDist)."""

from __future__ import annotations

import numpy as np

from ..filters.identity import (
    segment_identity_counts, alignment_identity_counts)
from ..infer import identity_bin, NUM_IDENTITY_BINS


class IdentityDistribution:
    def __init__(self):
        self.count = np.zeros(NUM_IDENTITY_BINS + 1, dtype=np.int64)
        self.coverage = np.zeros(NUM_IDENTITY_BINS + 1, dtype=np.int64)

    def from_match(self, seq1, pos1, seq2, pos2, length):
        numer, denom = segment_identity_counts(
            seq1.v, pos1, seq2.v, pos2, length)
        b = identity_bin(numer, denom)
        self.count[b] += 1
        self.coverage[b] += denom

    def from_align(self, seq1, seq2, a):
        numer, denom = alignment_identity_counts(seq1.v, seq2.v, a)
        b = identity_bin(numer, denom)
        self.count[b] += 1
        self.coverage[b] += denom

    def print_job(self, out):
        """reference print_identity_dist_job (identity_dist.c:793):
        print the [min-1, max+1] bin range, one line per bin."""
        nz = np.nonzero(self.count)[0]
        if len(nz) == 0:
            min_bin = max_bin = NUM_IDENTITY_BINS
        else:
            min_bin, max_bin = int(nz[0]), int(nz[-1])
        if min_bin > 0:
            min_bin -= 1
        if max_bin < NUM_IDENTITY_BINS:
            max_bin += 1
        for b in range(min_bin, max_bin + 1):
            out.write("%.3f\t%d\t%d\n"
                      % (b / NUM_IDENTITY_BINS,
                         self.count[b], self.coverage[b]))
