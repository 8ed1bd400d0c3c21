"""Score tables from a configuration's scores file.

The file is LASTZ's: a line of column letters (A C G T), then one row of
integer scores a letter. Every other character pair scores `fill`
(-100) and X scores `bad` (-1000), LASTZ's defaults. Two 256 x 256
tables indexed by ASCII codes come out of it:

- `gapped`: case-blind, the table of gapped extension and of the
  scores printed in the output;
- `masked`: the seed stage's, where a lowercase (soft-masked) base or
  an N on either side scores `bad`, so a gap-free extension stops in a
  repeat.
"""

from __future__ import annotations

import numpy as np

FILL = -100
BAD = -1000


def read_matrix(path: str) -> np.ndarray:
    """The 4 x 4 ACGT matrix of a scores file."""
    rows = []
    cols = None
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" in line:
                continue
            fields = line.split()
            if cols is None:
                cols = fields
                continue
            if fields[0].isalpha():
                fields = fields[1:]
            rows.append([int(x) for x in fields])
    if cols != ["A", "C", "G", "T"] or len(rows) != 4:
        raise ValueError(f"{path}: expected an A C G T matrix")
    return np.array(rows, dtype=np.int64)


class Scores:
    def __init__(self, matrix: np.ndarray, gap_open: int, gap_extend: int):
        self.matrix = matrix
        self.gap_open = int(gap_open)
        self.gap_extend = int(gap_extend)
        g = np.full((256, 256), FILL, dtype=np.int64)
        for i, a in enumerate(b"ACGT"):
            for j, b in enumerate(b"ACGT"):
                for x in (a, a + 32):
                    for y in (b, b + 32):
                        g[x, y] = matrix[i, j]
        for x in (ord("X"), ord("x")):
            g[x, :] = BAD
            g[:, x] = BAD
        self.gapped = g
        m = g.copy()
        low = list(range(ord("a"), ord("z") + 1)) + [ord("N"), ord("X")]
        m[low, :] = BAD
        m[:, low] = BAD
        self.masked = m

    def gap(self, length):
        """The cost of a gap of `length` columns (0 for none)."""
        length = np.asarray(length)
        return np.where(length > 0,
                        self.gap_open + self.gap_extend * length, 0)
