"""Nucleotide <-> bit encodings and complement maps.

Semantics match the reference LASTZ tables (dna_utilities.c:56-117):
A/C/G/T encode as 0/1/2/3 so that the low bit is the pyrimidine
(transition-invariant) bit, which is what makes transition-tolerant
seeds cheap: a transition substitution flips only the high bit.

Sequences are kept as raw ASCII bytes end-to-end (uint8 arrays); the
scoring matrix is indexed directly by character codes, so NUL
partition separators and masked/ambiguous letters fall out of the
score table rather than needing special cases in kernels.
"""

from __future__ import annotations

import numpy as np

BITS_TO_NUC = b"ACGT"

# char -> 2-bit code, upper+lower case both valid (reference nuc_to_bits)
NUC_TO_BITS = np.full(256, -1, dtype=np.int8)
# char -> 2-bit code, upper case only; lower case (soft-masked) is invalid
# for seeding (reference upper_nuc_to_bits)
UPPER_NUC_TO_BITS = np.full(256, -1, dtype=np.int8)

for _i, _ch in enumerate(BITS_TO_NUC):
    NUC_TO_BITS[_ch] = _i
    NUC_TO_BITS[_ch + 32] = _i  # lower case
    UPPER_NUC_TO_BITS[_ch] = _i

# char -> complement char, case preserving, full IUPAC ambiguity codes
# (reference nuc_to_complement, dna_utilities.c:100)
NUC_TO_COMPLEMENT = np.arange(256, dtype=np.uint8)
_COMP_PAIRS = (
    b"AT", b"TA", b"CG", b"GC",
    b"BV", b"VB", b"DH", b"HD",  # B=not-A <-> V=not-T, D=not-C <-> H=not-G
    b"KM", b"MK",                # K=G/T <-> M=A/C
    b"RY", b"YR",                # R=A/G <-> Y=C/T
    b"SS", b"WW", b"NN",
)
for _p in _COMP_PAIRS:
    NUC_TO_COMPLEMENT[_p[0]] = _p[1]
    NUC_TO_COMPLEMENT[_p[0] + 32] = _p[1] + 32


def reverse_complement(seq: np.ndarray, comp_map: np.ndarray | None = None) -> np.ndarray:
    """Reverse-complement an ASCII uint8 sequence array."""
    if comp_map is None:
        comp_map = NUC_TO_COMPLEMENT
    return comp_map[seq[::-1]]


def encode_2bit(seq: np.ndarray, charmap: np.ndarray = NUC_TO_BITS) -> np.ndarray:
    """Map ASCII bytes to 2-bit codes; invalid characters become -1."""
    return charmap[seq]
