"""--format=comp (HSP composition) and --format=deseed
(reference output.c:1458-1546, seed_search.c:3851)."""

from __future__ import annotations

import numpy as np

from ..core.encoding import NUC_TO_BITS, UPPER_NUC_TO_BITS
from .lav import percent_identical


def match_composition(v1, pos1, v2, pos2, length):
    """4x4 pair counts over UPPER-case DNA only (reference
    match_composition, sequences.c:9572 -- soft-masked bases are
    excluded here, unlike percent_identical)."""
    count = np.zeros((4, 4), dtype=np.int64)
    b1 = UPPER_NUC_TO_BITS[v1[pos1 : pos1 + length]]
    b2 = UPPER_NUC_TO_BITS[v2[pos2 : pos2 + length]]
    ok = (b1 >= 0) & (b2 >= 0)
    np.add.at(count, (b1[ok], b2[ok]), 1)
    return count


def discovery_probability(v1, pos1, v2, pos2, length, seed, step):
    """Probability that this match would be discovered by the
    (seed, step) search (reference discovery_probability,
    seed_search.c:3851): the fraction of the `step` positional shifts
    for which at least one seed hit lands on a step multiple."""
    a_start = pos1 - length
    b_start = pos2 - length
    L = seed.length

    # unpacked-space mask: high bit of every match ('1') position;
    # used to classify diffs as transitions vs transversions
    trans_mask = 0
    for k, ch in enumerate(seed.pattern):
        if ch == "1":
            trans_mask |= 1 << (2 * (L - 1 - k) + 1)

    folded = [False] * step
    found = 0
    a_un = b_un = 0
    run = 0  # columns accumulated since last ambiguous base
    for ix in range(length):
        aa = int(NUC_TO_BITS[v1[a_start + ix]])
        bb = int(NUC_TO_BITS[v2[b_start + ix]])
        if aa < 0 or bb < 0:
            run = 0
            continue
        a_un = ((a_un << 2) | aa) & ((1 << (2 * L)) - 1)
        b_un = ((b_un << 2) | bb) & ((1 << (2 * L)) - 1)
        run += 1
        if run < L:
            continue
        hit = False
        if int(seed.pack(np.array([a_un], dtype=np.uint64))[0]) \
                == int(seed.pack(np.array([b_un], dtype=np.uint64))[0]):
            hit = True
        elif seed.with_trans:
            # the reference stores these masks in a u32 (seed_search.c
            # :3866 'u32 ... trans'), silently ignoring diffs beyond the
            # low 16 bases of the window -- observable behavior, kept
            diff = a_un ^ b_un
            if (diff << 1) & trans_mask & 0xFFFFFFFF:
                hit = False  # transversion at a match position
            else:
                trans = diff & ~(diff << 1) & trans_mask & 0xFFFFFFFF
                hit = bin(trans).count("1") <= seed.with_trans
        if hit:
            i = (ix + 1 - L) % step
            if not folded[i]:
                folded[i] = True
                found += 1
    return found / step


def comp_match(seq1, pos1, seq2, pos2, length, s, seed, step) -> str:
    """reference print_match_composition (output.c:1458): pctid,
    score, positions/strands, length, discovery probability, and the
    16 pair counts."""
    pct = percent_identical(seq1.v, pos1, seq2.v, pos2, length)
    count = match_composition(seq1.v, pos1, seq2.v, pos2, length)
    p = discovery_probability(seq1.v, pos1 + length, seq2.v, pos2 + length,
                              length, seed, step)
    p = min(max(p, 0.0), 1.0)
    pstr = f"{p:.3f}"
    if pstr.startswith("1"):
        pstr = pstr[:4]  # 1.000 -> 1.00
    else:
        pstr = pstr[1:]  # 0.XXX -> .XXX
    strand1 = "-" if (seq1.rev_comp_flags & 2) else "+"  # rcf_rev bit
    strand2 = "-" if (seq2.rev_comp_flags & 2) else "+"
    fields = [f"{pct} {s} {pos1 + 1}{strand1}/{pos2 + 1}{strand2}"
              f" {length} {pstr}"]
    for ix in range(4):
        for iy in range(4):
            fields.append(f" {count[ix, iy]}")
    return "".join(fields) + "\n"


def deseed_match(seq1, pos1, seq2, pos2, length) -> str:
    """reference dump_match (output.c:1534) + trailing blank line."""
    return (seq1.v[pos1 : pos1 + length].tobytes().decode("latin-1") + "\n"
            + seq2.v[pos2 : pos2 + length].tobytes().decode("latin-1")
            + "\n\n")
