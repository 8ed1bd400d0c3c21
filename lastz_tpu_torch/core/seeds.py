"""Spaced-seed patterns and packing.

Re-implements the observable semantics of the reference seed machinery
(seeds.c:299-640, seeds.h:37-88): a pattern over {1, 0/x, T} is reduced
to a packing function that extracts, from a 2-bits-per-base window, the
bits relevant to the seed:

  * '1' (match) positions contribute both bits,
  * 'T' (transition-tolerant) positions contribute only the low
    (pyrimidine) bit, which is invariant under transitions,
  * '0'/'x' (don't care) positions contribute nothing.

Half-weight seeds (only T/0) operate on 1 bit per base.  Overweight
seeds (weight > max_index_bits) demote the high bits of trailing match
positions to "resolving bits" that are checked against the actual
sequences at probe time rather than being part of the table index.

Packing order matches the reference exactly (leftmost pattern position
occupies the most significant packed bits; transition-flip probe masks
are enumerated from the least significant packed bit upward,
seeds.c:601-627) because probe order is observable in hit order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SEED_12OF19 = "1110100110010101111"
SEED_14OF22 = "1110101100110010101111"

MAX_SEED_LEN = 31
MAX_HW_SEED_LEN = 63
MAX_SEED_BIT_WEIGHT = 31
MAX_RESOLVED_BITS = 16


@dataclass
class Seed:
    type: str  # 'S' strict, 'H' half-weight, 'R' overweight, '_' mixed
    length: int  # span in bases (after trimming don't-care ends)
    weight: int  # packed index weight in bits
    pattern: str  # trimmed pattern string over {1,0,T}
    is_halfweight: bool
    with_trans: int = 0  # 0/1/2 transitions allowed in match positions
    resolving_mask: int = 0  # unpacked-space mask of demoted bits
    rev_comp: bool = False
    # (src_bit, dst_bit) pairs: packed |= ((window >> src) & 1) << dst
    bit_map: tuple = field(default_factory=tuple)
    # packed-space single-bit masks for transition flips, LSB-first
    trans_flips: tuple = field(default_factory=tuple)
    # resolving positions: (src_bit in unpacked window) of each demoted
    # high bit, used to re-check overweight seeds against the sequence
    resolve_bits: tuple = field(default_factory=tuple)

    @property
    def bits_per_base(self) -> int:
        return 1 if self.is_halfweight else 2

    def pack(self, windows: np.ndarray) -> np.ndarray:
        """Pack 2-bit (or 1-bit) windows into seed-index words.

        windows: uint64 array, each holding `length` bases, last base in
        the least significant bits.  Vectorized over any shape.
        """
        w = windows.astype(np.uint64)
        if self.rev_comp:
            w = np.minimum(w, self._rc_words(w))
        packed = np.zeros_like(w, dtype=np.uint64)
        for src, dst in self.bit_map:
            packed |= ((w >> np.uint64(src)) & np.uint64(1)) << np.uint64(dst)
        return packed.astype(np.uint32)

    def pack_resolve(self, windows: np.ndarray) -> np.ndarray:
        """Pack the demoted (resolving) bits of each window into a
        compact word for overweight-seed verification."""
        w = windows.astype(np.uint64)
        packed = np.zeros_like(w, dtype=np.uint64)
        for i, src in enumerate(self.resolve_bits):
            packed |= ((w >> np.uint64(src)) & np.uint64(1)) << np.uint64(i)
        return packed.astype(np.uint32)

    def _rc_words(self, w: np.ndarray) -> np.ndarray:
        n = self.length
        out = np.zeros_like(w)
        if self.is_halfweight:
            # reverse of the R/Y bits; complement leaves R/Y unchanged?
            # No: complement flips purine<->pyrimidine, i.e. flips the bit.
            for i in range(n):
                bit = (w >> np.uint64(i)) & np.uint64(1)
                out |= (bit ^ np.uint64(1)) << np.uint64(n - 1 - i)
        else:
            for i in range(n):
                pair = (w >> np.uint64(2 * i)) & np.uint64(3)
                out |= (pair ^ np.uint64(3)) << np.uint64(2 * (n - 1 - i))
        return out


def parse_seed(
    s: str,
    max_index_bits: int = 28,
    transitions_ok: bool = True,
    with_trans: int = 0,
) -> Seed:
    """Parse one seed pattern string (reference parse_one_seed, seeds.c:322)."""
    if max_index_bits > MAX_SEED_BIT_WEIGHT:
        raise ValueError(f"max index bits cannot exceed {MAX_SEED_BIT_WEIGHT}")

    txt = [c for c in s if c not in " \t\n"]
    for c in txt:
        if c not in "10xXtT":
            raise ValueError(f"seed string {s} contains illegal character {c}")
        if c in "tT" and not transitions_ok:
            raise ValueError(f"seed string {s} may not contain transitions")

    # trim don't-care ends
    def is_dc(c):
        return c in "0xX"

    lo, hi = 0, len(txt) - 1
    while lo < len(txt) and is_dc(txt[lo]):
        lo += 1
    if lo >= len(txt):
        raise ValueError("seed string is empty")
    while is_dc(txt[hi]):
        hi -= 1
    txt = txt[lo : hi + 1]

    matches = sum(1 for c in txt if c == "1")
    num_t = sum(1 for c in txt if c in "tT")
    is_strict = num_t == 0
    is_halfweight = matches == 0
    weight = 2 * matches + num_t
    stype = "S" if is_strict else ("H" if is_halfweight else "_")

    matches_to_keep = matches
    if max_index_bits > 0 and weight > max_index_bits:
        to_resolve = weight - max_index_bits
        if to_resolve > matches:
            raise ValueError("seed requires more resolving bits than matches")
        if to_resolve > MAX_RESOLVED_BITS:
            raise ValueError("seed requires too many resolving bits")
        stype = "R"
        matches_to_keep -= to_resolve

    length = len(txt)
    if is_halfweight:
        if length > MAX_HW_SEED_LEN:
            raise ValueError("half-weight seed too long")
    elif length > MAX_SEED_LEN:
        raise ValueError("seed too long")
    if weight > MAX_SEED_BIT_WEIGHT:
        raise ValueError("seed bit weight too large")
    if weight == 0:
        raise ValueError("seed cannot have zero weight")

    bits_per = 1 if is_halfweight else 2
    pattern = []
    kept: list[tuple[int, str]] = []  # (pattern index, kind)
    resolve_srcs: list[int] = []
    resolving_mask = 0
    seen_matches = 0
    eff_weight = 0  # packed index weight after demotion
    for i, c in enumerate(txt):
        # source bit positions of this base in the unpacked window:
        # low bit at bits_per*(length-1-i)
        low_src = bits_per * (length - 1 - i)
        if c == "1":
            if seen_matches >= matches_to_keep:
                # overweight: keep low bit in index, demote high bit
                # (the reference also records these as 'T' in the
                # pattern string, seeds.c:458-487)
                kept.append((i, "low"))
                resolve_srcs.append(low_src + 1)
                resolving_mask |= 2 << low_src
                eff_weight += 1
                pattern.append("T")
            else:
                kept.append((i, "pair"))
                eff_weight += 2
                pattern.append("1")
            seen_matches += 1
        elif c in "tT":
            kept.append((i, "low"))
            eff_weight += 1
            pattern.append("T")
        else:  # '0'/'x'/'X'
            pattern.append("0")

    # assign packed destination bits with the reference's greedy
    # masked-shift covering (seeds.c:540-551 + best_shift :1399): take
    # whichever shift covers the most uncovered packed bits, repeat.
    # This reproduces the reference's packed word VALUES, which are
    # observable in --tableonly dumps.
    seed_bits = 0  # unpacked-space mask of index bits
    pair_low_srcs = []
    for i, kind in kept:
        low_src = bits_per * (length - 1 - i)
        if kind == "pair":
            seed_bits |= 3 << low_src
            pair_low_srcs.append(low_src)
        else:
            seed_bits |= 1 << low_src

    w_bits = (1 << eff_weight) - 1
    # first masked-shift is always shift-zero: index bits already in
    # the low `weight` positions stay put (seeds.c:578-583)
    covered = seed_bits & w_bits
    rem = seed_bits - covered
    src_to_dst = {}
    m = covered
    while m:
        low = m & -m
        b = low.bit_length() - 1
        src_to_dst[b] = b
        m -= low
    while covered != w_bits:
        uncovered = (~covered) & w_bits
        best_cov, best_shift = -1, -1
        sb, shift = rem, 0
        while sb:
            cov = bin(sb & uncovered).count("1")
            if cov > best_cov:
                best_cov, best_shift = cov, shift
            sb >>= 1
            shift += 1
        mask = (rem >> best_shift) & uncovered
        covered += mask
        rem -= mask << best_shift
        m = mask
        while m:
            low = m & -m
            dst_bit = low.bit_length() - 1
            src_to_dst[dst_bit + best_shift] = dst_bit
            m -= low

    bit_map = sorted(((src, dst) for src, dst in src_to_dst.items()),
                     key=lambda p: -p[0])
    # packed dst of each match position's high bit => transition flips
    flip_bits = [src_to_dst[s + 1] for s in pair_low_srcs]

    # transition flips enumerate from the least significant packed bit
    # upward (seeds.c:614-626, the non-maintainFlippedBitOrder branch)
    trans_flips = tuple(1 << b for b in sorted(flip_bits))

    return Seed(
        type=stype,
        length=length,
        weight=eff_weight if stype == "R" else weight,
        pattern="".join(pattern),
        is_halfweight=is_halfweight,
        with_trans=with_trans,
        resolving_mask=resolving_mask,
        bit_map=tuple(bit_map),
        trans_flips=trans_flips,
        resolve_bits=tuple(resolve_srcs),
    )


def seed_pattern_string(seed: Seed) -> str:
    """Render the seed as in reference seed_pattern (seeds.c): the
    implemented pattern over 1/T/0, plus '/RRR..' resolving-bit suffix
    for overweight seeds."""
    out = seed.pattern
    if seed.type == "R" and seed.resolving_mask:
        loc = 0
        while loc < 16 and (seed.resolving_mask >> (2 * loc)) != 0:
            loc += 1
        if loc > 0:
            out += "/"
            for k in range(loc - 1, -1, -1):
                bits = (seed.resolving_mask >> (2 * k)) & 3
                out += {3: "?", 2: "R", 1: "?", 0: "0"}[bits]
    return out


def match_seed(word_len: int) -> str:
    """Exact-match seed of `word_len` consecutive 1s (reference W= option)."""
    if not (1 <= word_len <= 15):
        raise ValueError(f"{word_len} is not a valid word length")
    return "1" * word_len


def packed_to_string(seed: Seed, word: int) -> str:
    """Render a packed seed word as its unpacked base string, 'x' at
    don't-care positions, R/Y at half-known (transition) positions
    (reference seed_packed_to_string, seeds.c:1216)."""
    unpacked_word = 0
    unpacked_seed = 0
    for src, dst in seed.bit_map:
        unpacked_word |= ((word >> dst) & 1) << src
        unpacked_seed |= 1 << src
    bits_per = 1 if seed.is_halfweight else 2
    mask = 1 if seed.is_halfweight else 3
    out = []
    for k in range(seed.length - 1, -1, -1):
        wbits = (unpacked_word >> (bits_per * k)) & mask
        sbits = (unpacked_seed >> (bits_per * k)) & mask
        if sbits == 0:
            out.append("x")
        elif sbits == 1:
            out.append("RY"[wbits] if wbits < 2 else "?")
        elif sbits == 2:
            out.append("?")
        else:
            out.append("ACGT"[wbits])
    return "".join(out)
