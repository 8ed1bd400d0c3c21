"""Score sets (substitution matrix + affine gap penalties).

Replicates the observable semantics of the reference's scoreset
(dna_utilities.c:137-560): a 256x256 integer substitution table indexed
directly by ASCII character codes, HOXD70 defaults, the 'masked' copy
that penalizes soft-masked (lower-case) and N bases during the
seeding/HSP stages, and the entropy adjustment applied to marginal
HSP scores (dna_utilities.c:2882-2960).

Score type is int32 (the reference's default build); a float64 variant
(reference lastz_D) is selected with dtype=np.float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .encoding import BITS_TO_NUC

# reference dna_utilities.h:130-139
WORST_POSSIBLE_SCORE = -0x7FFFFFFF - 1
NEG_INFINITY_SCORE = int(0.9 * WORST_POSSIBLE_SCORE)  # -1932735283
VERY_BAD_SCORE = -((NEG_INFINITY_SCORE - WORST_POSSIBLE_SCORE) // 2)  # -107374182

# double-score build ('D', reference lastz_D): score constants derive
# from -FLT_MAX instead of INT32_MIN
FLT_MAX = float(np.finfo(np.float32).max)
WORST_POSSIBLE_SCORE_D = -FLT_MAX
NEG_INFINITY_SCORE_D = 0.9 * WORST_POSSIBLE_SCORE_D
VERY_BAD_SCORE_D = -((NEG_INFINITY_SCORE_D - WORST_POSSIBLE_SCORE_D) / 2)

# process-wide score type, mirroring the reference's compile-time
# scoreType switch ('I' int32 default, 'D' double for lastz_D parity)
SCORE_TYPE = "I"


def set_score_type(t: str):
    global SCORE_TYPE
    SCORE_TYPE = t


def score_dtype():
    return np.float64 if SCORE_TYPE == "D" else np.int64


def worst_possible_score():
    return WORST_POSSIBLE_SCORE_D if SCORE_TYPE == "D" else WORST_POSSIBLE_SCORE


def neg_infinity_score():
    return NEG_INFINITY_SCORE_D if SCORE_TYPE == "D" else NEG_INFINITY_SCORE


def very_bad_score():
    return VERY_BAD_SCORE_D if SCORE_TYPE == "D" else VERY_BAD_SCORE


def score_str(s) -> str:
    """Format a score as the reference's scoreFmtSimple does."""
    if SCORE_TYPE == "D":
        return f"{float(s):f}"
    return str(int(s))


def score_fmt(s) -> str:
    """Format a score as the reference's scoreFmt does ('%d' for int
    builds, '%le' for double builds; dna_utilities.h:105-125).  Used by
    the maf/axt/cigar writers for alignment scores."""
    if SCORE_TYPE == "D":
        return f"{float(s):e}"
    return str(int(s))

# default substitution scores (reference dna_utilities.c:137-148)
HOXD70 = np.array(
    [
        [91, -114, -31, -123],
        [-114, 100, -125, -31],
        [-31, -125, 100, -114],
        [-123, -31, -114, 91],
    ],
    dtype=np.int64,
)
HOXD70_OPEN = 400
HOXD70_EXTEND = 30
HOXD70_X = -1000
HOXD70_FILL = -100

UNIT_SCORES = np.array(
    [[1, -1, -1, -1], [-1, 1, -1, -1], [-1, -1, 1, -1], [-1, -1, -1, 1]],
    dtype=np.int64,
)


@dataclass
class ScoreSet:
    """Substitution scores + gap penalties, indexed by raw ASCII codes."""

    sub: np.ndarray  # (256, 256) int32 or float64
    gap_open: int = HOXD70_OPEN
    gap_extend: int = HOXD70_EXTEND
    row_chars: bytes = b"ACGTacgt"
    col_chars: bytes = b"ACGTacgt"
    bad_row: int = ord("X")
    bad_col: int = ord("X")
    rows_are_dna: bool = True
    cols_are_dna: bool = True
    gap_open_set: bool = False
    gap_extend_set: bool = False
    # quantum column alphabet: complement map from `A~T`-style score
    # file labels (reference scoreset.qToComplement); None if absent
    q_to_complement: np.ndarray | None = field(default=None, repr=False)
    # quantum row (target) alphabet: the 4-symbol bottleneck alphabet and
    # the map from each row char to its closest bottleneck 2-bit code(s)
    # (reference scoreset.bottleneck/qToBest, dna_utilities.c:1253-1345)
    bottleneck: bytes | None = field(default=None, repr=False)
    q_to_best: dict | None = field(default=None, repr=False)
    # derived 4x4 view over upper-case ACGT, used by device kernels
    _dna4: np.ndarray | None = field(default=None, repr=False)

    @property
    def dna4(self) -> np.ndarray:
        if self._dna4 is None:
            idx = np.frombuffer(BITS_TO_NUC, dtype=np.uint8)
            self._dna4 = self.sub[np.ix_(idx, idx)].copy()
        return self._dna4

    def copy(self) -> "ScoreSet":
        return ScoreSet(
            sub=self.sub.copy(),
            gap_open=self.gap_open,
            gap_extend=self.gap_extend,
            row_chars=self.row_chars,
            col_chars=self.col_chars,
            bad_row=self.bad_row,
            bad_col=self.bad_col,
            rows_are_dna=self.rows_are_dna,
            cols_are_dna=self.cols_are_dna,
            gap_open_set=self.gap_open_set,
            gap_extend_set=self.gap_extend_set,
            q_to_complement=self.q_to_complement,
            bottleneck=self.bottleneck,
            q_to_best=(dict(self.q_to_best)
                       if self.q_to_best is not None else None),
        )


def new_dna_score_set(
    template: np.ndarray | None = None,
    bad_score: int = HOXD70_X,
    fill_score: int = HOXD70_FILL,
    gap_open: int = HOXD70_OPEN,
    gap_extend: int = HOXD70_EXTEND,
    dtype=None,
) -> ScoreSet:
    """Build a DNA score set (reference new_dna_score_set, dna_utilities.c:206).

    Layout of the 256x256 table:
      * row/column 0 (NUL, the partition separator): VERY_BAD_SCORE
      * rows/columns for 'X'/'x': bad_score
      * every other non-ACGT pairing: fill_score
      * ACGT x ACGT (both cases): the 4x4 template
    """
    if template is None:
        template = HOXD70
    if dtype is None:
        dtype = score_dtype()
    vbad = VERY_BAD_SCORE_D if dtype == np.float64 else VERY_BAD_SCORE
    sub = np.full((256, 256), fill_score, dtype=dtype)
    sub[0, :] = vbad
    sub[:, 0] = vbad
    # note: the X rows/columns deliberately cover index 0 too, matching the
    # reference fill order (dna_utilities.c:283-291)
    for xc in (ord("X"), ord("x")):
        sub[xc, :] = bad_score
        sub[:, xc] = bad_score
    for r in range(4):
        for c in range(4):
            ru, cu = BITS_TO_NUC[r], BITS_TO_NUC[c]
            for rr in (ru, ru + 32):
                for cc in (cu, cu + 32):
                    sub[rr, cc] = template[r, c]
    return ScoreSet(sub=sub, gap_open=gap_open, gap_extend=gap_extend)


def masked_score_set(ss: ScoreSet) -> ScoreSet:
    """Copy of a score set with soft-masked letters scored badly.

    Mirrors reference masked_score_set (dna_utilities.c:497-560): every
    lower-case DNA row/column, plus 'N'/'n'/'X', is filled with the
    score of (good row x bad column) — i.e. the X score — except the
    NUL row/column keeps VERY_BAD_SCORE.
    """
    new = ss.copy()
    good_row = ss.row_chars[0]
    bad = ss.sub[good_row, ss.bad_col]
    if ss.rows_are_dna:
        new.row_chars = bytes(c for c in ss.row_chars if 65 <= c <= 90)
        n_is_row = ord("N") in new.row_chars
        for r in ss.row_chars:
            if not (65 <= r <= 90):
                new.sub[r, 1:] = bad
        if not n_is_row:
            new.sub[ord("N"), 1:] = bad
        new.sub[ord("n"), 1:] = bad
        new.sub[ord("X"), 1:] = bad
    if ss.cols_are_dna:
        new.col_chars = bytes(c for c in ss.col_chars if 65 <= c <= 90)
        n_is_col = ord("N") in new.col_chars
        for c in ss.col_chars:
            if not (65 <= c <= 90):
                new.sub[1:, c] = bad
        if not n_is_col:
            new.sub[1:, ord("N")] = bad
        new.sub[1:, ord("n")] = bad
        new.sub[1:, ord("X")] = bad
    new._dna4 = None
    return new


def scale_score_set(ss: ScoreSet, scale: float):
    """Multiply every substitution score (reference scale_score_set,
    dna_utilities.c:1924)."""
    ss.sub *= scale
    ss._dna4 = None


def round_score(v: float) -> int:
    """reference round_score (dna_utilities.c:1953): round half away
    from zero."""
    return int(v + 0.5) if v >= 0 else int(v - 0.5)


def write_score_set(f, ss: ScoreSet, with_gap_scores: bool = True,
                    as_ints: bool = False):
    """Write a score set as a LASTZ score file (reference
    private_write_score_set, dna_utilities.c; used by --infer)."""
    def fmt(v):
        if as_ints:
            return "%d" % round_score(float(v))
        if SCORE_TYPE == "D":
            return "%.6f" % float(v)
        return "%d" % int(v)

    def fmt_star(v, w):
        s = fmt(v)
        return "%*s" % (w, s)

    rows = [c for c in ss.row_chars if 65 <= c <= 90] \
        if ss.rows_are_dna else list(ss.row_chars)
    cols = [c for c in ss.col_chars if 65 <= c <= 90] \
        if ss.cols_are_dna else list(ss.col_chars)

    min_sub = min(float(ss.sub[r, c])
                  for r in ss.row_chars for c in ss.col_chars)

    v_width = 18 if with_gap_scores else 10
    f.write('# (a LASTZ scoring set, created by "LASTZ --infer")\n\n')
    f.write("%-*s = %c:%s # used for sub[%c][*] and sub[*][%c]\n"
            % (v_width, "bad_score", ss.bad_row, fmt(10 * min_sub),
               ss.bad_row, ss.bad_row))
    f.write("%-*s = %s    # used when sub[*][*] not otherwise defined\n"
            % (v_width, "fill_score", fmt(min_sub)))
    if with_gap_scores:
        f.write("%-*s = %s\n" % (v_width, "gap_open_penalty",
                                 fmt(ss.gap_open)))
        f.write("%-*s = %s\n" % (v_width, "gap_extend_penalty",
                                 fmt(ss.gap_extend)))
    f.write("\n")

    w = 3
    for r in rows:
        for c in cols:
            w = max(w, len(fmt(ss.sub[r, c])) + 1)
    f.write(" " + "".join(" %*c" % (w, c) for c in cols) + "\n")
    for r in rows:
        f.write(chr(r)
                + "".join(" " + fmt_star(ss.sub[r, c], w) for c in cols)
                + "\n")


def _parse_char_code(label: str):
    """Parse a score-file row/column label: a single character or a
    two-hex-digit code, with an optional ~complement suffix (reference
    parse_char_code_common, dna_utilities.c:1374).  Returns (code,
    comp_code_or_0)."""
    def one(s):
        if len(s) == 2 and all(ch in "0123456789abcdefABCDEF" for ch in s):
            v = int(s, 16)
            if v == 0:
                raise ValueError(f"character code 00 not allowed: {s}")
            return v
        if len(s) == 1:
            return ord(s)
        raise ValueError(f"invalid character code: {s}")

    if "~" in label:
        a, b = label.split("~", 1)
        return one(a), one(b)
    return one(label), 0


def _is_dna_alphabet(chars) -> bool:
    """reference is_dna_alphabet (dna_utilities.c:1437)."""
    s = set(chars)
    acgt = {ord("A"), ord("C"), ord("G"), ord("T")}
    if len(chars) == 4:
        return s == acgt
    if len(chars) == 5:
        return s == acgt | {ord("N")}
    if len(chars) == 8:
        return s == acgt | {ord("a"), ord("c"), ord("g"), ord("t")}
    return False


def read_score_file(path: str) -> dict:
    """Parse a blastz/lastz score file (reference read_score_set,
    dna_utilities.c:657+): leading `name=value` assignments, then a
    column-header line and one score row per row character.  Labels
    may be single characters or two-hex-digit codes; column labels may
    carry `~` complement pairing (quantum alphabets).

    Returns a dict with a 'scoring' ScoreSet plus any of the optional
    assignment values that were present (hsp_threshold, x_drop, ...).
    """
    bad_score = -1000  # blastz defaults (dna_utilities.c:692-693)
    fill_score = -100
    bad_row = bad_col = -1
    gap_open = HOXD70_OPEN
    gap_extend = HOXD70_EXTEND
    extras: dict = {}

    lines = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            lines.append(line)

    ix = 0
    while ix < len(lines) and "=" in lines[ix]:
        key, val = lines[ix].split("=", 1)
        key = key.strip().lower()
        val = val.strip()
        ix += 1
        if key in ("gap_open_penalty", "gap_open", "o"):
            gap_open = int(float(val))
            extras["gap_open_set"] = True
        elif key in ("gap_extend_penalty", "gap_extend", "e"):
            gap_extend = int(float(val))
            extras["gap_extend_set"] = True
        elif key in ("bad", "bad_score"):
            # [<row>[:<col>]:]<score> (dna_utilities.c:753-782)
            parts = val.split(":")
            if len(parts) == 1:
                bad_score = int(float(parts[0]))
            elif len(parts) == 2:
                bad_row = bad_col = _parse_char_code(parts[0])[0]
                bad_score = int(float(parts[1]))
            else:
                bad_col = _parse_char_code(parts[0])[0] if parts[0] else -1
                bad_row = _parse_char_code(parts[1])[0] if parts[1] else -1
                bad_score = int(float(parts[2]))
        elif key in ("fill", "fill_score"):
            fill_score = int(float(val))
        elif key in ("hsp_threshold", "k"):
            extras["hsp_threshold"] = int(float(val))
        elif key in ("gapped_threshold", "l"):
            extras["gapped_threshold"] = int(float(val))
        elif key in ("x_drop", "x"):
            extras["x_drop"] = int(float(val))
        elif key in ("y_drop", "y"):
            extras["y_drop"] = int(float(val))
        elif key in ("step", "z"):
            extras["step"] = int(val)
        elif key in ("seed",):
            extras["seed"] = val
        elif key in ("ball",):
            # quantum seeding threshold: absolute score or % of max
            if val.endswith("%"):
                extras["ball_factor"] = float(val[:-1]) / 100.0
            else:
                extras["ball"] = int(float(val))
        elif key in ("bottleneck",):
            extras["bottleneck"] = val

    if ix >= len(lines):
        raise ValueError(f"score file {path} has no score matrix")

    col_labels = lines[ix].split()
    ix += 1
    col_chars = []
    col_comps = {}
    have_comps = None
    for lab in col_labels:
        c, comp = _parse_char_code(lab)
        if have_comps is None:
            have_comps = comp != 0
        elif have_comps != (comp != 0):
            raise ValueError(f"missing complement(s) in {path}")
        col_chars.append(c)
        if comp:
            col_comps[c] = comp
    if have_comps:
        for c, comp in col_comps.items():
            if comp not in col_comps or col_comps[comp] != c:
                raise ValueError(
                    f"complement pairing is not symmetric in {path}")

    dtype = score_dtype()
    sub = np.full((256, 256), fill_score, dtype=dtype)
    row_chars = []
    row_seen = 0
    num_fields = None
    while ix < len(lines):
        fields = lines[ix].split()
        ix += 1
        if num_fields is None:
            if len(fields) not in (len(col_chars), len(col_chars) + 1):
                raise ValueError(f"wrong number of score columns in {path}")
            num_fields = len(fields)
        elif len(fields) != num_fields:
            raise ValueError(
                f"inconsistent number of score columns in {path}")
        if num_fields == len(col_chars) + 1:
            r = _parse_char_code(fields[0])[0]
            scores = fields[1:]
        else:
            if row_seen >= len(col_chars):
                raise ValueError(f"too many score rows in {path}")
            r = col_chars[row_seen]
            scores = fields
        row_seen += 1
        row_chars.append(r)
        for c, sval in zip(col_chars, scores):
            sub[r, c] = float(sval) if SCORE_TYPE == "D" else int(float(sval))

    cols_are_dna = _is_dna_alphabet(col_chars)
    rows_are_dna = _is_dna_alphabet(row_chars)

    # case-fold DNA alphabets (dna_utilities.c:1176-1225)
    if cols_are_dna:
        if bad_col < 0:
            bad_col = ord("X")
        for c in list(col_chars):
            if 65 <= c <= 90:
                for r in row_chars:
                    sub[r, c + 32] = sub[r, c]
        for c in list(col_chars):
            low = c + 32 if 65 <= c <= 90 else c
            if low not in col_chars:
                col_chars.append(low)
    if rows_are_dna:
        if bad_row < 0:
            bad_row = ord("X")
        for r in list(row_chars):
            if 65 <= r <= 90:
                sub[r + 32, :] = sub[r, :]
        for r in list(row_chars):
            low = r + 32 if 65 <= r <= 90 else r
            if low not in row_chars:
                row_chars.append(low)

    if bad_col == -1:
        bad_col = 0
    if bad_row == -1:
        bad_row = 0
    sub[bad_row, :] = bad_score
    sub[:, bad_col] = bad_score
    vbad = very_bad_score()
    sub[0, :] = vbad
    sub[:, 0] = vbad

    q_to_complement = None
    if have_comps:
        q_to_complement = np.arange(256, dtype=np.uint8)
        for c, comp in col_comps.items():
            q_to_complement[c] = comp

    ss = ScoreSet(
        sub=sub, gap_open=gap_open, gap_extend=gap_extend,
        row_chars=bytes(row_chars), col_chars=bytes(col_chars),
        bad_row=bad_row, bad_col=bad_col,
        rows_are_dna=rows_are_dna, cols_are_dna=cols_are_dna,
        gap_open_set=extras.get("gap_open_set", False),
        gap_extend_set=extras.get("gap_extend_set", False),
    )
    ss.q_to_complement = q_to_complement
    _resolve_bottleneck(ss, extras.pop("bottleneck", None), path)
    extras["scoring"] = ss
    return extras


def _parse_bottleneck(s: str):
    """reference parse_bottleneck (dna_utilities.c:1475-1510): four
    symbols separated by whitespace; adjacent characters are only legal
    as a two-digit hex code.  Returns the 4 char codes or None."""
    out = []
    i = 0
    for _ in range(4):
        if i >= len(s):
            return None
        cc = s[i]
        i += 1
        follower = s[i] if i < len(s) else ""
        if follower and not follower.isspace():
            i += 1
            if cc in "0123456789abcdefABCDEF" \
                    and follower in "0123456789abcdefABCDEF":
                code = int(cc + follower, 16)
            else:
                return None
            if code == 0:
                return None
            out.append(code)
        else:
            out.append(ord(cc))
        while i < len(s) and s[i].isspace():
            i += 1
    if i < len(s):
        return None
    return out


def _resolve_bottleneck(ss: ScoreSet, bottleneck_str, name):
    """Validate/default the bottleneck alphabet and derive qToBest
    (reference read_score_set, dna_utilities.c:1253-1345)."""
    ss.bottleneck = None
    ss.q_to_best = None
    bn = None
    if bottleneck_str is not None:
        bn = _parse_bottleneck(bottleneck_str)
        if bn is None:
            raise SystemExit(
                "FAILURE: invalid bottleneck alphabet, bottleneck=%s"
                % bottleneck_str)
    if bn is not None and ss.rows_are_dna:
        raise SystemExit(
            "FAILURE: invalid bottleneck alphabet (%s in %s), rows are DNA"
            % (bottleneck_str, name))
    if bn is not None and ss.cols_are_dna and bytes(bn) != b"ACGT":
        raise SystemExit(
            "FAILURE: invalid bottleneck alphabet (%s in %s), columns"
            " are DNA" % (bottleneck_str, name))
    if bn is None and not ss.rows_are_dna and ss.cols_are_dna:
        bn = [ord(c) for c in "ACGT"]
    if bn is None and not ss.rows_are_dna and not ss.cols_are_dna:
        raise SystemExit(
            "FAILURE: missing bottleneck alphabet (in %s)" % name)
    if bn is None:
        return
    for c in bn:
        if c not in ss.col_chars:
            raise SystemExit(
                "FAILURE: invalid bottleneck alphabet (%s in %s), not"
                " contained in column alphabet" % (bottleneck_str, name))
    ss.bottleneck = bytes(bn)
    q_to_best = {}
    for r in ss.row_chars:
        best_bits = []
        best = None
        for bits in range(4):
            this = ss.sub[r, bn[bits]]
            if best is None or this > best:
                best_bits = [bits]
                best = this
            elif this == best:
                best_bits.append(bits)
        q_to_best[r] = best_bits
    ss.q_to_best = q_to_best


def ambiguate_n(ss: ScoreSet, n_vs_n: int, n_vs_non_n: int):
    """Score N as an ambiguous base (reference ambiguate_n)."""
    sub = ss.sub
    for r in (ord("N"), ord("n")):
        for c in (ord("N"), ord("n")):
            sub[r, c] = n_vs_n
    if ss.cols_are_dna:
        for ch in ss.row_chars:
            if ch == ord("N"):
                continue
            lo = ch + 32 if 65 <= ch <= 90 else ch
            for c in (ord("N"), ord("n")):
                sub[ch, c] = n_vs_non_n
                sub[lo, c] = n_vs_non_n
    if ss.rows_are_dna:
        for ch in ss.col_chars:
            if ch == ord("N"):
                continue
            lo = ch + 32 if 65 <= ch <= 90 else ch
            for r in (ord("N"), ord("n")):
                sub[r, ch] = n_vs_non_n
                sub[r, lo] = n_vs_non_n
    ss._dna4 = None


_AMBIGGIES = b"NnBDHKMRSVWYbdhkmrsvwy"


def ambiguate_iupac(ss: ScoreSet, n_vs_n: int, n_vs_non_n: int):
    """Score all IUPAC ambiguity codes (reference ambiguate_iupac)."""
    sub = ss.sub

    def low(c):
        return c + 32 if 65 <= c <= 90 else c

    for r in _AMBIGGIES:
        for c in _AMBIGGIES:
            sub[r, c] = n_vs_n if low(r) == low(c) else n_vs_non_n
    if ss.rows_are_dna:
        for ch in ss.row_chars:
            for c in _AMBIGGIES:
                if ch == ord("N") and c in (ord("N"), ord("n")):
                    continue
                sub[ch, c] = n_vs_non_n
                sub[low(ch), c] = n_vs_non_n
    if ss.cols_are_dna:
        for ch in ss.col_chars:
            for r in _AMBIGGIES:
                if ch == ord("N") and r in (ord("N"), ord("n")):
                    continue
                sub[r, ch] = n_vs_non_n
                sub[r, low(ch)] = n_vs_non_n
    ss._dna4 = None


def entropy(s: np.ndarray, t: np.ndarray) -> float:
    """Entropy of an ungapped alignment (reference dna_utilities.c:2882).

    Counts positions where the two ASCII characters are equal AND are
    upper-case A/C/G/T; if fewer than 20 such matches, returns 1.0.
    Otherwise the normalized Shannon entropy (base 4) of the matched-
    base composition, with probabilities divided by the full alignment
    length (not the match count).
    """
    eq = s == t
    counts = [int(np.count_nonzero(eq & (s == ch))) for ch in BITS_TO_NUC]
    return entropy_from_counts(counts, len(s))


def entropy_from_counts(counts, length: int) -> float:
    """`entropy` of an alignment of `length` columns whose matched
    upper-case A, C, G, T number `counts` (four ints): the one scalar
    formula, shared by `entropy` and the seed stage's array replay
    (search/device_hits.py), so both give the same float to the bit."""
    if sum(counts) < 20:
        return 1.0
    acc = 0.0
    for c in counts:
        if c != 0:
            p = c / length
            acc += p * math.log(p)
    return -acc / math.log(4.0)
