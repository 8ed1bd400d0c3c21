"""Scoring inference (reference infer_scores.c).

Iteratively aligns target vs queries, tallies substitution/gap
statistics from the resulting alignments, and regenerates log-odds
score sets until convergence (Chiaromonte/Yap/Miller 2002).  Mirrors
`drive_scoring_inference` (infer_scores.c:259): phase I iterates
substitution scores over ungapped alignments (C=3 mode); phase II
derives gap penalties (gap-score *iteration* is blocked, exactly as in
the reference, infer_scores.c:287-292), then the final score set is
written as a LASTZ score file (`write_scores`, infer_scores.c:1373).

Only double-score arithmetic is supported, as in the reference
(lastz_D); integer mode refuses with the reference's message.
"""

from __future__ import annotations

import copy
import math
import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .config import Config, ScoreThreshold
from .core.encoding import NUC_TO_BITS
from .core.scoring import (
    ScoreSet, new_dna_score_set, masked_score_set, scale_score_set,
    write_score_set, worst_possible_score, set_score_type,
)

# reference infer_scores.c:60-68
MAX_SUB_ITERATIONS = 30
MAX_GAP_ITERATIONS = 30
SUB_CLOSE_ENOUGH = 0.000001   # double build
GAP_CLOSE_ENOUGH = 0.0001

# reference identity_dist.h:40-58
NUM_IDENTITY_BINS = 1000

# reference dna_utilities.c:150-162 (unit scores used to bootstrap
# inference; open/extend are RATIOS vs the worst substitution)
UNIT_SCORES = np.array(
    [[1, -1, -1, -1], [-1, 1, -1, -1], [-1, -1, 1, -1], [-1, -1, -1, 1]],
    dtype=np.float64)
UNIT_SCORES_OPEN = 3.25       # 400/123
UNIT_SCORES_EXTEND = 0.24375  # 30/123
UNIT_SCORES_X = -10.0
UNIT_SCORES_FILL = -1.0

BITS_TO_COMPLEMENT = (3, 2, 1, 0)

RATIO_NONE = "none"
RATIO_MAX_SUB = "maxsub"   # value is a multiple of the max substitution score
RATIO_MIN_SUB = "minsub"   # value is a multiple of the (-) min substitution


def identity_bin(numer: int, denom: int) -> int:
    if denom == 0:
        return 0
    return (2 * numer * NUM_IDENTITY_BINS + denom) // (2 * denom)


@dataclass
class InferControl:
    """reference infcontrol (lastz.h) defaults at lastz.c:341-348."""

    infer_filename: Optional[str] = None
    infer_scale: float = 100.0
    write_as_int: bool = True
    hsp_threshold_is_ratio: str = RATIO_NONE
    gapped_threshold_is_ratio: str = RATIO_NONE
    gap_open_is_ratio: str = RATIO_NONE
    gap_extend_is_ratio: str = RATIO_NONE
    sub_iterations: int = 30
    gap_iterations: int = 0
    id_is_percentile: bool = False


class InfStats:
    """One bin of inference statistics (reference infstats)."""

    __slots__ = ("count", "coverage", "ref_bases", "sec_bases",
                 "ref_bkgd", "sec_bkgd", "subs",
                 "ref_blocks", "sec_blocks", "ref_gaps", "sec_gaps",
                 "ref_runs", "sec_runs", "segments")

    def __init__(self):
        self.erase()

    def erase(self):
        self.count = 0
        self.coverage = 0
        self.ref_bases = 0
        self.sec_bases = 0
        self.ref_bkgd = np.zeros(4, dtype=np.int64)
        self.sec_bkgd = np.zeros(4, dtype=np.int64)
        self.subs = np.zeros((4, 4), dtype=np.int64)
        self.ref_blocks = {}
        self.sec_blocks = {}
        self.ref_gaps = {}
        self.sec_gaps = {}
        self.ref_runs = {}
        self.sec_runs = {}
        self.segments = {}


def _add_length(d: dict, length: int, count: int = 1):
    if length == 0:
        return
    d[length] = d.get(length, 0) + count


def _merge_distn(dst: dict, src: dict):
    for length, count in src.items():
        dst[length] = dst.get(length, 0) + count


def _count_substitutions(v1, pos1, v2, pos2, length):
    """reference count_substitutions (identity_dist.c:435): per-pair
    counts over positions where both characters are unambiguous DNA."""
    pair_count = np.zeros((4, 4), dtype=np.int64)
    if length == 0:
        return 0, pair_count
    c1 = NUC_TO_BITS[v1[pos1:pos1 + length]]
    c2 = NUC_TO_BITS[v2[pos2:pos2 + length]]
    valid = (c1 >= 0) & (c2 >= 0)
    if not valid.any():
        return 0, pair_count
    np.add.at(pair_count, (c1[valid], c2[valid]), 1)
    return int(valid.sum()), pair_count


def accumulate_from_match(inf: InfStats, v1, pos1, v2, pos2, length):
    """reference accumulate_stats_from_match (infer_scores.c:1911)."""
    denom, pair_count = _count_substitutions(v1, pos1, v2, pos2, length)
    inf.ref_bases += denom
    inf.sec_bases += denom
    _add_length(inf.ref_blocks, denom)
    _add_length(inf.sec_blocks, denom)
    _add_length(inf.segments, denom)
    inf.ref_bkgd += pair_count.sum(axis=1)
    inf.sec_bkgd += pair_count.sum(axis=0)
    inf.subs += pair_count
    return denom, pair_count


def accumulate_from_align(inf: InfStats, v1, v2, a):
    """reference accumulate_stats_from_align (infer_scores.c:1804)."""
    beg1 = a.beg1  # 1-based inclusive
    beg2 = a.beg2
    height = a.end1 - beg1 + 1
    width = a.end2 - beg2 + 1
    _add_length(inf.ref_blocks, height)
    _add_length(inf.sec_blocks, width)

    pair_count = np.zeros((4, 4), dtype=np.int64)
    ref_run = sec_run = 0
    i = j = 0
    ops = a.script.ops
    op_ix = 0
    while i < height or j < width:
        prev_i, prev_j = i, j
        run = 0
        while op_ix < len(ops) and ops[op_ix][0] == "S":
            run += ops[op_ix][1]
            op_ix += 1
        i += run
        j += run
        ref_run += run
        sec_run += run
        if run > 0:
            d, pc = _count_substitutions(
                v1, beg1 - 1 + prev_i, v2, beg2 - 1 + prev_j, run)
            pair_count += pc
            if d != 0:
                inf.ref_bases += d
                inf.sec_bases += d
                _add_length(inf.segments, d)
        if i < height or j < width:
            prev_i, prev_j = i, j
            if op_ix < len(ops):
                op, rpt = ops[op_ix]
                op_ix += 1
                if op == "I":
                    j += rpt
                else:
                    i += rpt
            if j != prev_j:  # deletion from reference sequence
                indel_len = j - prev_j
                _add_length(inf.ref_gaps, indel_len)
                if ref_run > 0:
                    _add_length(inf.ref_runs, ref_run)
                    ref_run = 0
                cc = NUC_TO_BITS[
                    v2[beg2 - 1 + prev_j : beg2 - 1 + prev_j + indel_len]]
                cc = cc[cc >= 0]
                np.add.at(inf.sec_bkgd, cc, 1)
                sec_run += len(cc)
                inf.sec_bases += len(cc)
            if i != prev_i:  # deletion from secondary sequence
                indel_len = i - prev_i
                _add_length(inf.sec_gaps, indel_len)
                if sec_run > 0:
                    _add_length(inf.sec_runs, sec_run)
                    sec_run = 0
                cc = NUC_TO_BITS[
                    v1[beg1 - 1 + prev_i : beg1 - 1 + prev_i + indel_len]]
                cc = cc[cc >= 0]
                np.add.at(inf.ref_bkgd, cc, 1)
                ref_run += len(cc)
                inf.ref_bases += len(cc)
    if ref_run > 0:
        _add_length(inf.ref_runs, ref_run)
    if sec_run > 0:
        _add_length(inf.sec_runs, sec_run)

    inf.ref_bkgd += pair_count.sum(axis=1)
    inf.sec_bkgd += pair_count.sum(axis=0)
    inf.subs += pair_count


class InfStatsCollector:
    """Output 'format' that tallies inference stats instead of printing
    (reference fmtInfScores; gather_stats_from_match/align_list)."""

    def __init__(self):
        self.bins = [InfStats() for _ in range(NUM_IDENTITY_BINS + 1)]

    def erase(self):
        for b in self.bins:
            b.erase()

    # -- gathering -----------------------------------------------------------

    def gather_from_match(self, seq1, pos1, seq2, pos2, length):
        """reference gather_stats_from_match (infer_scores.c:1528)."""
        denom, pair_count = _count_substitutions(
            seq1.v, pos1, seq2.v, pos2, length)
        numer = int(np.trace(pair_count))
        inf = self.bins[identity_bin(numer, denom)]
        inf.count += 1
        inf.coverage += denom
        accumulate_from_match(inf, seq1.v, pos1, seq2.v, pos2, length)

    def gather_from_align(self, seq1, seq2, a):
        """reference gather_stats_from_align_list (infer_scores.c:1478)."""
        numer, denom = _alignment_identity(seq1.v, seq2.v, a)
        inf = self.bins[identity_bin(numer, denom)]
        inf.count += 1
        inf.coverage += denom
        accumulate_from_align(inf, seq1.v, seq2.v, a)

    # -- reduction -----------------------------------------------------------

    def filter_by_percentile(self, min_identity: float, max_identity: float):
        """reference filter_stats_by_percentile (infer_scores.c:1567):
        convert identity percentiles to a coverage budget and discard
        identity bins outside it."""
        covs = [b.coverage for b in self.bins]
        cov_total = sum(covs)
        min_bin = next((i for i, c in enumerate(covs) if c > 0),
                       NUM_IDENTITY_BINS)
        cov_lo = int(cov_total * min_identity + 0.5)
        cov_hi = int(cov_total * max_identity + 0.5)

        remaining = cov_total
        for b in range(NUM_IDENTITY_BINS, -1, -1):
            cov = self.bins[b].coverage
            if cov == 0:
                continue
            self.bins[b].erase()
            remaining -= cov
            if remaining <= cov_hi:
                break
        dropped = 0
        for b in range(min_bin, NUM_IDENTITY_BINS + 1):
            cov = self.bins[b].coverage
            if cov == 0:
                continue
            self.bins[b].erase()
            dropped += cov
            if dropped >= cov_lo:
                break
        if sum(b.coverage for b in self.bins) == 0:
            raise SystemExit(
                "FAILURE: internal error in filter_stats_by_percentile:"
                " no alignments remain after filtering")

    def combined(self, merge_sequences: bool = True) -> InfStats:
        """reference combine_binned_stats (infer_scores.c:1676)."""
        total = InfStats()
        for inf in self.bins:
            if inf.count == 0:
                continue
            total.count += inf.count
            total.coverage += inf.coverage
            total.ref_bases += inf.ref_bases
            total.sec_bases += inf.sec_bases
            total.ref_bkgd += inf.ref_bkgd
            total.sec_bkgd += inf.sec_bkgd
            total.subs += inf.subs
            _merge_distn(total.ref_blocks, inf.ref_blocks)
            _merge_distn(total.ref_gaps, inf.ref_gaps)
            _merge_distn(total.ref_runs, inf.ref_runs)
            _merge_distn(total.segments, inf.segments)
            if merge_sequences:
                _merge_distn(total.ref_blocks, inf.sec_blocks)
                _merge_distn(total.ref_gaps, inf.sec_gaps)
                _merge_distn(total.ref_runs, inf.sec_runs)
            else:
                _merge_distn(total.sec_blocks, inf.sec_blocks)
                _merge_distn(total.sec_gaps, inf.sec_gaps)
                _merge_distn(total.sec_runs, inf.sec_runs)
        return total


def _alignment_identity(v1, v2, a):
    """Match/denominator counts over a gapped alignment's substitution
    columns (reference alignment_identity, identity_dist.c:180)."""
    numer = denom = 0
    pos1 = a.beg1 - 1
    pos2 = a.beg2 - 1
    for op, rpt in a.script.ops:
        if op == "S":
            d, pc = _count_substitutions(v1, pos1, v2, pos2, rpt)
            numer += int(np.trace(pc))
            denom += d
            pos1 += rpt
            pos2 += rpt
        elif op == "I":
            pos2 += rpt
        else:
            pos1 += rpt
    return numer, denom


# ---------------------------------------------------------------------------
# log-odds inference (reference infer_scores.c:912-1067)
# ---------------------------------------------------------------------------

def infer_substitution_scores(stats: InfStats, p_open: float,
                              scale_to: float):
    """Fold in strand/species symmetry, then compute log-odds scores
    (reference infer_substitution_scores, infer_scores.c:920).

    Returns (scale_by, scores4x4, p, q1, q2)."""
    m = np.zeros((4, 4), dtype=np.int64)
    n1 = np.zeros(4, dtype=np.int64)
    n2 = np.zeros(4, dtype=np.int64)
    for x in range(4):
        for y in range(4):
            n = int(stats.subs[x, y])
            for xx, yy in ((x, y),
                           (BITS_TO_COMPLEMENT[x], BITS_TO_COMPLEMENT[y]),
                           (y, x),
                           (BITS_TO_COMPLEMENT[y], BITS_TO_COMPLEMENT[x])):
                m[xx, yy] += n
                n1[xx] += n
                n2[yy] += n

    npairs = float(n1.sum())
    if (n1 == 0).any() or (n2 == 0).any():
        raise SystemExit(
            "FAILURE: internal error in infer_substitution_scores:"
            " a background count is zero")
    q1 = n1 / npairs
    q2 = n2 / npairs
    p = m / npairs
    if (p == 0).any():
        raise SystemExit(
            "FAILURE: internal error in infer_substitution_scores:"
            " s[x][y] = -infinity")
    # bit-identical to the C (infer_scores.c:1045-1063): log(x)*overLog2,
    # not log2(x) -- the results differ in the last ulp and the DP's
    # tie-breaking is sensitive to it
    over_log2 = 1.0 / math.log(2.0)
    s = np.empty((4, 4), dtype=np.float64)
    for x in range(4):
        for y in range(4):
            v = math.log(p[x, y] / (q1[x] * q2[y])) * over_log2
            if p_open != 0:
                v += math.log(1 - 2 * p_open) * over_log2
            s[x, y] = v
    scale_by = 1.0 if scale_to <= 0 else float(scale_to) / s.max()
    return scale_by, scale_by * s, p, q1, q2


def infer_gap_scores(stats: InfStats, s_unscaled_fn, scale_to: float):
    """reference infer_gap_scores (infer_scores.c:1154).  s_unscaled_fn
    recomputes substitution log-odds for a given p_open and returns
    (scale_by, scores).  Returns (scores4x4, gap_open, gap_extend)."""
    n_gaps = sum(stats.ref_gaps.values())
    if n_gaps == 0:
        raise SystemExit("FAILURE: internal error in infer_gap_scores: no gaps")
    avg_gap = (sum(l * c for l, c in stats.ref_gaps.items()) / n_gaps)
    n_segs = sum(stats.segments.values())
    avg_seg = (sum(l * c for l, c in stats.segments.items()) / n_segs)
    if avg_gap == 1:
        raise SystemExit(
            "FAILURE: internal error in infer_gap_scores: average gap is 1")
    p_extend = 1 - (1 / avg_gap)
    s_extend = math.log2(p_extend)
    p_open = 1 / (2 * avg_seg)
    s_open = (math.log(p_open) - math.log(1 - 2 * p_open)
              + math.log(1 - p_extend) - math.log(p_extend)) / math.log(2)
    if s_open + s_extend >= 0:
        raise SystemExit(
            "FAILURE: internal inconsistency, gap open \"reward\" in"
            " infer_gap_scores")
    scale_by, scores = s_unscaled_fn(p_open, scale_to)
    return scores, scale_by * (-s_open), scale_by * (-s_extend)


# ---------------------------------------------------------------------------
# control files (reference read_control_file, lastz.c:10007)
# ---------------------------------------------------------------------------

def read_inference_control_file(path: str, izcfg: Config, ic: InferControl):
    id_is_percentile = None
    have_min_id = have_max_id = False
    try:
        f = open(path)
    except OSError as e:
        raise SystemExit(
            f'FAILURE: failed to open "{path}" for reading ({e.strerror})')
    with f:
        for line_num, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise SystemExit(
                    f"FAILURE: invalid line in control file"
                    f" ({path}:{line_num})")
            key, val = (s.strip() for s in line.split("=", 1))
            if not val:
                raise SystemExit(
                    f"FAILURE: empty assignment in control file"
                    f" ({path}:{line_num})")
            if key == "inference_scale":
                if val == "none":
                    ic.infer_scale = 0
                    ic.write_as_int = False
                else:
                    ic.infer_scale = float(val)
                    try:
                        int(val)
                        ic.write_as_int = True
                    except ValueError:
                        ic.write_as_int = False
            elif key in ("hsp_threshold", "gapped_threshold"):
                is_hsp = key == "hsp_threshold"
                ratio = RATIO_NONE
                if val.startswith("top"):
                    th = ScoreThreshold("P", p=float(val[3:].rstrip("%")) / 100)
                elif val.endswith("*inference_scale"):
                    v = float(val[: -len("*inference_scale")])
                    if ic.infer_scale > 0:
                        th = ScoreThreshold("S", s=v * ic.infer_scale)
                    else:
                        th = ScoreThreshold("S", s=v)
                        ratio = RATIO_MAX_SUB
                elif val.endswith("*worst_substitution"):
                    th = ScoreThreshold(
                        "S", s=float(val[: -len("*worst_substitution")]))
                    ratio = RATIO_MIN_SUB
                elif not is_hsp and val == "hsp_threshold":
                    # gapped_threshold = hsp_threshold (lastz.c:10162);
                    # NB upstream does NOT copy the is-ratio flag
                    th = izcfg.hsp_threshold.copy()
                else:
                    th = ScoreThreshold("S", s=float(val))
                if is_hsp:
                    izcfg.hsp_threshold = th
                    ic.hsp_threshold_is_ratio = ratio
                else:
                    izcfg.gapped_threshold = th
                    ic.gapped_threshold_is_ratio = ratio
            elif key in ("gap_open_penalty", "gap_extend_penalty"):
                is_open = key == "gap_open_penalty"
                ratio = RATIO_NONE
                if val.endswith("*inference_scale"):
                    v = float(val[: -len("*inference_scale")])
                    if ic.infer_scale > 0:
                        v *= ic.infer_scale
                    else:
                        ratio = RATIO_MAX_SUB
                elif val.endswith("*worst_substitution"):
                    v = float(val[: -len("*worst_substitution")])
                    ratio = RATIO_MIN_SUB
                else:
                    v = float(val)
                if is_open:
                    izcfg.scoring.gap_open = v
                    ic.gap_open_is_ratio = ratio
                else:
                    izcfg.scoring.gap_extend = v
                    ic.gap_extend_is_ratio = ratio
            elif key == "entropy":
                izcfg.entropic_hsp = val in ("on", "true", "1", "yes")
            elif key == "max_sub_iterations":
                ic.sub_iterations = int(val)
            elif key == "max_gap_iterations":
                ic.gap_iterations = int(val)
            elif key == "step":
                izcfg.step = int(val)
            elif key in ("min_identity", "max_identity"):
                pct = val.endswith("%")
                if pct:
                    val = val[:-1]
                if id_is_percentile is not None and pct != id_is_percentile:
                    raise SystemExit(
                        f"FAILURE: mixed identity/percentile in control file"
                        f" ({path}:{line_num})")
                if id_is_percentile is None:
                    ic.id_is_percentile = id_is_percentile = pct
                if key == "min_identity":
                    izcfg.min_identity = float(val) / 100
                    have_min_id = True
                    if not have_max_id:
                        izcfg.max_identity = 1.0
                else:
                    izcfg.max_identity = float(val) / 100
                    have_max_id = True
                    if not have_min_id:
                        izcfg.min_identity = 0.0
            elif key in ("min_coverage", "max_coverage"):
                if key == "min_coverage":
                    izcfg.min_coverage = float(val) / 100
                else:
                    izcfg.max_coverage = float(val) / 100
            elif key in ("min_continuity", "max_continuity"):
                if key == "min_continuity":
                    izcfg.min_continuity = float(val) / 100
                else:
                    izcfg.max_continuity = float(val) / 100
            elif key in ("min_match_count", "min_nmatch"):
                if val.endswith("%"):
                    izcfg.min_match_count_ratio = float(val[:-1]) / 100
                else:
                    izcfg.min_match_count = int(val)
            elif key in ("max_mismatch_count", "max_nmismatch"):
                izcfg.max_mismatch_count = int(val)
            elif key in ("max_gap_count", "max_ngap"):
                izcfg.max_separate_gaps_count = int(val)
            elif key in ("max_gap_column_count", "max_cgap"):
                izcfg.max_gap_columns_count = int(val)
            else:
                raise SystemExit(
                    f"FAILURE: unknown assignment in control file"
                    f" ({path}:{line_num}): {key}")


# ---------------------------------------------------------------------------
# driver (reference drive_scoring_inference, infer_scores.c:259)
# ---------------------------------------------------------------------------

def _max_min_sub(ss: ScoreSet):
    d = ss.dna4
    return float(d.max()), float(d.min())


def _apply_ratio(value: float, ratio_kind: str, max_sub: float,
                 min_sub: float) -> float:
    # association matters for bit-equality with the C
    # (infer_scores.c:327-337: oneOverMaxSubScore / minOverMaxSubScore
    # are computed first, then multiplied in)
    if ratio_kind == RATIO_NONE:
        return value * (1.0 / max_sub)
    if ratio_kind == RATIO_MIN_SUB:
        return value * ((-min_sub) / max_sub)
    return value  # RATIO_MAX_SUB: value is already a multiple of max sub


def _set_inferred_subs(ss: ScoreSet, scores: np.ndarray,
                       masked: ScoreSet | None):
    """Write inferred 4x4 scores into a score set and repair it:
    propagate to lower case, set N rows to the worst substitution,
    refresh the masked set's upper-case cells, and keep row/column 0
    very bad (reference log_scores_to_scoring_set + repair_scores,
    infer_scores.c:1067,1310)."""
    from .core.encoding import BITS_TO_NUC
    from .core.scoring import very_bad_score
    worst = float(scores.min())
    for x in range(4):
        ru = BITS_TO_NUC[x]
        rl = ru + 32
        for y in range(4):
            cu = BITS_TO_NUC[y]
            cl = cu + 32
            v = float(scores[x, y])
            ss.sub[ru, cu] = v
            ss.sub[rl, cu] = v
            ss.sub[ru, cl] = v
            ss.sub[rl, cl] = v
            if masked is not None:
                masked.sub[ru, cu] = v
        for nc in (ord("N"), ord("n")):
            ss.sub[ru, nc] = worst
            ss.sub[rl, nc] = worst
            ss.sub[nc, ru] = worst
            ss.sub[nc, rl] = worst
    for r in (ord("N"), ord("n")):
        for c in (ord("N"), ord("n")):
            ss.sub[r, c] = worst
    ss.sub[0, :] = very_bad_score()
    ss.sub[:, 0] = very_bad_score()
    ss._dna4 = None
    if masked is not None:
        masked._dna4 = None


def _sub_tuple(ss: ScoreSet, second: str = "CC"):
    A, C, G, T = ord("A"), ord("C"), ord("G"), ord("T")
    s2 = ss.sub[T, T] if second == "TT" else ss.sub[C, C]
    return (float(ss.sub[A, A]), float(s2), float(ss.sub[A, C]),
            float(ss.sub[A, G]), float(ss.sub[A, T]), float(ss.sub[C, G]))


def _close_enough6(u, v) -> bool:
    return all(abs(a - b) <= SUB_CLOSE_ENOUGH for a, b in zip(u, v))


def _run_collect(izcfg: Config, collector: InfStatsCollector,
                 target=None, pt=None):
    """One full target-vs-queries pass with output routed into the
    stats collector (reference align_for_stats, infer_scores.c:821)."""
    import io
    from .pipeline import Pipeline

    cfg = copy.copy(izcfg)
    cfg.seed = izcfg.seed
    pipe = Pipeline(cfg, out=io.StringIO(), collector=collector)
    pipe.run(target=target, pt=pt)
    return pipe.target, pipe.pt


def drive_scoring_inference(cfg: Config, control_filename: Optional[str],
                            infer_filename: Optional[str]) -> ScoreSet:
    """Run the inference loop; returns the inferred score set and
    writes it as a score file (stdout unless --infscores=<file>)."""
    if cfg.score_type != "D":
        raise SystemExit(
            "FAILURE: scoring inference can't be performed with integer"
            " arithmetic;  use --scoretype=double (the reference's lastz_D)")
    set_score_type("D")

    ic = InferControl(infer_filename=infer_filename)
    izcfg = copy.deepcopy(cfg)
    izcfg.output_format = "infscores"
    izcfg.chain = False
    izcfg.gapped_extend = False
    izcfg.dynamic_masking = 0
    izcfg.report_census = False
    izcfg.self_compare = cfg.self_compare

    # bootstrap scoring: the user's score file if given, else unit scores
    # with ratio-mode gap penalties (lastz.c:9617-9666 note 1)
    worst = worst_possible_score()
    if izcfg.scoring is None:
        izcfg.scoring = new_dna_score_set(
            template=UNIT_SCORES, bad_score=UNIT_SCORES_X,
            fill_score=UNIT_SCORES_FILL, gap_open=worst, gap_extend=worst,
            dtype=np.float64)

    if control_filename is not None:
        read_inference_control_file(control_filename, izcfg, ic)
    ic.sub_iterations = min(ic.sub_iterations, MAX_SUB_ITERATIONS)
    ic.gap_iterations = min(ic.gap_iterations, MAX_GAP_ITERATIONS)

    if ic.gap_iterations > 0:
        raise SystemExit(
            "FAILURE: Gap scoring inference has not been shown to produce"
            " useful results and\nis currently blocked.  To unblock gap"
            " scoring inference, contact the author.")
    if izcfg.gapped_threshold.t not in ("S",):
        raise SystemExit(
            "FAILURE: drive_scoring_inference can't handle score threshold "
            + izcfg.gapped_threshold.to_string())
    if izcfg.min_coverage > 0 or izcfg.max_coverage < 1:
        raise SystemExit(
            "FAILURE: drive_scoring_inference can't handle query coverage"
            " filtering")

    if ic.infer_scale > 0 and ic.infer_scale != 1:
        scale_score_set(izcfg.scoring, ic.infer_scale)
    if izcfg.scoring.gap_open == worst:
        ic.gap_open_is_ratio = RATIO_MIN_SUB
        izcfg.scoring.gap_open = UNIT_SCORES_OPEN
    if izcfg.scoring.gap_extend == worst:
        ic.gap_extend_is_ratio = RATIO_MIN_SUB
        izcfg.scoring.gap_extend = UNIT_SCORES_EXTEND
    izcfg.masked_scoring = masked_score_set(izcfg.scoring)

    min_identity_saved = izcfg.min_identity
    max_identity_saved = izcfg.max_identity
    if ic.id_is_percentile:
        izcfg.min_identity = 0.0
        izcfg.max_identity = 1.0

    orig_hsp = float(izcfg.hsp_threshold.s)
    orig_gap_open = float(izcfg.scoring.gap_open)
    orig_gap_extend = float(izcfg.scoring.gap_extend)

    scale_to = ic.infer_scale
    max_sub, min_sub = _max_min_sub(izcfg.scoring)
    hsp_ratio = _apply_ratio(orig_hsp, ic.hsp_threshold_is_ratio,
                             max_sub, min_sub)

    collector = InfStatsCollector()
    target = pt = None

    # Phase I: iterate substitution score inference (ungapped, C=3)
    past = [_sub_tuple(izcfg.scoring, second="TT")]
    in_orbit = False
    trial = 1
    combined = None
    while not in_orbit and trial <= ic.sub_iterations:
        max_sub, _ = _max_min_sub(izcfg.scoring)
        # only the score field is refreshed; adaptive ('P'/'C')
        # thresholds keep their tag (reference infer_scores.c:438-440)
        izcfg.hsp_threshold.s = hsp_ratio * max_sub
        izcfg.x_drop = 10 * max_sub

        collector.erase()
        target, pt = _run_collect(izcfg, collector, target, pt)

        if ic.id_is_percentile:
            collector.filter_by_percentile(
                min_identity_saved, max_identity_saved)
        combined = collector.combined(merge_sequences=True)

        _, scores, _, _, _ = infer_substitution_scores(combined, 0.0, scale_to)
        _set_inferred_subs(izcfg.scoring, scores, izcfg.masked_scoring)
        izcfg.scoring.gap_open = 0
        izcfg.scoring.gap_extend = 0

        tup = _sub_tuple(izcfg.scoring)
        in_orbit = any(_close_enough6(tup, p) for p in past)
        past.append(tup)
        trial += 1

    # Phase II: derive gap penalties relative to the final matrix
    # (iteration is blocked; the pre-loop ratio assignment still runs,
    # infer_scores.c:520-566)
    final = izcfg.scoring
    max_sub, min_sub = _max_min_sub(final)
    final.gap_open = _apply_ratio(
        orig_gap_open, ic.gap_open_is_ratio, max_sub, min_sub) * max_sub
    final.gap_extend = _apply_ratio(
        orig_gap_extend, ic.gap_extend_is_ratio, max_sub, min_sub) * max_sub

    # write the resulting scores (stdout unless --infscores=<file>)
    if ic.infer_filename is None:
        write_score_set(sys.stdout, final,
                        with_gap_scores=True, as_ints=ic.write_as_int)
    else:
        name = ic.infer_filename.replace("_%s", "").replace(".%s", "") \
                                .replace("%s", "")
        with open(name, "w") as f:
            write_score_set(f, final,
                            with_gap_scores=True, as_ints=ic.write_as_int)
    return final
