"""Run configuration (the reference's ~120-field `control` struct, lastz.h:95-467).

Only behavior-bearing fields are kept; debug/stat plumbing is handled
by Python logging instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .core.scoring import ScoreSet
from .core.seeds import Seed


@dataclass
class ScoreThreshold:
    """Tagged threshold (reference sthresh, dna_utilities.h:252-259).

    t == 'S': plain score; t == 'P': fraction of target (resolved to
    'C' once target length is known); t == 'C': coverage base count.
    """

    t: str = "S"
    s: int = 0  # score (valid when t == 'S')
    c: int = 0  # base count (valid when t == 'C')
    p: float = 0.0  # fraction (valid when t == 'P')

    def copy(self) -> "ScoreThreshold":
        return ScoreThreshold(self.t, self.s, self.c, self.p)

    def to_string(self) -> str:
        # reference score_thresh_to_string (dna_utilities.c:2292)
        if self.t == "S":
            from .core.scoring import score_str
            return score_str(self.s)
        if self.t == "C":
            return f"top{self.c}"
        if self.t == "P":
            return f"top{100 * self.p:.1f}%"
        return "(unrecognized)"


GFEX_NO_EXTEND = 0
GFEX_XDROP = 1
GFEX_EXACT = 2
GFEX_MISMATCH_BASE = 10  # GFEX_MISMATCH_BASE + n => n-mismatch extension

HIT_SIMPLE = 0
HIT_RECOVER = 1


@dataclass
class Config:
    """Alignment run controls, defaults per reference lastz.c:333-449."""

    seq1_filename: Optional[str] = None
    seq2_filename: Optional[str] = None

    self_compare: bool = False
    cloned_query: bool = False
    inhibit_trivial: bool = False

    which_strand: int = 1  # 0: + only, >0: both, <0: - only
    step: int = 1

    seed: Optional[Seed] = None  # default 12of19, 1 transition
    seed_string: Optional[str] = None
    max_index_bits: int = 28
    with_trans: int = 1
    twin_min_span: int = 0
    twin_max_span: int = 0
    twin_min_gap: Optional[int] = None  # from --twins=min..max
    twin_max_gap: Optional[int] = None
    basic_hit_type: int = HIT_SIMPLE
    min_matches: int = -1
    max_transversions: int = -1
    filter_cares_only: bool = False

    gf_extend: int = GFEX_XDROP
    merge_anchors: bool = False
    chain: bool = False
    chain_diag: int = 0
    chain_anti: int = 0
    gapped_extend: bool = True

    scoring: Optional[ScoreSet] = None
    masked_scoring: Optional[ScoreSet] = None
    x_drop: int = 0  # 0 => default 10*sub[A][A]
    y_drop: int = 0  # 0 => default open + 300*extend
    x_drop_untrimmed: bool = False
    y_drop_untrimmed: bool = False
    hsp_threshold: ScoreThreshold = field(default_factory=lambda: ScoreThreshold("S", 3000))
    gapped_threshold: ScoreThreshold = field(default_factory=lambda: ScoreThreshold("S", 0))
    entropic_hsp: bool = True
    report_entropy: bool = False
    gapped_all_bounds: bool = False
    # None = unset (reference -1); --self enables mirroring by default
    mirror_hsp: Optional[bool] = None
    mirror_gapped: Optional[bool] = None
    traceback_mem: int = 80 * 1024 * 1024

    n_is_ambiguous: bool = False
    allow_ambi_dna: bool = False
    ambi_match: int = 0
    ambi_mismatch: int = 0

    hsp_immediate: bool = False
    search_limit: int = 0
    search_limit_warn: bool = True
    search_limit_keep: bool = False
    num_best_hsps: int = 0
    max_paired_bases: int = 0
    max_paired_depth: float = 0.0
    overly_paired_warn: bool = False
    overly_paired_keep: bool = False

    word_count_keep: float = 0.0
    word_count_limit: int = 0
    max_word_count_chasm: int = 0
    dynamic_masking: int = 0
    census_kind: str = ""          # '', 'B', 'W', or 'L'
    census_filename: str | None = None
    report_census: bool = False
    # --outputmasking[+][:dynamic]= / --outputmasking[+]:soft=
    # (lastz.c:405-406,6585-6617)
    masking_filename: Optional[str] = None
    masking_3fields: bool = False
    soft_masked_filename: Optional[str] = None
    soft_masked_3fields: bool = False

    min_identity: float = 0.0
    max_identity: float = 1.0
    min_coverage: float = 0.0
    max_coverage: float = 1.0
    min_continuity: float = 0.0
    max_continuity: float = 1.0
    min_match_count: int = 0
    min_match_count_ratio: float = 0.0
    max_mismatch_count: int = -1
    max_separate_gaps_count: int = -1
    max_gap_columns_count: int = -1

    output_format: str = "lav"
    output_info: Optional[str] = None  # genpaf field keys
    output_filename: Optional[str] = None
    # secondary output channels (reference lastz.c dotplotFilename,
    # axtFilename, mafFilename: written in ADDITION to the primary format)
    dotplot_filename: Optional[str] = None
    dotplot_keys: Optional[str] = None     # rdotplot vs rdotplot+score
    axt_filename: Optional[str] = None
    maf_filename: Optional[str] = None
    sam_mark_mismatches: bool = False
    read_group: Optional[str] = None
    sam_rg_tags: Optional[str] = None
    end_comment: bool = False
    de_gapify_output: bool = False

    inner_threshold: int = 0  # interpolation (H=)
    inner_seed: Optional[Seed] = None
    inner_window: int = 20000

    anchors_filename: Optional[str] = None
    chores_filename: Optional[str] = None  # --chores= / [chores=] action
    segments_filename: Optional[str] = None  # --segments= input

    args: str = ""  # reconstructed command tail for job headers
    verbosity: int = 0
    progress: int = 0          # --progress=<n>: report every nth query
    # --tableonly/--showtable: '' | 'table' | 'counts' | 'withcounts'
    # | 'distribution'
    show_pos_table: str = ""
    do_seed_search: bool = True
    seed_queue_size: int = 256 * 1024  # --seedqueue (twin-hit queue)
    band_width: int = 0  # --band= (0 => no band restriction, lastz.c:420)
    shard_index: int = 0  # --shard=i/n query sharding (farm-out)
    shard_count: int = 1
    no_truncation_report: bool = False  # --notruncationreport
    text_context: int = 0  # --expand= context columns (text formats)
    force_report_filtered_hsps: bool = False  # --force:reportfilteredhsps
    stats_filename: Optional[str] = None  # --stats[=file]; '' => stderr
    raw_hits: bool = False  # --rawhits (seed_search noHitFiltering)
    target_actions: list = field(default_factory=list)  # --action:target=
    query_actions: list = field(default_factory=list)   # --action:query=

    # quantum DNA (reference quantum.c): --ball seeding threshold
    query_is_quantum: bool = False
    target_is_quantum: bool = False
    ball_score: float = -1.0          # <0 => unset
    ball_score_factor: float = -1.0   # <0 => unset ; else fraction of max

    # capsule: persisted index snapshot (--writecapsule/--targetcapsule)
    write_capsule: bool = False
    read_capsule: bool = False
    capsule_filename: Optional[str] = None

    # scoring inference (--infer/--inferonly/--infscores)
    infer_scores: bool = False
    infer_only: bool = False
    infer_control_filename: Optional[str] = None
    infer_scores_filename: Optional[str] = None

    # runtime backend: "host" exact engine or "tpu" batched kernels
    backend: str = "host"
    # score type: 'I' int32 (reference lastz) or 'D' double (lastz_D)
    score_type: str = "I"

    def effective_x_drop(self) -> int:
        if self.x_drop != 0:
            return self.x_drop
        # 10 * sub[rowChars[0]][colChars[0]] (lastz.c:9319-9321); for
        # plain DNA this is sub['A']['A']
        r = self.scoring.row_chars[0]
        c = self.scoring.col_chars[0]
        return int(10 * self.scoring.sub[r, c])

    def effective_y_drop(self) -> int:
        if self.y_drop != 0:
            return self.y_drop
        return int(self.scoring.gap_open + 300 * self.scoring.gap_extend)
