"""Run orchestration: the reference driver's main loop re-expressed.

Mirrors lastz.c main/start_one_strand/finish_one_strand control flow
(lastz.c:653-1720, 3006-3560): target loaded once, position table
built once, queries streamed; each query strand runs seed search,
then (depending on mode) immediate reporting, segment collection +
chaining + gapped extension, filtering, interpolation and output.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from .config import (
    Config, ScoreThreshold,
    GFEX_NO_EXTEND, GFEX_XDROP, GFEX_EXACT, HIT_RECOVER,
)
from .core.encoding import NUC_TO_BITS, UPPER_NUC_TO_BITS
from .core.scoring import new_dna_score_set, masked_score_set
from .core.seeds import parse_seed, SEED_12OF19
from .index.postable import (build_seed_position_table,
                             build_seed_position_table_device)
from .io.sequence import SequenceFile, Sequence
from .out.dispatcher import OutputDispatcher
from .search.engine import SeedSearchEngine, HitProcessorParams
from .align.segments import SegmentTable, Segment
from .device import get_device

# the program name written in the output: the same bytes as lastz_tpu
PROGRAM_NAME = "lastz_tpu.v0.1.0"


def _upper_truncate(script, pos1, pos2):
    """reference edit_script_upper_truncate (edit_script.c): truncate
    the script where it first touches/crosses the self-diagonal in
    conceptual coordinates.  Returns (x, y, truncated); x None means
    the whole alignment was below the diagonal."""
    if not script.ops:
        return pos1, pos2, False
    if pos1 > pos2:
        script.ops.clear()
        return None, None, True
    # expand into single (op, rpt) steps scanning
    reaches = False
    i = 0
    prev1 = prev2 = 0
    limit = 0
    for i, (op, rpt) in enumerate(script.ops):
        prev1, prev2 = pos1, pos2
        if op == "S":
            pos1 += rpt
            pos2 -= rpt
            limit = pos2 + 1
        elif op == "I":
            pos2 -= rpt
            limit = pos2
        else:
            pos1 += rpt
            limit = pos2
        if pos1 >= limit:
            reaches = True
            break
    if not reaches:
        return pos1, pos2, False
    del script.ops[i + 1:]
    if pos1 > pos2:
        op, rpt = script.ops[i]
        if op == "S":
            rpt = (prev2 + 1 - prev1) // 2
            pos1 = prev1 + rpt
            pos2 = prev2 - rpt
        elif op == "I":
            rpt = prev2 - prev1
            pos1 = prev1
            pos2 = prev2 - rpt
        else:
            rpt = prev2 - prev1
            pos1 = prev1 + rpt
            pos2 = prev2
        script.ops[i] = (op, rpt)
    return pos1, pos2, True


def _trim_head(script, n):
    """Remove the first n columns (reference edit_script_trim_head)."""
    while n > 0 and script.ops:
        op, rpt = script.ops[0]
        take = min(rpt, n)
        if rpt <= take:
            script.ops.pop(0)
        else:
            script.ops[0] = (op, rpt - take)
        n -= take


def _resolve_chore_target(chore, target):
    """reference resolve_chore_target (lastz.c:2503): map the chore's
    origin-1 closed target interval into current 0-based half-open
    coordinates, validating the name."""
    wildcard = chore.t_name == ""
    if not target.is_partitioned:
        t_header = target.name_for_output()
        if not wildcard and chore.t_name != t_header:
            raise SystemExit(
                f"FAILURE: chore target name mismatch: {chore.t_name}"
                f" is not {t_header}")
        if not chore.t_subrange:
            return (0, len(target.v))
        seq_start = target.start_loc - 1
        seq_end = seq_start + len(target.v)
        if chore.t_start - 1 < seq_start or chore.t_end > seq_end:
            raise SystemExit(
                f"FAILURE: chore target interval out of range"
                f" ({chore.t_start} {chore.t_end})")
        return (chore.t_start - 1 - seq_start, chore.t_end - seq_start)
    if wildcard:
        raise SystemExit(
            "FAILURE: chore target name wildcard can't be used with a"
            " partitioned target")
    parts = [p for p in target.partitions if p.header == chore.t_name]
    if not parts:
        raise SystemExit(
            f"FAILURE: chore target {chore.t_name} does not exist in"
            f" target file")
    part = parts[0]
    offset = part.sep_before + 1
    if not chore.t_subrange:
        return (offset, parts[-1].sep_after)
    seq_start = part.start_loc - 1
    return (offset + chore.t_start - 1 - seq_start,
            offset + chore.t_end - seq_start)


def _resolve_chore_query(query, chore, strand):
    """reference resolve_chore_query (lastz.c:2616): the chore's query
    interval in the CURRENT orientation's coordinates ('-' flips)."""
    if not query.is_partitioned:
        if not chore.q_subrange:
            return (0, len(query.v))
        seq_start = query.start_loc - 1
        n = len(query.v)
        seq_end = seq_start + n
        q_start = chore.q_start - 1
        q_end = chore.q_end
        if q_start < seq_start or q_end > seq_end:
            raise SystemExit(
                f"FAILURE: chore query interval out of range on"
                f" {chore.q_name} ({chore.q_start} {chore.q_end})")
        if strand != "-":
            return (q_start - seq_start, q_end - seq_start)
        return (seq_end - q_end, seq_end - q_start)
    parts = [p for p in query.partitions if p.header == chore.q_name]
    if not parts:
        raise SystemExit(
            f"FAILURE: chore query {chore.q_name} does not exist in"
            f" query file")
    part = parts[0]
    offset = part.sep_before + 1
    q_len = parts[-1].sep_after - offset
    if not chore.q_subrange:
        return (offset, offset + q_len)
    seq_start = part.start_loc - 1
    seq_end = seq_start + q_len
    if strand != "-":
        return (offset + chore.q_start - 1 - seq_start,
                offset + chore.q_end - seq_start)
    return (offset + seq_end - chore.q_end,
            offset + seq_end - (chore.q_start - 1))


def _fence_interval(v, interval):
    """reference fence_sequence_interval (sequences.c:7789): NUL the
    characters just outside [s, e); returns restore info."""
    s, e = interval
    saved = []
    if s >= 1:
        saved.append((s - 1, int(v[s - 1])))
        v[s - 1] = 0
    if e < len(v):
        saved.append((e, int(v[e])))
        v[e] = 0
    return saved


def _lowercase_intervals(v):
    """reference report_masked_intervals (masking.c:529-566) with
    maskChar=-1: yield (beg, end) origin-1 inclusive runs of lowercase
    characters."""
    low = (v >= ord("a")) & (v <= ord("z"))
    if not low.any():
        return
    edges = np.flatnonzero(np.diff(low.astype(np.int8)))
    starts = list(edges[~low[edges]] + 1)
    ends = list(edges[low[edges]] + 1)
    if low[0]:
        starts.insert(0, 0)
    if low[-1]:
        ends.append(len(v))
    for s, e in zip(starts, ends):
        yield (s + 1, e)


def _masking_interval_line(target, beg, end, three_fields):
    """print_masking_interval[_3] (masking.c:570-660): origin-1
    inclusive interval, optionally prefixed by the sequence name."""
    if not three_fields:
        beg += target.start_loc - 1
        end += target.start_loc - 1
        return f"{beg} {end}\n"
    if target.is_partitioned:
        part = target.lookup_partition(beg - 1)
        name = part.header
        offset = part.sep_before + 1
    else:
        name = target.name_for_output() or "seq1"
        offset = 0
    beg += target.start_loc - offset - 1
    end += target.start_loc - offset - 1
    return f"{name} {beg} {end}\n"


class Pipeline:
    def __init__(self, cfg: Config, out=None, collector=None):
        self.cfg = cfg
        self.out = out or sys.stdout
        self._finalize_config()
        self.dispatcher = OutputDispatcher(cfg, self.out, PROGRAM_NAME,
                                           collector=collector)
        self.anchors: Optional[SegmentTable] = None
        self.secondary_anchors: Optional[SegmentTable] = None
        # the hit-reporter choice is fixed at setup time, BEFORE any
        # per-query ratio filters are resolved (lastz.c:2773)
        self._mode_cache = None
        self._mode_cache = self._reporter_mode_uncached()
        # seed_search_dbgSearchLimitExceeded / firstReport
        # (seed_search.c:3797,3801)
        self._search_limit_exceeded = 0
        self._limit_warned_once = False
        self._paired_warned_once = False
        # the torch device of the seed search (LASTZ_TORCH_DEVICE)
        self.device = get_device()

    # -- configuration finalization (lastz.c:8900-9400) --------------------

    def _finalize_config(self):
        cfg = self.cfg
        from .core.scoring import set_score_type
        set_score_type(cfg.score_type)
        if cfg.scoring is None:
            cfg.scoring = new_dna_score_set()
        if cfg.masked_scoring is None:
            cfg.masked_scoring = masked_score_set(cfg.scoring)
        if cfg.allow_ambi_dna:
            from .core.scoring import ambiguate_iupac
            ambiguate_iupac(cfg.scoring, cfg.ambi_match, -cfg.ambi_mismatch)
            ambiguate_iupac(cfg.masked_scoring, cfg.ambi_match,
                            -cfg.ambi_mismatch)
        if cfg.n_is_ambiguous:
            from .core.scoring import ambiguate_n
            ambiguate_n(cfg.scoring, cfg.ambi_match, -cfg.ambi_mismatch)
            ambiguate_n(cfg.masked_scoring, cfg.ambi_match,
                        -cfg.ambi_mismatch)
        if cfg.seed is None:
            seed_string = cfg.seed_string or SEED_12OF19
            cfg.seed = parse_seed(
                seed_string, cfg.max_index_bits, with_trans=cfg.with_trans)
        else:
            cfg.seed.with_trans = cfg.with_trans
        if cfg.twin_min_gap is not None:
            cfg.twin_min_span = 2 * cfg.seed.length + cfg.twin_min_gap
            cfg.twin_max_span = 2 * cfg.seed.length + cfg.twin_max_gap

        # quantum scoring sanity (lastz.c:9457-9475); note the column
        # check only applies when a seed search will actually run
        if not cfg.infer_scores:
            if not cfg.target_is_quantum \
                    and not cfg.masked_scoring.rows_are_dna:
                raise SystemExit(
                    "FAILURE: row scores are for quantum DNA,"
                    " but target is not")
            if (cfg.do_seed_search and not cfg.query_is_quantum
                    and not cfg.masked_scoring.cols_are_dna):
                raise SystemExit(
                    "FAILURE: column scores are for quantum DNA,"
                    " but query is not")
            if cfg.target_is_quantum and cfg.masked_scoring.rows_are_dna:
                raise SystemExit(
                    "FAILURE: target is quantum DNA,"
                    " but row scores are not")
            if cfg.query_is_quantum and cfg.masked_scoring.cols_are_dna:
                raise SystemExit(
                    "FAILURE: query is quantum DNA,"
                    " but column scores are not")

        # quantum seeding threshold default: 75% of the max word score
        # (lastz.c:9476-9493; defaultBallScoreFactor)
        if (cfg.query_is_quantum or cfg.target_is_quantum) \
                and cfg.ball_score <= 0:
            factor = (cfg.ball_score_factor
                      if cfg.ball_score_factor >= 0 else 0.75)
            max_score = max(
                float(cfg.scoring.sub[r, c])
                for r in cfg.scoring.row_chars
                for c in cfg.scoring.col_chars)
            cfg.ball_score = int(factor * max_score * (cfg.seed.weight // 2))

        if cfg.gf_extend == GFEX_NO_EXTEND:
            cfg.x_drop = 0
            cfg.hsp_threshold = ScoreThreshold("S", 0)
            cfg.entropic_hsp = False
        if cfg.x_drop == 0 and cfg.gf_extend == GFEX_XDROP:
            cfg.x_drop = cfg.effective_x_drop()
        if cfg.y_drop == 0:
            cfg.y_drop = cfg.effective_y_drop()
        if cfg.gapped_threshold.t == "S" and cfg.gapped_threshold.s == 0:
            if cfg.gf_extend == GFEX_XDROP:
                cfg.gapped_threshold = cfg.hsp_threshold.copy()
            else:
                cfg.gapped_threshold = ScoreThreshold("S", 3000)

        # --self: mirroring defaults (lastz.c:8722-8745, 9056-9061)
        if cfg.self_compare:
            if cfg.mirror_hsp is None:
                cfg.mirror_hsp = True
                cfg.mirror_gapped = False
            elif cfg.mirror_gapped is None:
                cfg.mirror_gapped = False
            if cfg.mirror_hsp and cfg.gapped_extend:
                cfg.mirror_hsp = False
                cfg.mirror_gapped = True
        if cfg.mirror_hsp is None:
            cfg.mirror_hsp = False
        if cfg.mirror_gapped is None:
            cfg.mirror_gapped = False

    # -- main entry ---------------------------------------------------------

    @staticmethod
    def _apply_actions(spec, actions):
        """--action:target=/--action:query= (lastz.c): append bracket
        actions to a sequence specifier."""
        if not actions or spec is None:
            return spec
        extra = ",".join(actions)
        if spec.endswith("]"):
            return spec[:-1] + "," + extra + "]"
        return spec + "[" + extra + "]"

    def run(self, target=None, pt=None):
        """Full job.  `target`/`pt` may be supplied pre-loaded (the
        scoring-inference loop shares them across iterations, as the
        reference shares seq1/targPositions with izParams)."""
        cfg = self.cfg
        disp = self.dispatcher

        from . import stats
        self.stats = stats.reset()
        if target is None and cfg.read_capsule:
            # target + index come from the capsule; its seed/step
            # replace the defaults (lastz.c:8807-8813)
            if cfg.dynamic_masking == 0:
                # the capsule's index goes to the device once and is
                # reused across queries and runs (capsule.c:6-15)
                from .index.capsule import open_capsule_to_device
                target, pt, self.device_index = open_capsule_to_device(
                    cfg.capsule_filename, self.device)
            else:
                from .index.capsule import open_capsule_file
                target, pt = open_capsule_file(
                    cfg.capsule_filename,
                    writable_target=cfg.dynamic_masking > 0)
            pt.seed.with_trans = cfg.with_trans
            cfg.seed = pt.seed
            cfg.step = pt.step
        if target is None:
            target_file = SequenceFile(cfg.seq1_filename)
            target = target_file.load()
            if target is None:
                raise ValueError(f"no sequence in {cfg.seq1_filename}")

        # multi-sequence targets can't use positional masking reports
        # (lastz.c:1128-1144)
        if target.is_partitioned:
            bad = ("multiple action (forced by separator action)"
                   if target.separator else "multiple action")
            if cfg.masking_filename is not None:
                raise ValueError(
                    f"{bad} cannot be used with --outputmasking")
            if (cfg.soft_masked_filename is not None
                    and not cfg.soft_masked_3fields):
                raise ValueError(
                    f"{bad} cannot be used with --outputmasking:soft\n"
                    "consider using --outputmasking+:soft instead")

        # resolve adaptive ('P') thresholds now that target length is known
        self._resolve_score_thresholds(target)

        if pt is None:
            if cfg.target_is_quantum:
                # (lastz.c:812,1225-1229)
                if target.file_type != "qdna":
                    raise ValueError(
                        f"{target.filename} does not contain quantum DNA")
                from .index.postable import (
                    build_quantum_seed_position_table)
                pt = build_quantum_seed_position_table(
                    target.v, 0, len(target.v), cfg.masked_scoring,
                    cfg.seed, cfg.step)
            else:
                with self.stats.time("pos table"):
                    pt = self._build_position_table(target)
            if cfg.word_count_limit > 0 or cfg.word_count_keep > 0:
                from .index.postable import limit_position_table
                limit_position_table(pt, cfg.word_count_limit,
                                     cfg.word_count_keep)
        self.target = target
        self.pt = pt

        if cfg.show_pos_table:
            # --tableonly/--showtable (lastz.c:1325-1360)
            from .index.postable import (
                dump_position_table, position_table_count_distribution)
            name1 = self.dispatcher.name1
            if cfg.show_pos_table == "distribution":
                self.out.write(
                    "seed-word counts distribution table for %s:\n" % name1)
                for count, occ in position_table_count_distribution(pt):
                    self.out.write(f"{count} {occ}\n")
            else:
                kind = {"table": "positions", "counts": "counts",
                        "withcounts": "counts and positions"}[
                    cfg.show_pos_table]
                self.out.write("seed-word %s table for %s:\n"
                               % (kind, name1))
                dump_position_table(
                    self.out, pt, cfg.seed,
                    show_positions=cfg.show_pos_table in (
                        "table", "withcounts"),
                    show_counts=cfg.show_pos_table in (
                        "counts", "withcounts"))
                self.out.write("\n")

        self.stats.target_length = len(target.v)
        self.stats.step = cfg.step
        if pt is not None:
            n = getattr(pt, "n_entries", None)
            if n is None and getattr(pt, "csr_pos", None) is not None:
                n = len(pt.csr_pos)
            if n is not None:
                self.stats.words_in_table = n

        if cfg.write_capsule:
            # write the index snapshot and quit (lastz.c:1361-1376)
            from .index.capsule import write_capsule_file, unitize
            cap_size = write_capsule_file(cfg.capsule_filename, target, pt)
            self.out.write(
                "%s byte target sequence capsule written to %s\n"
                % (unitize(cap_size, by_thousands=True),
                   cfg.capsule_filename))
            return

        if not cfg.do_seed_search:
            return  # --tableonly: quit after dumping (lastz.c:1390)

        self.targ_census = None
        if cfg.dynamic_masking > 0 or cfg.report_census:
            from .masking import Census
            self.targ_census = Census(
                len(target.v), cfg.census_kind or "B", cfg.dynamic_masking)

        if cfg.seq2_filename:
            query_file = SequenceFile(cfg.seq2_filename,
                                      chores_filename=cfg.chores_filename)
        elif cfg.self_compare:
            query_file = SequenceFile(cfg.seq1_filename)
        else:
            query_file = SequenceFile(None)  # query from stdin

        # partitioned target/query vs output format (lastz.c:1103-1126):
        # gfa and lav can't express out-of-order partitioned output
        q_spec = getattr(query_file, "spec", None)
        if target.is_partitioned or (q_spec is not None
                                     and q_spec.do_partition):
            bad = "multiple action"
            if target.separator and (q_spec is not None
                                     and q_spec.separator):
                bad = "multiple action (forced by separator action)"
            if cfg.do_seed_search and not cfg.infer_only:
                fmt = cfg.output_format
                if fmt in ("gfa", "gfanoscore"):
                    raise ValueError(f"{bad} cannot be used with --gfa")
                if fmt in ("lav", "lav+", "lavscore", "lav+text"):
                    raise ValueError(
                        f"{bad} cannot be used with --lav\n"
                        "(lav has requirements on the order of alignments"
                        " that would require additional\n"
                        " computation;  use \"--help=formats\" to see other"
                        " options for output)")

        disp.job_header()

        hsps_are_adaptive = cfg.hsp_threshold.t != "S"
        collect_from_both = hsps_are_adaptive or cfg.search_limit > 0 \
            or cfg.num_best_hsps > 0
        collect_separately = False
        if collect_from_both:
            collect_separately = not (hsps_are_adaptive or cfg.num_best_hsps > 0)

        num_queries = 0
        progress_clock = None
        while True:
            query = query_file.load()
            if query is None:
                break
            if len(query.v) == 0:
                continue
            num_queries += 1
            self.stats.num_queries += 1
            self.stats.query_length += len(query.v)
            if cfg.shard_count > 1:
                # process-level query sharding (--shard=i/n): the
                # TPU-native analogue of the reference's capsule
                # farm-out — each worker takes every n-th query and
                # the per-shard outputs concatenate (capsule.c:6-15)
                if (num_queries - 1) % cfg.shard_count != cfg.shard_index:
                    continue
            if cfg.progress and (cfg.progress == 1
                                 or num_queries % cfg.progress == 1):
                # --progress=<n> (lastz.c dbgQueryProgress)
                import time
                now = time.monotonic()
                dt = 0.0 if progress_clock is None else now - progress_clock
                progress_clock = now
                sys.stderr.write(
                    "(%.3fs) processing query %d: %s\n"
                    % (dt, num_queries, query.name_for_output()))
            disp.set_sequences(target, query)
            if query.chore is None or query.chore.num == 1:
                disp.init_for_query()
            if cfg.which_strand < 0 and query.chore is None:
                self._rev_comp_query(query)

            self._run_query(target, pt, query,
                            collect_from_both, collect_separately)

        # --outputmasking files (lastz.c:1731-1759): written before the
        # m-stanza; the dynamic file reports census runs over threshold,
        # the soft file reports lowercase runs in the (possibly
        # dynamically masked) target
        if cfg.masking_filename is not None:
            with open(cfg.masking_filename, "w") as f:
                if self.targ_census is not None:
                    for beg, end in self.targ_census.masked_intervals():
                        f.write(_masking_interval_line(
                            target, beg, end, cfg.masking_3fields))
        if cfg.soft_masked_filename is not None:
            with open(cfg.soft_masked_filename, "w") as f:
                for beg, end in _lowercase_intervals(target.v):
                    f.write(_masking_interval_line(
                        target, beg, end, cfg.soft_masked_3fields))

        # end-of-job m-stanza (reference lastz.c:1761 prints it always
        # for lav, with the census intervals when masking was active)
        disp.print_m_stanza(getattr(self, "targ_census", None))
        if cfg.report_census and self.targ_census is not None:
            # reference lastz.c:1762-1775: census is printed with the
            # threshold dropped to zero (every position reported)
            cen = self.targ_census
            saved = cen.mask_thresh
            cen.mask_thresh = 0
            if cfg.census_filename is None:
                disp.print_census_stanza(cen)
            else:
                with open(cfg.census_filename, "w") as f:
                    cen.print_census(f, target, "\t")
            cen.mask_thresh = saved

        # end-of-job search-limit summary (lastz.c:1777-1793); suppressed
        # for the gappily reporter only when warnings are off, and worded
        # differently when the limit applied to gapped alignments
        gappily = cfg.hsp_immediate and cfg.gapped_extend
        if (self._search_limit_exceeded > 0
                and (cfg.search_limit_warn or not gappily)):
            n = self._search_limit_exceeded
            head = ("1 query exceeded the" if n == 1
                    else "%d queries exceeded the" % n)
            tail = (" limit of qualifying alignments\n" if gappily
                    else " HSP limit\n")
            sys.stderr.write(head + tail)
        disp.job_footer()
        if cfg.stats_filename is not None:
            if cfg.stats_filename == "":
                self.stats.show(sys.stderr)
            else:
                with open(cfg.stats_filename, "w") as sf:
                    self.stats.show(sf)


    def _rev_comp_query(self, query):
        """Reverse-complement the query, with the score file's
        qToComplement map for quantum queries (lastz.c passes
        scoring->qToComplement to rev_comp_sequence)."""
        comp = None
        if query.file_type == "qdna":
            comp = self.cfg.scoring.q_to_complement
        query.rev_comp(comp)

    def _resolve_score_thresholds(self, target: Sequence):
        for th in (self.cfg.hsp_threshold, self.cfg.gapped_threshold):
            if th.t == "P":
                th.t = "C"
                th.c = int(th.p * len(target.v) + 0.5)

    # -- per-query processing ------------------------------------------------

    def _run_query(self, target, pt, query, collect_from_both,
                   collect_separately):
        cfg = self.cfg
        disp = self.dispatcher

        if cfg.min_match_count_ratio != 0:
            # per-query resolution of --filter=nmatch:<pct>% (lastz.c:1520)
            import math
            cfg.min_match_count = int(
                math.ceil(query.true_len * cfg.min_match_count_ratio))

        # alignment chores: resolve the restriction intervals and the
        # per-chore strand selection (lastz.c:1496-1630)
        chore = query.chore
        self._chore = chore
        skip_plus = skip_minus = False
        if chore is not None:
            chore.target_interval = _resolve_chore_target(chore, target)
            chore.query_interval = _resolve_chore_query(query, chore, "+")
            skip_plus = chore.q_strand < 0
            skip_minus = chore.q_strand == 0

        if not skip_plus:
            ok = self._start_one_strand(target, pt, query,
                                        empty_anchors=True)
            if not ok:
                return

            if not collect_from_both:
                self._finish_one_strand(target, pt, query)
        else:
            self.anchors = SegmentTable(
                coverage_limit=cfg.hsp_threshold.c
                if cfg.hsp_threshold.t == "C" else 0)

        if skip_minus:
            self._chore = None
            return

        if chore is not None:
            chore.query_interval = _resolve_chore_query(query, chore, "-")

        if cfg.which_strand > 0:
            self._rev_comp_query(query)
            disp.set_sequences(target, query)
            prev_anchor_count = 0
            if collect_separately and self.anchors is not None:
                prev_anchor_count = len(self.anchors)
                self._swap_anchor_sets()
                self.anchors = SegmentTable()
            ok = self._start_one_strand(
                target, pt, query,
                empty_anchors=not collect_from_both,
                prev_anchor_count=prev_anchor_count)
            if not ok:
                return
            if cfg.num_best_hsps > 0:
                self._choose_best_anchors(cfg.num_best_hsps)
            if collect_from_both and not collect_separately:
                self._split_anchors(query.rev_comp_flags)
            self._finish_one_strand(target, pt, query)
            if collect_from_both:
                self._swap_anchor_sets()
                self._rev_comp_query(query)
                disp.set_sequences(target, query)

        if collect_from_both:
            disp.init_for_strand()
            self._finish_one_strand(target, pt, query)
        self._chore = None

    def _build_position_table(self, target):
        """Build the target index (reference build_seed_position_table,
        pos_table.c:118) on the device where the device search reads it
        in place, else on the host (the gate of lastz_tpu/pipeline.py:
        789-798).  A failed device build raises."""
        cfg = self.cfg
        if (cfg.seed.type != "R" and not cfg.seed.rev_comp
                and cfg.seed.weight <= 26
                and not cfg.write_capsule and not cfg.show_pos_table
                and cfg.word_count_limit == 0 and cfg.word_count_keep == 0
                and cfg.dynamic_masking == 0
                and len(target.v) < (1 << 31)):
            return build_seed_position_table_device(
                target.v, 0, len(target.v), UPPER_NUC_TO_BITS, cfg.seed,
                cfg.step, device=self.device)
        return build_seed_position_table(
            target.v, 0, len(target.v), UPPER_NUC_TO_BITS,
            cfg.seed, cfg.step)

    # -- strand processing ----------------------------------------------------

    def _reporter_mode(self) -> str:
        """Choose immediate reporting vs collection (set_up_hit_processor).

        Decided ONCE, like the reference (lastz.c:2773): a match-count
        filter given as a ratio has minMatchCount==0 at setup time, so
        it does NOT flip the mode -- ungapped ratio filtering is
        silently inert in the reference, and stays inert here."""
        if getattr(self, "_mode_cache", None) is not None:
            return self._mode_cache
        self._mode_cache = self._reporter_mode_uncached()
        return self._mode_cache

    def _reporter_mode_uncached(self) -> str:
        cfg = self.cfg
        merge_anchors = cfg.basic_hit_type == HIT_RECOVER or cfg.twin_min_span > 0
        if (cfg.hsp_threshold.t == "S" and cfg.search_limit == 0
                and cfg.num_best_hsps == 0 and not cfg.chain
                and not cfg.gapped_extend and not merge_anchors
                and cfg.dynamic_masking == 0 and not cfg.report_census
                and not self._filtering_active()):
            return "report"
        return "collect"

    def _filtering_active(self) -> bool:
        cfg = self.cfg
        return (cfg.min_identity > 0 or cfg.max_identity < 1
                or cfg.min_coverage > 0 or cfg.max_coverage < 1
                or cfg.min_continuity > 0 or cfg.max_continuity < 1
                or cfg.min_match_count > 0 or cfg.max_mismatch_count >= 0
                or cfg.max_separate_gaps_count >= 0
                or cfg.max_gap_columns_count >= 0)

    def _hit_params(self) -> HitProcessorParams:
        cfg = self.cfg
        th = cfg.hsp_threshold
        zero = 0
        if th.t == "S" and th.s > 0:
            zero = th.s
        chore = getattr(self, "_chore", None)
        return HitProcessorParams(
            gf_extend=cfg.gf_extend,
            scoring=cfg.masked_scoring,
            x_drop=cfg.x_drop,
            hsp_threshold=th,
            hsp_zero_threshold=zero,
            entropic_hsp=cfg.entropic_hsp,
            report_entropy=cfg.report_entropy,
            min_matches=cfg.min_matches,
            max_transversions=cfg.max_transversions,
            filter_pattern=(cfg.seed.pattern if cfg.filter_cares_only else None),
            pos_filter=chore is not None,
            target_interval=(chore.target_interval if chore else (0, 0)),
            query_interval=(chore.query_interval if chore else (0, 0)),
        )

    def _start_one_strand(self, target, pt, query, empty_anchors=True,
                          prev_anchor_count=0) -> bool:
        cfg = self.cfg
        disp = self.dispatcher
        disp.init_for_strand()

        if cfg.segments_filename is not None:
            from .align.segments import read_segment_table
            if empty_anchors or self.anchors is None:
                self.anchors = SegmentTable(
                    coverage_limit=cfg.hsp_threshold.c
                    if cfg.hsp_threshold.t == "C" else 0)
            read_segment_table(
                cfg.segments_filename, self.anchors, target, query)
            return True

        if empty_anchors or self.anchors is None:
            self.anchors = SegmentTable(
                coverage_limit=cfg.hsp_threshold.c
                if cfg.hsp_threshold.t == "C" else 0)

        mode = self._reporter_mode()
        if cfg.hsp_immediate and cfg.gapped_extend:
            reporter = self._make_gappily_reporter(target, query)
        elif cfg.hsp_immediate:
            def reporter(pos1, pos2, length, s):
                # report_filtered_hsps: identity/coverage filters then print
                if self._segment_passes_filters(target, query,
                                                pos1 - length, pos2 - length,
                                                length):
                    disp.print_match(pos1 - length, pos2 - length, length, s)
                    return length
                return 0
        elif mode == "report":
            def reporter(pos1, pos2, length, s):
                disp.print_match(pos1 - length, pos2 - length, length, s)
                if cfg.mirror_hsp:
                    self._report_mirror(pos1, pos2, length, s)
                return length
        else:
            anchors = self.anchors
            rcf = query.rev_comp_flags

            def reporter(pos1, pos2, length, s):
                anchors.add(pos1 - length, pos2 - length, length, s, rcf)
                if cfg.mirror_hsp:
                    self._collect_mirror(pos1, pos2, length, s, rcf)
                return length

        search_limit = cfg.search_limit
        if search_limit > 0 and prev_anchor_count > 0:
            if prev_anchor_count < search_limit:
                search_limit -= prev_anchor_count
            else:
                search_limit = 1

        hit_mode = {0: "simple", 1: "recover"}[cfg.basic_hit_type]
        if cfg.twin_min_span > 0:
            hit_mode = "twin"
        if cfg.gf_extend == GFEX_NO_EXTEND and not cfg.gapped_extend:
            hit_mode = "plain"
        if cfg.raw_hits:
            # --rawhits: no hit filtering at all (lastz.c:5724)
            hit_mode = "plain"

        same_strand = (cfg.self_compare
                       and target.rev_comp_flags == query.rev_comp_flags)
        engine = SeedSearchEngine(
            target.v, pt, query.v, cfg.seed, UPPER_NUC_TO_BITS,
            self._hit_params(), reporter,
            self_compare=cfg.self_compare,
            same_strand=same_strand,
            search_limit=search_limit,
            hit_mode=hit_mode,
            twin_min_span=cfg.twin_min_span,
            twin_max_span=cfg.twin_max_span,
            anchors=self.anchors,
            seed_queue_size=cfg.seed_queue_size,
            band_width=cfg.band_width,
            device=self.device,
        )
        engine.on_limit_exceeded = self._make_limit_warner(query)
        chore = getattr(self, "_chore", None)
        fences = []
        if chore is not None:
            # fence the chore intervals for the duration of the search
            # (lastz.c:3030-3031; removed again at :3171)
            fences.append((target.v,
                           _fence_interval(target.v,
                                           chore.target_interval)))
            fences.append((query.v,
                           _fence_interval(query.v,
                                           chore.query_interval)))
        try:
            with self.stats.time("seed search"):
                if cfg.query_is_quantum:
                    engine.search_quantum(cfg.ball_score, 0,
                                          len(query.v))
                else:
                    engine.search(0, len(query.v))
        finally:
            for v, saved in fences:
                for pos, ch in saved:
                    v[pos] = ch

        if (cfg.search_limit > 0 and not cfg.search_limit_keep
                and self.anchors is not None
                and len(self.anchors) + prev_anchor_count > cfg.search_limit):
            return False
        return True

    def _make_limit_warner(self, query):
        """warn_for_search_limit (seed_search.c:3795-3813): tell the user
        this query exceeded the HSP limit; the count is kept even when the
        warning itself is suppressed (nowarn)."""
        def warn():
            self._search_limit_exceeded += 1
            if not self.cfg.search_limit_warn:
                return
            sys.stderr.write(
                'WARNING. Query "%s" contains more than %s HSPs.\n'
                % (query.name_for_output(), f"{self.cfg.search_limit:,}"))
            if not self._limit_warned_once:
                sys.stderr.write(
                    "All HSPs for this query are discarded and the query"
                    " is not processed further.\n")
                self._limit_warned_once = True
        return warn

    def _make_paired_warner(self, query, max_paired):
        """warn_for_paired_bases_limit (gapped_extend.c:5725-5754)."""
        def warn():
            name2 = ("seq2" if query.is_partitioned
                     else query.name_for_output())
            strand = "-" if query.rev_comp_flags & 2 else "+"
            sys.stderr.write(
                "WARNING. Query %s (%c strand) contains more than %s"
                " paired bases.\n"
                % (name2, ord(strand), f"{max_paired:,}"))
            if not self._paired_warned_once:
                if self.cfg.overly_paired_keep:
                    sys.stderr.write(
                        "Any gapped alignments already found for this"
                        " query/strand are reported but the\n"
                        "query/strand is not processed further.\n")
                else:
                    sys.stderr.write(
                        "All gapped alignments for this query/strand are"
                        " discarded and the query/strand\n"
                        "is not processed further.\n")
                self._paired_warned_once = True
        return warn

    def _finish_one_strand(self, target, pt, query):
        cfg = self.cfg
        disp = self.dispatcher
        anchors = self.anchors
        mode = self._reporter_mode()
        if mode == "report":
            return  # already printed during search

        hsps_are_adaptive = cfg.hsp_threshold.t != "S"
        low_anchor_score = 0
        if anchors is not None and hsps_are_adaptive:
            low_anchor_score = anchors.low_score
            if (self.secondary_anchors is not None
                    and len(self.secondary_anchors) > 0
                    and self.secondary_anchors.low_score < low_anchor_score):
                low_anchor_score = self.secondary_anchors.low_score

        merge_anchors = (cfg.basic_hit_type == HIT_RECOVER
                         or cfg.twin_min_span > 0
                         or cfg.segments_filename is not None)
        if anchors is not None and merge_anchors:
            anchors.merge_overlapping()

        if anchors is not None and not cfg.gapped_extend:
            self._filter_segments(target, query, anchors)

        if (anchors is not None and not anchors.have_scores
                and (cfg.chain or cfg.gapped_extend)):
            anchors.score_all(target.v, query.v, cfg.masked_scoring)

        if anchors is not None and cfg.chain:
            from .align.chain import reduce_to_chain
            reduce_to_chain(anchors, cfg.chain_diag, cfg.chain_anti,
                            cfg.scoring)
            anchors.sort_by_pos1()

        if anchors is not None and not cfg.gapped_extend:
            for seg in anchors.segments:
                disp.print_match(seg.pos1, seg.pos2, seg.length, seg.score,
                                 seg.hsp_id)

        if (self.targ_census is not None and anchors is not None
                and not cfg.gapped_extend):
            num_masked = self.targ_census.mask_segments(
                anchors, target.v, self._on_mask_interval)
            disp.print_x_stanza(num_masked)

        if cfg.gapped_extend:
            from .align.ydrop import gapped_extend, reduce_to_points
            reduce_to_points(target.v, query.v, cfg.scoring, anchors)
            gapped_threshold = cfg.gapped_threshold
            if gapped_threshold.t != "S" and hsps_are_adaptive:
                gapped_threshold = ScoreThreshold("S", low_anchor_score)
            # paired-bases cap: fixed count, or depth x query length
            # (lastz.c:3413-3417)
            max_paired = cfg.max_paired_bases
            if max_paired == 0 and cfg.max_paired_depth > 0.0:
                import math
                max_paired = int(
                    math.ceil(cfg.max_paired_depth * len(query.v)))
            with self.stats.time("gapped"):
                align_list = gapped_extend(
                    target, query, cfg.scoring, anchors,
                    inhibit_trivial=cfg.inhibit_trivial,
                    y_drop=cfg.y_drop,
                    trim_to_peak=not cfg.y_drop_untrimmed,
                    score_thresh=gapped_threshold,
                    traceback_mem=cfg.traceback_mem,
                    max_paired_bases=max_paired,
                    overly_paired_warn=cfg.overly_paired_warn,
                    overly_paired_keep=cfg.overly_paired_keep,
                    on_overly_paired=self._make_paired_warner(
                        query, max_paired),
                    truncation_report=not cfg.no_truncation_report,
                )
            align_list = self._filter_aligns(target, query, align_list)
            if align_list and cfg.inner_threshold > 0:
                from .align.tweener import tweener_interpolate
                align_list = tweener_interpolate(
                    self, target, query, align_list)
            if align_list:
                if cfg.mirror_gapped:
                    align_list = self._mirror_alignments(align_list)
                if cfg.de_gapify_output:
                    self._print_align_list_segments(align_list)
                else:
                    disp.print_align_list(align_list)
            if self.targ_census is not None and align_list:
                num_masked = self.targ_census.mask_aligns(
                    align_list, target.v, self._on_mask_interval)
                disp.print_x_stanza(num_masked)

    # -- helpers ---------------------------------------------------------------

    def _filter_segments(self, target, query, anchors):
        cfg = self.cfg
        if cfg.min_identity > 0 or cfg.max_identity < 1:
            from .filters.identity import filter_segments_by_identity
            filter_segments_by_identity(
                target.v, query.v, anchors, cfg.min_identity, cfg.max_identity)
        if cfg.min_coverage > 0 or cfg.max_coverage < 1:
            from .filters.coverage import filter_segments_by_coverage
            filter_segments_by_coverage(
                target, query, anchors, cfg.min_coverage, cfg.max_coverage)
        if cfg.min_match_count > 0:
            from .filters.identity import filter_segments_by_match_count
            filter_segments_by_match_count(
                target.v, query.v, anchors, cfg.min_match_count)
        if cfg.max_mismatch_count >= 0:
            from .filters.identity import filter_segments_by_mismatch_count
            filter_segments_by_mismatch_count(
                target.v, query.v, anchors, cfg.max_mismatch_count)

    def _filter_aligns(self, target, query, align_list):
        cfg = self.cfg
        if not align_list:
            return align_list
        if cfg.min_identity > 0 or cfg.max_identity < 1:
            from .filters.identity import filter_aligns_by_identity
            align_list = filter_aligns_by_identity(
                target.v, query.v, align_list,
                cfg.min_identity, cfg.max_identity)
        if cfg.min_coverage > 0 or cfg.max_coverage < 1:
            from .filters.coverage import filter_aligns_by_coverage
            align_list = filter_aligns_by_coverage(
                target, query, align_list, cfg.min_coverage, cfg.max_coverage)
        if cfg.min_continuity > 0 or cfg.max_continuity < 1:
            from .filters.continuity import filter_aligns_by_continuity
            align_list = filter_aligns_by_continuity(
                align_list, cfg.min_continuity, cfg.max_continuity)
        if cfg.min_match_count > 0:
            from .filters.identity import filter_aligns_by_match_count
            align_list = filter_aligns_by_match_count(
                target.v, query.v, align_list, cfg.min_match_count)
        if cfg.max_mismatch_count >= 0:
            from .filters.identity import filter_aligns_by_mismatch_count
            align_list = filter_aligns_by_mismatch_count(
                target.v, query.v, align_list, cfg.max_mismatch_count)
        if cfg.max_separate_gaps_count >= 0:
            from .filters.continuity import filter_aligns_by_num_gaps
            align_list = filter_aligns_by_num_gaps(
                align_list, cfg.max_separate_gaps_count)
        if cfg.max_gap_columns_count >= 0:
            from .filters.continuity import filter_aligns_by_num_gap_columns
            align_list = filter_aligns_by_num_gap_columns(
                align_list, cfg.max_gap_columns_count)
        return align_list

    def _make_gappily_reporter(self, target, query):
        """hspImmediate + gapped: per-hit gapped extension and printing
        (reference gappily_extend_hsps, gapped_extend.c:5279)."""
        from .align.ydrop import YDropAligner, segment_peak, format_alignment
        from .align.ydrop import GAlign

        cfg = self.cfg
        disp = self.dispatcher
        aligner = YDropAligner(target.v, query.v, cfg.scoring, cfg.y_drop,
                               not cfg.y_drop_untrimmed, cfg.traceback_mem)
        # alignment-hash dedup under search limits; a set, like the
        # reference's alignment_hash table (edit_script.c), so the
        # membership test is O(1) rather than a list scan
        seen_hashes: set = set()

        def reporter(pos1, pos2, length, s):
            p1 = pos1 - length
            p2 = pos2 - length
            peak = segment_peak(
                target.v[p1 : p1 + length], query.v[p2 : p2 + length],
                cfg.scoring.sub)
            a1 = p1 + peak
            a2 = p2 + peak
            aligner.left_align = aligner.right_align = None
            aligner.left_seg = aligner.right_seg = None
            aligner.above_list = aligner.below_list = None
            if target.is_partitioned:
                part = target.lookup_partition(a1)
                aligner.low1, aligner.high1 = part.sep_before + 1, part.sep_after
            if query.is_partitioned:
                part = query.lookup_partition(a2)
                aligner.low2, aligner.high2 = part.sep_before + 1, part.sep_after
            sc, start1, start2, stop1, stop2, script = aligner.ydrop_align(
                a1, a2)
            if sc < cfg.gapped_threshold.s:
                return 0
            mp = GAlign(hsp_id=0)
            a = format_alignment(target.v, query.v, start1, start2,
                                 stop1, stop2, sc, script, mp)
            if mp.first_seg is None:
                return 0
            alist = self._filter_aligns(target, query, [a])
            if not alist:
                return 0
            if cfg.search_limit > 1:
                h = (a.beg1, a.end1, target.rev_comp_flags,
                     a.beg2, a.end2, query.rev_comp_flags)
                if len(seen_hashes) > cfg.search_limit:
                    return 0
                if h in seen_hashes:
                    return 0
                if len(seen_hashes) >= cfg.search_limit:
                    seen_hashes.add(h)
                    return 1
                seen_hashes.add(h)
            disp.print_align_list(alist)
            return 1

        return reporter

    def _segment_passes_filters(self, target, query, pos1, pos2, length):
        """reference report_filtered_hsps (lastz.c:3905)."""
        cfg = self.cfg
        from .filters.identity import segment_identity_counts
        if cfg.min_identity > 0 or cfg.max_identity < 1:
            numer, denom = segment_identity_counts(
                target.v, pos1, query.v, pos2, length)
            ident = numer / denom if denom else 0.0
            if not (cfg.min_identity <= ident <= cfg.max_identity):
                return False
        if cfg.min_coverage > 0 or cfg.max_coverage < 1:
            from .filters.coverage import segment_coverage

            class _S:
                pass
            seg = _S()
            seg.pos1, seg.pos2, seg.length = pos1, pos2, length
            numer, denom = segment_coverage(target, query, seg)
            cov = numer / denom if denom else 0.0
            if not (cfg.min_coverage <= cov <= cfg.max_coverage):
                return False
        if cfg.min_match_count > 0:
            numer, denom = segment_identity_counts(
                target.v, pos1, query.v, pos2, length)
            if denom == 0 or numer < cfg.min_match_count:
                return False
        if cfg.max_mismatch_count >= 0:
            # the reference passes minMatchCount here by mistake
            # (lastz.c:3987, filter_segment_by_mismatch_count called
            # with currParams->minMatchCount) -- replicated
            numer, denom = segment_identity_counts(
                target.v, pos1, query.v, pos2, length)
            if denom == 0 or denom - numer > cfg.min_match_count:
                return False
        return True

    def _on_mask_interval(self, beg, end):
        """Masking callback: drop the seeds over the masked interval
        BEFORE the characters are overwritten (reference
        remove_interval_seeds)."""
        from .masking import remove_interval_seeds
        remove_interval_seeds(self.pt, self.cfg.seed, self.target.v,
                              beg - 1, end)

    def _print_align_list_segments(self, align_list):
        """reference print_align_list_segments (output.c:126): print
        each gapped alignment's ungapped segments as matches."""
        disp = self.dispatcher
        sub = self.cfg.scoring.sub
        v1 = self.target.v
        v2 = disp.seq2.v
        for a in align_list:
            i = j = 0
            beg1, beg2 = a.beg1, a.beg2
            ops = a.script.ops
            op_ix = 0
            height = a.end1 - beg1 + 1
            width = a.end2 - beg2 + 1
            while i < height or j < width:
                prev_i, prev_j = i, j
                run = 0
                while op_ix < len(ops) and ops[op_ix][0] == "S":
                    run += ops[op_ix][1]
                    op_ix += 1
                i += run
                j += run
                if i < height or j < width:
                    if op_ix < len(ops):
                        op, r = ops[op_ix]
                        op_ix += 1
                        if op == "I":
                            j += r
                        else:
                            i += r
                s = 0
                if run:
                    s = sub[v1[beg1 - 1 + prev_i : beg1 - 1 + prev_i + run],
                            v2[beg2 - 1 + prev_j : beg2 - 1 + prev_j + run]
                            ].sum().item()
                disp.print_match(beg1 - 1 + prev_i, beg2 - 1 + prev_j,
                                 run, s, a.hsp_id)

    def _mirror_coords(self, query, pos1, pos2, length):
        """Mirror an HSP across the self-alignment diagonal
        (reference report_hsps/collect_hsps mirroring)."""
        if self.target.rev_comp_flags == query.rev_comp_flags:
            return pos1, pos2
        s1 = len(self.target.v) - pos1 + length
        s2 = len(query.v) - pos2 + length
        if s2 == pos1 and s1 == pos2:
            return None
        return s1, s2

    def _report_mirror(self, pos1, pos2, length, s):
        m = self._mirror_coords(self.dispatcher.seq2, pos1, pos2, length)
        if m is None:
            return
        s1, s2 = m
        self.dispatcher.print_match(s2 - length, s1 - length, length, s)

    def _collect_mirror(self, pos1, pos2, length, s, rcf):
        m = self._mirror_coords(self.dispatcher.seq2, pos1, pos2, length)
        if m is None:
            return
        s1, s2 = m
        self.anchors.add(s2 - length, s1 - length, length, s, rcf)

    def _mirror_alignments(self, align_list):
        """reference mirror_alignments (lastz.c:4229): add the mirror
        image of each alignment; opposite-strand alignments touching
        the main anti-diagonal are truncated and self-joined."""
        from .align.edit_script import EditScript, Alignment

        target = self.target
        query = self.dispatcher.seq2
        seq_len = len(target.v)
        same_strand = target.rev_comp_flags == query.rev_comp_flags

        out = []
        mirrored = []
        for a in align_list:
            pos1, end1 = a.beg1 - 1, a.end1
            pos2, end2 = a.beg2 - 1, a.end2
            if same_strand:
                b = Alignment(
                    beg1=pos2 + 1, beg2=pos1 + 1, end1=end2, end2=end1,
                    script=a.script.mirrored(), score=a.score)
                out.append(a)
                mirrored.append(b)
                continue
            # opposite strands: conceptual coordinates flip
            in_pos2, in_end2 = pos2, end2
            invert1 = invert2 = seq_len
            if target.is_partitioned or query.is_partitioned:
                p1 = target.lookup_partition(pos1)
                p2 = query.lookup_partition(pos2)
                invert1 = p1.sep_before + p1.sep_after + 1
                invert2 = p2.sep_before + p2.sep_after + 1
            pos2c = invert2 - in_pos2
            end2c = invert2 - in_end2
            if pos1 == pos2c:
                continue  # starts on the diagonal: discard
            if end1 >= end2c:
                # touches or crosses the diagonal: truncate + self-join
                x, y, truncated = _upper_truncate(a.script, pos1, pos2c)
                if truncated and x is None:
                    continue
                have_overlap = False
                if truncated:
                    if x < y or x > y + 1:
                        sys.stderr.write(
                            "WARNING. alignment crosses the main diagonal "
                            "in an unexpected way\n")
                        a.end1 = x
                        a.end2 = invert2 - y
                        out.append(a)
                        continue
                    a.end1 = end1 = x
                    a.end2 = in_end2 = invert2 - y
                    have_overlap = x == y + 1
                tmp = a.script.reversed().mirrored()
                if have_overlap:
                    _trim_head(tmp, 1)
                a.script.append_script(tmp)
                n1, n2 = a.script.lengths()
                a.end1 = pos1 + n1
                a.end2 = in_pos2 + n2
                from .align.ydrop import YDropAligner
                al = YDropAligner(target.v, query.v, self.cfg.scoring,
                                  self.cfg.y_drop, True)
                a.score = al._score_alignment(pos1, in_pos2, a.script)
                out.append(a)
                continue
            b = Alignment(
                beg1=(invert2 - in_end2) + 1, end1=(invert2 - in_pos2),
                beg2=(invert1 - end1) + 1, end2=(invert1 - pos1),
                script=a.script.reversed().mirrored(), score=a.score)
            out.append(a)
            mirrored.append(b)
        return out + mirrored

    def _swap_anchor_sets(self):
        self.anchors, self.secondary_anchors = (
            self.secondary_anchors, self.anchors)

    def _split_anchors(self, rcf: int):
        """Move segments NOT matching rcf to the secondary table."""
        if self.secondary_anchors is None:
            self.secondary_anchors = SegmentTable()
        keep, move = [], []
        for seg in self.anchors.segments:
            (keep if seg.seg_id == rcf else move).append(seg)
        self.anchors.segments = keep
        self.secondary_anchors.segments = move

    def _choose_best_anchors(self, n: int):
        a = self.anchors
        if a is None or len(a) <= n:
            return
        a.segments.sort(key=lambda s: -s.score)
        cutoff = a.segments[n - 1].score
        end = len(a.segments)
        for i in range(n, len(a.segments)):
            if a.segments[i].score < cutoff:
                end = i
                break
        a.segments = a.segments[:end]
