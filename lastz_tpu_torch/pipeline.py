"""The pipeline with the port's device stages swapped in.

Pipeline subclasses lastz_tpu.pipeline.Pipeline and owns copies of
the two methods that pick the device path through function-local
imports: _start_one_strand (lastz_tpu/pipeline.py:869-977) builds the
port's seed search engine, and _finish_one_strand (:1021-1111) calls
the port's gapped_extend.  The target index is the host build
(build_seed_position_table), uploaded once per run by the seed
search; building it on the device waits for a later slice.  Everything
else, output bytes included, is lastz_tpu's.
"""

from __future__ import annotations

import math

from lastz_tpu.align.segments import SegmentTable
from lastz_tpu.config import GFEX_NO_EXTEND, HIT_RECOVER, ScoreThreshold
from lastz_tpu.core.encoding import UPPER_NUC_TO_BITS
from lastz_tpu.index.postable import build_seed_position_table
from lastz_tpu.pipeline import Pipeline as _HostPipeline
from lastz_tpu.pipeline import _fence_interval

from .align.ydrop import gapped_extend
from .device import get_device
from .search.engine import SeedSearchEngine


class Pipeline(_HostPipeline):
    def __init__(self, cfg, out=None, collector=None):
        super().__init__(cfg, out, collector)
        self.device = get_device()

    def _farm_devices(self):
        return []  # multi-card farm-out is not ported yet

    def _build_position_table(self, target):
        cfg = self.cfg
        return build_seed_position_table(
            target.v, 0, len(target.v), UPPER_NUC_TO_BITS,
            cfg.seed, cfg.step)

    def _start_one_strand(self, target, pt, query, empty_anchors=True,
                          prev_anchor_count=0) -> bool:
        cfg = self.cfg
        disp = self.dispatcher
        disp.init_for_strand()

        if cfg.segments_filename is not None:
            from lastz_tpu.align.segments import read_segment_table
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
            from lastz_tpu.align.chain import reduce_to_chain
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
            from lastz_tpu.align.ydrop import reduce_to_points
            reduce_to_points(target.v, query.v, cfg.scoring, anchors)
            gapped_threshold = cfg.gapped_threshold
            if gapped_threshold.t != "S" and hsps_are_adaptive:
                gapped_threshold = ScoreThreshold("S", low_anchor_score)
            # paired-bases cap: fixed count, or depth x query length
            # (lastz.c:3413-3417)
            max_paired = cfg.max_paired_bases
            if max_paired == 0 and cfg.max_paired_depth > 0.0:
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
                    device=self.device,
                    truncation_report=not cfg.no_truncation_report,
                )
            align_list = self._filter_aligns(target, query, align_list)
            if align_list and cfg.inner_threshold > 0:
                from lastz_tpu.align.tweener import tweener_interpolate
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

