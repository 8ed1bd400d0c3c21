"""Output dispatcher: lazy per-strand headers + format fan-out.

Mirrors the reference output.c state machine: the s/h (or equivalent)
per-strand header is only emitted when the first match or alignment of
that strand is printed (output.c:550-770, strandHeaderPrinted).
"""

from __future__ import annotations

from typing import Optional, TextIO

from . import lav as lav_mod


class OutputDispatcher:
    def __init__(self, config, out: TextIO, program_name: str = "lastz_tpu.v0.1.0",
                 collector=None):
        self.cfg = config
        self.out = out
        self.collector = collector
        self.program_name = program_name
        self.strand_header_printed = False
        self.printed_for_query = 0
        self._name_header = False
        self._prev_names = (None, None)
        self.seq1 = None
        self.seq2 = None
        # job headers echo the FILE part of each sequence spec, with
        # /contig and [bracket] parts stripped (reference keeps
        # seqXFilename pre-stripped; see d-stanza of any /name run)
        from ..io.sequence import parse_sequence_spec

        def file_part(name):
            if not name:
                # query read from stdin (reference prints "(stdin)")
                return "(stdin)"
            try:
                return parse_sequence_spec(name).filename
            except Exception:
                return name
        self.name1 = file_part(config.seq1_filename)
        self.name2 = file_part(config.seq2_filename)
        self._writer = None
        fmt = config.output_format
        # lav family (reference fmtLav/LavComment/LavScore/LavText)
        self._lav_extras = fmt == "lav+"
        self._lav_score_l = fmt == "lavscore"
        self._lav_text = fmt in ("lav+text", "text+lav")
        # axt family (fmtAxt/AxtComment/AxtGeneral)
        self._axt_comments = fmt == "axt+"
        self._axt_size2 = fmt in ("axt:size2", "waxt")
        # maf comments (fmtMafComment)
        self._maf_comments = fmt == "maf+"
        self._gfa_noscore = fmt == "gfanoscore"
        if fmt in ("lav", "lav+", "lav+text", "text+lav", "lavscore"):
            self._fmt = "lav"
        elif fmt in ("axt:size2", "waxt"):
            self._fmt = "axt"
        elif fmt == "gfanoscore":
            self._fmt = "gfa"
        else:
            self._fmt = fmt
        # identity-distribution / inference-stats collectors
        # (fmtIdDist, fmtInfStats: collected per record, printed in the
        # job footer)
        self._iddist = None
        self._infstats = None
        if self._fmt == "identity":
            from .iddist import IdentityDistribution
            self._iddist = IdentityDistribution()
        elif self._fmt == "istats":
            from .infstats import InferenceStatsReport
            self._infstats = InferenceStatsReport()
        # formats that are canned genpaf key strings (reference
        # genpaf.h:117-126 and lastz.c --format= parsing)
        from . import genpaf as gp_mod
        self._genpaf_keys = None
        if self._fmt in ("general", "general-"):
            self._genpaf_keys = config.output_info or gp_mod.STANDARD_KEYS
        elif self._fmt == "segments":
            self._genpaf_keys = gp_mod.SEGMENT_KEYS
        elif self._fmt == "paf":
            self._genpaf_keys = gp_mod.PAF_MINIMAP2_KEYS
        elif self._fmt == "paf:wfmash":
            self._genpaf_keys = gp_mod.PAF_WFMASH_KEYS
        elif self._fmt == "mapping":
            self._genpaf_keys = gp_mod.MAPPING_KEYS
        elif self._fmt in ("blastn", "blastn-"):
            self._genpaf_keys = gp_mod.BLAST_KEYS
        elif self._fmt == "rdotplot":
            self._genpaf_keys = gp_mod.RDOTPLOT_KEYS
            self._name_header = True
        elif self._fmt == "rdotplot+score":
            self._genpaf_keys = gp_mod.RDOTPLOT_SCORE_KEYS
            self._name_header = True

        # secondary output channels (reference lastz.c:8557-8580):
        # --rdotplot=/--axt=/--maf= files written alongside the primary
        self.secondaries = []
        if getattr(config, "dotplot_filename", None) \
                or getattr(config, "axt_filename", None) \
                or getattr(config, "maf_filename", None):
            import dataclasses
            pairs = []
            if config.dotplot_filename:
                if self._fmt in ("rdotplot", "rdotplot+score"):
                    raise SystemExit(
                        "--format=rdotplot can't be used with "
                        "--rdotplot=<file>")
                pairs.append((config.dotplot_keys or "rdotplot",
                              config.dotplot_filename))
            if config.axt_filename:
                if self._fmt == "axt":
                    raise SystemExit(
                        "--format=axt can't be used with --axt=<file>")
                pairs.append(("axt", config.axt_filename))
            if config.maf_filename:
                if self._fmt == "maf":
                    raise SystemExit(
                        "--format=maf can't be used with --maf=<file>")
                pairs.append(("maf", config.maf_filename))
            for fmt2, fname in pairs:
                sub_cfg = dataclasses.replace(
                    config, output_format=fmt2, dotplot_filename=None,
                    axt_filename=None, maf_filename=None,
                    end_comment=False)
                self.secondaries.append(OutputDispatcher(
                    sub_cfg, open(fname, "w"), program_name))

    # -- lifecycle ---------------------------------------------------------

    def set_sequences(self, seq1, seq2):
        self.seq1 = seq1
        self.seq2 = seq2
        for sub in self.secondaries:
            sub.set_sequences(seq1, seq2)

    def init_for_query(self):
        self.printed_for_query = 0
        for sub in self.secondaries:
            sub.init_for_query()

    def init_for_strand(self):
        self.strand_header_printed = False
        for sub in self.secondaries:
            sub.init_for_strand()

    def job_header(self):
        for sub in self.secondaries:
            sub.job_header()
        cfg = self.cfg
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_job_header(
                self.program_name,
                self.name1, self.name2, cfg.args,
                cfg.scoring, cfg.hsp_threshold, cfg.gapped_threshold,
                cfg.dynamic_masking,
                with_extras=self._lav_extras,
                x_drop=cfg.effective_x_drop(),
                y_drop=cfg.effective_y_drop()))
            if self._lav_extras or self._lav_text:
                # print_options via print_generic (lastz.c:1443,10440):
                # lav+ prints comments; lav+text prints comment + plain
                for line in self._options_lines():
                    self.out.write(lav_mod.lav_comment(line))
                    if self._lav_text:
                        self.out.write(line + "\n")
        elif self._fmt == "gfa":
            from . import gfa as gfa_mod
            self.out.write(gfa_mod.gfa_job_header(
                self.program_name, self.name1, self.name2))
            # reference print_options emits z-records after the header
            for line in self._options_lines():
                self.out.write(gfa_mod.gfa_generic(line))
        elif self._fmt in ("axt", "axt+"):
            from . import axt as axt_mod
            self.out.write(axt_mod.axt_job_header(
                self.program_name, cfg.args, cfg.scoring,
                cfg.hsp_threshold, cfg.gapped_threshold,
                cfg.effective_x_drop(), cfg.effective_y_drop()))
            if self._axt_comments:
                for line in self._options_lines():
                    self.out.write(f"# {line}\n")
        elif self._fmt in ("maf", "maf+"):
            from . import maf as maf_mod
            self.out.write(maf_mod.maf_job_header(
                self.program_name, cfg.args, cfg.scoring,
                cfg.hsp_threshold, cfg.gapped_threshold,
                cfg.effective_x_drop(), cfg.effective_y_drop(),
                with_comments=True))
            if self._maf_comments:
                for line in self._options_lines():
                    self.out.write(f"# {line}\n")
        elif self._fmt in ("maf-",):
            pass
        elif self._fmt in ("sam", "softsam", "hardsam"):
            from . import sam as sam_mod
            self.out.write(sam_mod.sam_job_header(
                self.cfg, getattr(self.cfg, "read_group", None)))
            self._sam_sq_printed = False
        elif self._fmt in ("sam-", "softsam-", "hardsam-"):
            pass
        elif self._fmt == "cigar":
            pass
        elif self._genpaf_keys is not None:
            from . import genpaf as gp_mod
            gp_mod.reset_alignment_counter()
            if self._fmt in ("general", "segments"):
                self.out.write(gp_mod.genpaf_job_header(self._genpaf_keys))
        elif self._fmt in ("text", "ztext"):
            # reference print_options emits plain seed=/step= lines
            for line in self._options_lines():
                self.out.write(line + "\n")
        elif self._fmt in ("none", "differences", "differences-",
                           "infscores", "comp", "deseed", "identity",
                           "istats"):
            pass
        else:
            raise ValueError(f"unsupported output format {self._fmt}")

    def _options_lines(self):
        """reference print_options (lastz.c:10440): the seed/step
        settings lines, rendered per-format as comments or records."""
        from ..core.seeds import seed_pattern_string
        cfg = self.cfg
        trans = {0: "", 1: " w/transition", 2: " w/2 transitions"}[
            cfg.seed.with_trans]
        return [f"seed={seed_pattern_string(cfg.seed)}{trans}",
                f"step={cfg.step}"]

    def job_footer(self):
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_job_footer())
        elif self._iddist is not None:
            self._iddist.print_job(self.out)
        elif self._infstats is not None:
            self._infstats.print_job(self.out)
        if self.cfg.end_comment:
            self.out.write("# lastz end-of-file\n")
        for sub in self.secondaries:
            sub.job_footer()
            sub.out.close()

    def _strand_header(self):
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_header(self.seq1, self.seq2))
        elif self._fmt == "gfa":
            from . import gfa as gfa_mod
            self.out.write(gfa_mod.gfa_header(self.seq1, self.seq2))
        elif self._fmt == "blastn":
            # print_blast_header (genpaf.c:252-278): per-strand comment
            # block naming the query and database (blastn- omits it)
            name2 = self.seq2.name_for_output() or "query"
            self.out.write("# %s %s\n" % (self.program_name, self.cfg.args))
            self.out.write("# Query: %s\n" % name2)
            self.out.write("# Database: %s\n"
                           % (self.seq1.filename or ""))
            self.out.write(
                "# Fields: query id, subject id, % identity,"
                " alignment length, mismatches, gap opens, q. start,"
                " q. end, s. start, s. end, evalue, bit score\n")
        elif self._name_header:
            # rdotplot: a name pair line whenever the names change
            # (output.c fmtGenpafNameHeader)
            name1 = self.seq1.name_for_output() or "seq1"
            name2 = self.seq2.name_for_output() or "seq2"
            if (name1, name2) != self._prev_names:
                if self._fmt == "rdotplot+score":
                    self.out.write(f"{name1}\t{name2}\tscore\n")
                else:
                    self.out.write(f"{name1}\t{name2}\n")
                self._prev_names = (name1, name2)
        # most other formats have no per-strand header

    def _ensure_strand_header(self):
        if not self.strand_header_printed:
            self._strand_header()
            self.strand_header_printed = True

    # -- records -----------------------------------------------------------

    def print_match(self, pos1: int, pos2: int, length: int, s: int,
                    hsp_id: int = 0):
        """Print one ungapped HSP; pos1/pos2 are START positions (origin-0)."""
        if self._fmt == "infscores":
            # scoring-inference collection (reference fmtInfScores,
            # output.c print_match -> gather_stats_from_match)
            if self.collector is not None:
                self.collector.gather_from_match(
                    self.seq1, pos1, self.seq2, pos2, length)
            return
        cfg = self.cfg
        if cfg.search_limit > 0 and self.printed_for_query >= cfg.search_limit:
            return
        self.printed_for_query += 1
        for sub in self.secondaries:
            sub.print_match(pos1, pos2, length, s, hsp_id)
        self._ensure_strand_header()
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_match(
                self.seq1.v, pos1, self.seq2.v, pos2, length, s,
                score_in_l_line=self._lav_score_l))
            if self._lav_text:
                # quirk: lav+text matches are ONE-based (outputFormat !=
                # fmtZeroText, output.c:846-848) while its gapped
                # alignments are zero-based (explicit false, :604)
                from . import text as text_mod
                self.out.write(text_mod.text_match(
                    self.seq1, pos1, self.seq2, pos2, length, s,
                    one_based=True))
        elif self._fmt == "gfa":
            from . import gfa as gfa_mod
            self.out.write(gfa_mod.gfa_match(
                self.seq1, pos1, self.seq2, pos2, length,
                0 if self._gfa_noscore else s))
        elif self._fmt == "comp":
            from . import comp as comp_mod
            self.out.write(comp_mod.comp_match(
                self.seq1, pos1, self.seq2, pos2, length, s,
                cfg.seed, cfg.step))
        elif self._fmt == "deseed":
            from . import comp as comp_mod
            self.out.write(comp_mod.deseed_match(
                self.seq1, pos1, self.seq2, pos2, length))
        elif self._fmt == "identity":
            self._iddist.from_match(self.seq1, pos1, self.seq2, pos2, length)
        elif self._fmt == "istats":
            self._infstats.from_match(self.seq1, pos1,
                                      self.seq2, pos2, length)
        elif self._fmt in ("sam", "softsam", "hardsam",
                           "sam-", "softsam-", "hardsam-"):
            from . import sam as sam_mod
            if not getattr(self, "_sam_sq_printed", True):
                self.out.write(sam_mod.sam_sq_header(self.seq1))
                self._sam_sq_printed = True
            self.out.write(sam_mod.sam_match(
                self.cfg, self.seq1, pos1, self.seq2, pos2, length,
                hard="hard" in self._fmt))
        elif self._genpaf_keys is not None:
            from . import genpaf as gp_mod
            self.out.write(gp_mod.genpaf_match(
                self.cfg, self.seq1, pos1, self.seq2, pos2, length, s,
                self._genpaf_keys))
        elif self._fmt in ("maf", "maf+", "maf-"):
            from . import maf as maf_mod
            if self._maf_comments:
                from .comments import match_comments
                self.out.write(match_comments(
                    self.seq1, pos1, self.seq2, pos2, length))
            self.out.write(maf_mod.maf_match(
                self.seq1, pos1, self.seq2, pos2, length, s))
        elif self._fmt in ("axt", "axt+"):
            from . import axt as axt_mod
            if self._axt_comments:
                from .comments import match_comments
                self.out.write(match_comments(
                    self.seq1, pos1, self.seq2, pos2, length,
                    with_cigar=False))
            self.out.write(axt_mod.axt_match(
                self.seq1, pos1, self.seq2, pos2, length, s,
                self._next_axt_id(), extras_size2=self._axt_size2))
        elif self._fmt in ("text", "ztext"):
            from . import text as text_mod
            self.out.write(text_mod.text_match(
                self.seq1, pos1, self.seq2, pos2, length, s,
                one_based=(self._fmt == "text")))
        elif self._fmt == "none":
            pass
        else:
            raise ValueError(
                f"format {self._fmt} cannot print ungapped matches yet")

    _axt_counter: int = 0

    def _next_axt_id(self) -> int:
        n = self._axt_counter
        self._axt_counter += 1
        return n

    def print_align_list(self, alignments):
        """Print gapped alignments (list of Alignment)."""
        if not alignments:
            return
        if self._fmt == "infscores":
            if self.collector is not None:
                for a in alignments:
                    self.collector.gather_from_align(self.seq1, self.seq2, a)
            return
        if self._fmt == "identity":
            for a in alignments:
                self._iddist.from_align(self.seq1, self.seq2, a)
            return
        if self._fmt == "istats":
            for a in alignments:
                self._infstats.from_align(self.seq1, self.seq2, a)
            return
        for sub in self.secondaries:
            if sub._fmt in ("rdotplot", "rdotplot+score"):
                # the dotplot channel is always de-gapified (reference
                # output.c:713 print_genpaf_align_list_segments)
                sub._print_aligns_degapified(alignments)
            else:
                sub.print_align_list(alignments)
        cfg = self.cfg
        for a in alignments:
            if cfg.search_limit > 0 and self.printed_for_query >= cfg.search_limit:
                return
            self.printed_for_query += 1
            self._ensure_strand_header()
            self._print_align(a)

    def _print_align(self, a):
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_align(
                self.seq1.v, a.beg1 - 1, a.end1,
                self.seq2.v, a.beg2 - 1, a.end2,
                a.script, a.score))
            if self._lav_text:
                # reference passes oneBased=false here (output.c:604-615)
                from . import text as text_mod
                self.out.write(text_mod.text_align(
                    self.seq1, self.seq2, a, one_based=False))
        elif self._fmt in ("axt", "axt+"):
            from . import axt as axt_mod
            if self._axt_comments:
                from .comments import align_comments
                self.out.write(align_comments(
                    self.seq1, self.seq2, a,
                    with_continuity=False, with_cigar=False))
            self.out.write(axt_mod.axt_align(
                self.seq1, self.seq2, a, self._next_axt_id(),
                extras_size2=self._axt_size2))
        elif self._fmt in ("maf", "maf+", "maf-"):
            from . import maf as maf_mod
            if self._maf_comments:
                from .comments import align_comments
                self.out.write(align_comments(
                    self.seq1, self.seq2, a,
                    with_continuity=True, with_cigar=True))
            self.out.write(maf_mod.maf_align(self.seq1, self.seq2, a))
        elif self._fmt == "gfa":
            from . import gfa as gfa_mod
            self.out.write(gfa_mod.gfa_align(
                self.seq1, self.seq2, a,
                scoring=None if self._gfa_noscore else self.cfg.scoring))
        elif self._genpaf_keys is not None:
            from . import genpaf as gp_mod
            self.out.write(gp_mod.genpaf_align(
                self.cfg, self.seq1, self.seq2, a, self._genpaf_keys))
        elif self._fmt in ("sam", "softsam", "hardsam", "sam-", "softsam-", "hardsam-"):
            from . import sam as sam_mod
            if not getattr(self, "_sam_sq_printed", True):
                self.out.write(sam_mod.sam_sq_header(self.seq1))
                self._sam_sq_printed = True
            self.out.write(sam_mod.sam_align(
                self.cfg, self.seq1, self.seq2, a,
                hard="hard" in self._fmt))
        elif self._fmt == "cigar":
            from . import cigar as cigar_mod
            self.out.write(cigar_mod.cigar_align(self.seq1, self.seq2, a))
        elif self._fmt in ("text", "ztext"):
            from . import text as text_mod
            self.out.write(text_mod.text_align(
                self.seq1, self.seq2, a,
                one_based=(self._fmt == "text")))
        elif self._fmt in ("differences", "differences-"):
            from . import diffs as diffs_mod
            self.out.write(diffs_mod.diffs_align(
                self.seq1, self.seq2, a,
                with_blocks=(self._fmt == "differences"),
                inhibit_n=self.cfg.n_is_ambiguous))
        elif self._fmt in ("none", "comp", "deseed"):
            pass
        else:
            raise ValueError(f"format {self._fmt} cannot print alignments yet")

    def _print_aligns_degapified(self, align_list):
        """Print each alignment's gap-free segments as matches
        (reference print_align_list_segments, output.c:126)."""
        sub = self.cfg.scoring.sub
        v1 = self.seq1.v
        v2 = self.seq2.v
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
                self.print_match(beg1 - 1 + prev_i, beg2 - 1 + prev_j,
                                 run, s, a.hsp_id)

    def print_x_stanza(self, num_masked: int):
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_x_stanza(num_masked))

    def print_m_stanza(self, census):
        if self._fmt == "lav":
            self.out.write(lav_mod.lav_m_stanza(census))

    def print_census_stanza(self, census):
        """Census stanza, lav family only (reference output.c:1205)."""
        if self._fmt == "lav":
            self.out.write("Census {\n")
            census.print_census(self.out, None, " ")
            self.out.write("}\n")
