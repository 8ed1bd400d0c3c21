"""--format=istats / infstats: inference statistics report
(reference infer_scores.c:2284-2362, fmtInfStats)."""

from __future__ import annotations

from ..core.encoding import BITS_TO_NUC
from ..infer import InfStats, accumulate_from_match, accumulate_from_align


def _print_distn(out, prefix, d: dict):
    if not d:
        out.write(f"{prefix}  (none)\n")
        return
    for length in sorted(d):
        out.write(f"{prefix}  {length}:{d[length]}\n")


class InferenceStatsReport:
    def __init__(self):
        self.inf = InfStats()

    def from_match(self, seq1, pos1, seq2, pos2, length):
        accumulate_from_match(self.inf, seq1.v, pos1, seq2.v, pos2, length)

    def from_align(self, seq1, seq2, a):
        accumulate_from_align(self.inf, seq1.v, seq2.v, a)

    def print_job(self, out):
        """reference private_print_inference_stats_job
        (infer_scores.c:2329)."""
        inf = self.inf
        ref, sec = "seq1", "seq2"
        out.write(f"{ref} vs {sec}\n")
        out.write("  0% < GC <= 100%\n")
        out.write("    %-7s %d bases, %d gaps, %d runs\n"
                  % (ref, inf.ref_bases,
                     sum(inf.ref_gaps.values()), sum(inf.ref_runs.values())))
        out.write("    %-7s %d bases, %d gaps, %d runs\n"
                  % (sec, inf.sec_bases,
                     sum(inf.sec_gaps.values()), sum(inf.sec_runs.values())))
        for name, bkgd in ((ref, inf.ref_bkgd), (sec, inf.sec_bkgd)):
            out.write("    %-7s" % name)
            for c in range(4):
                out.write(" %c:%d" % (BITS_TO_NUC[c], bkgd[c]))
            out.write("\n")
        for c1 in range(4):
            out.write("    ")
            out.write(" ".join(
                "%c%c:%d" % (BITS_TO_NUC[c1], BITS_TO_NUC[c2],
                             inf.subs[c1, c2])
                for c2 in range(4)))
            out.write("\n")
        for label, d in (
                (f"blocks in {ref}", inf.ref_blocks),
                (f"blocks in {sec}", inf.sec_blocks),
                (f"gaps in {ref}", inf.ref_gaps),
                (f"gaps in {sec}", inf.sec_gaps),
                (f"runs in {ref}", inf.ref_runs),
                (f"runs in {sec}", inf.sec_runs)):
            out.write(f"    {label}\n")
            _print_distn(out, "    ", d)
        out.write("    segments\n")
        _print_distn(out, "    ", inf.segments)
        out.write("\n")
