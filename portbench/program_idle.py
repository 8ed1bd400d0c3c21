"""The card's idle time named by the program's own spans.

trace.device_reading names each idle gap of the card by the harness's
span that holds it (`trace.Spans.label`). `ProgramSpans.label` names it
by the innermost span of the program (lastz_tpu_torch/stats.py) that
holds it, and by the harness's span where none does. Both lie on
torch.profiler's timeline: a gap at `host0 + t` is `t` seconds after
the profile's start, which is `trace_start_ns` on the Unix clock, and
the program's trace maps its spans onto the Unix clock.

    python3 portbench/program_idle.py --workload NAME --seed N --seconds S

makes the cell's traced run (run.py's `--trace 1`) with its idle gaps
so named, prints its result line, and on standard error the idle time
of every label, each gap divided among the spans it crosses
(`ProgramSpans.split`), and the share of it that lies in a program span
below the harness's stage spans (any but `query` and `strand`).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time
from collections import defaultdict

PROCESS_START = time.monotonic()

# the program's spans that hold a whole strand or query, no finer than
# the harness's stage spans
COARSE = ("query", "strand")


class ProgramSpans:
    """The innermost program span at each moment of the profile, else
    the harness's span (`fallback`): a labeller for
    trace.device_reading, which names a gap by its middle, and `split`,
    which divides every gap among the spans it crosses."""

    def __init__(self, trace, trace_start_ns, host0, fallback):
        self.host0 = host0
        self.fallback = fallback
        spans = [((trace.unix_ns(s.t0) - trace_start_ns) / 1e9,
                  (trace.unix_ns(s.t1) - trace_start_ns) / 1e9, s.name)
                 for s in trace.spans if s.t1 is not None]
        self.names = {x[2] for x in spans}
        self.pieces = innermost(spans)
        self.starts = [p[0] for p in self.pieces]

    def _at(self, rel):
        k = bisect.bisect_right(self.starts, rel) - 1
        if k >= 0 and rel < self.pieces[k][1]:
            return self.pieces[k][2]
        return None

    def label(self, times):
        """As trace.Spans.label, on the profile's own timeline."""
        out = [self._at(t - self.host0) for t in times]
        named = iter(self.fallback.label(
            [t for t, name in zip(times, out) if name is None]))
        return [name if name is not None else next(named) for name in out]

    def split(self, gaps):
        """{label: seconds} of the gaps (start s, seconds), sorted by
        start: each part of a gap goes to the innermost program span
        that holds it, a part in none to the harness's span at its
        middle."""
        by = defaultdict(float)
        holes = []
        for a, sec in gaps:
            b = a + sec
            cur = a
            k = max(bisect.bisect_right(self.starts, a) - 1, 0)
            while k < len(self.pieces) and self.pieces[k][0] < b:
                p0, p1, name = self.pieces[k]
                k += 1
                if p1 <= cur:
                    continue
                if p0 > cur:
                    holes.append((cur, p0))
                by[name] += min(b, p1) - max(cur, p0)
                cur = min(b, p1)
            if cur < b:
                holes.append((cur, b))
        names = self.fallback.label([self.host0 + (x + y) / 2
                                     for x, y in holes])
        for (x, y), name in zip(holes, names):
            by[name] += y - x
        return dict(by)


def innermost(spans):
    """(start, end, name) pieces, in order and not overlapping, of the
    innermost of nested (start, end, name) spans at each moment."""
    out = []
    stack = []
    cur = float("-inf")

    def upto(t):
        nonlocal cur
        if stack and t > cur:
            out.append((cur, t, stack[-1][2]))
        cur = max(cur, t)

    for s in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s[0]:
            upto(stack[-1][1])
            stack.pop()
        upto(s[0])
        stack.append(s)
    while stack:
        upto(stack[-1][1])
        stack.pop()
    return out


def gaps(intervals):
    """(start s, seconds) of every idle gap between the device's
    intervals (start_us, end_us, name), as device_reading finds them."""
    intervals = sorted(intervals)
    out = []
    cur1 = intervals[0][1]
    if intervals[0][0] > 0:
        out.append((0.0, intervals[0][0] / 1e6))
    for a, b, _ in intervals:
        if a > cur1:
            out.append((cur1 / 1e6, (a - cur1) / 1e6))
        cur1 = max(cur1, b)
    return out


def main(argv) -> int:
    import torch
    from lastz_tpu_torch import stats
    from portbench import cellrun, trace

    profiles = []
    tallies = {}

    class KeptProfile(torch.profiler.profile):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            profiles.append(self)

    own_reading = trace.device_reading

    def device_reading(intervals, window_s, host0, spans):
        prof = profiles[-1]
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        named = ProgramSpans(stats.recorded(), start_ns, host0, spans)
        got = own_reading(list(intervals), window_s, host0, named)
        whole = gaps(intervals)
        by = named.split(whole)
        idle = sum(by.values())
        fine = sum(v for k, v in by.items()
                   if k in named.names and k not in COARSE)
        tallies.update(idle_s=idle, fine_share=100.0 * fine / idle,
                       by_label=dict(sorted(by.items(),
                                            key=lambda kv: -kv[1])))
        return got

    torch.profiler.profile = KeptProfile
    trace.device_reading = device_reading
    rc = cellrun.main(list(argv) + ["--trace", "1"], PROCESS_START)
    sys.stderr.write("idle by program span: " + json.dumps(tallies) + "\n")
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
