"""The program's own spans (lastz_tpu_torch/stats.py) for the readers
of portbench/metrics/.

The program records its spans while a torch profiler records, so the
traced run's window is traced with no switch of the harness's. A
reader takes the spans of the window's completed queries: the
program's `query` spans that lie inside a record's handover and end
(both on the monotonic clock), and every span under them. A program
that records no span (tracing off, or a program older than its spans)
gives None, and so does each reader.
"""

from __future__ import annotations

import bisect


def window(r):
    """The spans of the window's completed queries, or None."""
    try:
        from lastz_tpu_torch import stats
    except ImportError:
        return None
    recorded = getattr(stats, "recorded", None)
    if recorded is None:
        return None
    spans = [s for s in recorded().spans if s.t1 is not None]
    bounds = sorted((q.handover, q.done) for q in r["records"]
                    if q.done is not None)
    starts = [b[0] for b in bounds]

    def in_window(s):
        k = bisect.bisect_right(starts, s.t0) - 1
        return k >= 0 and s.t1 <= bounds[k][1]

    roots = {id(s) for s in spans
             if s.name == "query" and s.parent is None and in_window(s)}
    if not roots:
        return None
    return [s for s in spans if id(root(s)) in roots]


def root(s):
    while s.parent is not None:
        s = s.parent
    return s


def under(s, name) -> bool:
    """Whether a span has an ancestor called `name`."""
    p = s.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def stage_s_per_mbp(r, name):
    """Seconds a query Mbp in the window's spans called `name`, those
    under the tweener left out (the stage's own, as the RunStats
    timers "seed search" and "gapped" are)."""
    spans = window(r)
    if spans is None or not r["mbp"]:
        return None
    return sum(s.t1 - s.t0 for s in spans
               if s.name == name and not under(s, "tweener")) / r["mbp"]
