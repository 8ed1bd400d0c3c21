"""Per-module run statistics (--stats[=<file>]).

The reference collects these only in its `collect_stats` compile mode
(seed_search.h:195-258, gapped_extend.h:100-140, shown by
lastz_show_stats, lastz.c:1796-1808); release builds print a
not-implemented notice.  Here the counters are always available —
they are cheap because the batched pipeline counts whole arrays, not
individual events — and `--stats` prints them in the reference's
two-column style.  The device/host split of gapped extensions is an
addition the reference has no analogue for.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


def _c(n) -> str:
    return f"{int(n):,}"


@dataclass
class RunStats:
    target_length: int = 0
    query_length: int = 0
    num_queries: int = 0
    step: int = 1
    words_in_table: int = 0
    words_in_queries: int = 0
    raw_seed_hits: int = 0
    hash_dropped_hits: int = 0
    ungapped_extensions: int = 0
    hsps: int = 0
    anchors_after_chain: int = 0
    gapped_anchors: int = 0
    gapped_device: int = 0
    gapped_host: int = 0
    alignments: int = 0
    extra: dict = field(default_factory=dict)
    # wall-clock buckets (reference dbgTiming, lastz.c:283-305)
    timers: dict = field(default_factory=dict)

    def time(self, bucket: str):
        """Context manager accumulating wall time into a bucket."""
        return _Timer(self, bucket)

    def merge(self, other: "RunStats") -> None:
        """Fold a farm worker's collector into this one (additive
        counters and timers; per-job constants keep self's value)."""
        for f in ("query_length", "num_queries", "words_in_queries",
                  "raw_seed_hits", "hash_dropped_hits",
                  "ungapped_extensions", "hsps", "anchors_after_chain",
                  "gapped_anchors", "gapped_device", "gapped_host",
                  "alignments"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for k, v in other.timers.items():
            self.timers[k] = self.timers.get(k, 0.0) + v
        for k, v in other.extra.items():
            if isinstance(v, (int, float)):
                self.extra[k] = self.extra.get(k, 0) + v
            else:
                self.extra.setdefault(k, v)

    def show(self, f=None):
        f = f or sys.stderr
        w = f.write
        w("-------------------\n")
        w(f"     target length: {_c(self.target_length)}\n")
        if self.query_length:
            w(f"      query length: {_c(self.query_length)}\n")
        w(f"           queries: {_c(self.num_queries)}\n")
        w(f"         step size: {self.step}\n")
        w("-------------------\n")
        w("position table:\n")
        w(f"    words in table: {_c(self.words_in_table)}\n")
        w("seed hit search:\n")
        w(f"    words in seq 2: {_c(self.words_in_queries)}\n")
        w(f"     raw seed hits: {_c(self.raw_seed_hits)}\n")
        if self.raw_seed_hits:
            pct = 100.0 * self.hash_dropped_hits / self.raw_seed_hits
            w(f"   diag-hash drops: {_c(self.hash_dropped_hits)}"
              f" ({pct:.2f}%)\n")
        w(f"ungapped extensions: {_c(self.ungapped_extensions)}\n")
        w(f"              HSPs: {_c(self.hsps)}\n")
        w("gapped extension:\n")
        w(f"           anchors: {_c(self.gapped_anchors)}\n")
        w(f"  extended on TPU : {_c(self.gapped_device)}\n")
        w(f"  extended on host: {_c(self.gapped_host)}\n")
        w(f"        alignments: {_c(self.alignments)}\n")
        for k, v in self.extra.items():
            w(f"{k:>18}: {_c(v)}\n")
        if self.timers:
            w("wall clock:\n")
            for k, v in self.timers.items():
                w(f"{k:>18}: {v:.3f}s\n")
        w("-------------------\n")


class _Timer:
    def __init__(self, st, bucket):
        self.st = st
        self.bucket = bucket

    def __enter__(self):
        import time
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        import time
        self.st.timers[self.bucket] = (
            self.st.timers.get(self.bucket, 0.0)
            + time.monotonic() - self.t0)
        return False


# One active collector per pipeline run.  `current` is thread-local
# so concurrent farm-out workers (parallel/farm.py) each accumulate
# into their own RunStats; threads that never called reset() (helper
# threads inside kernels) fall back to the main thread's collector.
import threading as _threading

_MAIN = RunStats()
_tls = _threading.local()


def __getattr__(name):
    if name == "current":
        return getattr(_tls, "current", _MAIN)
    raise AttributeError(name)


def reset() -> RunStats:
    global _MAIN
    rs = RunStats()
    _tls.current = rs
    if _threading.current_thread() is _threading.main_thread():
        _MAIN = rs
    return rs
