"""Per-module run statistics (--stats[=<file>]) and the program's spans.

The reference collects these only in its `collect_stats` compile mode
(seed_search.h:195-258, gapped_extend.h:100-140, shown by
lastz_show_stats, lastz.c:1796-1808); release builds print a
not-implemented notice.  Here the counters are always available —
they are cheap because the batched pipeline counts whole arrays, not
individual events — and `--stats` prints them in the reference's
two-column style.  The device/host split of gapped extensions is an
addition the reference has no analogue for.

Spans.  `RunStats.time(bucket)` adds its wall time to
`timers[bucket]`; while tracing is on it also records a `Span`: the
bucket's name, its start and end on the monotonic clock, its parent
(the innermost span open on the thread), the query ordinal and strand
it ran for, and its thread.  `RunStats.span(name)` records a span and
fills no bucket (the pipeline's `query` and `strand`); those spans also
keep the deltas of the counters over their time.  Work done once an
anchor is timed with `span=False`: a bucket and no span, its time
added to the innermost open span's `inner[bucket]`.  Tracing is on
inside `tracing()`, and while a torch profiler records
(`torch.profiler.profile`), so a profiled run is traced with no switch
of its own; its spans are kept in memory, in `recorded()`.

One clock with the device trace: torch.profiler places its events,
host and device, on the Unix clock (an event's time in
`prof.events()` is its Unix time less the profile's
`kineto_results.trace_start_ns()`).  A trace keeps pairs of
(monotonic, Unix) readings, taken as it starts and as each span with
no parent (a query's) opens, and `Trace.unix_ns` maps a span's stamp through the pair
read nearest before it.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass, field, fields

import torch.autograd.profiler as _profiler


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

    def time(self, bucket: str, span: bool = True):
        """Context manager accumulating wall time into a bucket and,
        while tracing, recording a span of that name; `span=False` for
        work done once an anchor (its time goes to the open span's
        `inner`)."""
        return _Timer(self, bucket, span)

    @contextmanager
    def span(self, name: str, query=None, strand=None):
        """Context manager recording, while tracing, a span with no
        bucket and the counters' deltas over it; `query` and `strand`
        are the ordinal and strand it and the spans inside it carry."""
        if not _recording():
            yield
            return
        c0 = _counters(self)
        sp = _open(name, query, strand)
        sp.t0 = _time.monotonic()
        try:
            yield
        finally:
            _close(sp, _time.monotonic())
            sp.counts = {k: v - c0.get(k, 0)
                         for k, v in _counters(self).items()
                         if v != c0.get(k, 0)}

    def add(self, key: str, n: int = 1) -> None:
        """Add n to the counter `extra[key]`."""
        self.extra[key] = self.extra.get(key, 0) + n

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


_INT_FIELDS = tuple(f.name for f in fields(RunStats)
                    if f.type in ("int", int))


def _counters(st) -> dict:
    """RunStats' integer counters and numeric `extra` entries."""
    c = {k: getattr(st, k) for k in _INT_FIELDS}
    c.update((k, v) for k, v in st.extra.items()
             if isinstance(v, (int, float)))
    return c


class Span:
    """One span of the program: `name`, `t0` and `t1` (monotonic
    seconds), `parent` (a Span or None), `query` (the query's ordinal),
    `strand` ('+', '-', or '+-' where one gapped pass takes both
    strands' anchors), `thread`, `inner` (bucket -> seconds of work
    timed with span=False inside it) and, for RunStats.span, `counts`
    (counter -> delta)."""

    __slots__ = ("name", "t0", "t1", "parent", "query", "strand",
                 "thread", "inner", "counts")

    def __init__(self, name, parent, query, strand):
        if parent is not None:
            query = parent.query if query is None else query
            strand = parent.strand if strand is None else strand
        self.name = name
        self.parent = parent
        self.query = query
        self.strand = strand
        self.thread = threading.get_ident()
        self.t0 = self.t1 = None
        self.inner = self.counts = None


class Trace:
    """The spans recorded while tracing, in the order they opened, and
    the (monotonic s, Unix ns) pairs that put them on the Unix clock."""

    def __init__(self):
        self.spans: list[Span] = []
        self._mono: list[float] = []
        self._unix: list[int] = []
        self._lock = threading.Lock()
        self.anchor()

    def anchor(self) -> None:
        """Read a pair (farm workers open their queries' spans at once,
        so a pair is read and kept under a lock)."""
        with self._lock:
            self._mono.append(_time.monotonic())
            self._unix.append(_time.time_ns())

    def unix_ns(self, t: float) -> int:
        """A monotonic stamp as Unix ns, through the pair read nearest
        before it (the first pair for a stamp before every pair)."""
        k = max(bisect.bisect_right(self._mono, t) - 1, 0)
        return self._unix[k] + round((t - self._mono[k]) * 1e9)


_tls = threading.local()
_forced = 0
_trace = Trace()


def _recording() -> bool:
    return bool(_forced or _profiler._is_profiler_enabled)


def _open(name, query, strand) -> Span:
    """A new span under the innermost one open on this thread."""
    stack = _tls.__dict__.setdefault("open", [])
    parent = stack[-1] if stack else None
    sp = Span(name, parent, query, strand)
    if parent is None:
        _trace.anchor()
    _trace.spans.append(sp)
    stack.append(sp)
    return sp


def _close(sp, t1) -> None:
    sp.t1 = t1
    _tls.open.pop()


@contextmanager
def tracing():
    """Record spans inside the block, into a new Trace that it yields."""
    global _trace, _forced
    saved = _trace
    _trace = Trace()
    _forced += 1
    try:
        yield _trace
    finally:
        _forced -= 1
        _trace = saved


def recorded() -> Trace:
    """The trace spans go to: tracing()'s inside its block, else the
    process's own, which every profiled run adds to."""
    return _trace


class _Timer:
    __slots__ = ("st", "bucket", "keep", "t0", "sp")

    def __init__(self, st, bucket, keep):
        self.st = st
        self.bucket = bucket
        self.keep = keep

    def __enter__(self):
        self.sp = sp = (_open(self.bucket, None, None)
                        if self.keep and _recording() else None)
        self.t0 = _time.monotonic()
        if sp is not None:
            sp.t0 = self.t0
        return self

    def __exit__(self, *exc):
        t1 = _time.monotonic()
        dt = t1 - self.t0
        timers = self.st.timers
        timers[self.bucket] = timers.get(self.bucket, 0.0) + dt
        if self.sp is not None:
            _close(self.sp, t1)
        elif not self.keep and _recording():
            stack = getattr(_tls, "open", None)
            if stack:
                if stack[-1].inner is None:
                    stack[-1].inner = {}
                inner = stack[-1].inner
                inner[self.bucket] = inner.get(self.bucket, 0.0) + dt
        return False


# One active collector per pipeline run.  `current` is thread-local
# so concurrent farm-out workers (parallel/farm.py) each accumulate
# into their own RunStats; threads that never called reset() (helper
# threads inside kernels) fall back to the main thread's collector.
_MAIN = RunStats()


def __getattr__(name):
    if name == "current":
        return getattr(_tls, "current", _MAIN)
    raise AttributeError(name)


def reset() -> RunStats:
    global _MAIN
    rs = RunStats()
    _tls.current = rs
    if threading.current_thread() is threading.main_thread():
        _MAIN = rs
    return rs
