"""The traced run's device readings.

- Kernel launches: a CUDA event pair around every call of the kernel
  library's `ydrop_mega_launch` and `xdrop_scan_launch` (as
  chip_smoke.py's `timed_launches`), and each launch's work from its
  wrapper's inputs and outputs (work.py), summed on the card without a
  host read until the window has closed.
- Device activity: torch.profiler's CUDA activity over the window. The
  union of the kernels', copies' and fills' intervals is the busy
  time; the gaps between them are the idle time, named by the harness's
  host span they fall in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from . import work


class Launches:
    """Event pairs and work of the window's K1 and K2 launches."""

    def __init__(self):
        self.events = {"ydrop_mega_launch": [], "xdrop_scan_launch": []}
        self.work = {"ydrop_mega_launch": [], "xdrop_scan_launch": []}

    @contextlib.contextmanager
    def hooked(self):
        import torch
        from lastz_tpu_torch.kernels import build
        import lastz_tpu_torch.align.ydrop_device as yd
        import lastz_tpu_torch.ops.xdrop_cuda as xc
        lib = build.load()
        owns = {e: getattr(lib, e) for e in self.events}

        def timed(entry):
            own = owns[entry]

            def call(*a):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                rc = own(*a)
                e1.record()
                self.events[entry].append((e0, e1))
                return rc
            return call

        own_mega = yd.ydrop_mega
        own_scan = xc.xdrop_scan

        def mega(*args, **kw):
            out = own_mega(*args, **kw)
            st_in = args[11]
            st, _, _, _, row_lo, row_hi, _ = out
            live = row_lo > 0
            cells = (st["tbp"].long() - st_in["tbp"].long()).sum()
            rows = ((row_hi - row_lo + 1) * live).long().sum()
            blocks = live.long().sum()
            B = args[2].shape[0]
            self.work["ydrop_mega_launch"].append(
                (cells, rows, blocks, B, kw["lanes"], kw["max_blocks"],
                 kw.get("with_tb", True)))
            return out

        def scan(*args, **kw):
            out = own_scan(*args, **kw)
            (lc, _, _), (rc, _, _) = out
            cells = lc.long().sum() + rc.long().sum()
            self.work["xdrop_scan_launch"].append((cells, lc.shape[0]))
            return out

        # the wrapper counts its launches on the module's attribute,
        # which is this stand-in while it is hooked
        for name in ("launches", "wide_launches"):
            setattr(scan, name, getattr(own_scan, name))

        for e in self.events:
            setattr(lib, e, timed(e))
        yd.ydrop_mega = mega
        xc.xdrop_scan = scan
        try:
            yield self
        finally:
            for e, own in owns.items():
                setattr(lib, e, own)
            yd.ydrop_mega = own_mega
            xc.xdrop_scan = own_scan
            for name in ("launches", "wide_launches"):
                setattr(own_scan, name, getattr(scan, name))

    def roofline(self, entry):
        """100 x the least time of the window's launches over their
        measured time; None without a launch."""
        ev = self.events[entry]
        if not ev:
            return None
        measured = sum(a.elapsed_time(b) for a, b in ev) / 1e3
        ideal = 0.0
        for w in self.work[entry]:
            if entry == "ydrop_mega_launch":
                cells, rows, blocks, B, lanes, mb, links = w
                ops, nb = work.k1_work(int(cells), int(rows), int(blocks), B,
                                       lanes, mb, links)
            else:
                cells, hits = w
                ops, nb = work.k2_work(int(cells), hits)
            ideal += work.ideal_s(ops, nb)
        return {"share": 100.0 * ideal / measured, "launches": len(ev),
                "measured_s": measured, "ideal_s": ideal}


class Spans:
    """Host spans of the harness in monotonic seconds: (name, t0, t1)."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.items.append((name, t0, time.monotonic()))

    def label(self, times):
        """The innermost span that holds each host time (times sorted);
        spans of one thread nest, so a stack of open spans finds it."""
        items = sorted(self.items, key=lambda x: x[1])
        out = []
        stack = []
        k = 0
        for t in times:
            while k < len(items) and items[k][1] <= t:
                while stack and stack[-1][2] < items[k][1]:
                    stack.pop()
                stack.append(items[k])
                k += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0] if stack else "between queries")
        return out


def device_intervals(prof):
    """(start_us, end_us, name) of every device kernel, copy and fill in
    the profile, relative to the profile's start."""
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) is None:
            continue
        if str(e.device_type).endswith("CUDA"):
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def device_reading(intervals, window_s, host0, spans):
    """busy_s, the top device ops and the idle time by host span."""
    if not intervals:
        return None
    intervals.sort()
    by_name = defaultdict(float)
    busy = 0.0
    gaps = []  # (host time of the gap's middle, seconds)
    cur0, cur1 = intervals[0][0], intervals[0][1]
    if cur0 > 0:
        gaps.append((host0 + cur0 / 2e6, cur0 / 1e6))
    for a, b, name in intervals:
        by_name[name] += (b - a) / 1e6
        if a > cur1:
            busy += (cur1 - cur0) / 1e6
            gaps.append((host0 + (cur1 + a) / 2e6, (a - cur1) / 1e6))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += (cur1 - cur0) / 1e6
    idle = defaultdict(float)
    for (_, sec), name in zip(gaps, spans.label([g[0] for g in gaps])):
        idle[name] += sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in worst]}
