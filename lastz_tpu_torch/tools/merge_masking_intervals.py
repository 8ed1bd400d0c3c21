#!/usr/bin/env python3
"""Combine overlapping masking intervals (reference
tools/merge_masking_intervals.py).

Reads "beg end" pairs (origin-1, closed, as written by --outputmasking
and consumed by xmask=/nmask=/softmask= actions) from stdin, merges
overlapping or adjoining intervals, and prints the merged set sorted.
"""

import sys


def merge_intervals(pairs):
    """Merge overlapping/adjoining origin-0 half-open intervals."""
    out = []
    for s, e in sorted(pairs):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("give me no arguments")
    intervals = []
    for num, line in enumerate(sys.stdin, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split()
        try:
            s = int(fields[0]) - 1
            e = int(fields[1])
        except (ValueError, IndexError):
            raise SystemExit("bad line (%d): %s" % (num, line))
        intervals.append((s, e))
    for s, e in merge_intervals(intervals):
        print("%d\t%d" % (s + 1, e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
