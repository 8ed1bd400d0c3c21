#!/usr/bin/env python3
"""Demonstrate the hsx name hash (reference tools/hassock_hash.py — a
back-to-front Murmur2 variant; the shared implementation lives in
lastz_tpu_torch.tools.hsx).

usage: hassock_hash [--mod=<m>] [string ...]   (reads stdin if no strings)
"""

import sys

from .hsx import hassock_hash


def _demonstrate(s, m):
    h = hassock_hash(s.encode("latin-1"))
    if m is None:
        print("%08X: %s" % (h, s))
    else:
        print("%d: %s" % (h % m, s))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    m = None
    strings = []
    for s in argv:
        if s.startswith("--mod="):
            m = int(s.split("=", 1)[1])
        else:
            strings.append(s)
    if strings:
        for s in strings:
            _demonstrate(s, m)
    else:
        for line in sys.stdin:
            _demonstrate(line.rstrip(), m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
