"""Semantic LAV comparison (the reference tools/lav_compare.py
capability): the d-stanza, which embeds program name/version and the
command line, is ignored; everything else must match.

    python -m lastz_tpu_torch.tools.lav_compare file1.lav file2.lav
exits 0 when equivalent, 1 with a report otherwise.
"""

from __future__ import annotations

import sys


def strip_d_stanzas(text: str) -> list:
    out = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("d {"):
            while i < len(lines) and lines[i] != "}":
                i += 1
            i += 1
            continue
        out.append(line)
        i += 1
    return out


def lav_equivalent(text1: str, text2: str):
    a = strip_d_stanzas(text1)
    b = strip_d_stanzas(text2)
    if a == b:
        return True, ""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return False, (f"first difference at stripped line {i + 1}:\n"
                           f"  file1: {x}\n  file2: {y}")
    return False, f"length mismatch: {len(a)} vs {len(b)} lines"


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("you must specify two lav files\n\n"
              "lav_compare lav_file1 lav_file2", file=sys.stderr)
        return 1
    with open(argv[0]) as f:
        t1 = f.read()
    with open(argv[1]) as f:
        t2 = f.read()
    ok, msg = lav_equivalent(t1, t2)
    if not ok:
        print(msg, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
