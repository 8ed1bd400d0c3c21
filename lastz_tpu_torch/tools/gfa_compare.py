#!/usr/bin/env python3
"""Compare two gfa files, ignoring trivial differences (reference
tools/gfa_compare.py).

usage: gfa_compare [--sort] gfa_file1 gfa_file2

d-lines (command echo) are ignored; h-lines are compared after
stripping '>' from the quoted names; --sort compares the files as
sorted line sets (for hit-order nondeterminism of overweight seeds).

Note the reference's --sort flag selects compare_UNsorted_files (the
sorting comparator) — the spelled behaviors are swapped relative to the
function names; we replicate the flag behavior.
"""

import re
import sys

USAGE = """
gfa_compare [--sort] gfa_file1 gfa_file2
"""

HEADER_RE = re.compile('^(?P<stanza>.+) +"(?P<name1>.+)" +"(?P<name2>.+)"$')


def header_strip(s):
    m = HEADER_RE.match(s)
    if m is None:
        return s
    name1 = m.group("name1").strip()
    name2 = m.group("name2").strip()
    if name1.startswith(">"):
        name1 = name1[1:].strip()
    if name2.startswith(">"):
        name2 = name2[1:].strip()
    return [m.group("stanza"), name1, name2]


def _compare_line_pair(line1, line2):
    """None = equal/ignored, True = different."""
    stanza = line1.split()[0] if line1.split() else ""
    stanza2 = line2.split()[0] if line2.split() else ""
    if stanza2 != stanza:
        return True
    if stanza == "d":
        return None
    if stanza == "h":
        line1 = " ".join(header_strip(line1))
        line2 = " ".join(header_strip(line2))
    return True if line1 != line2 else None


def compare_in_order(f1, f2):
    line_num = 0
    while True:
        line_num += 1
        line1 = f1.readline()
        line2 = f2.readline()
        if line1 == "" and line2 == "":
            return (False, line_num)
        line1 = line1.rstrip()
        line2 = line2.rstrip()
        verdict = _compare_line_pair(line1, line2)
        if verdict:
            return (True, line_num)


def compare_as_sorted(f1, f2):
    lines1 = sorted((ln.rstrip(), num)
                    for num, ln in enumerate(f1, 1))
    lines2 = sorted((ln.rstrip(), num)
                    for num, ln in enumerate(f2, 1))
    for compare_num in range(max(len(lines1), len(lines2)) + 1):
        line1 = lines1[compare_num][0] if compare_num < len(lines1) else ""
        line2 = lines2[compare_num][0] if compare_num < len(lines2) else ""
        if line1 == "" and line2 == "":
            return (False, compare_num + 1)
        verdict = _compare_line_pair(line1, line2)
        if verdict:
            return (True, compare_num + 1)
    return (False, 0)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    sort_em = False
    if argv and argv[0] == "--sort":
        sort_em = True
        del argv[0]
    if len(argv) != 2:
        raise SystemExit(USAGE)
    name1, name2 = argv
    with open(name1) as f1, open(name2) as f2:
        if sort_em:
            different, line_num = compare_as_sorted(f1, f2)
        else:
            different, line_num = compare_in_order(f1, f2)
    if different:
        print("FAILURE: %s and %s are different (line %d)"
              % (name1, name2, line_num), file=sys.stderr)
        return 1
    print("SUCCESS: %s and %s are equivalent" % (name1, name2),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
