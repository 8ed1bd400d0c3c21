#!/usr/bin/env python3
"""Sort the a-stanzas of a LAV file by a chosen key (reference
tools/lav_sort.py).

usage: lav_sort --key=[-]<score|beg1|beg2|end1|end2> < lav > lav

Runs of consecutive a-stanzas are sorted within their section; all
other stanzas (d/s/h/x/m, '#:' waffle lines) pass through in place.
"""

import sys

VALID_KEYS = ("score", "pos1", "pos2", "beg1", "beg2", "end1", "end2")

USAGE = """
lav_sort --key=[-]<score|beg1|beg2|end1|end2> < lav_file > lav_file
"""


def read_stanzas(f):
    """Yield (kind, lines) per stanza; '#:' lines are their own stanzas
    and trailing non-stanza lines ride with the preceding one."""
    kind = None
    stanza = []
    in_curly = False
    for line in f:
        line = line.rstrip()
        if not in_curly:
            is_waffle = line.startswith("#:")
            in_curly = len(line) == 3 and line.endswith(" {")
            if is_waffle or in_curly:
                if stanza:
                    yield (kind, stanza)
                    stanza = []
                if is_waffle:
                    yield (line[2:], [line])
                    kind = None
                    continue
                kind = line[0]
            stanza.append(line)
        else:
            stanza.append(line)
            if line == "}":
                in_curly = False
    if stanza:
        raise SystemExit("premature end of file")


def get_key_value(key, stanza):
    if key == "score":
        s = stanza[1].split()[1]
        for conv in (int, float):
            try:
                return conv(s)
            except ValueError:
                pass
        return s
    if key in ("pos1", "beg1"):
        return int(stanza[2].split()[1])
    if key in ("pos2", "beg2"):
        return int(stanza[2].split()[2])
    if key == "end1":
        return int(stanza[3].split()[1])
    if key == "end2":
        return int(stanza[3].split()[2])
    raise AssertionError(key)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not argv[0].startswith("--key="):
        raise SystemExit(USAGE)
    key = argv[0].split("=", 1)[1]
    reverse = key.startswith("-")
    key = key.lstrip("+-")
    if key not in VALID_KEYS:
        raise SystemExit('unrecognized key: "%s"\n%s' % (key, USAGE))

    blocks = []

    def flush():
        # reference sorts (key, stanza) tuples then reverses wholesale,
        # so ties order by stanza text (reversed under '-')
        blocks.sort()
        if reverse:
            blocks.reverse()
        for _, s in blocks:
            print("\n".join(s))
        del blocks[:]

    for kind, stanza in read_stanzas(sys.stdin):
        if kind == "a":
            blocks.append((get_key_value(key, stanza), stanza))
            continue
        if blocks:
            flush()
        print("\n".join(stanza))
    if blocks:
        flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
