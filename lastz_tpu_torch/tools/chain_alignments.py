#!/usr/bin/env python3
"""Chain (syntenic-filter) alignments in lastz general format
(reference tools.python2/chain_alignments.py — which itself carries
"WARNING: THIS MODULE HAS NOT BEEN TESTED").

Groups alignments by (name1, name2, strand2), keeps the best chain per
group under lastz's blastz chain-penalty model (chain.c via our
align.chain DP), and reprints the surviving input lines.
"""

import sys

USAGE = """
usage: cat alignments | chain_alignments [options]
  --format=<list>      provide comma-separated list of the names of the
                       columns, in order; these must include the field names
                       that are listed in detail below
  --format=auto        read column names from the first line of the input,
                       which must begin with a "#"
  --chain=<diag,anti>  penalties for diagonal and anti-diagonal
                       (default penalties are 0)
  --match=<reward>     score for matched bases; this informs us of the scale
                       of the scores given in the input; in lastz this was
                       taken from the scoring matrix's A-to-A match value
                       (default value is 91)
"""

REQUIRED = ["name1", "start1", "end1",
            "name2", "strand2", "start2", "end2", "score"]
OPTIONAL = ["strand1"]
ALIASES = {"s": "strand2", "s2": "strand2"}

CHAIN_SCALE = 100.0
BEST_POSSIBLE = 0x7FFFFFFF


def column_names(names):
    cols = {}
    for ix, name in enumerate(names):
        actual = name
        name = ALIASES.get(name, name)
        if name not in REQUIRED + OPTIONAL:
            continue
        if name in cols:
            raise SystemExit(
                '"%s" (or alias) appears more than once in --format'
                % actual)
        cols[name] = ix
    for name in REQUIRED:
        if name not in cols:
            raise SystemExit('--format lacks required name "%s"\n%s'
                             % (name, USAGE))
    return cols


def read_alignments(f, cols):
    header_line = None
    for line_number, line in enumerate(f, 1):
        line = line.strip()
        if line.startswith("#"):
            header_line = line
            if cols is None:
                fields = line.split()
                fields[0] = fields[0][1:]
                cols = column_names(fields)
            yield ("header", header_line)
            continue
        if cols is None:
            raise SystemExit(
                "input column names are not provided within the file")
        fields = line.split()
        a = {"line": line, "lineNumber": line_number}
        for name in REQUIRED:
            a[name] = fields[cols[name]]
        if "strand1" in cols:
            s1 = fields[cols["strand1"]]
            if s1 == "-":
                raise SystemExit(
                    'bad alignment (at line %d), first species strand'
                    ' must be "+"\n%s' % (line_number, line))
        try:
            a["pos1"] = int(a["start1"])
            end1 = int(a["end1"]) + 1
            a["length"] = end1 - a["pos1"]
            if a["length"] <= 0:
                raise ValueError
            a["pos2"] = int(a["start2"])
            end2 = int(a["end2"]) + 1
            if end2 - a["pos2"] != a["length"]:
                raise SystemExit(
                    "bad alignment (at line %d), unequal lengths\n%s"
                    % (line_number, line))
            a["score"] = float(a["score"])
            if a["score"] <= 0:
                raise ValueError
        except ValueError:
            raise SystemExit("bad alignment (at line %d)\n%s"
                             % (line_number, line))
        if a["strand2"] not in ("+", "-"):
            raise SystemExit(
                "bad alignment (at line %d), second species strand\n%s"
                % (line_number, line))
        yield ("alignment", a)


def reduce_to_chain(aligns, diag_pen, anti_pen, aa_match):
    """Best strictly-ordered chain (chain.c semantics, O(n^2) DP)."""
    segs = sorted(aligns, key=lambda a: (a["pos1"], a["length"],
                                         a["pos2"], a["lineNumber"]))
    n = len(segs)
    chain_score = [0.0] * n
    back = [-1] * n
    for i in range(n):
        si = segs[i]
        x_i, y_i = si["pos1"], si["pos2"]
        best_contrib = 0.0
        best_j = -1
        for j in range(n):
            sj = segs[j]
            if not (sj["pos1"] < x_i and sj["pos2"] < y_i):
                continue
            diag_diff = (x_i - y_i) - (sj["pos1"] - sj["pos2"])
            if diag_diff >= 0:
                num_subs = y_i - (sj["pos2"] + sj["length"] - 1) - 1
            else:
                num_subs = x_i - (sj["pos1"] + sj["length"] - 1) - 1
            penalty = abs(diag_diff) * diag_pen
            if num_subs >= 0:
                penalty += num_subs * anti_pen
            else:
                penalty += (-num_subs) * CHAIN_SCALE * aa_match
            penalty = min(penalty, BEST_POSSIBLE)
            cand = chain_score[j] - penalty
            if cand > best_contrib:
                best_contrib = cand
                best_j = j
        chain_score[i] = si["score"] * CHAIN_SCALE + best_contrib
        back[i] = best_j
    best = 0.0
    best_end = -1
    for i in range(n):
        if chain_score[i] > best:
            best = chain_score[i]
            best_end = i
    chain = []
    i = best_end
    while i >= 0:
        chain.append(segs[i])
        i = back[i]
    chain.reverse()
    return best / CHAIN_SCALE, chain


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cols = None
    diag_pen = 0.0
    anti_pen = 0.0
    aa_match = 91.0
    for arg in argv:
        val = arg.split("=", 1)[1] if "=" in arg else None
        if arg in ("--format=auto", "--format=automatic"):
            cols = "automatic"
        elif arg.startswith("--format=general:"):
            cols = column_names(arg.split(":", 1)[1].split(","))
        elif arg.startswith("--format="):
            cols = column_names(val.split(","))
        elif arg == "--chain":
            diag_pen = anti_pen = 0.0
        elif arg.startswith("G="):
            diag_pen = float(val)
        elif arg.startswith("R="):
            anti_pen = float(val)
        elif arg.startswith("--chain="):
            d, a = val.split(",", 1)
            diag_pen, anti_pen = float(d), float(a)
        elif arg.startswith("--match="):
            aa_match = float(val)
        else:
            raise SystemExit("unrecognized option: %s\n%s" % (arg, USAGE))
    if cols is None:
        raise SystemExit("you must tell me the input column names\n" + USAGE)
    if cols == "automatic":
        cols = None

    pair_strand_to_aligns = {}
    pairs = []
    header_line = None
    for kind, item in read_alignments(sys.stdin, cols):
        if kind == "header":
            header_line = item
            continue
        a = item
        pair = (a["name1"], a["name2"])
        if pair not in pair_strand_to_aligns:
            pass
        key = (pair, a["strand2"])
        if key not in pair_strand_to_aligns:
            pair_strand_to_aligns[key] = []
            if pair not in pairs:
                pairs.append(pair)
        pair_strand_to_aligns[key].append(a)

    header_printed = False
    for pair in pairs:
        for strand2 in ("+", "-"):
            key = (pair, strand2)
            if key not in pair_strand_to_aligns:
                continue
            _, chain = reduce_to_chain(
                pair_strand_to_aligns[key], diag_pen, anti_pen, aa_match)
            for a in chain:
                if not header_printed and header_line is not None:
                    print(header_line)
                    header_printed = True
                print(a["line"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
