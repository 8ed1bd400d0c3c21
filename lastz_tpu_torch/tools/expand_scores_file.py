#!/usr/bin/env python3
"""Add derived scoring parameters to a lastz scores file (reference
tools/expand_scores_file.py).

Reads a scores file on stdin; fills in O/E/X/Y/K/L (and T/Z seed hints
for strongly negative matrices) from the substitution matrix when they
aren't already present, and reprints the file with the additions.
"""

import sys

USAGE = """
expand_scores_file [options]< scores_file > scores_file
  --overridegaps  ignore gap scores already set
"""


def int_or_float(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    override_gaps = False
    for arg in argv:
        if arg in ("--help", "-h", "--h", "-help"):
            raise SystemExit(USAGE)
        elif arg == "--overridegaps":
            override_gaps = True
        else:
            raise SystemExit("unrecognized argument: %s\n%s" % (arg, USAGE))

    lines = []
    num_value_lines = None
    values_finished = False
    name_to_val = {}
    subs = None
    sub_columns = None

    for line_number, line in enumerate(sys.stdin, 1):
        line = line.rstrip()
        lines.append(line)
        if line == "" or line.startswith("#"):
            continue
        if "#" in line:
            line = line.split("#", 1)[0].strip()
        if "=" in line:
            if values_finished:
                raise SystemExit(
                    "in scores file, unexpected assignment (line %d): %s"
                    % (line_number, line))
            name, val = (p.strip() for p in line.split("=", 1))
            if name == "gap_open_penalty":
                name = "O"
            elif name == "gap_extend_penalty":
                name = "E"
            if name in name_to_val:
                raise SystemExit(
                    "in scores file, %s is assigned twice (line %d): %s"
                    % (name, line_number, line))
            if override_gaps and name in ("O", "E"):
                lines.pop()
                continue
            try:
                name_to_val[name] = int_or_float(val)
            except ValueError:
                if name in ("O", "E"):
                    raise SystemExit(
                        "in scores file, bad assignment value (line %d): %s"
                        % (line_number, line))
        elif not values_finished:
            num_value_lines = len(lines) - 1
            values_finished = True
            sub_columns = line.split()
            subs = {}
        else:
            fields = line.split()
            row_ch = fields.pop(0)
            if len(fields) != len(sub_columns):
                raise SystemExit(
                    "in scores file, inconsistent matrix (line %d): %s"
                    % (line_number, line))
            for ix, val in enumerate(fields):
                subs[row_ch + sub_columns[ix]] = int_or_float(val)

    if subs is None:
        raise SystemExit("scores file is missing a matrix")
    if "AA" not in subs:
        raise SystemExit("scores file lacks A-to-A score")

    best_sub = float(max(subs.values()))
    worst_sub = float(min(subs.values()))
    aa_sub = float(subs["AA"])

    known = set(name_to_val)
    if "O" not in name_to_val:
        name_to_val["O"] = -int(3.25 * worst_sub)
    if "E" not in name_to_val:
        name_to_val["E"] = -int(0.25 * worst_sub)
    if "X" not in name_to_val:
        name_to_val["X"] = int(10 * aa_sub)
    if "Y" not in name_to_val:
        name_to_val["Y"] = int(name_to_val["O"] + 100 * name_to_val["E"])
    if "K" not in name_to_val:
        name_to_val["K"] = int(30 * best_sub)
    if "L" not in name_to_val:
        name_to_val["L"] = int(30 * best_sub)
    if "T" not in name_to_val and worst_sub / best_sub < -1.5:
        name_to_val["T"] = "2"
    if "Z" not in name_to_val and worst_sub / best_sub < -3.0:
        name_to_val["Z"] = "3"

    added = [n for n in ("T", "Z", "O", "E", "X", "Y", "K", "L")
             if n in name_to_val and n not in known]
    added += [n for n in name_to_val
              if n not in added and n not in known]

    blank = False
    for ix in range(num_value_lines):
        print(lines[ix])
        blank = lines[ix] == ""
    if added:
        if not blank:
            print("")
        print("# (score parameters added by expand_scores_file)")
        print("")
        for name in added:
            print("%s=%s" % (name, name_to_val[name]))
        if lines[num_value_lines] != "":
            print("")
    for ix in range(num_value_lines, len(lines)):
        print(lines[ix])
    return 0


if __name__ == "__main__":
    sys.exit(main())
