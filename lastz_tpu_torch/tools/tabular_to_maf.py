#!/usr/bin/env python3
"""Convert lastz --format=general output to MAF (reference
tabular_tools/tabular_to_maf.py + alignment_table.py + cigar.py +
alignment_table_aids.py, self-contained).

usage: cat <alignment_file> | tabular_to_maf --sequences=<file> [options]

Input must have a #-header naming at least name1, zstart1, end1, name2,
zstart2+, end2+, strand2 (or an alias) and cigarx/cigar; text1/text2 and
score are used when present, otherwise reconstructed from the cigar and
rescored with lastz's default HOXD70 scoring.
"""

import sys
from math import ceil

PROGRAM_NAME = "tabular_to_maf"
PROGRAM_VERSION = "0.1.0"

USAGE = """
usage: cat <alignment_file> | %s [options]
  --sequence[s]=<file>    (required) specify the reference sequence(s); <file>
                          can be .2bit, .fasta, or .fasta.gz
  --alias:<alias>=<name>  the input can use <alias> as an alias for column
                          name <name>
  --head=<number>         limit the number of alignment records
  --progress=<number>     periodically report how many alignment records we've
                          processed
  --version               report this program's version number
""" % PROGRAM_NAME

COMPLEMENT = str.maketrans("ACGTSWRYMKBDHVNacgtswrymkbdhvn",
                           "TGCASWYRKMVHDBNtgcaswyrkmvhdbn")


def reverse_complement(nukes):
    return nukes[::-1].translate(COMPLEMENT)


def split_cigar(cigar):
    """(count, op) pairs with H clipping trimmed from the ends
    (tabular_tools/cigar.py:254-292)."""
    if cigar == "*":
        return None
    ops = []
    rpt = []
    for ch in cigar:
        if ch.isdigit():
            rpt.append(ch)
        else:
            ops.append((int("".join(rpt)) if rpt else 1, ch))
            rpt = []
    if rpt:
        raise SystemExit('bad cigar: "%s"' % cigar)
    if ops and ops[0][1] == "H":
        ops = ops[1:]
    if ops and ops[-1][1] == "H":
        ops = ops[:-1]
    return ops


def construct_alignment_text(a, cigar_ops, lookup):
    """(alignment_table_aids.py:10-55)"""
    t_sub = lookup[a["name1"]][a["start1"]:a["end1"]]
    q_sub = lookup[a["name2"]][a["start2"]:a["end2"]]
    if a["strand"] == "-":
        q_sub = reverse_complement(q_sub)
    text1, text2 = [], []
    t_ix = q_ix = 0
    for rpt, op in cigar_ops:
        if op in ("M", "X", "="):
            text1.append(t_sub[t_ix:t_ix + rpt])
            text2.append(q_sub[q_ix:q_ix + rpt])
            t_ix += rpt
            q_ix += rpt
        elif op == "I":
            text1.append("-" * rpt)
            text2.append(q_sub[q_ix:q_ix + rpt])
            q_ix += rpt
        elif op == "D":
            text1.append(t_sub[t_ix:t_ix + rpt])
            text2.append("-" * rpt)
            t_ix += rpt
        else:
            raise SystemExit(
                '(at line %s) unsupported "%d%s" in cigar'
                % (a["lineNumber"], rpt, op))
    if t_ix != a["end1"] - a["start1"] or q_ix != a["end2"] - a["start2"]:
        raise SystemExit(
            "(at line %s) cigar extent doesn't match interval"
            % a["lineNumber"])
    return "".join(text1), "".join(text2)


SUB_SCORE = {"AA": 91, "AC": -114, "AG": -31, "AT": -123,
             "CA": -114, "CC": 100, "CG": -125, "CT": -31,
             "GA": -31, "GC": -125, "GG": 100, "GT": -114,
             "TA": -123, "TC": -31, "TG": -114, "TT": 91}


def alignment_score(text1, text2):
    """Rescore with lastz defaults (alignment_table_aids.py:60-107)."""
    gap_open, gap_extend = 400, 30
    x_penalty, n_penalty = 1000, 100
    score = 0
    gap1 = gap2 = 0
    for ch1, ch2 in zip(text1.upper(), text2.upper()):
        if ch1 != "-" and ch2 != "-":
            if gap1 > 0:
                score -= gap_open + gap1 * gap_extend
                gap1 = 0
            elif gap2 > 0:
                score -= gap_open + gap2 * gap_extend
                gap2 = 0
            key = ch1 + ch2
            if key in SUB_SCORE:
                score += SUB_SCORE[key]
            elif ch1 == "X" or ch2 == "X":
                score -= x_penalty
            else:
                score -= n_penalty
        elif ch1 == "-":
            if gap2 > 0:
                score -= gap_open + gap2 * gap_extend
                gap2 = 0
            gap1 += 1
        elif ch2 == "-":
            if gap1 > 0:
                score -= gap_open + gap1 * gap_extend
                gap1 = 0
            gap2 += 1
    if gap1 > 0:
        score -= gap_open + gap1 * gap_extend
    elif gap2 > 0:
        score -= gap_open + gap2 * gap_extend
    return score


def read_sequences(path):
    """name -> sequence string, from fasta(.gz) or 2bit."""
    if path.endswith(".2bit"):
        from ..io.sequence import _read_2bit
        return {short: data.decode("latin-1")
                for data, header, short, contig in _read_2bit(path)}
    if path.endswith((".gz", ".gzip")):
        import gzip
        opener = gzip.open
    else:
        opener = open
    seqs = {}
    name = None
    parts = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(parts)
                name = line[1:].split()[0]
                parts = []
            elif name is not None:
                parts.append(line)
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


REQUIRED = ("name1", "zstart1", "end1", "name2", "zstart2+", "end2+",
            "strand", "cigarx")
NON_REQUIRED = ("score", "text1", "text2")
BASE_ALIASES = {"strand2": "strand", "s": "strand", "s2": "strand",
                "cigar": "cigarx"}


def parse_table(f, aliases):
    """Yield alignment dicts from a general-format table
    (alignment_table.py read_file)."""
    column_names = None
    for line_number, line in enumerate(f, 1):
        line = line.strip()
        if line.startswith("#"):
            if column_names is not None:
                continue
            fields = line.split()
            fields[0] = fields[0][1:]
            column_names = {}
            wanted = set(REQUIRED) | set(NON_REQUIRED)
            for ix, name in enumerate(fields):
                name = aliases.get(name, name)
                if name not in wanted:
                    continue
                if name in column_names:
                    raise SystemExit(
                        '"%s" (or alias) appears more than once' % name)
                column_names[name] = ix
            for name in REQUIRED:
                if name not in column_names:
                    raise SystemExit('required name "%s" is absent' % name)
            continue
        if column_names is None:
            raise SystemExit("input column names weren't specified, and"
                             " are not provided within the file")
        fields = line.split()
        a = {"lineNumber": line_number}
        for name in list(REQUIRED) + [n for n in NON_REQUIRED
                                      if n in column_names]:
            a[name] = fields[column_names[name]]
        a["start1"] = int(a.pop("zstart1"))
        a["end1"] = int(a["end1"])
        a["start2"] = int(a.pop("zstart2+"))
        a["end2"] = int(a.pop("end2+"))
        if a["start1"] >= a["end1"] or a["start2"] >= a["end2"]:
            raise SystemExit("bad alignment (at line %d)\n%s"
                             % (line_number, line))
        if a["strand"] not in ("+", "-"):
            raise SystemExit('bad alignment (at line %d), bad strand "%s"'
                             % (line_number, a["strand"]))
        yield a


def int_with_unit(s):
    mult = {"K": 10**3, "M": 10**6, "G": 10**9}.get(s[-1:], 1)
    if mult != 1:
        s = s[:-1]
    try:
        return int(s) * mult
    except ValueError:
        return int(ceil(float(s) * mult))


def alignment_to_maf(a, lookup, out):
    seq1 = lookup.get(a["name1"])
    seq2 = lookup.get(a["name2"])
    if seq1 is None:
        raise SystemExit("no sequence has been provided for %s"
                         % a["name1"])
    if seq2 is None:
        raise SystemExit("no sequence has been provided for %s"
                         % a["name2"])
    src_size1, src_size2 = len(seq1), len(seq2)
    if "text1" in a and "text2" in a:
        text1, text2 = a["text1"], a["text2"]
    else:
        text1, text2 = construct_alignment_text(
            a, split_cigar(a["cigarx"]), lookup)
    score = a.get("score", None)
    if score is None:
        score = alignment_score(text1, text2)
    start1 = a["start1"]
    size1 = a["end1"] - a["start1"]
    start2 = a["start2"] if a["strand"] == "+" else src_size2 - a["end2"]
    size2 = a["end2"] - a["start2"]
    src_w = max(len(a["name1"]), len(a["name2"]))
    start_w = max(len(str(start1)), len(str(start2)))
    size_w = max(len(str(size1)), len(str(size2)))
    src_size_w = max(len(str(src_size1)), len(str(src_size2)))
    out.write("a score=%s\n" % score)
    out.write("s %-*s %*s %*s %s %*s %s\n"
              % (src_w, a["name1"], start_w, start1, size_w, size1,
                 "+", src_size_w, src_size1, text1))
    out.write("s %-*s %*s %*s %s %*s %s\n"
              % (src_w, a["name2"], start_w, start2, size_w, size2,
                 a["strand"], src_size_w, src_size2, text2))
    out.write("\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    reference_filenames = []
    aliases = dict(BASE_ALIASES)
    head_limit = None
    report_progress = None
    for arg in argv:
        val = arg.split("=", 1)[1] if "=" in arg else None
        if arg.startswith(("--sequence=", "--sequences=", "--ref=")):
            if not val.endswith((".2bit", ".fa.gz", ".fasta.gz",
                                 ".fsa_nt.gz", ".fa", ".fasta", ".fsa_nt")):
                raise SystemExit("unrecognized file extension in %s\n%s"
                                 % (arg, USAGE))
            reference_filenames.append(val)
        elif arg.startswith("--alias:"):
            for field in arg.split(":", 1)[1].split(","):
                alias, name = field.split("=", 1)
                if alias in aliases:
                    raise SystemExit("duplicate alias %s" % alias)
                aliases[alias] = name
        elif arg.startswith("--head="):
            head_limit = int_with_unit(val)
        elif arg.startswith("--progress="):
            report_progress = int_with_unit(val)
        elif arg in ("--version", "--v", "--V", "-version", "-v", "-V"):
            raise SystemExit("%s, version %s"
                             % (PROGRAM_NAME, PROGRAM_VERSION))
        else:
            raise SystemExit("unrecognized option: %s\n%s" % (arg, USAGE))
    if not reference_filenames:
        raise SystemExit("you need to provide a reference genome file\n"
                         + USAGE)
    if len(reference_filenames) > 1:
        raise SystemExit("sorry, support for more than one reference"
                         " genome file had not been implemented yet")

    lookup = read_sequences(reference_filenames[0])

    header_written = False
    for num, a in enumerate(parse_table(sys.stdin, aliases), 1):
        if head_limit is not None and num > head_limit:
            print("limit of %s alignments reached"
                  % "{:,}".format(head_limit), file=sys.stderr)
            break
        if report_progress is not None \
                and (num == 1 or num % report_progress == 0):
            print("processing alignment %s" % "{:,}".format(num),
                  file=sys.stderr)
        if not header_written:
            print("##maf version=1 scoring=lastz_defaults")
            print("# this file generated by %s version %s, converting"
                  " from lastz tabular format"
                  % (PROGRAM_NAME, PROGRAM_VERSION))
            print("#")
            print("# gap_open_penalty   = 400")
            print("# gap_extend_penalty = 30")
            print("#        A    C    G    T")
            print("#   A   91 -114  -31 -123")
            print("#   C -114  100 -125  -31")
            print("#   G  -31 -125  100 -114")
            print("#   T -123  -31 -114   91")
            header_written = True
        alignment_to_maf(a, lookup, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
