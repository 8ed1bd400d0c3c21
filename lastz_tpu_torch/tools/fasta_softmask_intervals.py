#!/usr/bin/env python3
"""Apply masking intervals to fasta sequences (reference
tools/fasta_softmask_intervals.py).

Reads fasta from stdin and a "<chrom> <start> <end>" intervals file;
masks the intervals (lowercase by default, or --mask=<char>) and writes
the masked fasta to stdout.
"""

import sys

from .merge_masking_intervals import merge_intervals

USAGE = """fasta_softmask_intervals [options] < fasta_file > fasta_file
  Apply masking intervals to create a soft-masked fasta file.

  options:
    <intervals_file>          file containing a list of intervals to be masked,
                              in the form <chrom> <start> <end>;  --origin
                              determines whether these are origin one or zero
    --complement              mask the intervals *not* in the intervals file
                              (not to be confused with reverse-complementation)
    --chrom=<sequence_names>  (cumulative) copy (and mask) only the specified
                              sequence(s) <sequence_names> is a comma-separated
                              list
                              (default is to copy and mask all sequences)
    --preserve:softmasking    if the input contains any softmasked content
                              *outside* of our intervals, leave it alone
                              (by default, we destroy softmasking in the input
                              sequences, converting them to uppercase, before
                              applying our intervals)
    --origin=one              intervals are origin-one, closed
                              (default is origin-zero, half-open)
    --wrap=<line_length>      split each sequence into multiple lines if needed
                              (default is to write sequence on a single line)
    --mask=<character>        mask with a particular character (usually X or N)
                              (default is to mask with lowercase)"""


def fasta_sequences(f):
    name = None
    nucs = []
    for line in f:
        line = line.strip()
        if line.startswith(">"):
            if name is not None:
                yield (name, "".join(nucs))
            name = line[1:].strip().split()[0]
            nucs = []
        elif name is None:
            raise SystemExit("first sequence has no header")
        else:
            nucs.append(line)
    if name is not None:
        yield (name, "".join(nucs))


def complement_intervals(intervals, length):
    out = []
    prev = 0
    for s, e in intervals:
        if prev < s:
            out.append((prev, s))
        prev = e
    if prev < length:
        out.append((prev, length))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    chroms_of_interest = None
    do_complement = False
    to_upper = True
    origin = "zero"
    wrap_length = 100
    mask_char = None
    intervals_file = None

    for arg in argv:
        val = arg.split("=", 1)[1] if "=" in arg else None
        if arg in ("--help", "-h", "--h", "-help"):
            raise SystemExit(USAGE)
        elif arg.startswith(("--chrom=", "--chroms=")):
            if chroms_of_interest is None:
                chroms_of_interest = []
            chroms_of_interest += val.split(",")
        elif arg == "--complement":
            do_complement = True
        elif arg == "--preserve:softmasking":
            to_upper = False
        elif arg.startswith("--origin="):
            origin = {"0": "zero", "1": "one"}.get(val, val)
            if origin not in ("zero", "one"):
                raise SystemExit(f"unknown argument: {arg}\n{USAGE}")
        elif arg.startswith("--wrap="):
            wrap_length = int(val)
        elif arg.startswith("--mask="):
            mask_char = val
            if len(mask_char) != 1:
                raise SystemExit("--mask requires a single character")
        elif arg.startswith("--"):
            raise SystemExit(f"can't understand {arg}\n{USAGE}")
        elif intervals_file is None:
            intervals_file = arg
        else:
            raise SystemExit(f"can't understand {arg}\n{USAGE}")

    if intervals_file is None:
        raise SystemExit(
            "you have to tell me the intervals you're interested in\n"
            + USAGE)

    chrom_to_intervals = {}
    with open(intervals_file) as f:
        for num, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            if len(fields) < 3:
                raise SystemExit(
                    "not enough fields (line %s): %s" % (num, line))
            try:
                chrom = fields[0]
                start = int(fields[1])
                end = int(fields[2])
                if origin == "one":
                    start -= 1
                if start < 0 or start >= end:
                    raise ValueError
            except ValueError:
                raise SystemExit("bad line (line %s): %s" % (num, line))
            if chroms_of_interest is not None \
                    and chrom not in chroms_of_interest:
                continue
            chrom_to_intervals.setdefault(chrom, []).append((start, end))

    for chrom in chrom_to_intervals:
        chrom_to_intervals[chrom] = merge_intervals(
            chrom_to_intervals[chrom])

    seen = set()
    for chrom, seq in fasta_sequences(sys.stdin):
        if chroms_of_interest is not None \
                and chrom not in chroms_of_interest:
            continue
        if chrom in seen:
            raise SystemExit("more than one sequence is named %s" % chrom)
        seen.add(chrom)
        if to_upper:
            seq = seq.upper()
        intervals = chrom_to_intervals.setdefault(chrom, [])
        if do_complement:
            intervals = complement_intervals(intervals, len(seq))
        pieces = []
        prev = 0
        for start, end in intervals:
            if prev < start:
                pieces.append(seq[prev:start])
            if mask_char is None:
                pieces.append(seq[start:end].lower())
            else:
                pieces.append(mask_char * (end - start))
            prev = end
        if prev < len(seq):
            pieces.append(seq[prev:])
        new_seq = "".join(pieces)
        print(">%s" % chrom)
        for i in range(0, len(new_seq), wrap_length):
            print(new_seq[i:i + wrap_length])

    missing = [c for c in chrom_to_intervals if c not in seen]
    if missing:
        raise SystemExit("missing fasta sequence %s" % ", ".join(missing))
    return 0


if __name__ == "__main__":
    sys.exit(main())
