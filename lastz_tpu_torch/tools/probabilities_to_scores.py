#!/usr/bin/env python3
"""Convert probabilities to a LASTZ scores file, including quantum
symbols (reference tools/probabilities_to_scores.py).

Given background probabilities, substitution-event probabilities, and
optional quantum symbol profiles, produce a log-odds scoring matrix:
score(r,c) = log( sum(u_y v_x p(yx)) / sum(u_y v_x p(y)p(x)) ).
"""

import sys
from math import log

USAGE = """
probabilities_to_scores [options] > lastz_score_file
  --scaleto=<max>    scale scores to give desired max
  --symmetric        map probabilities symmetrically
  --nodna            don't include A,G,C,T in the alphabets
  --dnarows          (target) row alphabet is A,C,G,T
  --dnacol[umn]s     (query) column alphabet is A,C,G,T
  --hoxd70           use HOXD70 (lastz default scores) for probabilities
  --iupac            alphabets are IUPAC 15-letter code
  --writecode=<file> write quantum code to a file
  --creator=<string> set name of creator to write as a comment in output
  --nocreator        inhibit creator comment in output
  <base>=<prob>      set background probability of a nucleotide
  <basepair>=<prob>  set basepair substitution probability
  <symbol>=<profile> define the profile for a quantum symbol
                     .. e.g. Y=T:.5,C:.5 or 07=A:0.311,C:0.228,G:0.422,T:0.039
"""

BASES = "ACGT"
BASE_PAIRS = [y + x for y in BASES for x in BASES]
SYMMETRIES = [["A", "T"], ["C", "G"],
              ["AA", "TT"], ["CC", "GG"], ["AT", "TA"], ["CG", "GC"],
              ["AC", "CA", "GT", "TG"], ["AG", "GA", "CT", "TC"]]
HOXD70 = [("A", .26585), ("C", .23415),
          ("AA", .18204), ("AC", .01903), ("AG", .04510), ("AT", .01967),
          ("CC", .15508), ("CG", .01495)]
IUPAC = [("R", "G,A"), ("Y", "T,C"), ("K", "G,T"), ("M", "A,C"),
         ("S", "G,C"), ("W", "A,T"), ("B", "G,T,C"), ("D", "G,A,T"),
         ("H", "A,C,T"), ("V", "G,C,A"), ("N", "A,C,G,T")]


def valid_dna_event(s):
    return 1 <= len(s) <= 2 and all(c in BASES for c in s)


def valid_quantum_symbol(s):
    if len(s) == 1:
        return s.isalnum() and s.isascii()
    if len(s) == 2:
        return s != "00" and all(c in "0123456789ABCDEF" for c in s)
    return False


def dna_event(s):
    s, p = s.split(":", 1)
    if not valid_dna_event(s):
        raise SystemExit("invalid DNA event: %s" % s)
    try:
        p = float(p)
        if not 0 <= p <= 1:
            raise ValueError
    except ValueError:
        raise SystemExit("invalid probability for %s: %s" % (s, p))
    return (s, p)


def non_single(s):
    return "" if len(s) == 1 else s


def non_single_comment(s):
    return "" if len(s) == 1 else " # " + s


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    prob = {}
    scale_to = None
    symmetric = False
    dna_query = True
    symbols = []
    sym_prob = {}
    sym_group = {}
    settings = []
    rows_are_dna = False
    cols_are_dna = False
    creator = "probabilities_to_scores"
    code_name = None

    for arg in argv:
        val = None
        if "=" in arg:
            arg, val = arg.split("=", 1)
            if val == "":
                raise SystemExit("missing a value in %s=" % arg)
        if arg in ("--help", "-h", "--h", "-help") and val is None:
            raise SystemExit(USAGE)
        elif arg == "--scaleto" and val is not None:
            try:
                scale_to = int(val)
            except ValueError:
                scale_to = float(val)
        elif arg == "--symmetric" and val is None:
            symmetric = True
        elif arg == "--nodna" and val is None:
            dna_query = False
        elif arg == "--dnarows" and val is None:
            rows_are_dna = True
        elif arg in ("--dnacols", "--dnacolumns") and val is None:
            cols_are_dna = True
        elif arg in ("--hoxd70", "--HOXD70") and val is None:
            symmetric = True
            for s, p in HOXD70:
                if s in prob:
                    raise SystemExit("duplicate DNA event: %s" % s)
                prob[s] = p
        elif arg in ("--iupac", "--IUPAC") and val is None:
            for sym, v in IUPAC:
                if sym in sym_prob:
                    raise SystemExit("duplicate quantum symbol: %s" % sym)
                symbols.append(sym)
                sym_prob[sym] = {}
                sym_group[sym] = ""
                vals = v.split(",")
                for s in vals:
                    sym_prob[sym][s] = 1.0 / len(vals)
                    sym_group[sym] += s
        elif arg == "--writecode" and val is not None:
            code_name = val
        elif arg == "--nocreator" and val is None:
            creator = None
        elif arg == "--creator" and val is not None:
            creator = val
        elif arg.startswith("--") and val is not None:
            settings.append((arg[2:], val))
        elif arg.startswith("--"):
            raise SystemExit("unknown argument: %s\n%s" % (arg, USAGE))
        elif val is None and ":" in arg:
            s, p = dna_event(arg)
            if s in prob:
                raise SystemExit("duplicate DNA event: %s" % s)
            prob[s] = p
        elif valid_quantum_symbol(arg) and val is not None:
            sym = arg
            if sym in sym_prob:
                raise SystemExit("duplicate quantum symbol: %s" % sym)
            symbols.append(sym)
            sym_prob[sym] = {}
            sym_group[sym] = ""
            vals = val.split(",")
            have_probs = any(":" in v for v in vals)
            for v in vals:
                if have_probs:
                    s, p = dna_event(v)
                    if len(s) != 1:
                        raise SystemExit(
                            "invalid DNA event for %s: %s" % (sym, s))
                else:
                    s, p = v, 1.0 / len(vals)
                    if len(s) != 1 or s not in BASES:
                        raise SystemExit(
                            "invalid DNA event for %s: %s" % (sym, s))
                if s in sym_prob[sym]:
                    raise SystemExit(
                        "duplicate DNA event for %s: %s" % (sym, s))
                sym_prob[sym][s] = p
                sym_group[sym] += s
        else:
            raise SystemExit("unknown argument: %s\n%s" % (arg, USAGE))

    if symmetric:
        for group in SYMMETRIES:
            present = [x for x in group if x in prob]
            if len(present) != 1:
                raise SystemExit(
                    "need a probability for exactly one of %s"
                    % ",".join(group))
            for x in group:
                prob.setdefault(x, prob[present[0]])

    for nuc in BASES:
        if nuc not in prob:
            raise SystemExit("need a probability for %s" % nuc)
    for xy in BASE_PAIRS:
        if xy not in prob:
            raise SystemExit("need a probability for %s" % xy)
    p = sum(prob[n] for n in BASES)
    if abs(p - 1) >= .000001:
        raise SystemExit("base probabilities sum to %f" % p)
    p = sum(prob[xy] for xy in BASE_PAIRS)
    if abs(p - 1) >= .000001:
        raise SystemExit("base pair probabilities sum to %f" % p)
    for sym in sym_prob:
        p = sum(sym_prob[sym].values())
        if abs(p - 1) >= .000001:
            raise SystemExit("probabilities for %s sum to %f" % (sym, p))
        for nuc in BASES:
            sym_prob[sym].setdefault(nuc, 0)

    if dna_query:
        for sym in BASES:
            if sym in sym_prob:
                continue
            symbols.append(sym)
            sym_prob[sym] = {n: (1 if n == sym else 0) for n in BASES}
            sym_group[sym] = sym
        symbols = list(BASES) + [s for s in symbols if s not in BASES]

    row_symbols = BASES if rows_are_dna else symbols
    col_symbols = BASES if cols_are_dna else symbols

    if code_name is not None:
        with open(code_name, "wt") as f:
            for sym in symbols:
                p = sym_prob[sym]
                f.write("%s\t%s\n"
                        % (sym, "\t".join("%.6f" % p[n] for n in BASES)))

    sub = {}
    max_sub = None
    for row in row_symbols:
        u = sym_prob[row]
        sub[row] = {}
        for col in col_symbols:
            v = sym_prob[col]
            numer = sum(u[y] * v[x] * prob[y + x]
                        for y in BASES for x in BASES)
            denom = sum(u[y] * v[x] * prob[y] * prob[x]
                        for y in BASES for x in BASES)
            sub[row][col] = log(float(numer) / float(denom))
            if max_sub is None or sub[row][col] > max_sub:
                max_sub = sub[row][col]

    if scale_to is not None:
        scale = scale_to / max_sub
        for row in row_symbols:
            for col in col_symbols:
                sub[row][col] *= scale
                if isinstance(scale_to, int):
                    sub[row][col] = round(sub[row][col])

    if creator is not None:
        print("# created by %s" % creator)
        print("")
    if settings:
        s_len = max(len(s) for s, _ in settings)
        for s, val in settings:
            print("%-*s = %s" % (s_len, s, val))
        print("")

    if scale_to is not None and isinstance(scale_to, int):
        fmt, w = "%*d", 4
        for row in row_symbols:
            for col in col_symbols:
                w = max(w, len("%d" % sub[row][col]))
    else:
        fmt, w = "%*.6f", 4
        for row in row_symbols:
            for col in col_symbols:
                w = max(w, len("%.6f" % sub[row][col]))
    print("%s %s" % ("#", "  ".join(
        "%*s" % (w, non_single(sym_group[c])) for c in col_symbols)))
    print("%s %s" % (" ", "  ".join(
        "%*s" % (w, c) for c in col_symbols)))
    for row in row_symbols:
        print("%s %s%s" % (row, "  ".join(
            fmt % (w, sub[row][c]) for c in col_symbols),
            non_single_comment(sym_group[row])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
