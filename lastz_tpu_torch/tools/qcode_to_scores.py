#!/usr/bin/env python3
"""Convert quantum-code files to a LASTZ scores file (reference
tools/qcode_to_scores.py).

Like probabilities_to_scores, but the row/column alphabets come from
quantum code files (symbol + p(A) p(C) p(G) p(T) per line), supporting
asymmetric target/query background probabilities.
"""

import sys
from math import log

USAGE = """
qcode_to_scores [options] > lastz_score_file
  --scaleto=<max>         scale scores to give desired max
  --symmetric             map probabilities symmetrically
  --hoxd70                use HOXD70 (lastz default scores) for probabilities
  --code.target=<codefile> specify the quantum code for rows (LASTZ target)
  --code.query=<codefile>  specify the quantum code for columns (LASTZ query)
  --code=<codefile>       specify the quantum code for both rows *and* columns
  --creator=<string>      set name of creator to write as a comment in output
  --nocreator             inhibit creator comment in output
  <base>.target:<prob>    set target background probability of a nucleotide
  <base>.query:<prob>     set query background probability of a nucleotide
  <base>:<prob>           set background probability of a nucleotide for *both*
                          target and query
  <basepair>:<prob>       set basepair substitution probability;  first base is
                          for target, second for query
"""

BASES = ["A", "C", "G", "T"]
BASE_PAIRS = [y + x for y in BASES for x in BASES]
BASE_SYMMETRIES = [["A", "T"], ["C", "G"]]
PAIR_SYMMETRIES = [["AA", "TT"], ["CC", "GG"], ["AT", "TA"], ["CG", "GC"],
                   ["AC", "CA", "GT", "TG"], ["AG", "GA", "CT", "TC"]]
HOXD70 = [("A", .26585), ("C", .23415),
          ("AA", .18204), ("AC", .01903), ("AG", .04510), ("AT", .01967),
          ("CC", .15508), ("CG", .01495)]


def float_or_fraction(s):
    if "/" in s:
        n, d = s.split("/", 1)
        return float(n) / float(d)
    return float(s)


def valid_dna_event(s):
    return 1 <= len(s) <= 2 and all(c in BASES for c in s)


def quantum_code_num(s):
    if len(s) == 1:
        if 0x21 <= ord(s) <= 0x7E:
            return ord(s)
        raise ValueError
    if len(s) == 2 and s != "00":
        return int(s, 16)
    raise ValueError


def dna_event(s):
    s, p = s.split(":", 1)
    which = None
    if "." in s:
        s, which = s.split(".", 1)
    if not valid_dna_event(s):
        raise SystemExit("invalid DNA event: %s" % s)
    try:
        p = float_or_fraction(p)
        if not 0 <= p <= 1:
            raise ValueError
    except ValueError:
        raise SystemExit("invalid probability for %s: %s" % (s, p))
    return (s, which, p)


def simple_dna_quantum_code():
    return {n1: {n2: (1 if n2 == n1 else 0) for n2 in BASES}
            for n1 in BASES}


def read_quantum_code(code_name):
    sym_to_profile = {}
    code_num_used = set()
    sym_order = []
    with open(code_name) as f:
        for line_num, line in enumerate(f, 1):
            line = line.strip()
            if "#" in line:
                line = line.split("#", 1)[0].strip()
            if line == "":
                continue
            fields = line.split()
            if len(fields) < 5:
                raise SystemExit("fewer than four probabilities (%s line %d)"
                                 % (code_name, line_num))
            if len(fields) > 5:
                raise SystemExit("more than four probabilities (%s line %d)"
                                 % (code_name, line_num))
            sym = fields[0]
            try:
                code_num = quantum_code_num(sym)
            except ValueError:
                raise SystemExit(
                    "%s is not a valid quantum symbol (%s line %d)"
                    % (sym, code_name, line_num))
            if code_num in code_num_used:
                raise SystemExit(
                    "%s (or equivalent) appears more than once (%s line %d)"
                    % (sym, code_name, line_num))
            profile = {}
            for ix in range(4):
                try:
                    p = float_or_fraction(fields[ix + 1])
                    if not 0 <= p <= 1:
                        raise ValueError
                except ValueError:
                    raise SystemExit(
                        "%s is a bad probability value (%s line %d)"
                        % (fields[ix + 1], code_name, line_num))
                profile[BASES[ix]] = p
            sym_to_profile[sym] = profile
            code_num_used.add(code_num)
            sym_order.append(sym)
    if not sym_to_profile:
        raise SystemExit("%s contains no code vectors!" % code_name)
    for sym in sym_to_profile:
        p = sum(sym_to_profile[sym].values())
        if abs(p - 1) >= .00001:
            raise SystemExit("probabilities for %s sum to %f (in %s)"
                             % (sym, p, code_name))
    sym_to_profile[".order"] = sym_order
    return sym_to_profile


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    r_prob = {}
    c_prob = {}
    rc_prob = {}
    scale_to = None
    symmetric = False
    settings = []
    row_code_name = None
    col_code_name = None
    creator = "qcode_to_scores"

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
        elif arg in ("--hoxd70", "--HOXD70") and val is None:
            # NB: the reference routes the hoxd70 PAIR entries into the
            # base-probability dicts too (qcode_to_scores.py:127-131),
            # so --hoxd70 always fails the pair-symmetry check there;
            # we replicate that (give pair probabilities explicitly)
            symmetric = True
            for s, p in HOXD70:
                if s in r_prob or s in c_prob:
                    raise SystemExit("duplicate DNA event: %s" % s)
                r_prob[s] = c_prob[s] = p
        elif arg in ("--code.row", "--code.target") and val is not None:
            if row_code_name is not None:
                raise SystemExit("can't have more than one row/target code")
            row_code_name = val
        elif arg in ("--code.column", "--code.col", "--code.query") \
                and val is not None:
            if col_code_name is not None:
                raise SystemExit(
                    "can't have more than one column/target code")
            col_code_name = val
        elif arg == "--code" and val is not None:
            if row_code_name is not None or col_code_name is not None:
                raise SystemExit("can't have more than one code")
            row_code_name = col_code_name = val
        elif arg == "--nocreator" and val is None:
            creator = None
        elif arg == "--creator" and val is not None:
            creator = val
        elif arg.startswith("--") and val is not None:
            settings.append((arg[2:], val))
        elif arg.startswith("--"):
            raise SystemExit("unknown argument: %s\n%s" % (arg, USAGE))
        elif val is None and ":" in arg:
            s, which, p = dna_event(arg)
            w = {"target": "row", "query": "col",
                 "column": "col"}.get(which, which)
            if w not in ("row", "col", None):
                raise SystemExit(
                    'can\'t decipher "%s" (in %s)' % (which, arg))
            if w == "row":
                if s not in BASES or s in r_prob:
                    raise SystemExit("duplicate DNA event: %s.target" % s)
                r_prob[s] = p
            elif w == "col":
                if s not in BASES or s in c_prob:
                    raise SystemExit("duplicate DNA event: %s.query" % s)
                c_prob[s] = p
            elif s in BASES:
                if s in r_prob or s in c_prob:
                    raise SystemExit("duplicate DNA event: %s" % s)
                r_prob[s] = c_prob[s] = p
            else:
                if s in rc_prob:
                    raise SystemExit("duplicate DNA pair event: %s" % s)
                rc_prob[s] = p
        else:
            raise SystemExit("unknown argument: %s\n%s" % (arg, USAGE))

    if symmetric:
        con_prob = {}
        for nuc in BASES:
            if nuc in r_prob and nuc not in c_prob:
                con_prob[nuc] = r_prob[nuc]
            elif nuc in c_prob and nuc not in r_prob:
                con_prob[nuc] = c_prob[nuc]
            elif nuc in c_prob and nuc in r_prob:
                if r_prob[nuc] != c_prob[nuc]:
                    raise SystemExit(
                        "can't use --symmetric with %s.target != %s.query"
                        % (nuc, nuc))
                con_prob[nuc] = r_prob[nuc]
        for group in BASE_SYMMETRIES:
            present = [x for x in group if x in con_prob]
            if len(present) != 1:
                raise SystemExit("need a probability for exactly one of %s"
                                 % ",".join(group))
            for x in group:
                con_prob.setdefault(x, con_prob[present[0]])
        r_prob = c_prob = con_prob
        for group in PAIR_SYMMETRIES:
            present = [x for x in group if x in rc_prob]
            if len(present) != 1:
                raise SystemExit("need a probability for exactly one of %s"
                                 % ",".join(group))
            for x in group:
                rc_prob.setdefault(x, rc_prob[present[0]])

    for nuc in BASES:
        if nuc not in r_prob:
            raise SystemExit("need a target probability for %s" % nuc)
        if nuc not in c_prob:
            raise SystemExit("need a query probability for %s" % nuc)
    for xy in BASE_PAIRS:
        if xy not in rc_prob:
            raise SystemExit("need a probability for %s" % xy)
    for probs, what in ((r_prob, "target base"), (c_prob, "query base")):
        p = sum(probs[n] for n in BASES)
        if abs(p - 1) >= .00001:
            raise SystemExit("%s probabilities sum to %f" % (what, p))
    p = sum(rc_prob[yx] for yx in BASE_PAIRS)
    if abs(p - 1) >= .00001:
        raise SystemExit("base pair probabilities sum to %f" % p)

    if row_code_name is None:
        row_code = simple_dna_quantum_code()
    else:
        row_code = read_quantum_code(row_code_name)
    row_symbols = row_code.get(".order") or sorted(row_code)
    if col_code_name is None:
        col_code = simple_dna_quantum_code()
    elif col_code_name == row_code_name:
        col_code = row_code
    else:
        col_code = read_quantum_code(col_code_name)
    col_symbols = col_code.get(".order") or sorted(col_code)

    sub = {}
    max_sub = None
    for row in row_symbols:
        u = row_code[row]
        sub[row] = {}
        for col in col_symbols:
            v = col_code[col]
            numer = sum(u[y] * v[x] * rc_prob[y + x]
                        for y in BASES for x in BASES)
            denom = sum(u[y] * v[x] * r_prob[y] * c_prob[x]
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

    w_row = max(len(row) for row in row_symbols)
    if scale_to is not None and isinstance(scale_to, int):
        fmt = "%*d"
        w_col = 4
        for row in row_symbols:
            for col in col_symbols:
                w_col = max(w_col, len("%d" % sub[row][col]))
    else:
        fmt = "%*.6f"
        w_col = 4
        for row in row_symbols:
            for col in col_symbols:
                w_col = max(w_col, len("%.6f" % sub[row][col]))
    print("%-*s %s" % (w_row, " ", "  ".join(
        "%*s" % (w_col, col) for col in col_symbols)))
    for row in row_symbols:
        print("%-*s %s" % (w_row, row, "  ".join(
            fmt % (w_col, sub[row][col]) for col in col_symbols)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
