"""General-purpose tabular output (reference genpaf.c).

One engine renders --format=general[:fields], segments, PAF (wfmash /
minimap2 presets), BLASTN, and rdotplot — each is a canned key string
(reference genpaf.h:117-126).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.encoding import NUC_TO_BITS, NUC_TO_COMPLEMENT
from ..core.scoring import score_str
from .axt import _names_and_coords, _gapped_texts

STANDARD_KEYS = "#NDSZEndszeIC"
MAPPING_KEYS = "NZEnd>,IC^"
SEGMENT_KEYS = "NBEnbed#"
BLAST_KEYS = "nNmWvy<,QR%$"
RDOTPLOT_KEYS = "02!13!XX"
RDOTPLOT_SCORE_KEYS = "02#!13#!XXX"
PAF_WFMASH_KEYS = "ns>,dNSZEuW{|}"
PAF_MINIMAP2_KEYS = "ns>,dNSZEuW{|."

KEY_NAMES = {
    "N": "name1", "O": "number1", "D": "strand1", "S": "size1",
    "B": "start1", "Z": "zstart1", "0": "start1", "Q": "bstart1",
    "E": "end1", "1": "end1", "R": "bend1", "L": "length1",
    "A": "align1", "T": "text1", "F": "qalign1",
    "n": "name2", "o": "number2", "d": "strand2", "s": "size2",
    "b": "start2", "z": "zstart2", "<": "start2+", ">": "zstart2+",
    "2": "start2", "e": "end2", ",": "end2+", "3": "end2",
    "l": "length2", "a": "align2", "t": "text2", "f": "qalign2",
    "u": "nmatch", "v": "nmismatch", "w": "npair", "W": "ncolumn",
    "y": "ngap", "x": "cgap", "=": "diff", "&": "cigar", "@": "cigar-",
    "_": "cigarx", "^": "cigarx-", '"': "cigarx1", "'": "cigarx1-",
    "/": "diagonal", "\\": "shingle", "#": "score", "]": "znumber",
    "[": "number", "$": "bitscore", "%": "evalue",
    "I": "identity\tidPct", "k": "idfrac", "i": "id%",
    "m": "blastid%", "C": "coverage\tcovPct", "7": "covfrac",
    "6": "cov%", "c": "continuity\tconPct", "9": "confrac",
    "8": "con%", "G": "gaprate\tgapPct", "*": "chore",
    "J": "nucs1", "K": "quals1", "p": "nucs2", "q": "quals2",
    "H": "entropy1", "h": "entropy2", "(": "hspid", "4": "phash",
    "5": "ahash", "{": "mapqual", "|": "astag", "}": "cgtag",
    ".": "cgtag", "X": "NA",
}


# canonical field names + aliases -> key characters (reference
# genpafName[]/genpafAliases[], genpaf.h:149-251)
NAME_TO_KEY = {
    "name1": "N", "number1": "O", "strand1": "D", "size1": "S",
    "start1": "B", "zstart1": "Z", "end1": "E", "length1": "L",
    "align1": "A", "text1": "T", "qalign1": "F",
    "name2": "n", "number2": "o", "strand2": "d", "size2": "s",
    "start2": "b", "zstart2": "z", "start2+": "<", "zstart2+": ">",
    "end2": "e", "end2+": ",", "length2": "l", "align2": "a",
    "text2": "t", "qalign2": "f",
    "nmatch": "u", "nmismatch": "v", "npair": "w", "ncolumn": "W",
    "ngap": "y", "cgap": "x",
    "cigar": "&", "cigar-": "@", "cigarx": "_", "cigarx-": "^",
    "cigarx1": '"', "cigarx1-": "'",
    "diagonal": "/", "shingle": "\\", "score": "#",
    "identity": "I", "idfrac": "k", "id%": "i", "blastid%": "m",
    "coverage": "C", "covfrac": "7", "cov%": "6",
    "continuity": "c", "confrac": "9", "con%": "8", "gaprate": "G",
    "nucs1": "J", "quals1": "K", "nucs2": "p", "quals2": "q",
    "number": "[", "znumber": "]", "chore": "*",
    "entropy1": "H", "entropy2": "h",
    "hspid": "(", "phash": "4", "ahash": "5",
    "NA": "X", "~": "~",
    # aliases (genpafAliases[])
    "n1": "N", "s1": "B", "z1": "Z", "e1": "E", "l1": "L", "a1": "A",
    "t1": "T", "n2": "n", "s2": "b", "z2": "z", "s2+": "<", "z2+": ">",
    "e2": "e", "e2+": ",", "l2": "l", "a2": "a", "t2": "t",
    "d": "/", "diag": "/", "s": "#", "id": "I", "ident": "I",
    "cov": "C", "con": "c", "gap": "G",
}


def parse_genpaf_keys(names: str) -> str:
    """Convert a comma-separated field-name list to key characters
    (reference parse_genpaf_keys, genpaf.c:1948).  An empty field is a
    line break ('!')."""
    keys = []
    for field in names.split(","):
        if field == "":
            keys.append("!")
            continue
        k = NAME_TO_KEY.get(field)
        if k is None and field.startswith("diff"):
            # diff<4 chars>: text-diff with custom marker characters
            keys.append("=")
            continue
        if k is None:
            raise SystemExit(
                f'FAILURE: unrecognized field name (for --format=general):'
                f' "{field}"')
        keys.append(k)
    return "".join(keys)


def genpaf_job_header(keys: str | None) -> str:
    keys = keys or STANDARD_KEYS
    out = []
    tab = "#"
    for k in keys:
        if k == ";":
            break
        if tab in ("#", None):
            out.append("#")
            tab = "\t"
        elif k in ("!", "~"):
            pass
        else:
            out.append("\t")
        if k == "!":
            out.append("\n")
            tab = "#"
            continue
        if k == "~":
            out.append("~")
            tab = None
            continue
        if k == "X":
            continue
        out.append(KEY_NAMES.get(k, ""))
    out.append("\n")
    return "".join(out)


_ALIGNMENT_COUNTER = [0]


def reset_alignment_counter():
    _ALIGNMENT_COUNTER[0] = 0


def _identity(v1, v2, a):
    beg1, beg2 = a.beg1, a.beg2
    i = j = 0
    matches = 0
    denom = 0
    for op, run in a.script.ops:
        if op == "S":
            b1 = NUC_TO_BITS[v1[beg1 - 1 + i : beg1 - 1 + i + run]]
            b2 = NUC_TO_BITS[v2[beg2 - 1 + j : beg2 - 1 + j + run]]
            ok = (b1 >= 0) & (b2 >= 0)
            denom += int(np.count_nonzero(ok))
            matches += int(np.count_nonzero(ok & (b1 == b2)))
            i += run
            j += run
        elif op == "I":
            j += run
        else:
            i += run
    return matches, denom


def _continuity(a):
    height = a.end1 - a.beg1 + 1
    width = a.end2 - a.beg2 + 1
    run_total = sum(r for op, r in a.script.ops if op == "S")
    if run_total == 0:
        return 0, 0
    gap_columns = (height - run_total) + (width - run_total)
    return run_total, run_total + gap_columns


def _coverage(seq1, seq2, a):
    t_len = (seq1.lookup_partition(a.beg1 - 1).true_len
             if seq1.is_partitioned else seq1.true_len)
    q_len = (seq2.lookup_partition(a.beg2 - 1).true_len
             if seq2.is_partitioned else seq2.true_len)
    if t_len < q_len:
        return a.end1 + 1 - a.beg1, t_len
    return a.end2 + 1 - a.beg2, q_len


def _sequence_entropy(v, pos, length):
    """reference sequence_entropy (sequences.c:9730-9780): base-composition
    entropy over v[pos:pos+length], N counted as 1/4 of each base; other
    characters ignored; -1 when nothing countable."""
    if length <= 0:
        return -1.0
    window = np.frombuffer(bytes(v[pos:pos + length]).upper(), dtype=np.uint8)
    counts = np.bincount(window, minlength=256)
    n = int(counts[ord("N")])
    acgt = [4 * int(counts[ord(c)]) + n for c in "ACGT"]
    denom = sum(acgt)
    if denom == 0:
        return -1.0
    log_denom = math.log2(denom)
    s = sum(c * (math.log2(c) - log_denom) for c in acgt if c > 0)
    return -s / denom


def blastz_score_to_ncbi_bits(s):
    # reference dna_utilities.c:2340-2344 (via UCSC blastOut.c)
    return s * 0.0205


def blastz_score_to_ncbi_expectation(s):
    # reference dna_utilities.c:2346-2352
    import math
    bits = s * 0.0205
    return 3.0e9 * math.exp(-bits * math.log(2))


def genpaf_align(cfg, seq1, seq2, a, keys=None, as_match=False) -> str:
    keys = keys if keys is not None else (cfg.output_info or STANDARD_KEYS)
    beg1, beg2 = a.beg1, a.beg2
    height = a.end1 - beg1 + 1
    width = a.end2 - beg2 + 1
    (name1, offset1, start_loc1, seq1_len, seq1_true,
     name2, offset2, start_loc2, seq2_len, seq2_true) = _names_and_coords(
        seq1, beg1, seq2, beg2)
    seq1_contig = (seq1.lookup_partition(beg1 - 1).contig
                   if seq1.is_partitioned else seq1.contig)
    seq2_contig = (seq2.lookup_partition(beg2 - 1).contig
                   if seq2.is_partitioned else seq2.contig)
    seq1_invert = ((seq1.lookup_partition(beg1 - 1).sep_before
                    + seq1.lookup_partition(beg1 - 1).sep_after + 1)
                   if seq1.is_partitioned else seq1_true)
    seq2_invert = ((seq2.lookup_partition(beg2 - 1).sep_before
                    + seq2.lookup_partition(beg2 - 1).sep_after + 1)
                   if seq2.is_partitioned else seq2_true)

    # the reference computes dot-plot coordinates differently for
    # gapped alignments (print_genpaf_align) and ungapped matches
    # (print_genpaf_match); as_match selects the latter
    m_plus = 0 if as_match else 1   # plus strand: align adds one
    m_minus = 1 if as_match else 0  # minus strand: match adds one
    if seq1.rev_comp_flags & 2:
        start1 = beg1 - 1 - offset1 + seq1_true + 2 - (start_loc1 + seq1_len)
        dot_start1 = ((start_loc1 + seq1_len + offset1 - beg1) - 1 + m_minus
                      if not seq1.is_partitioned
                      else seq1_invert - beg1 + m_minus)
        dot_end1 = (dot_start1 - height) + 1
        strand1 = "-"
    else:
        start1 = beg1 - 1 - offset1 + start_loc1
        dot_start1 = (start1 + m_plus if not seq1.is_partitioned
                      else beg1 + m_plus)
        dot_end1 = dot_start1 + height - 1
        strand1 = "+"
    if seq2.rev_comp_flags & 2:
        start2 = beg2 - 1 - offset2 + seq2_true + 2 - (start_loc2 + seq2_len)
        dot_start2 = ((start_loc2 + seq2_len + offset2 - beg2) - 1 + m_minus
                      if not seq1.is_partitioned
                      else seq2_invert - beg2 + m_minus)
        dot_end2 = (dot_start2 - width) + 1
        strand2 = "-"
    else:
        start2 = beg2 - 1 - offset2 + start_loc2
        dot_start2 = (start2 + m_plus if not seq2.is_partitioned
                      else beg2 + m_plus)
        dot_end2 = dot_start2 + width - 1
        strand2 = "+"

    id_numer, id_denom = _identity(seq1.v, seq2.v, a)
    con_numer, con_denom = _continuity(a)
    try:
        cov_numer, cov_denom = _coverage(seq1, seq2, a)
    except Exception:
        cov_numer = cov_denom = 0

    num = _ALIGNMENT_COUNTER[0]
    _ALIGNMENT_COUNTER[0] += 1

    t1 = t2 = None

    def texts():
        nonlocal t1, t2
        if t1 is None:
            t1, t2 = _gapped_texts(seq1.v, seq2.v, beg1, beg2, a.script)
        return t1, t2

    out = []
    tab = "#"
    for k in keys:
        if k == ";":
            break
        if tab in ("#", None) or k in ("!", "~"):
            tab = "\t"
        else:
            out.append("\t")
        if k == "!":
            out.append("\n")
            tab = "#"
            continue
        if k == "~":
            out.append("~")
            tab = None
            continue
        if k == "X":
            out.append("NA")
        elif k == "N":
            out.append(f"{name1}")
        elif k == "O":
            out.append(str(seq1_contig - 1))
        elif k == "D":
            out.append(strand1)
        elif k == "S":
            out.append(str(seq1_true))
        elif k == "B":
            out.append(str(start1))
        elif k == "Z":
            out.append(str(start1 - 1))
        elif k == "0":
            out.append(str(dot_start1))
        elif k == "Q":
            out.append(str(start1 if strand2 == strand1
                           else start1 + height - 1))
        elif k == "E":
            out.append(str(start1 + height - 1))
        elif k == "1":
            out.append(str(dot_end1))
        elif k == "R":
            out.append(str(start1 + height - 1 if strand2 == strand1
                           else start1))
        elif k == "L":
            out.append(str(height))
        elif k in ("A", "T"):
            out.append(texts()[0])
        elif k == "n":
            out.append(f"{name2}")
        elif k == "o":
            out.append(str(seq2_contig - 1))
        elif k == "d":
            out.append(strand2)
        elif k == "s":
            out.append(str(seq2_true))
        elif k == "<":
            out.append(str(seq2_true + 2 - start2 - width
                           if strand2 == "-" else start2))
        elif k == "b":
            out.append(str(start2))
        elif k == ">":
            out.append(str(seq2_true + 1 - start2 - width
                           if strand2 == "-" else start2 - 1))
        elif k == "z":
            out.append(str(start2 - 1))
        elif k == "2":
            out.append(str(dot_start2))
        elif k == ",":
            out.append(str(seq2_true + 1 - start2
                           if strand2 == "-" else start2 + width - 1))
        elif k == "e":
            out.append(str(start2 + width - 1))
        elif k == "3":
            out.append(str(dot_end2))
        elif k == "l":
            out.append(str(width))
        elif k in ("a", "t"):
            out.append(texts()[1])
        elif k == "u":
            out.append(str(id_numer))
        elif k == "v":
            out.append(str(id_denom - id_numer))
        elif k == "w":
            out.append(str(id_denom))
        elif k == "W":
            out.append(str(con_denom))
        elif k == "y":
            out.append(str(sum(1 for op, r in a.script.ops if op != "S")))
        elif k == "x":
            out.append(str(con_denom - con_numer))
        elif k in ("&", "@"):
            out.append(_cigar(a.script, height, width, lower=(k == "@")))
        elif k in ("_", "^", '"', "'"):
            from .cigar import cigarx_text
            out.append(cigarx_text(
                seq1.v, a.beg1 - 1, seq2.v, a.beg2 - 1, a.script,
                letter_after=True, with_spaces=True,
                hide_singles=(k in ("_", "^")),
                lower_case=(k in ("^", "'")),
                mark_mismatches=True))
        elif k == "/":
            out.append(str(start1 - start2))
        elif k == "#":
            out.append(str(a.score))
        elif k == "]":
            out.append(str(num))
        elif k == "[":
            out.append(str(num + 1))
        elif k == "$":
            out.append(f"{blastz_score_to_ncbi_bits(a.score):.1f}")
        elif k == "%":
            out.append(f"{blastz_score_to_ncbi_expectation(a.score):.2g}")
        elif k == "I":
            out.append(f"{id_numer}/{id_denom}")
            out.append(f"\t{100.0 * id_numer / id_denom:.1f}%"
                       if id_denom else "\tNA")
        elif k == "k":
            out.append(f"{id_numer}/{id_denom}")
        elif k == "i":
            out.append(f"{100.0 * id_numer / id_denom:.1f}%"
                       if id_denom else "NA")
        elif k == "m":
            out.append(f"{100.0 * id_numer / con_denom:.2f}"
                       if con_denom else "NA")
        elif k == "C":
            out.append(f"{cov_numer}/{cov_denom}")
            out.append(f"\t{100.0 * cov_numer / cov_denom:.1f}%"
                       if cov_denom else "\tNA")
        elif k == "7":
            out.append(f"{cov_numer}/{cov_denom}")
        elif k == "6":
            out.append(f"{100.0 * cov_numer / cov_denom:.1f}%"
                       if cov_denom else "NA")
        elif k == "c":
            out.append(f"{con_numer}/{con_denom}")
            out.append(f"\t{100.0 * con_numer / con_denom:.1f}%"
                       if con_denom else "\tNA")
        elif k == "9":
            out.append(f"{con_numer}/{con_denom}")
        elif k == "8":
            out.append(f"{100.0 * con_numer / con_denom:.1f}%"
                       if con_denom else "NA")
        elif k == "J":
            out.append(_whole_seq_text(seq1, offset1, seq1_len, strand1))
        elif k == "p":
            out.append(_whole_seq_text(seq2, offset2, seq2_len, strand2))
        elif k in ("K", "q", "F", "f"):
            out.append("*")  # quality fields (fastq arrives later)
        elif k == "(":
            out.append(str(a.hsp_id))
        elif k == "{":
            out.append("255")
        elif k == "|":
            # genpaf.c:1296-1300: the raw lastz score, not negated
            out.append("AS:i:" + score_str(a.score))
        elif k == "}":
            from .cigar import cigarx_text
            out.append("cg:Z:" + cigarx_text(
                seq1.v, a.beg1 - 1, seq2.v, a.beg2 - 1, a.script,
                letter_after=True, with_spaces=False, hide_singles=False,
                lower_case=False, mark_mismatches=True))
        elif k == ".":
            out.append("cg:Z:" + _cigar(a.script, height, width, lower=False,
                                        paf_order=True))
        elif k == "=":
            out.append(_text_diff(seq1.v, seq2.v, a))
        elif k == "G":
            # gap rate (genpaf.c:1200-1204): bases-in-gaps over aligned
            # columns, as fraction then percent
            gap_numer = con_denom - con_numer
            gap_denom = con_numer
            out.append(f"{gap_numer}/{gap_denom}")
            out.append(f"\t{100.0 * gap_numer / gap_denom:.1f}%"
                       if gap_denom else "\tNA")
        elif k in ("H", "h"):
            # entropy of the target/query side (genpaf.c:1268-1277); note
            # the reference passes the ORIGIN-1 beg as an origin-0 offset
            # for gapped alignments, shifting the window by one (and one
            # short), while the match printer (genpaf.c:1871-1880) uses
            # the true origin-0 start and full length
            if k == "H":
                v, b, ln = seq1.v, beg1, height
            else:
                v, b, ln = seq2.v, beg2, width
            if as_match:
                e = _sequence_entropy(v, b - 1, ln)
            else:
                e = _sequence_entropy(v, b, ln - 1)
            e = float(np.float32(e))  # reference stores in a C float
            out.append(f"{e:.3f}" if e >= 0 else "NA")
        elif k == "*":
            # chore id tag (reference genpafChoreId)
            chore = getattr(seq2, "chore", None)
            out.append(chore.id_tag if chore is not None and chore.id_tag
                       else "NA")
        else:
            out.append("NA")
    out.append("\n")
    return "".join(out)


def _cigar(script, height, width, lower=False, paf_order=False) -> str:
    m, d, i_ = ("m", "d", "i") if lower else ("M", "D", "I")
    out = []
    ii = jj = 0
    for op, run in script.ops:
        if op == "S":
            out.append(f"{run}{m}")
            ii += run
            jj += run
        elif op == "D":
            out.append(f"{run}{d}")
            ii += run
        else:
            out.append(f"{run}{i_}")
            jj += run
    return "".join(out)


def _whole_seq_text(seq, offset, length, strand) -> str:
    seg = seq.v[offset : offset + length]
    if strand == "+":
        return seg.tobytes().decode("latin-1")
    return NUC_TO_COMPLEMENT[seg[::-1]].tobytes().decode("latin-1")


def _text_diff(v1, v2, a, info="..:\"-\"") -> str:
    out = []
    i = j = 0
    beg1, beg2 = a.beg1, a.beg2
    for op, run in a.script.ops:
        if op == "S":
            for k in range(run):
                c1 = v1[beg1 - 1 + i + k]
                c2 = v2[beg2 - 1 + j + k]
                u1 = c1 - 32 if ord("a") <= c1 <= ord("z") else c1
                u2 = c2 - 32 if ord("a") <= c2 <= ord("z") else c2
                out.append("." if u1 == u2 else ":")
            i += run
            j += run
        elif op == "D":
            out.append("-" * run)
            i += run
        else:
            out.append('"' * run)
            j += run
    return "".join(out)


def genpaf_match(cfg, seq1, pos1, seq2, pos2, length, s, keys=None) -> str:
    from ..align.edit_script import EditScript, Alignment

    script = EditScript()
    script.add("S", length)
    a = Alignment(beg1=pos1 + 1, beg2=pos2 + 1,
                  end1=pos1 + length, end2=pos2 + length,
                  script=script, score=s)
    return genpaf_align(cfg, seq1, seq2, a, keys, as_match=True)
