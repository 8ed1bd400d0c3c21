"""A reader of LAV text (the blastz format LASTZ writes by default).

`parse(text)` gives one entry a strand stanza: the query's strand (1
for the reverse complement) and its alignments, each a score and its
gap-free blocks (b1, b2, e1, e2, pct), origin-1 and inclusive, the
query's positions on the strand aligned. Text it cannot read raises
`LavError`.
"""

from __future__ import annotations


class LavError(ValueError):
    pass


def parse(text: str) -> list[dict]:
    strands = []
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        i += 1
        if line == "s {":
            seqs = []
            while i < n and lines[i].strip() != "}":
                seqs.append(lines[i].split())
                i += 1
            i += 1
            if len(seqs) != 2:
                raise LavError("s stanza without two sequences")
            # "name" start end strand contig, read from the right: a
            # name may hold spaces
            strands.append({"rc": int(seqs[1][-2]), "q_len": int(seqs[1][-3]),
                            "t_len": int(seqs[0][-3]), "aligns": []})
        elif line == "a {":
            if not strands:
                raise LavError("a stanza before any s stanza")
            score = None
            blocks = []
            begin = end = None
            while i < n and lines[i].strip() != "}":
                f = lines[i].split()
                i += 1
                if f[0] == "s":
                    score = int(f[1])
                elif f[0] == "b":
                    begin = (int(f[1]), int(f[2]))
                elif f[0] == "e":
                    end = (int(f[1]), int(f[2]))
                elif f[0] == "l":
                    blocks.append(tuple(int(x) for x in f[1:6]))
                else:
                    raise LavError(f"unknown line in a stanza: {f[0]}")
            i += 1
            if score is None or begin is None or end is None or not blocks:
                raise LavError("a stanza without s, b, e or l lines")
            strands[-1]["aligns"].append(
                {"score": score, "begin": begin, "end": end,
                 "blocks": blocks})
    return strands


def write(strands: list[dict]) -> str:
    """LAV text of parsed strands (what `parse` reads back)."""
    out = []
    for st in strands:
        out.append("s {\n")
        out.append(f'  "target" 1 {st["t_len"]} 0 1\n')
        out.append(f'  "query" 1 {st["q_len"]} {st["rc"]} 1\n')
        out.append("}\n")
        for al in st["aligns"]:
            out.append("a {\n")
            out.append(f"  s {al['score']}\n")
            out.append("  b %d %d\n" % tuple(al["begin"]))
            out.append("  e %d %d\n" % tuple(al["end"]))
            for b in al["blocks"]:
                out.append("  l %d %d %d %d %d\n" % tuple(b))
            out.append("}\n")
    return "".join(out)
